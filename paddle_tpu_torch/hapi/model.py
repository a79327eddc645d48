"""hapi.Model (port of paddle_tpu's `hapi/model.py`): `prepare`, `fit`,
`train_batch`, `eval_batch`, `predict_batch`, `evaluate`, `predict`,
`save`, `load`.

`prepare(optimizer, loss, metrics, amp_configs, strategy)` builds the
single-device train step of `distributed.fleet.compiler` on the default
device (`set_device`; cuda, which raises without a GPU) and moves the
network there. Without a strategy, `amp_configs` ("O1", "O2" or
{"level": ...}) selects AMP for training, as on the JAX package's plain
path; with one, the strategy's `amp` does (and `amp_configs` is ignored
with a warning, as in the JAX package).

`fit` loops over epochs and batches; each step's loss stays on the device
inside an `_AsyncScalar` until something reads it with `float()`, as in
the JAX package. The LR scheduler (stepped by the `LRScheduler` callback)
and the beta powers live on the host, and the gradient clip keeps its
norm on the device, so a train step makes no host sync. Metrics follow
the JAX package's rule: updated and logged on every train step only
without a strategy (which makes that step read the outputs back), and
always in `evaluate`. `eval_data` is evaluated every `eval_freq` epochs;
`save_dir` adds a `ModelCheckpoint`; `accumulate_grad_batches=n` applies
the optimizer to the mean gradient of every n batches.

`save(path)` writes ``{path}.pdparams`` (`framework.save` of the
network's `state_dict()`) and ``{path}.pdopt``: a pickle of
``{"LR_Scheduler": ..., "functional_state": {name: {slot: array}}}``, the
form the JAX package's `Model.save` writes from its compiled step, with
the slots keyed as the JAX package names the parameters
(`framework.stacked_layout`). `load(path)` reads either package's pair.
Evaluation runs under the strategy's AMP when there is a strategy and in
fp32 otherwise; `predict` runs in fp32, as the JAX package's does.
`save(training=False)` (the inference export) and `summary` are not
ported and raise.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import List

import numpy as np
import torch

from .. import amp as amp_mod
from ..core.arrays import to_numpy
from ..core.device import get_device
from ..distributed.fleet.compiler import compile_train_step
from ..distributed.fleet.strategy import DistributedStrategy
from ..framework import indexed_layout, load as fload, save as fsave
from ..framework import stacked_layout
from ..io.dataloader import DataLoader
from ..metric import Metric
from . import callbacks as cbks_mod

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class _AsyncScalar:
    """A scalar loss left on the device; `float()` reads it (and waits
    for the step that made it)."""

    __slots__ = ("_t",)

    def __init__(self, t):
        self._t = t

    def __float__(self):
        return float(self._t.float().item())

    def __format__(self, spec):
        return format(float(self), spec)

    def __repr__(self):
        return repr(float(self))


def _compute_loss(loss_fn, outputs, labels):
    """`loss_fn(*outputs, *labels)`, or with no loss function the first
    output."""
    outs = _as_list(outputs)
    return outs[0] if loss_fn is None else loss_fn(*outs, *labels)


class _LossAdapter:
    """The network plus the optional loss as a layer with a `loss(*batch)`
    method: the first `n_inputs` batch items (the inputs of the
    `train_batch` call) feed the network, the rest are labels for the
    loss (with no loss, the network's first output is the loss). With
    `keep_outs` it keeps the last outputs, detached, for the metrics."""

    def __init__(self, network, loss_fn):
        self.network, self._loss_fn = network, loss_fn
        self.n_inputs = 0
        self.keep_outs = False
        self.outs = None

    def train(self):
        self.network.train()

    def loss(self, *batch):
        k = self.n_inputs
        outs = self.network(*batch[:k])
        if self.keep_outs:
            self.outs = [o.detach() for o in _as_list(outs)]
        return _compute_loss(self._loss_fn, outs, list(batch[k:]))


_AMP_KEYS = {"level"}


def _amp_level(amp_configs):
    """The AMP level of `amp_configs`; what the port's op-by-op bf16 AMP
    cannot express raises."""
    if amp_configs is None:
        return "O0"
    if isinstance(amp_configs, str):
        level = amp_configs
    elif isinstance(amp_configs, dict):
        extra = sorted(set(amp_configs) - _AMP_KEYS)
        if extra:
            raise NotImplementedError(
                f"Model.prepare(amp_configs=): {extra} not ported to "
                f"paddle_tpu_torch (bf16 op-by-op AMP by level only; set "
                f"strategy.amp_configs for the rest)")
        level = amp_configs.get("level", "O1")
    else:
        raise TypeError(f"amp_configs must be a level string or a dict, "
                        f"got {type(amp_configs)}")
    if level not in ("O0", "O1", "O2"):
        raise NotImplementedError(f"Model.prepare(amp_configs=): level "
                                  f"{level!r} not ported (O0, O1, O2)")
    return level


class Model:
    """Wraps a Layer with train / eval / predict loops."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._strategy = None
        self._prog = None
        self._adapter = None
        self.stop_training = False

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, strategy=None):
        """Build the train step (when there is an optimizer) on the
        default device. Strategy toggles the port does not run, and
        amp_configs it cannot express, raise `NotImplementedError`."""
        self._metrics = _as_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric, got {type(m)}")
        level = _amp_level(amp_configs)
        if strategy is not None and level != "O0" and not strategy.amp:
            warnings.warn(
                "amp_configs is ignored on the strategy training path; set "
                "strategy.amp=True (+ amp_configs.use_pure_bf16 for O2) "
                "instead")
        if strategy is not None and self._metrics:
            warnings.warn(
                "metrics are computed by evaluate(), not during fit() — the "
                "strategy train step returns only the loss, so per-batch "
                "train logs omit metric values")
        self._strategy = strategy
        if strategy is None:
            strategy = DistributedStrategy()
            strategy.amp = level != "O0"
            strategy.amp_configs.use_pure_bf16 = level == "O2"
        device = get_device()
        self.network.to(device)
        self._device = device
        self._optimizer = optimizer
        self._loss = loss
        self._adapter = _LossAdapter(self.network, loss)
        self._prog = None
        if optimizer is not None:
            self._prog = compile_train_step(self._adapter, optimizer,
                                            strategy, device=device)

    # ------------------------------------------------------------------
    def _n_inputs(self, n_batch):
        if self._inputs is not None:
            return len(_as_list(self._inputs))
        return n_batch - 1 if n_batch > 1 else n_batch

    def _put(self, batch):
        """Batch items (tensors or arrays) as tensors on the device."""
        return [torch.as_tensor(np.ascontiguousarray(d)
                                if not isinstance(d, torch.Tensor) else d)
                .to(self._device) for d in batch]

    def train_batch(self, inputs, labels=None, sync=True):
        """One batch through the train step; returns [loss] as a float,
        or (sync=False) as an `_AsyncScalar` still on the device."""
        if self._prog is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        live_metrics = bool(self._metrics) and self._strategy is None
        self._adapter.keep_outs = live_metrics
        self._adapter.n_inputs = len(_as_list(inputs))
        loss = self._prog.step(*_as_list(inputs), *_as_list(labels),
                               lr=self._optimizer.get_lr())
        if live_metrics:
            self._update_metrics(self._adapter.outs,
                                 self._put(_as_list(labels)))
            self._adapter.outs = None
        return [float(_AsyncScalar(loss))] if sync else [_AsyncScalar(loss)]

    def _eval_amp(self):
        s = self._strategy
        return amp_mod.auto_cast(
            enable=s is not None and bool(s.amp),
            level="O2" if s is not None and s.amp_configs.use_pure_bf16
            else "O1", dtype="bfloat16")

    def eval_batch(self, inputs, labels=None):
        """[loss] of a batch in eval mode, with no gradient (no loss when
        there is neither a strategy nor a loss function with labels, as
        in the JAX package); updates the metrics."""
        self.network.eval()
        inputs, labels = self._put(_as_list(inputs)), \
            self._put(_as_list(labels))
        with torch.no_grad(), self._eval_amp():
            outs = self.network(*inputs)
            loss = None
            if self._strategy is not None or (self._loss is not None
                                              and labels):
                loss = _compute_loss(self._loss, outs, labels)
        self._update_metrics(outs, labels)
        return [float(loss.float().item())] if loss is not None else []

    def predict_batch(self, inputs):
        """The network's outputs on a batch, in eval mode and fp32, as
        host numpy arrays."""
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*self._put(_as_list(inputs)))
        return [to_numpy(o) for o in _as_list(outs)]

    def _update_metrics(self, outs, labels):
        if not self._metrics:
            return
        pred = _as_list(outs)[0]
        for m in self._metrics:
            res = _as_list(m.compute(pred, *labels))
            m.update(*[to_numpy(r) if isinstance(r, torch.Tensor) else r
                       for r in res])

    # ------------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, drop_last=False,
                     num_workers=0):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _split_batch(self, batch, has_labels=True):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        n_in = self._n_inputs(len(batch))
        return batch[:n_in], (batch[n_in:] if has_labels else [])

    @staticmethod
    def _metric_items(m):
        """Metric.name() / accumulate() may be scalars or lists (Accuracy
        with several topk)."""
        names, vals = m.name(), m.accumulate()
        names = names if isinstance(names, (list, tuple)) else [names]
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        return list(zip(names, vals))

    def _step_logs(self, losses, step, batch_size):
        logs = {"loss": losses[0] if losses else 0.0, "step": step,
                "batch_size": batch_size}
        # the strategy step returns only the loss: its metrics never
        # update during fit, so they are not reported there
        if self._strategy is None:
            for m in self._metrics:
                logs.update(self._metric_items(m))
        return logs

    def _reset_metrics(self):
        for m in self._metrics:
            m.reset()

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for `epochs` over `train_data` (a Dataset or DataLoader),
        calling the callbacks' `on_train_batch_end(step, logs)` with
        logs["loss"] an `_AsyncScalar`."""
        if self._prog is None:
            raise RuntimeError("call prepare(optimizer, loss) first")
        loader = self._make_loader(train_data, batch_size, shuffle, drop_last,
                                   num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False)
        n_acc = max(int(accumulate_grad_batches), 1)
        if n_acc != self._prog.accumulate_steps:
            self._prog.accumulate_steps, self._prog._micro = n_acc, 0
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names += list(n) if isinstance(n, (list, tuple)) else [n]
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=len(loader), log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir, metrics=names)
        cbks.on_begin("train")
        self.stop_training = False
        logs, global_step = {}, 0
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            self._reset_metrics()
            for step, batch in enumerate(loader):
                cbks.on_batch_begin("train", step, logs)
                ins, lbls = self._split_batch(batch)
                losses = self.train_batch(ins, lbls, sync=False)
                logs = self._step_logs(losses, step, batch_size)
                cbks.on_batch_end("train", step, logs)
                global_step += 1
                if num_iters is not None and global_step >= num_iters:
                    self.stop_training = True
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0,
                                          _inside_fit=cbks)
                logs.update({"eval_" + k: v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _inside_fit=None):
        """{"loss": mean batch loss, metric: value, ...} over `eval_data`."""
        loader = self._make_loader(eval_data, batch_size, False,
                                   num_workers=num_workers)
        self._reset_metrics()
        losses_sum, n = 0.0, 0
        cbks = _inside_fit
        if cbks is None and (callbacks or verbose):
            cbks = cbks_mod.config_callbacks(
                callbacks, model=self, verbose=verbose, log_freq=log_freq,
                steps=len(loader), mode="eval")
        if cbks:
            cbks.on_begin("eval")
        for batch in loader:
            ins, lbls = self._split_batch(batch)
            losses = self.eval_batch(ins, lbls)
            if losses:
                losses_sum += losses[0]
                n += 1
        logs = {}
        if n:
            logs["loss"] = losses_sum / n
        for m in self._metrics:
            logs.update(self._metric_items(m))
        if cbks:
            cbks.on_end("eval", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """Per output, the list of its batches (numpy), or with
        `stack_outputs` one array concatenated over the batches."""
        loader = self._make_loader(test_data, batch_size, False,
                                   num_workers=num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_labels=False)
            outputs.append(self.predict_batch(ins))
        n_out = len(outputs[0]) if outputs else 0
        per_out = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            per_out = [np.concatenate(o, axis=0) for o in per_out]
        return per_out

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """``{path}.pdparams`` and, with an optimizer, ``{path}.pdopt``."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False): the inference export is not "
                "ported to paddle_tpu_torch")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fsave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            opt_sd = {"LR_Scheduler": self._optimizer._scheduler_state(),
                      "functional_state": stacked_layout(
                          self._optimizer.functional_state(
                              self.network.named_parameters()),
                          self.network)}
            with open(path + ".pdopt", "wb") as f:
                pickle.dump(opt_sd, f, protocol=4)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``{path}.pdparams`` into the network (a shape mismatch
        raises, or with `skip_mismatch` is left out with a warning) and,
        unless `reset_optimizer`, ``{path}.pdopt`` into the optimizer.
        Tensors go to the device of the network's parameters."""
        first = next(iter(self.network.parameters()), None)
        device = first.device if first is not None else get_device()
        sd = fload(path + ".pdparams", device=device)
        if skip_mismatch:
            own = self.network.state_dict()
            bad = sorted(k for k, v in sd.items()
                         if k in own and tuple(v.shape) != tuple(own[k].shape))
            if bad:
                warnings.warn(f"Model.load: skipping mismatched {bad}")
            sd = {k: v for k, v in sd.items() if k not in bad}
        self.network.set_state_dict(sd)
        if self._prog is not None:
            self._prog._micro = 0
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt_sd = fload(path + ".pdopt", return_numpy=True)
            fs = opt_sd.pop("functional_state", None)
            if fs:
                self._optimizer.set_functional_state(
                    self.network.named_parameters(),
                    indexed_layout(fs, self.network))
            self._optimizer.set_state_dict(opt_sd)
        return self

    def parameters(self, *args, **kwargs) -> List:
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        raise NotImplementedError("Model.summary is not ported to "
                                  "paddle_tpu_torch")
