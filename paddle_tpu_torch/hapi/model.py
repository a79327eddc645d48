"""hapi.Model, training side (port of paddle_tpu's `hapi/model.py`:
`prepare`, `fit`, `train_batch`, `parameters`, `_make_loader`).

`prepare(optimizer, strategy=)` builds the single-device train step of
`distributed.fleet.compiler` on the default device (`set_device`; cuda,
which raises without a GPU) and moves the network there. `fit` loops over
epochs and batches; each step's loss stays on the device inside an
`_AsyncScalar` until something reads it with `float()` (the closing read
of a timed epoch is its one host sync), as in the JAX package.
`evaluate`, `predict`, metrics, the async step pipeline, checkpointing and
gradient accumulation wait for a later slice and raise.
"""
from __future__ import annotations

from typing import List

from ..core.device import get_device
from ..distributed.fleet.compiler import compile_train_step
from ..distributed.fleet.strategy import DistributedStrategy
from ..io.dataloader import DataLoader
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


class _LossAdapter:
    """The network plus the optional loss as a layer with a `loss(*batch)`
    method: the first `n_inputs` batch items feed the network, the rest
    are labels for the loss (with no loss, the network's first output is
    the loss)."""

    def __init__(self, network, loss, n_inputs):
        self.network, self._loss, self._n = network, loss, n_inputs

    def train(self):
        self.network.train()

    def loss(self, *batch):
        outs = self.network(*batch[:self._n])
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        if self._loss is None:
            return outs[0]
        return self._loss(*outs, *batch[self._n:])


class Model:
    """Wraps a Layer with a training loop."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._prog = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, strategy=None):
        """Build the train step. `strategy` (default: a plain
        `DistributedStrategy`) selects AMP; toggles the port does not run
        raise `NotImplementedError` here."""
        if metrics:
            raise NotImplementedError("hapi metrics are not ported to "
                                      "paddle_tpu_torch")
        if amp_configs is not None:
            raise NotImplementedError("Model.prepare(amp_configs=) is not "
                                      "ported; set strategy.amp (and "
                                      "amp_configs.use_pure_bf16 for O2)")
        if optimizer is None:
            raise ValueError("Model.prepare: an optimizer is needed to train")
        device = get_device()
        self.network.to(device)
        self._optimizer = optimizer
        self._loss = loss
        self._strategy = strategy if strategy is not None \
            else DistributedStrategy()
        n_in = len(_as_list(self._inputs)) if self._inputs is not None \
            else None
        self._n_inputs = n_in
        adapter = _LossAdapter(self.network, loss, n_in)
        self._prog = compile_train_step(adapter, optimizer, self._strategy,
                                        device=device)

    def train_batch(self, inputs, labels=None, sync=True):
        """One optimizer step on a batch; returns [loss] as a float, or
        (sync=False) as an `_AsyncScalar` still on the device."""
        if self._prog is None:
            raise RuntimeError("call prepare(optimizer, ...) first")
        loss = self._prog.step(*_as_list(inputs), *_as_list(labels),
                               lr=self._optimizer.get_lr())
        return [float(_AsyncScalar(loss))] if sync else [_AsyncScalar(loss)]

    def _make_loader(self, data, batch_size, shuffle, drop_last=False,
                     num_workers=0):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _split_batch(self, batch):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if self._n_inputs is not None:
            return batch[:self._n_inputs], batch[self._n_inputs:]
        # no input spec: (x, y) convention, the last item is the label
        return (batch[:-1], batch[-1:]) if len(batch) > 1 else (batch, [])

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train for `epochs` over `train_data` (a Dataset or DataLoader),
        calling the callbacks' `on_train_batch_end(step, logs)` with
        logs["loss"] an `_AsyncScalar`."""
        if eval_data is not None or save_dir is not None \
                or accumulate_grad_batches != 1:
            raise NotImplementedError(
                "Model.fit: eval_data, save_dir and accumulate_grad_batches "
                "are not ported to paddle_tpu_torch")
        loader = self._make_loader(train_data, batch_size, shuffle, drop_last,
                                   num_workers)
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=len(loader),
            log_freq=log_freq, verbose=verbose, metrics=["loss"])
        cbks.on_begin("train")
        self.stop_training = False
        logs, global_step = {}, 0
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for step, batch in enumerate(loader):
                cbks.on_batch_begin("train", step, logs)
                ins, lbls = self._split_batch(batch)
                losses = self.train_batch(ins, lbls, sync=False)
                logs = {"loss": losses[0], "step": step,
                        "batch_size": batch_size}
                cbks.on_batch_end("train", step, logs)
                global_step += 1
                if num_iters is not None and global_step >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, logs)
        cbks.on_end("train", logs)
        return self

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError("Model.evaluate is not ported to "
                                  "paddle_tpu_torch yet")

    def predict(self, *args, **kwargs):
        raise NotImplementedError("Model.predict is not ported to "
                                  "paddle_tpu_torch yet")

    def parameters(self, *args, **kwargs) -> List:
        return self.network.parameters(*args, **kwargs)
