"""hapi callbacks (port of paddle_tpu's `hapi/callbacks.py`: Callback,
CallbackList, config_callbacks, ProgBarLogger, ModelCheckpoint,
LRScheduler, EarlyStopping, MetricsLogger, VisualDL). `config_callbacks`
adds a ModelCheckpoint when `save_dir` is set and an LRScheduler callback
always, as the JAX package's does."""
from __future__ import annotations

import json
import numbers
import os
import sys
import time
from typing import List, Optional


__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "MetricsLogger", "VisualDL",
           "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin")(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end")(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end")(step, logs)

    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    for cb in cbks:
        cb.set_model(model)
        cb.set_params({"batch_size": batch_size, "epochs": epochs,
                       "steps": steps, "verbose": verbose,
                       "save_dir": save_dir, "metrics": metrics or ["loss"]})
    return CallbackList(cbks)


class ProgBarLogger(Callback):
    """Console progress; formatting a log reads the loss off the device."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._step = 0
        self._t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        parts = []
        for k in self.params.get("metrics", []):
            if k in (logs or {}):
                v = logs[k]
                parts.append(f"{k}: {float(v):.4f}" if isinstance(
                    v, numbers.Number) or hasattr(v, "_t") else f"{k}: {v}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self.verbose == 2 and self._step % self.log_freq == 0:
            print(f"step {self._step}/{self.params.get('steps') or '?'} - "
                  f"{self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"epoch {epoch + 1} done ({time.time() - self._t0:.1f}s) "
                  f"- {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print("Eval - " + " - ".join(
                f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                if isinstance(v, numbers.Number)))


class ModelCheckpoint(Callback):
    """Periodic checkpointing with an atomic publish and retention.

    Each save goes to a ``.tmp`` prefix through `Model.save` and is
    published by rename, ``.pdopt`` first and ``.pdparams`` last, so the
    params file (the one `Model.load` requires) appears only once its
    optimizer twin is in place. Epoch checkpoints are ``{epoch}``, the
    last one ``final``; `keep_last=k` prunes older epoch checkpoints
    ('final' and 'best_model' are never pruned)."""

    def __init__(self, save_freq=1, save_dir=None, keep_last=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.keep_last = keep_last

    def _atomic_save(self, path):
        tmp = path + ".tmp"
        self.model.save(tmp)
        for ext in (".pdopt", ".pdparams"):      # params LAST: the commit
            if os.path.exists(tmp + ext):
                os.replace(tmp + ext, path + ext)

    def _gc(self):
        if not self.keep_last or not os.path.isdir(self.save_dir):
            return
        epochs = sorted({int(f.split(".")[0])
                         for f in os.listdir(self.save_dir)
                         if f.split(".")[0].isdigit()
                         and f.endswith((".pdparams", ".pdopt"))})
        for e in epochs[:-self.keep_last]:
            for ext in (".pdparams", ".pdopt"):
                p = os.path.join(self.save_dir, f"{e}{ext}")
                if os.path.exists(p):
                    os.unlink(p)

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and (epoch + 1) % self.save_freq == 0:
            self._atomic_save(os.path.join(self.save_dir, f"{epoch}"))
            self._gc()

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self._atomic_save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler, once per epoch by default
    (by_epoch=True, the reference's default) or after every train batch
    (by_step=True). The scheduler runs on the host: no device sync."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch and not by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stop fit when the monitored value (the eval one when there is one)
    has not improved for `patience` epochs; with `save_best_model` and a
    fit `save_dir`, save the best as ``best_model``."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and ("acc" in monitor
                                                 or "auc" in monitor)):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = -float("inf")
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = float("inf")
        self.wait = 0

    def on_train_begin(self, logs=None):
        self.save_dir = self.params.get("save_dir")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get("eval_" + self.monitor, logs.get(self.monitor))
        if cur is None:
            return
        cur = float(cur)                  # a train loss still on the device
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.model is not None and \
                    getattr(self, "save_dir", None):
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait > self.patience:
                if self.model is not None:
                    self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}: "
                          f"best {self.monitor}={self.best:.4f}")


class MetricsLogger(Callback):
    """Periodic machine-readable training telemetry, in the JAX package's
    format.

    Every ``log_freq`` train batches (and at each epoch end) one JSON line
    goes to ``path`` (appended; default stderr, prefixed
    ``TRAIN_METRICS``): the monotonic time, event, epoch and step, steps/s
    over the window and the numeric entries of ``logs`` (the loss, read
    off the device here, and the metrics). With `hbm` and a model on a
    CUDA device, ``hbm_bytes_in_use`` maps every visible card
    (``"cuda:0"``, ...) to its allocated bytes (`core.monitor`, as in the
    JAX package); on the CPU there is nothing to report and the key is
    left out, as the JAX package leaves it out for a backend that reports
    nothing. The port has no async step pipeline, so the keys the JAX
    package takes from ``model._async_pipeline.stats()``
    (``steps_in_flight``, ``host_blocked_s``, ``steps_submitted``,
    ``window``) are not written."""

    def __init__(self, log_freq: int = 50, path: Optional[str] = None,
                 hbm: bool = True):
        super().__init__()
        self.log_freq = max(int(log_freq), 1)
        self.path = path
        self.hbm = hbm
        self._f = None
        self._step = 0
        self._epoch = 0
        self._win_t0 = None
        self._win_step0 = 0

    def _emit(self, payload: dict):
        line = json.dumps(payload)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()
        else:
            print("TRAIN_METRICS " + line, file=sys.stderr, flush=True)

    def on_train_begin(self, logs=None):
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._step = 0
        self._win_t0 = time.monotonic()
        self._win_step0 = 0
        self._epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def _hbm(self):
        dev = getattr(self.model, "_device", None)
        if dev is None or dev.type != "cuda":
            return {}
        from ..core import monitor
        return {d: st["bytes_in_use"]
                for d, st in monitor.all_device_memory_stats().items()
                if st.get("bytes_in_use") is not None}

    def _payload(self, logs, event):
        now = time.monotonic()
        dt = now - (self._win_t0 or now)
        steps = self._step - self._win_step0
        payload = {k: float(v) for k, v in (logs or {}).items()
                   if isinstance(v, numbers.Number)}
        # the structural fields win over log entries of the same name
        # (hapi's "step" is the index within the epoch)
        payload.update(
            ts_monotonic=round(now, 3),
            event=event,
            epoch=self._epoch,
            step=self._step,
            steps_per_s=round(steps / dt, 3) if dt > 0 and steps else 0.0)
        if self.hbm:
            hbm = self._hbm()
            if hbm:
                payload["hbm_bytes_in_use"] = hbm
        self._win_t0 = now
        self._win_step0 = self._step
        return payload

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % self.log_freq == 0:
            self._emit(self._payload(logs, "step"))

    def on_epoch_end(self, epoch, logs=None):
        self._emit(self._payload(logs, "epoch_end"))

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


class VisualDL(Callback):
    """Scalar logger writing ``{log_dir}/scalars.tsv`` (appended): a
    ``# run <time>`` line per fit, then ``step<TAB>name<TAB>value`` for
    every numeric log entry of every train batch (the loss is read off
    the device for it), flushed each batch; the JAX package's format."""

    def __init__(self, log_dir="vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._step = 0

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "scalars.tsv"), "a")
        self._f.write(f"# run {time.strftime('%Y-%m-%dT%H:%M:%S')}\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._f.write(f"{self._step}\t{k}\t{v}\n")
        self._f.flush()

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None
