"""hapi callbacks for the training slice (port of paddle_tpu's
`hapi/callbacks.py`: Callback, CallbackList, config_callbacks,
ProgBarLogger). Checkpointing and LR-scheduler callbacks are not ported."""
from __future__ import annotations

import numbers
import time
from typing import List

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "config_callbacks"]


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
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass


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


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, metrics=None):
    cbks = list(callbacks) if callbacks else []
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    for cb in cbks:
        cb.set_model(model)
        cb.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                       "metrics": metrics or ["loss"]})
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
                v = float(v) if not isinstance(v, numbers.Number) else v
                parts.append(f"{k}: {v:.4f}")
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
