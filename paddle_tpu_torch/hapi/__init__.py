"""paddle.hapi for the training slice: `Model`, `callbacks`, and the
model `summary` and `flops`."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler, MetricsLogger,
                        ModelCheckpoint, ProgBarLogger, VisualDL)
from .model import Model
from .summary import flops, summary

__all__ = ["Model", "summary", "flops", "callbacks", "Callback",
           "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "MetricsLogger", "VisualDL"]
