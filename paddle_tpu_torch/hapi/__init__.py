"""paddle.hapi for the training slice: `Model` and `callbacks`."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
