"""paddle.optimizer: `SGD`, `Momentum`, `Adam`, `AdamW` and the LR
schedulers of `optimizer.lr`."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
