"""paddle.optimizer for the training slice: `Adam`."""
from .optimizer import Optimizer
from .optimizers import Adam

__all__ = ["Optimizer", "Adam"]
