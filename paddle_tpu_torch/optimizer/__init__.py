"""paddle.optimizer for the training slices: `Momentum` and `Adam`."""
from .optimizer import Optimizer
from .optimizers import Adam, Momentum

__all__ = ["Optimizer", "Momentum", "Adam"]
