"""paddle.optimizer: `SGD`, `Momentum`, `Adam`, `AdamW`, `Lamb`, `Lars`,
`RMSProp`, `Adagrad`, `Adadelta`, `Adamax` and the LR schedulers of
`optimizer.lr`."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Lars, Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb", "Lars",
           "RMSProp", "Adagrad", "Adadelta", "Adamax", "lr"]
