"""paddle.nn for the training slice: `Layer` and the layers GPT is built
from, `functional`, `initializer`, and the gradient clips."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "functional", "initializer", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue"]
