"""paddle.nn for the training slice: `Layer` and the layers GPT and BERT
are built from (the transformer layers among them), the vision layers
LeNet and ResNet are built from (conv, pooling, batch norm, ReLU,
Sequential, Flatten, CrossEntropyLoss), `functional`, `initializer`, and
the gradient clips."""
from ..core.tensor import Parameter
from ..framework import ParamAttr
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm2D,
                    Conv2D, CrossEntropyLoss, Dropout, Embedding, Flatten,
                    Layer, LayerList, LayerNorm, Linear, MaxPool2D,
                    MultiHeadAttention, ReLU, Sequential, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "functional", "initializer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "ParamAttr", "Parameter", "Conv2D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "BatchNorm", "BatchNorm2D",
           "CrossEntropyLoss", "ReLU", "Sequential", "Flatten"]
