from .activation import ReLU
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .layers import Layer
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "Conv2D", "MaxPool2D",
           "AvgPool2D", "AdaptiveAvgPool2D", "BatchNorm", "BatchNorm2D",
           "CrossEntropyLoss", "ReLU", "Sequential", "Flatten"]
