from .common import Dropout, Embedding, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
