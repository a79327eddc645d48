"""paddle.nn for the training slice: `Layer` and the layers GPT and BERT
are built from (the transformer layers among them), `functional`,
`initializer`, and the gradient clips."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, Layer, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, Transformer, TransformerDecoder,
                    TransformerDecoderLayer, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer", "functional", "initializer",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
