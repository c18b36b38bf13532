"""Gradient clipping, the eager layers, the transformer layers, the
initializers and the functionals they use (counterpart of
``paddle_tpu/nn``)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer import ParamAttr
from .layer import (Dropout, Embedding, LayerNorm, Linear, MSELoss, ReLU,
                    Sequential)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear", "MSELoss",
           "MultiHeadAttention", "ParamAttr", "ReLU", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", "functional",
           "initializer"]
