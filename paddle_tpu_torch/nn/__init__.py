"""Gradient clipping, the eager layers, the transformer encoder, the
initializers and the functionals they use (counterpart of
``paddle_tpu/nn``)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer import ParamAttr
from .layer import (Dropout, Embedding, LayerNorm, Linear, MSELoss, ReLU,
                    Sequential)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear", "MSELoss",
           "MultiHeadAttention", "ParamAttr", "ReLU", "Sequential",
           "TransformerEncoder", "TransformerEncoderLayer", "functional",
           "initializer"]
