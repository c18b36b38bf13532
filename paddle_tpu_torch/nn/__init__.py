"""Gradient clipping, the eager layers and the functionals they use
(counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, LayerNorm, Linear, MSELoss, ReLU,
                    Sequential)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear", "MSELoss", "ReLU",
           "Sequential", "functional"]
