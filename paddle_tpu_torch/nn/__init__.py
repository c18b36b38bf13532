"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
