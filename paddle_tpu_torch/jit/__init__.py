"""The eager training step (counterpart of ``paddle_tpu/jit``):
``TrainStep`` and ``to_tensor``."""
from ..tensor import to_tensor
from .train_step import TrainStep

__all__ = ["TrainStep", "to_tensor"]
