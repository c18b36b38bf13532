"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout module for module
(``paddle_tpu_torch/serving/engine.py`` is the counterpart of
``paddle_tpu/serving/engine.py``). It imports torch and numpy only: the
JAX package is the reference the tests hold it against, never a
dependency. Plain tensor code is PyTorch; every Pallas kernel of the
reference becomes a kernel written by hand for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound with ctypes.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises instead of
falling back to the CPU.
"""
from .device import resolve_device
from .tensor import to_tensor

__all__ = ["resolve_device", "to_tensor"]
