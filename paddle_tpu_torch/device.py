"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. The
CPU is used only when the caller names it: a silent CPU fallback would
turn every later timing into a CPU timing without anyone noticing.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch paths on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
