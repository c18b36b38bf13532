"""``to_tensor`` (counterpart of ``paddle_tpu.to_tensor``)."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def to_tensor(data, dtype=None, place=None):
    """``data`` (a tensor, an array or nested lists) as a tensor on
    ``place`` (None: the CUDA device, as every entry point), in ``dtype``
    (a torch dtype or its name) if given."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.array(data))
    return t.to(resolve_device(place), dtype)
