"""Mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``):
``decorate``. At ``level="O2"`` every floating parameter of the models is
cast to the amp dtype in place (the same ``Parameter`` objects, so a step
built afterwards sees them), and each optimizer keeps fp32 masters of
them (``multi_precision``, unless ``master_weight`` says otherwise), as
the reference's ``decorate`` (amp/__init__.py:40-59). O1 leaves both as
they are, as the reference's does. ``auto_cast`` and ``GradScaler`` are
not ported yet (ROADMAP Queue A item 14).
"""
from __future__ import annotations

import torch

__all__ = ["decorate"]


def _dtype(name):
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"unknown amp dtype {name!r}")
    return dtype


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Returns ``models`` (and ``optimizers`` when given) as passed, after
    the O2 casts."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be O1 or O2, got {level!r}")
    if level == "O2":
        d = _dtype(dtype)
        with torch.no_grad():
            for m in _as_list(models):
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(d)
        if optimizers is not None:
            for o in _as_list(optimizers):
                o._multi_precision = (True if master_weight is None
                                      else bool(master_weight))
    if optimizers is None:
        return models
    return models, optimizers
