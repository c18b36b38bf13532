"""Remat policies for the training step's blocks (counterpart of
``POLICIES`` in ``paddle_tpu/distributed/recompute.py``).

Each policy wraps a block function ``fn(p, x)``:

* ``"full"``: save nothing inside the block, recompute it in the backward
  (``torch.utils.checkpoint`` without re-entry) — the reference's default;
* ``"nothing"``: no checkpoint, autograd keeps every activation.

The selective presets ``"dots"``, ``"dots_no_batch"`` and ``"save_attn"``
keep chosen residuals in the reference; they are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

UNPORTED = ("dots", "dots_no_batch", "save_attn")


def _full(fn):
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def _nothing(fn):
    return fn


def _unported(name):
    def refuse(fn):
        raise NotImplementedError(
            f"remat_policy={name!r} is not ported yet (ROADMAP Queue A "
            f"item 5: selective-save presets); use 'full' or 'nothing'")
    return refuse


POLICIES = {"full": _full, "nothing": _nothing,
            **{name: _unported(name) for name in UNPORTED}}


def remat(fn, policy="full"):
    """``fn`` wrapped by the named policy (None means ``"full"``)."""
    name = policy or "full"
    if name not in POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; choose from "
                         f"{sorted(POLICIES)}")
    return POLICIES[name](fn)
