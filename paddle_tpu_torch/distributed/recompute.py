"""Remat policies for the training step's blocks (counterpart of
``POLICIES`` in ``paddle_tpu/distributed/recompute.py``).

Each policy wraps a block function ``fn(*args)`` (a function or a
module):

* ``"full"``: save nothing inside the block, recompute it in the backward
  (``torch.utils.checkpoint`` without re-entry) — the reference's default;
* ``"nothing"``: no checkpoint, autograd keeps every activation;
* ``"dots_no_batch"``: ``jax.checkpoint_policies.
  checkpoint_dots_with_no_batch_dims``, which the eager GPT uses
  (reference models/gpt.py:174-178): a selective checkpoint that saves
  the outputs of the 2-D GEMMs (``aten.mm`` / ``aten.addmm``: a GPT
  block's qkv, out, up and down projections) and recomputes everything
  else, attention included.

Under both checkpointing policies the recompute draws what the forward
drew: ``torch.utils.checkpoint`` keeps only torch's default generators,
so ``_replaying_rng`` takes ``framework.random``'s generators' states
(hidden dropout's masks, attention dropout's Philox keys) before the
forward, puts them back for the recompute and then restores where the
run stood.

The presets ``"dots"`` and ``"save_attn"`` keep other residuals in the
reference; they are not ported yet and raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..framework import random

UNPORTED = ("dots", "save_attn")

# the ops whose outputs "dots_no_batch" saves: matrix products without
# batch dimensions (a batched product is aten.bmm and is recomputed)
NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _replaying_rng(fn):
    """``fn`` whose later calls (the recomputes) draw from
    ``framework.random`` what its first call (the forward) drew, leaving
    the generators where they stood before each recompute."""
    before = random.state_dict()
    ran = []

    def body(*args):
        if not ran:
            ran.append(True)
            return fn(*args)
        now = random.state_dict()
        random.set_state_dict(before)
        try:
            return fn(*args)
        finally:
            random.set_state_dict(now)
    return body


def _full(fn):
    def run(*args):
        return checkpoint(_replaying_rng(fn), *args, use_reentrant=False)
    return run


def _nothing(fn):
    return fn


def _no_batch_dots(ctx, op, *args, **kwargs):
    if op in NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_no_batch(fn):
    context = functools.partial(create_selective_checkpoint_contexts,
                                _no_batch_dots)

    def run(*args):
        return checkpoint(_replaying_rng(fn), *args, use_reentrant=False,
                          context_fn=context)
    return run


def _unported(name):
    def refuse(fn):
        raise NotImplementedError(
            f"remat_policy={name!r} is not ported yet (ROADMAP Queue A "
            f"item 5: selective-save presets); use 'full', "
            f"'dots_no_batch' or 'nothing'")
    return refuse


POLICIES = {"full": _full, "nothing": _nothing,
            "dots_no_batch": _dots_no_batch,
            **{name: _unported(name) for name in UNPORTED}}


def remat(fn, policy="full"):
    """``fn`` wrapped by the named policy (None means ``"full"``)."""
    name = policy or "full"
    if name not in POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; choose from "
                         f"{sorted(POLICIES)}")
    return POLICIES[name](fn)
