"""Gradient clipping on lists of gradient tensors (counterpart of the
``apply_arrays`` rules of ``paddle_tpu/nn/clip.py``).

Norms are taken in fp32 whatever the gradients' dtype, and each clipped
gradient is cast back to its own dtype, as the reference does. The eager
``(param, grad)`` form of the reference waits for the eager API (ROADMAP
Queue A item 14).

Tensor parallel: ``apply_arrays(grads, group=, sharded=)`` takes one
rank's gradients, ``sharded[i]`` saying whether gradient i is this rank's
shard of a leaf (else a replicated leaf whose gradient every rank holds
alike, already summed over the group). A norm then counts every shard
once, summing their squares over the group, and every replicated leaf
once, as the reference's GSPMD norm over the global leaves does.
Pipeline parallel: ``apply_arrays(grads, group=)`` with ``sharded=None``
takes one stage's gradients, each rank holding whole leaves no other rank
holds; the global norm sums every rank's squares once (one all-reduce of
a scalar), a per-leaf norm needs none.
"""
from __future__ import annotations

import torch


def _sq_norm(g):
    return g.float().square().sum()


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _sq_norms(grads, group, sharded):
    """fp32 [len(grads)] squared norms; with a group, each sharded leaf's
    summed over the ranks (one all-reduce)."""
    sq = torch.stack([_sq_norm(g) for g in grads])
    if group is not None and sharded is not None:
        mask = torch.tensor(sharded, device=sq.device)
        part = group.all_reduce_(torch.where(mask, sq, 0.0))
        sq = torch.where(mask, part, sq)
    return sq


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_arrays(self, grads, group=None, sharded=None):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm:
    """Each gradient scaled to norm at most ``clip_norm`` on its own."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_arrays(self, grads, group=None, sharded=None):
        norms = torch.sqrt(_sq_norms(grads, group, sharded)) \
            if group is not None else [torch.sqrt(_sq_norm(g))
                                       for g in grads]
        out = []
        for g, norm in zip(grads, norms):
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append(_scaled(g, scale))
        return out


class ClipGradByGlobalNorm:
    """All gradients scaled by ``min(clip_norm / max(norm, 1e-12), 1)``,
    norm the fp32 global norm over every gradient."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_arrays(self, grads, group=None, sharded=None):
        if group is None:
            norm = torch.sqrt(sum(_sq_norm(g) for g in grads))
        elif sharded is None:        # whole leaves, each on one rank
            norm = torch.sqrt(group.all_reduce_(
                sum(_sq_norm(g) for g in grads)))
        else:
            norm = torch.sqrt(_sq_norms(grads, group, sharded).sum())
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [_scaled(g, scale) for g in grads]
