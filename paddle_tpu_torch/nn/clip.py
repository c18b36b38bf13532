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
Pipeline parallel: ``apply_arrays(grads, stage_group=)`` takes one
stage's gradients, each rank holding whole leaves no other stage holds;
the global norm sums every stage's squares once (one all-reduce of a
scalar), a per-leaf norm needs none. Data parallel under ZeRO-1:
``apply_arrays(grads, dp_group=)`` takes this replica's flat shards of
the reduced gradients (``distributed/grad_comm.py``), each leaf's shards
disjoint over the replicas: its squares sum over them. Without ZeRO the
dp replicas hold the same reduced gradients, counted once (no dp group).
The three compose: every element of the model is counted once, over
leaves split by mp and by pp stage and replicated or sharded over dp.
"""
from __future__ import annotations

import torch


def _sq_norm(g):
    return g.float().square().sum()


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _sq_norms(grads, group, sharded, dp_group=None):
    """fp32 [len(grads)] squared norms of whole leaves: each sharded leaf's
    summed over ``group`` (one all-reduce), then, for dp shards, every
    leaf's over ``dp_group`` (one more)."""
    sq = torch.stack([_sq_norm(g) for g in grads])
    if group is not None and sharded is not None:
        mask = torch.tensor(sharded, device=sq.device)
        part = group.all_reduce_(torch.where(mask, sq, 0.0))
        sq = torch.where(mask, part, sq)
    if dp_group is not None:
        sq = dp_group.all_reduce_(sq)
    return sq


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_arrays(self, grads, group=None, sharded=None,
                     stage_group=None, dp_group=None):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm:
    """Each gradient scaled to norm at most ``clip_norm`` on its own."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_arrays(self, grads, group=None, sharded=None,
                     stage_group=None, dp_group=None):
        split = sharded is not None or dp_group is not None
        norms = torch.sqrt(_sq_norms(grads, group, sharded, dp_group)) \
            if split else [torch.sqrt(_sq_norm(g)) for g in grads]
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

    def apply_arrays(self, grads, group=None, sharded=None,
                     stage_group=None, dp_group=None):
        if sharded is None and dp_group is None:      # whole leaves
            total = sum(_sq_norm(g) for g in grads)
        else:
            total = _sq_norms(grads, group, sharded, dp_group).sum()
        if stage_group is not None:
            total = stage_group.all_reduce_(total)
        norm = torch.sqrt(total)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return [_scaled(g, scale) for g in grads]
