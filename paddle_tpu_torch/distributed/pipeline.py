"""Pipeline parallelism over a group of stages (counterpart of
``paddle_tpu/distributed/pipeline.py``: the explicit schedules
``pipeline_ring_gpipe`` :431, ``pipeline_ring_1f1b`` :491 and
``run_pipeline`` :598, and the pp ledger :713-812).

The reference runs its schedules as a ``lax.scan`` over ticks inside a
full-manual ``shard_map``, one program for every stage, and lets JAX
differentiate (GPipe) or writes the backward by hand (1F1B). The port is
SPMD in PyTorch's idiom: one process per stage, joined by an ``MPGroup``
(``distributed/env.py``; rank = stage), each running the same tick loop on
its own blocks. A boundary hop is a point-to-point send to the next or
the previous stage (``MPGroup.stage_hops_async``), posted at the end of a
tick, with no wrap-around: the reference's ring sends the last stage's
output back to stage 0, which ignores it.

Two rules keep the stages in step:

* autograd never orders a hop. A step's M microbatches are independent
  branches of the autograd graph, and the engine's order for them is not
  the tick order, so the same shapes would pair with the wrong
  microbatch. The schedule is one ``torch.autograd.Function`` whose
  backward is an explicit tick loop calling ``torch.autograd.grad`` per
  microbatch, in the reference's tick order, with the hops between;
* no hop runs inside ``torch.utils.checkpoint``: a recompute would post
  it again on one stage only, and the ring would hang. Only blocks (or a
  block's prelude) are checkpointed.

Schedules, at S stages and M microbatches (stage s, tick t):

* GPipe: T = M + S - 1 forward ticks; stage s runs its blocks on
  microbatch t - s and posts the output to s + 1. Every microbatch's
  graph is kept; the backward runs the ticks in reverse, cotangents
  hopping to s - 1.
* 1F1B: the forward is the GPipe stream without graphs; the backward is
  T = M + 2S - 2 combined ticks, each a forward sub-tick that recomputes
  the activation stream (microbatch t - s, its input stashed in one of
  K = 2S - 1 slots) and a backward sub-tick on microbatch
  t - 2(S - 1) + s that recomputes the stage from its stashed input and
  takes ``torch.autograd.grad``; both hops are posted at tick end, and the
  stage's gradients accumulate in the param dtype.

The fused rung (``backend="fused"``, GPipe) hands each sending stage's
last block to ``boundary`` (``models/gpt.py:gpt_fused_boundary``), whose
kernel wrapper posts the forward hop and whose backward receives the
reverse one; the tick loop then posts neither.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from .recompute import remat

SCHEDULES = ("gpipe", "1f1b")


class _Plan:
    """What one ``run_pipeline`` call runs: its blocks, group and shapes."""

    def __init__(self, block_fn, keys, group, M, schedule, wire, boundary,
                 remat_policy):
        self.block_fn, self.keys, self.group = block_fn, keys, group
        self.M, self.schedule = M, schedule
        self.wire, self.boundary = wire, boundary
        self.grad_block = block_fn if remat_policy is None else \
            remat(block_fn, remat_policy)
        self.S, self.s = group.n, group.rank
        self.keep_graphs = torch.is_grad_enabled()   # else: forward only

    def stage(self, leaves, h, post, block):
        """This stage's blocks over h (the last one through ``boundary``
        on a sending stage of the fused rung)."""
        per_layer = {k: v.unbind(0) for k, v in zip(self.keys, leaves)}
        L = len(per_layer[self.keys[0]])
        fused = self.boundary is not None and self.s < self.S - 1
        for layer in range(L):
            p = {k: v[layer] for k, v in per_layer.items()}
            if fused and layer == L - 1:
                h = self.boundary(p, h, post)
            else:
                h = block(p, h)
        return h


def _accumulate(acc, grads):
    return [g if a is None else a + g for a, g in zip(acc, grads)]


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: ``forward`` runs the forward
    ticks, ``backward`` the backward ticks (see the module's note)."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        S, s, M = plan.S, plan.s, plan.M
        mb = x.shape[0] // M
        xs = x.detach()
        ctx.plan, ctx.dtype = plan, x.dtype
        ctx.spec = ((mb,) + tuple(x.shape[1:]), plan.wire or x.dtype)
        ctx.mb = mb
        gpipe = plan.schedule == "gpipe" and plan.keep_graphs
        if gpipe:                    # every microbatch's graph is kept
            ctx.pleaves = [t.detach().requires_grad_(True) for t in leaves]
            use = ctx.pleaves
        else:                        # 1F1B keeps the stage's input only
            ctx.leaves = leaves
            ctx.xs = xs if s == 0 else None
            use = leaves
        graphs, outs, pending = {}, [], []
        hop = plan.group.stage_hops_async()
        with torch.set_grad_enabled(gpipe):
            for t in range(M + S - 1):
                got, _ = hop.wait()
                m = t - s
                out = None
                if 0 <= m < M:
                    inp = xs[m * mb:(m + 1) * mb] if s == 0 else \
                        got.to(x.dtype)
                    if gpipe:
                        inp = inp.detach().requires_grad_(True)
                    out = plan.stage(use, inp, pending.append,
                                     plan.block_fn)
                    if gpipe:
                        graphs[m] = (inp, out)
                    if s == S - 1:
                        outs.append(out.detach())
                send = None
                if out is not None and s < S - 1 and plan.boundary is None:
                    send = out.detach().to(ctx.spec[1])
                nxt = t + 1 - s
                hop = plan.group.stage_hops_async(
                    send_next=send,
                    recv_prev=ctx.spec if s > 0 and 0 <= nxt < M else None)
        hop.wait()
        for h in pending:
            h.wait()
        ctx.graphs = graphs
        if s == S - 1:
            return torch.cat(outs)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan.schedule == "gpipe":
            gx, pgrads = _gpipe_backward(ctx, g)
        else:
            gx, pgrads = _one_f_one_b_backward(ctx, g)
        ctx.graphs = ctx.pleaves = ctx.leaves = ctx.xs = None
        gx = torch.cat(gx) if plan.s == 0 and ctx.needs_input_grad[1] \
            else None
        return (None, gx, *pgrads)


def _gpipe_backward(ctx, g):
    """The GPipe forward's ticks in reverse: stage s takes microbatch t - s,
    its output's cotangent from the loss (last stage), from s + 1 (ring)
    or, on the fused rung, from the boundary op's own receive; posts its
    input's cotangent to s - 1."""
    plan, mb = ctx.plan, ctx.mb
    S, s, M = plan.S, plan.s, plan.M
    fused = plan.boundary is not None
    pgrads = [None] * len(ctx.pleaves)
    gx = [None] * M
    hop = plan.group.stage_hops_async()
    for t in reversed(range(M + S - 1)):
        _, got = hop.wait()
        m = t - s
        gi = None
        if 0 <= m < M:
            inp, out = ctx.graphs.pop(m)
            if s == S - 1:
                gout = g[m * mb:(m + 1) * mb]
            elif fused:             # the boundary's backward receives
                gout = torch.zeros_like(out)
            else:
                gout = got.to(out.dtype)
            grads = torch.autograd.grad(out, [inp] + ctx.pleaves, gout)
            gi = grads[0]
            pgrads = _accumulate(pgrads, grads[1:])
            gx[m] = gi
        nxt = t - 1 - s
        hop = plan.group.stage_hops_async(
            send_prev=gi.to(ctx.spec[1]) if gi is not None and s > 0
            else None,
            recv_next=ctx.spec if s < S - 1 and not fused and 0 <= nxt < M
            else None)
    hop.wait()
    return gx, pgrads


def _one_f_one_b_backward(ctx, g):
    """The reference's combined 1F1B backward ticks (pipeline.py:511-583)."""
    plan, mb = ctx.plan, ctx.mb
    S, s, M = plan.S, plan.s, plan.M
    dtype, wire = ctx.dtype, ctx.spec[1]
    K = 2 * S - 1
    stash = [None] * K
    pleaves = [t.detach().requires_grad_(True) for t in ctx.leaves]
    pgrads = [None] * len(pleaves)
    gx = [None] * M
    hop = plan.group.stage_hops_async()
    for t in range(M + 2 * S - 2):
        got_f, got_b = hop.wait()
        # forward sub-tick: the activation stream, recomputed
        fm = t - s
        out_f = None
        if 0 <= fm < M:
            inp = ctx.xs[fm * mb:(fm + 1) * mb] if s == 0 else got_f.to(dtype)
            if s < S - 1:           # the last stage's output goes nowhere
                with torch.no_grad():
                    out_f = plan.stage(ctx.leaves, inp, None, plan.block_fn)
            stash[fm % K] = inp
        # backward sub-tick: the stage again from its stashed input
        bm = t - 2 * (S - 1) + s
        gi = None
        if 0 <= bm < M:
            leaf = stash[bm % K].detach().requires_grad_(True)
            stash[bm % K] = None
            gout = (g[bm * mb:(bm + 1) * mb].to(wire) if s == S - 1
                    else got_b).to(dtype)
            with torch.enable_grad():
                out = plan.stage(pleaves, leaf, None, plan.grad_block)
                grads = torch.autograd.grad(out, [leaf] + pleaves, gout)
            gi = grads[0]
            pgrads = _accumulate(pgrads, grads[1:])
            gx[bm] = gi
        # both hops at tick end, for the next tick
        nf, nb = t + 1 - s, t + 1 - 2 * (S - 1) + s
        hop = plan.group.stage_hops_async(
            send_next=None if out_f is None else out_f.to(wire),
            send_prev=gi.to(wire) if gi is not None and s > 0 else None,
            recv_prev=ctx.spec if s > 0 and 0 <= nf < M else None,
            recv_next=ctx.spec if s < S - 1 and 0 <= nb < M else None)
    hop.wait()
    return gx, pgrads


def run_pipeline(block_fn, stage_params, x, num_microbatches, group,
                 schedule="gpipe", backend="ring", wire_dtype=None,
                 boundary=None, remat_policy=None, interleave=1):
    """Run this stage's blocks in the pipeline over ``group`` (rank =
    stage) and return the last stage's outputs.

    ``block_fn(layer_params, h) -> h`` is one block; ``stage_params`` this
    stage's stacked leaves ``{name: [L/S, ...]}``; ``x`` [B, ...] the
    activations entering the pipelined blocks, of which only stage 0's
    values are read (the others pass any tensor of that shape and dtype,
    e.g. an expanded zero). Returns [B, ...] on the last stage and an empty
    tensor elsewhere; every stage must differentiate its result (the
    empty one by ``.sum()``) for the backward ticks to run, and each gets
    its own leaves' gradients, stage 0 also x's.

    ``schedule`` "gpipe" or "1f1b"; ``backend`` "ring" or "fused" (GPipe
    only; ``boundary(last_layer_params, h, post) -> h`` then runs each
    sending stage's last block and owns its hops, e.g.
    ``models.gpt.gpt_fused_boundary``); ``wire_dtype`` the dtype of the
    ring rung's hops (None: x's). ``remat_policy`` (``distributed.
    recompute``) wraps the block in the 1F1B backward sub-tick, whose
    stage-input recompute is already the reference's "full" remat; with
    GPipe it raises (checkpoint the block itself: the hops stay outside).
    Virtual stages (``interleave > 1``) raise, as in the reference's
    explicit path."""
    if interleave > 1:
        raise ValueError("the explicit pp schedule does not interleave "
                         "virtual stages (comm_backend.resolve_pp gates "
                         "this)")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                         f"{schedule!r}")
    if backend not in ("ring", "fused"):
        raise ValueError(f"backend must be 'ring' or 'fused', got "
                         f"{backend!r}")
    if schedule == "gpipe" and remat_policy is not None:
        raise ValueError("remat_policy requires the 1f1b schedule (the "
                         "gpipe schedule keeps each microbatch's graph; "
                         "checkpoint the block itself)")
    if backend == "fused":
        if schedule != "gpipe":
            raise ValueError("the fused rung runs the gpipe schedule "
                             "(comm_backend.resolve_pp)")
        if boundary is None:
            raise ValueError("backend='fused' needs its boundary "
                             "(models.gpt.gpt_fused_boundary)")
    else:
        boundary = None
    M = int(num_microbatches)
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"microbatches {M}")
    keys = list(stage_params)
    plan = _Plan(block_fn, keys, group, M, schedule, wire_dtype, boundary,
                 remat_policy)
    return _Pipeline.apply(plan, x, *[stage_params[k] for k in keys])


# ---------------------------------------------------------------------------
# the pp ledger: one step's boundary traffic per stage, and the counters


@dataclass
class PpStepRecord:
    """The pp traffic of one executed step (forward and backward) on one
    stage. ``boundary_bytes`` are the bytes this stage sends over its
    boundary hops and ``ppermute_hops`` how many hops it posts (the
    reference counts a hop on every device at every tick, idle and wrap
    included). ``fused_dispatches``
    counts the boundary kernels' calls (rows 14 and 15; the reference's
    RDMA kernels also replace its hops, the port's post NCCL sends beside
    them). ``bubble_fraction`` is the schedule's idle-slot estimate, GPipe
    (S-1)/(M+S-1), 1F1B (2S-2)/(M+2S-2), not a measurement."""
    backend: str = "ring"
    schedule: str = "gpipe"
    stages: int = 1
    stage: int = 0
    microbatches: int = 1
    boundary_bytes: int = 0
    ppermute_hops: int = 0
    fused_dispatches: int = 0
    bubble_fraction: float = 0.0


def bubble_fraction(schedule, S, M):
    """Idle-slot fraction of the schedule at S stages, M microbatches."""
    if S <= 1:
        return 0.0
    if schedule == "1f1b":
        return (2 * S - 2) / (M + 2 * S - 2)
    return (S - 1) / (M + S - 1)


def stage_hops(schedule, S, s, M):
    """Hops stage s posts in one step: M activations down unless it is the
    last stage (twice under 1F1B: the primal stream and its recompute),
    and M cotangents up unless it is the first."""
    down = M if s < S - 1 else 0
    up = M if s > 0 else 0
    return (2 * down if schedule == "1f1b" else down) + up


def gpt_pp_step_record(config, ppc, batch, seq, num_microbatches, stage):
    """Ledger of one pipelined GPT step on ``stage`` under the resolved
    ``comm_backend.PpConfig``: one hop moves a microbatch's activation
    [batch / M, seq, H] at the wire dtype (the compute dtype unless
    ``ppc.wire_dtype``)."""
    S, M = int(ppc.n), int(num_microbatches)
    wire = ppc.wire_dtype or getattr(torch, config.compute_dtype or
                                     "float32")
    hop_bytes = (batch // M) * seq * config.hidden_size * wire.itemsize
    hops = stage_hops(ppc.schedule, S, stage, M)
    fused = ppc.backend == "fused" and stage < S - 1
    return PpStepRecord(
        backend=ppc.backend, schedule=ppc.schedule, stages=S, stage=stage,
        microbatches=M, boundary_bytes=hops * hop_bytes,
        ppermute_hops=hops, fused_dispatches=2 * M if fused else 0,
        bubble_fraction=bubble_fraction(ppc.schedule, S, M))


_pp_lock = threading.Lock()


def _zero_pp_counters():
    return {"steps": 0, "boundary_bytes": 0, "ppermute_hops": 0,
            "fused_dispatches": 0, "backend": {}, "schedule": "",
            "stages": 0, "stage": 0, "microbatches": 0,
            "bubble_fraction": 0.0}


_pp_counters = _zero_pp_counters()


def record_pp_step(rec: PpStepRecord | None):
    if rec is None:
        return
    with _pp_lock:
        _pp_counters["steps"] += 1
        _pp_counters["boundary_bytes"] += rec.boundary_bytes
        _pp_counters["ppermute_hops"] += rec.ppermute_hops
        _pp_counters["fused_dispatches"] += rec.fused_dispatches
        _pp_counters["backend"]["pp"] = rec.backend
        for k in ("schedule", "stages", "stage", "microbatches",
                  "bubble_fraction"):
            _pp_counters[k] = getattr(rec, k)


def pp_counters():
    with _pp_lock:
        out = dict(_pp_counters)
        out["backend"] = dict(out["backend"])
    return out


def reset_pp_counters():
    global _pp_counters
    with _pp_lock:
        _pp_counters = _zero_pp_counters()
