"""Tensor-parallel schedules (counterpart of
``paddle_tpu/distributed/tp_overlap.py``): the training half (:103-420,
:659-760) and the serving part (:196-219, :423-).

Training, sequence parallelism (Megatron-LM's, arXiv:2205.05198): the
activations between blocks live seq-sharded, [B, S/n, H] per rank; each
block's two all-reduces become an all-gather before each ColumnParallel
GEMM (qkv, up) and a reduce-scatter after each RowParallel GEMM (out,
down). The rungs move the same bytes three ways:

* ``"rsag"``: whole collectives (``seq_all_gather`` /
  ``seq_reduce_scatter``, each the other's backward: the transpose of an
  all-gather is a reduce-scatter that sums);
* ``"ring"``: the collectives decomposed into n - 1 ring hops beside
  each chunk's GEMM (``ring_ag_gemm`` / ``gemm_ring_rs``), in the
  compute dtype, differentiated through the hops (``RingShift``);
* ``"fused"``: the hand-written kernels of ``ops/ring_gemm.py`` through
  ``ops/fused_collectives.py``'s autograd functions.

``sp_block_fn`` is the block on one rank's shards (head-major qkv, nh/n
heads over the full sequence, the row-parallel biases added once after
the reduction); ``SP_BLOCK_PARAM_SPECS`` says which dim of each block
leaf is sharded; ``resolve_gpt`` decides the schedule and raises where
the reference steps down (the port never falls back from a rung);
``gpt_step_record`` is the per-rank wire ledger of one step, added to
``mp_counters()`` by ``record_step``.

The reference is single-controller under ``shard_map``; the port is SPMD
over ``distributed.env.MPGroup`` (one process per rank).

Serving:

* ``qkv_head_major_perm`` / ``to_qkv_head_major``: the column relabeling
  that makes a contiguous 1/n column shard of the qkv projection the q, k
  and v of exactly nh/n whole heads;
* ``ServingMPConfig`` / ``resolve_serving``: the serving engine's mp
  schedule (degree, rung, whether the LM head shards over the vocab);
* ``serving_step_record``: the bytes one dispatch moves and the
  collectives it issues (the engine adds it to the serving counters of
  ``serving/metrics.py`` per executed dispatch).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import comm_backend

TRAIN_BACKENDS = ("rsag", "ring", "fused")


def qkv_head_major_perm(H, nh):
    """Column permutation [3H] taking the logical [3, nh, d] qkv layout to
    head-major [nh, 3, d]: position (h, a, dd) <- logical column
    (a, h, dd)."""
    d = H // nh
    a, h, dd = np.meshgrid(np.arange(3), np.arange(nh), np.arange(d),
                           indexing="ij")
    logical = (a * H + h * d + dd).reshape(3, nh, d)
    return logical.transpose(1, 0, 2).reshape(-1)


def to_qkv_head_major(blocks, H, nh):
    """Stacked qkv_w [L, H, 3H] / qkv_b [L, 3H] permuted to head-major (a
    relabeling: the values are the same, in other columns)."""
    perm = torch.from_numpy(qkv_head_major_perm(H, nh))
    out = dict(blocks)
    for name in ("qkv_w", "qkv_b"):
        t = blocks[name]
        out[name] = t[..., perm.to(t.device)]
    return out


@dataclass(frozen=True)
class ServingMPConfig:
    """Static mp configuration of a serving engine. ``backend`` names the
    rung: 'gspmd' (one all-gather collective per gather), 'ring' (n - 1
    point-to-point hops) or 'fused' (the hand-written kernels of
    ``ops/fused_collectives.py``). All three run the same gather-only
    arithmetic."""
    n: int
    backend: str       # 'gspmd' | 'ring' | 'fused'
    shard_vocab: bool  # LM head and logits gather sharded over the vocab


def resolve_serving(config, n, backend=None, device=None,
                    weight_dtypes=None):
    """The serving engine's mp schedule for an ``n``-rank group, or None for
    n <= 1. Raises when n does not divide the hidden size, the heads and
    the FFN width. ``backend`` None reads ``FLAGS_comm_backend`` (default
    'gspmd'). On a CUDA ``device`` the fused rung raises, naming the
    reason, where its kernels cannot take the out, down or head GEMM
    (``weight_dtypes``: their stored dtypes by leaf name, default the
    compute dtype and an fp32 head); the reference steps down to 'ring'
    there, the port never steps down."""
    n = int(n or 1)
    if n <= 1:
        return None
    H = config.hidden_size
    nh = config.num_heads
    inner = config.ffn_mult * H
    if H % n or nh % n or inner % n:
        raise ValueError(
            f"serving mp={n} must divide hidden {H}, heads {nh} and ffn "
            f"{inner} (choose an mp degree dividing all three)")
    if backend is None:
        backend = comm_backend.serving_requested() or "gspmd"
    if backend not in comm_backend.BACKENDS:
        raise ValueError(f"serving comm_backend must be one of "
                         f"{comm_backend.BACKENDS}, got {backend!r}")
    shard_vocab = config.vocab_size % n == 0
    if backend == "fused" and device is not None and \
            torch.device(device).type == "cuda":
        from ..models.gpt import compute_dtype
        from ..ops import fused_collectives as fc
        dt = compute_dtype(config)
        wd = dict(weight_dtypes or {})
        gemms = [("out_w", H, H // n, wd.get("out_w", dt), dt),
                 ("down_w", inner, H // n, wd.get("down_w", dt), dt)]
        if shard_vocab:
            gemms.append(("head_w", H, config.vocab_size // n,
                          wd.get("head_w", torch.float32), torch.float32))
        whys = [f"{name} [{K}, {F}]: {why}"
                for name, K, F, w_dtype, x_dtype in gemms
                if (why := fc.unsupported_reason(K, F, w_dtype, x_dtype))]
        if whys:
            raise ValueError(
                f"the fused serving rung cannot run this config on CUDA "
                f"({'; '.join(whys)}); choose comm_backend='ring' or "
                f"'gspmd'")
    return ServingMPConfig(n=n, backend=str(backend),
                           shard_vocab=shard_vocab)


@dataclass
class MpStepRecord:
    """Per-rank mp wire traffic of one executed serving dispatch or of one
    training step's forward schedule (the backward mirrors it)."""
    collectives: int = 0          # collectives issued (ring: hop groups)
    ppermute_hops: int = 0        # point-to-point hops (ring rung only)
    fused_dispatches: int = 0     # fused calls (fused rung)
    backend: str = "gspmd"
    ag_bytes: int = 0
    bytes_by_kind: dict = field(default_factory=dict)
    activation_bytes: int = 0     # the activation a rank holds between
    rs_bytes: int = 0             # blocks; reduce-scatter bytes (training)


def serving_step_record(config, cfg: ServingMPConfig, B, T):
    """Per-rank wire ledger of one serving dispatch at window [B, T]
    (decode: [slots, 1]; prefill chunk: [1, rung]): per block the
    all-gathers of the attention context, the out projection's blocks, the
    FFN activation and the down projection's blocks, plus the embedding's
    and, vocab-sharded, the logits' (one row per slot, fp32). Each
    all-gather sends this rank's 1/n block to the n - 1 others."""
    n = cfg.n
    from ..models.gpt import compute_dtype
    item = compute_dtype(config).itemsize
    H = config.hidden_size
    inner = config.ffn_mult * H
    L = config.num_layers
    R = B * T

    def ag(F, isz=item):
        return R * F * isz * (n - 1) // n

    rec = MpStepRecord()
    rec.backend = cfg.backend
    total = ag(H) + L * (ag(H) + ag(H) + ag(inner) + ag(H))
    colls = 1 + 4 * L
    if cfg.shard_vocab:
        total += B * config.vocab_size * 4 * (n - 1) // n
        colls += 1
    rec.ag_bytes = total
    rec.collectives = colls
    rec.bytes_by_kind = {"all_gather": total}
    if cfg.backend == "ring":
        rec.ppermute_hops = colls * (n - 1)
    elif cfg.backend == "fused":
        rec.fused_dispatches = colls
    rec.activation_bytes = R * H * item
    return rec



# --------------------------------------------------------------------------
# training: sequence-parallel primitives on one rank's shards


def _gather_seq(x, group):
    """[B, s, ...] from every rank -> [B, n*s, ...], rank r's block at
    [r*s, (r+1)*s) (the reference's tiled all-gather along axis 1)."""
    n = group.n
    buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    group.all_gather_into(buf, x.contiguous())
    out = buf.view((n,) + tuple(x.shape)).transpose(0, 1)
    return out.reshape((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))


def _scatter_seq(y, group):
    """[B, S, ...] partial on every rank -> this rank's [B, S/n, ...] block
    summed over the ranks (the reference's tiled psum_scatter)."""
    n = group.n
    B, S = y.shape[:2]
    rest = tuple(y.shape[2:])
    blocks = y.reshape((B, n, S // n) + rest).transpose(0, 1).contiguous()
    out = y.new_empty((B, S // n) + rest)
    group.reduce_scatter_into(out, blocks.view((n * B, S // n) + rest))
    return out


class SeqAllGather(torch.autograd.Function):
    """Seq shard -> full sequence; backward: the reduce-scatter (sum) of
    the full-sequence gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.group), None


class SeqReduceScatter(torch.autograd.Function):
    """Full-sequence partial -> reduced seq shard; backward: the
    all-gather of the shard's gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _scatter_seq(y, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group), None


class RingShift(torch.autograd.Function):
    """One hop to the right neighbour; backward: the hop back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.ring_shift(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.ring_shift(g.contiguous(), reverse=True), None


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of a per-rank partial of a value every rank
    then uses alike (a loss term); backward: the identity, since every
    rank's partial feeds the same replicated result."""

    @staticmethod
    def forward(ctx, t, group):
        return group.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def seq_all_gather(x, group):
    """[B, s, ...] seq shard -> [B, S, ...] (one collective)."""
    return x if group.n == 1 else SeqAllGather.apply(x, group)


def seq_reduce_scatter(y, group):
    """[B, S, ...] per-rank partial -> [B, s, ...] reduced seq shard."""
    return y if group.n == 1 else SeqReduceScatter.apply(y, group)


def all_reduce_sum(t, group):
    return AllReduceSum.apply(t, group)


def ring_ag_gemm(x, w, group):
    """All-gather + GEMM in n - 1 hops: x [B, s, H] seq shard, w [H, F/n]
    -> [B, S, F/n]; each chunk's GEMM in the compute dtype."""
    if group.n == 1:
        return x @ w
    from ..ops.ring_gemm import ring_ag
    return ring_ag(x, w, group, torch.matmul,
                   lambda t: RingShift.apply(t, group))


def gemm_ring_rs(y, w, group):
    """GEMM + reduce-scatter in n - 1 hops: y [B, S, F/n], w [F/n, H] ->
    [B, s, H]; the accumulator for chunk c rides the ring visiting every
    rank once, in the compute dtype."""
    if group.n == 1:
        return y @ w
    from ..ops.ring_gemm import ring_rs
    return ring_rs(y, w, group, torch.matmul,
                   lambda t: RingShift.apply(t, group))


def column_parallel(x, w, b, group, backend):
    """Seq-sharded input -> full-sequence, feature-sharded output (the
    all-gather before ColumnParallel); ``b`` the bias shard or None."""
    if backend == "fused":
        from ..ops.fused_collectives import fused_ag_gemm
        out = fused_ag_gemm(x, w, group)
    elif backend == "ring":
        out = ring_ag_gemm(x, w, group)
    else:
        out = seq_all_gather(x, group) @ w
    return out if b is None else out + b


def row_parallel(y, w, b, group, backend):
    """Full-sequence, feature-sharded input -> seq-sharded reduced output
    (the reduce-scatter after RowParallel); ``b`` the full bias, added once
    after the reduction."""
    if backend == "fused":
        from ..ops.fused_collectives import fused_gemm_rs
        out = fused_gemm_rs(y, w, group)
    elif backend == "ring":
        out = gemm_ring_rs(y, w, group)
    else:
        out = seq_reduce_scatter(y @ w, group)
    return out if b is None else out + b


def sp_block_fn(config, group, backend="rsag"):
    """(p, x) -> x of one block on this rank's shards: x [B, S/n, H]; qkv_w
    [H, 3H/n] head-major, out_w [H/n, H], up_w [H, I/n], down_w [I/n, H];
    LayerNorms and the row-parallel biases replicated. Attention runs nh/n
    heads over the full sequence (the flash kernels read q, k and v as
    strided views of the head-major qkv), as the one-device block does;
    only the layout between the GEMMs changes."""
    from ..models.gpt import attention, ln_fp32

    nh = config.num_heads
    eps = config.layer_norm_epsilon
    n = group.n

    def block(p, x):
        B, _, H = x.shape
        dt = x.dtype
        d = H // nh
        h1 = ln_fp32(x, p["ln1_g"], p["ln1_b"], eps)
        qkv = column_parallel(h1, p["qkv_w"].to(dt), p["qkv_b"].to(dt),
                              group, backend)
        S = qkv.shape[1]
        q, k, v = qkv.view(B, S, nh // n, 3, d).unbind(3)
        ctx = attention(q, k, v, config)
        x = x + row_parallel(ctx.reshape(B, S, H // n), p["out_w"].to(dt),
                             p["out_b"].to(dt), group, backend)
        h2 = ln_fp32(x, p["ln2_g"], p["ln2_b"], eps)
        up = F.gelu(column_parallel(h2, p["up_w"].to(dt), p["up_b"].to(dt),
                                    group, backend), approximate="tanh")
        return x + row_parallel(up, p["down_w"].to(dt), p["down_b"].to(dt),
                                group, backend)

    return block


# the sharded dim of each per-layer block leaf (None: replicated); the
# stacked [L, ...] leaves shard one dim later
SP_BLOCK_PARAM_SPECS = {
    "ln1_g": None, "ln1_b": None,
    "qkv_w": 1, "qkv_b": 0,
    "out_w": 0, "out_b": None,
    "ln2_g": None, "ln2_b": None,
    "up_w": 1, "up_b": 0,
    "down_w": 0, "down_b": None,
}


@dataclass(frozen=True)
class SPConfig:
    """The training step's mp schedule: degree and rung."""
    n: int
    backend: str       # 'rsag' | 'ring' | 'fused'


def resolve_gpt(config, n, backend=None, device=None, seq=None):
    """The sequence-parallel schedule of a training step over an ``n``-rank
    group, or None for n <= 1. ``backend`` None reads the flags
    (``comm_backend.train_requested``). Raises, with the reason, where
    the reference steps down: no explicit schedule requested (its GSPMD
    all-reduce schedule is not ported), hidden, heads, FFN or vocab not
    divisible by n, a sequence not divisible by n, logical (not
    head-major) qkv storage, and, for the fused rung on a CUDA
    ``device``, shapes or dtypes its kernels do not take. The port never
    steps down from one rung to another."""
    n = int(n or 1)
    if n <= 1:
        return None
    if backend is None:
        backend = comm_backend.train_requested()
        if backend is None:
            raise NotImplementedError(
                "training at mp>1 runs the sequence-parallel schedule; the "
                "reference's GSPMD all-reduce schedule is not ported "
                "(ROADMAP Queue A 11): pass comm_backend='rsag', 'ring' or "
                "'fused', or set FLAGS_comm_backend='mp=fused' or "
                "FLAGS_sequence_parallel=True")
    if backend not in TRAIN_BACKENDS:
        raise ValueError(f"training comm_backend must be one of "
                         f"{TRAIN_BACKENDS}, got {backend!r}")
    H = config.hidden_size
    inner = config.ffn_mult * H
    whys = [f"{name} {v} not divisible by mp={n}" for name, v in (
        ("hidden", H), ("heads", config.num_heads), ("ffn", inner),
        ("vocab", config.vocab_size)) if v % n]
    if seq is not None and seq % n:
        whys.append(f"sequence {seq} not divisible by mp={n}")
    if not config.qkv_head_major:
        whys.append("the sequence-parallel block needs head-major qkv "
                    "storage (config.qkv_head_major; HybridTrainStep sets "
                    "it up)")
    if whys:
        raise ValueError(f"sequence parallelism at mp={n}: "
                         f"{'; '.join(whys)}")
    if backend == "fused" and device is not None and \
            torch.device(device).type == "cuda":
        from ..models.gpt import compute_dtype
        from ..ops import ring_gemm
        dt = compute_dtype(config)
        # the step GEMMs' (rows, cols, contraction) shapes that do not
        # depend on the batch: the GEMM widths of the four projections
        shapes = [("qkv", H, 3 * H // n), ("out", H // n, H),
                  ("up", H, inner // n), ("down", inner // n, H)]
        whys = [f"{name} [{K}, {Fo}]: {why}" for name, K, Fo in shapes
                if (why := ring_gemm.unsupported_reason(16, Fo, K, dt))]
        if seq is not None and (seq // n) % 16:
            whys.append(f"seq shard {seq // n} not a multiple of 16")
        if whys:
            raise ValueError(
                f"the fused training rung cannot run this config on CUDA "
                f"({'; '.join(whys)}); choose comm_backend='ring' or "
                f"'rsag'")
    return SPConfig(n=n, backend=str(backend))


def gpt_step_record(config, cfg: SPConfig, batch, seq):
    """Per-rank wire ledger of one training step's forward schedule: per
    block an all-gather before qkv, a reduce-scatter after out, an
    all-gather before up and a reduce-scatter after down, each moving
    (n - 1) seq chunks of [B, S/n, H]. Under the fused rung the four are
    fused calls; under the ring rung (n - 1) hops each."""
    from ..models.gpt import compute_dtype
    n = cfg.n
    item = compute_dtype(config).itemsize
    chunk = batch * (seq // n) * config.hidden_size * item
    per_coll = (n - 1) * chunk
    L = config.num_layers
    rec = MpStepRecord(backend=cfg.backend, collectives=4 * L,
                       rs_bytes=2 * L * per_coll, ag_bytes=2 * L * per_coll,
                       activation_bytes=chunk)
    if cfg.backend == "ring":
        rec.ppermute_hops = 4 * L * (n - 1)
    elif cfg.backend == "fused":
        rec.fused_dispatches = 4 * L
    rec.bytes_by_kind = {"reduce_scatter": rec.rs_bytes,
                         "all_gather": rec.ag_bytes}
    return rec


_lock = threading.Lock()


def _zero_counters():
    return {"steps": 0, "collectives": 0, "ppermute_hops": 0,
            "fused_dispatches": 0, "backend": {}, "rs_bytes": 0,
            "ag_bytes": 0, "bytes_by_kind": {}, "activation_bytes": 0}


_counters = _zero_counters()


def record_step(rec):
    """Add one executed training step's record to ``mp_counters()``."""
    if rec is None:
        return
    with _lock:
        c = _counters
        c["steps"] += 1
        for k in ("collectives", "ppermute_hops", "fused_dispatches",
                  "rs_bytes", "ag_bytes"):
            c[k] += getattr(rec, k)
        c["backend"]["mp"] = rec.backend
        c["activation_bytes"] = rec.activation_bytes
        for k, v in rec.bytes_by_kind.items():
            c["bytes_by_kind"][k] = c["bytes_by_kind"].get(k, 0) + v


def mp_counters():
    """The training mp counters since the last reset, with ``wire_bytes``
    the sum of the kinds."""
    with _lock:
        out = dict(_counters)
        out["bytes_by_kind"] = dict(out["bytes_by_kind"])
        out["backend"] = dict(out["backend"])
    out["wire_bytes"] = sum(out["bytes_by_kind"].values())
    return out


def reset_mp_counters():
    global _counters
    with _lock:
        _counters = _zero_counters()
