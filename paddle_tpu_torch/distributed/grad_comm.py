"""Explicit data-parallel gradient communication (counterpart of
``paddle_tpu/distributed/grad_comm.py``).

``jit.TrainStep`` over a group of n data-parallel replicas (one process
each, ``distributed.env.MPGroup``) hands its gradients to this module when
the flags ask for the explicit schedule (``resolve``):

* the bucketed reduce-scatter of the local gradients
  (``reduce_scatter_grads``): every parameter's flat gradient is
  zero-padded to a multiple of n and viewed as (n, cols); same-dtype
  parameters concatenate along the columns into buckets of about
  ``FLAGS_grad_bucket_bytes`` (``BucketPlan``), and row r of a bucket,
  summed over the replicas, lands on replica r: its flat shard of every
  member parameter;
* the optimizer's elementwise update on each replica's 1/n shard, its
  slots stored packed (``shard_of``, ``pack_opt_state``), after clipping
  computed from the shards (``clip_shards``);
* the bucketed all-gather of the updated params (``all_gather_shards``).

Rungs of ``FLAGS_comm_backend``'s dp entry: ``ring`` reduces with the
library's reduce-scatter and gathers with its all-gather; ``fused``
reduces with the hand-written kernel of
``ops.fused_collectives.fused_rs_bucket`` (row 10), whose wire may be
bf16 while it accumulates in fp32, and gathers with ``fused_ag_bucket``
(row 11). On the card each of those is one launch of a pull kernel over
peer staging (``distributed.peer``) that the buckets and rows are packed
straight into. ``FLAGS_allreduce_dtype="int8"`` (and bf16 on the ring
rung) exchanges the rows with one all-to-all at the compressed dtype and
sums them in fp32 (``_quantized_reduce_row``; int8
with a scale per 2,048-element chunk).

The reference's branches for its dp x mp composed step (auto axes, the
int16 fixed-point wire, the emulated gather) raise here: that composition
is ROADMAP Queue A step 3. The per-step byte and collective counts are
computed from the plan, as the reference's are, and read through
``comm_counters()``.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from ..flags import get_flags
from . import comm_backend, peer

logger = logging.getLogger(__name__)

# per-chunk scale granularity of the int8 wire: one outlier flattens only
# its own chunk's resolution
INT8_CHUNK = 2048

WIRE_DTYPES = {"float32": None, "fp32": None, None: None,
               "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
               "int8": torch.int8}

_COMPOSED = ("the dp x mp composed schedule (auto axes, the int16 "
             "fixed-point wire, the emulated gather) is ROADMAP Queue A "
             "step 3")


def _int8_chunking(cols):
    """(chunk, n_chunks, padded_cols) of an int8 row of ``cols`` elements;
    the chunk shrinks to the row for small buckets."""
    chunk = max(1, min(INT8_CHUNK, cols))
    nch = -(-cols // chunk)
    return chunk, nch, nch * chunk


def dtype_name(dtype):
    """``torch.float32`` -> ``"float32"``: the names the reference's plan,
    fingerprint and byte records use."""
    return str(dtype).replace("torch.", "")


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# bucket plan


@dataclass(frozen=True)
class _Entry:
    name: str
    shape: tuple
    dtype: torch.dtype
    size: int          # true element count
    cols: int          # padded size // n
    bucket: int        # bucket index
    offset: int        # column offset inside the bucket


@dataclass(frozen=True)
class _Bucket:
    index: int
    dtype: torch.dtype
    names: tuple
    cols: int          # total columns


class BucketPlan:
    """Static flat-buffer layout of a parameter dict over n replicas."""

    def __init__(self, n, entries, buckets):
        self.n = n
        self.entries = entries      # dict name -> _Entry
        self.buckets = buckets      # list[_Bucket]

    @staticmethod
    def build(params, n, bucket_bytes):
        """params: dict name -> tensor (the order defines the packing
        order; ``jit.TrainStep`` passes the reference Layer's order)."""
        by_dtype = {}
        for name, a in params.items():
            by_dtype.setdefault(a.dtype, []).append((name, a))
        entries, buckets = {}, []
        for dtype, items in by_dtype.items():
            itemsize = _itemsize(dtype)
            cur_names, cur_cols = [], 0
            for name, a in items:
                size = _numel(a.shape)
                cols = -(-size // n)
                if cur_names and (cur_cols + cols) * n * itemsize > \
                        bucket_bytes:
                    buckets.append(_Bucket(len(buckets), dtype,
                                           tuple(cur_names), cur_cols))
                    cur_names, cur_cols = [], 0
                entries[name] = _Entry(name, tuple(int(s) for s in a.shape),
                                       dtype, size, cols, len(buckets),
                                       cur_cols)
                cur_names.append(name)
                cur_cols += cols
            if cur_names:
                buckets.append(_Bucket(len(buckets), dtype, tuple(cur_names),
                                       cur_cols))
        return BucketPlan(n, entries, buckets)

    def fingerprint(self):
        """Short digest of the packed layout (the reference's, so two
        plans of the two frameworks over the same names, shapes and dtypes
        have the same fingerprint)."""
        ent = sorted((e.name, e.shape, dtype_name(e.dtype), e.size, e.cols,
                      e.bucket, e.offset) for e in self.entries.values())
        bks = [(b.index, dtype_name(b.dtype), b.names, b.cols)
               for b in self.buckets]
        return hashlib.sha1(repr((self.n, ent, bks)).encode()).hexdigest()[:16]

    # -- static byte accounting (per-replica wire traffic) ------------------
    def payload_bytes(self):
        return sum(e.size * _itemsize(e.dtype) for e in self.entries.values())

    def padded_bytes(self, wire_dtype=None):
        return sum(b.cols * self.n * _itemsize(wire_dtype or b.dtype)
                   for b in self.buckets)

    def reduce_record(self, wire_dtype, two_sided=False, fixed16=False):
        """({dtype name: wire bytes}, collectives) of one reduce pass: a
        ring reduce-scatter moves (n-1)/n of the buffer per replica; the
        explicit all-reduce baseline (``two_sided``) is reduce-scatter +
        gradient all-gather, twice that. int8 adds its fp32 chunk scales
        and their all-to-all."""
        if fixed16:
            raise NotImplementedError(_COMPOSED)
        n = self.n
        frac = (n - 1) / n
        by_dtype, coll = {}, 0
        for b in self.buckets:
            wd = wire_dtype if (wire_dtype is not None and
                                b.dtype.is_floating_point) else None
            eff = wd or b.dtype
            cols = b.cols
            if wd is torch.int8:
                _, nch, cols = _int8_chunking(b.cols)
                by_dtype["float32"] = by_dtype.get("float32", 0) + int(
                    n * nch * 4 * frac)
                coll += 1
            key = dtype_name(eff)
            by_dtype[key] = by_dtype.get(key, 0) + int(
                cols * n * _itemsize(eff) * frac)
            coll += 1
            if two_sided:
                key = dtype_name(b.dtype)
                by_dtype[key] = by_dtype.get(key, 0) + int(
                    b.cols * n * _itemsize(b.dtype) * frac)
                coll += 1
        return by_dtype, coll

    def gather_record(self, emulated=False):
        """(bytes, collectives) of the bucketed all-gather."""
        if emulated:
            raise NotImplementedError(_COMPOSED)
        frac = (self.n - 1) / self.n
        total = sum(int(b.cols * self.n * _itemsize(b.dtype) * frac)
                    for b in self.buckets)
        return total, len(self.buckets)


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# packing and the collectives


def _padded_rows(t, n, cols):
    flat = t.reshape(-1)
    pad = cols * n - flat.numel()
    return (F.pad(flat, (0, pad)) if pad else flat).view(n, cols)


def _pack_bucket(plan, bucket, tree, out=None):
    """The (n, cols) bucket of ``tree``'s members, each zero-padded to a
    multiple of n and viewed as (n, its cols), side by side; into ``out``
    (a contiguous (n, cols) tensor, e.g. row 10's peer staging) when
    given."""
    parts = [_padded_rows(tree[name], plan.n, plan.entries[name].cols)
             for name in bucket.names]
    if out is not None:
        return out.copy_(parts[0]) if len(parts) == 1 else \
            torch.cat(parts, dim=1, out=out)
    return parts[0].contiguous() if len(parts) == 1 else \
        torch.cat(parts, dim=1)


def _split_row(plan, bucket, row):
    out = {}
    for name in bucket.names:
        e = plan.entries[name]
        out[name] = row[e.offset:e.offset + e.cols]
    return out


def _quantized_reduce_row(x, group, wire_dtype):
    """(n, cols) local bucket -> this replica's reduced (cols,) fp32 row.
    Row j is destined for replica j: one all-to-all moves every row to its
    owner at the wire dtype (int8 with per-chunk fp32 scales, which a
    second all-to-all carries); the owner dequantizes and sums in fp32."""
    n, cols = x.shape
    if wire_dtype is torch.int8:
        chunk, _, padded = _int8_chunking(cols)
        xc = F.pad(x.float(), (0, padded - cols)).view(n, -1, chunk)
        scale = xc.abs().amax(-1) / 127.0                      # (n, nch)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        inv = torch.where(scale > 0, 1.0 / safe, torch.zeros_like(scale))
        q = torch.clamp(torch.round(xc * inv[..., None]), -127, 127).to(
            torch.int8)
        qr = group.all_to_all_rows(torch.empty_like(q), q)
        sr = group.all_to_all_rows(torch.empty_like(scale), scale)
        deq = qr.float() * sr[..., None]
        return deq.sum(0).reshape(padded)[:cols]
    y = group.all_to_all_rows(torch.empty((n, cols), dtype=wire_dtype,
                                          device=x.device),
                              x.to(wire_dtype))
    return y.float().sum(0)


def reduce_scatter_grads(plan, grads, group, wire_dtype, denom=1,
                         fused=False, fixed16=False):
    """Local per-replica gradients -> this replica's flat shard of their
    sum over the replicas divided by ``denom`` (the mean at denom = n), as
    ``{name: (cols,)}`` in each bucket's dtype. Per bucket: ``fused`` (the
    fused dp rung) sends float buckets on an fp32 or bf16 wire through
    row 10 (``ops.fused_collectives.fused_rs_bucket``); otherwise an fp32
    wire takes the library's reduce-scatter and a compressed wire the
    all-to-all exchange. int8 never reaches row 10; non-float buckets
    always reduce at full precision."""
    if fixed16:
        raise NotImplementedError(_COMPOSED)
    from ..ops import fused_collectives as fc

    def wire_of(b):
        return wire_dtype if (wire_dtype is not None and
                              b.dtype.is_floating_point) else None

    row10 = {b.index: b for b in plan.buckets if fused and
             b.dtype.is_floating_point and wire_of(b) is not torch.int8}
    on_card = bool(row10) and group.device.type == "cuda"
    if on_card:              # row 10's staging holds its largest bucket
        peer.channel(group, fc.RS_CHANNEL, max(
            plan.n * b.cols * _itemsize(b.dtype) for b in row10.values()))
    shards = {}
    for b in plan.buckets:
        is_float = b.dtype.is_floating_point
        wd = wire_of(b)
        if b.index in row10:
            # packed straight into this rank's peer staging on the card
            stage = fc.rs_bucket_staging(group, (plan.n, b.cols), b.dtype) \
                if on_card else None
            row = fc.fused_rs_bucket(_pack_bucket(plan, b, grads, stage),
                                     group, wd)
        elif wd is None:
            x = _pack_bucket(plan, b, grads)
            row = group.reduce_scatter_into(
                torch.empty(b.cols, dtype=x.dtype, device=x.device),
                x.reshape(-1))
        else:
            row = _quantized_reduce_row(_pack_bucket(plan, b, grads), group,
                                        wd)
        if denom != 1:
            row = row / denom
        if is_float:
            row = row.to(b.dtype)
        shards.update(_split_row(plan, b, row))
    return shards


def all_gather_shards(plan, shards, group, fused=False, idx=None, out=None):
    """Every replica's flat shards -> full tensors of the plan's shapes and
    dtypes: one all-gather per bucket (on the fused rung through row 11,
    ``fused_ag_bucket``, each row built in its peer staging on the card).
    With ``out`` (a
    dict of tensors) each result is copied into ``out[name]`` in place
    and ``out`` returned."""
    if idx is not None:
        raise NotImplementedError(_COMPOSED)
    from ..ops import fused_collectives as fc
    res = {} if out is None else out
    on_card = fused and group.device.type == "cuda"
    if on_card:              # row 11's staging holds the longest row
        peer.channel(group, fc.AG_CHANNEL, max(
            b.cols * _itemsize(b.dtype) for b in plan.buckets))
    for b in plan.buckets:
        parts = [shards[name] for name in b.names]
        if on_card:          # built straight in this rank's peer staging
            row = fc.ag_bucket_staging(group, b.cols, parts[0].dtype)
            if len(parts) > 1:
                torch.cat(parts, out=row)
            else:
                row.copy_(parts[0])
        else:
            row = torch.cat(parts) if len(parts) > 1 else \
                parts[0].contiguous()
        full = fc.fused_ag_bucket(row, group) if fused else \
            fc.all_gather_stack(row, group)                     # (n, cols)
        for name in b.names:
            e = plan.entries[name]
            flat = full[:, e.offset:e.offset + e.cols].reshape(-1)[:e.size]
            val = flat.view(e.shape).to(e.dtype)
            if out is None:
                res[name] = val
            else:
                res[name].copy_(val)
    return res


def shard_of(plan, name, arr, idx):
    """Replica ``idx``'s flat shard (cols,) of a full tensor: a view of
    ``arr`` where the shard holds no padding, else a copy zero-padded as
    the packed layout is."""
    e = plan.entries[name]
    flat = arr.reshape(-1)
    lo = idx * e.cols
    hi = min(lo + e.cols, e.size)
    if hi - lo == e.cols:
        return flat[lo:hi]
    row = flat.new_zeros(e.cols)
    if hi > lo:
        row[:hi - lo] = flat[lo:hi]
    return row


def clip_shards(grad_clip, shards, group):
    """Gradient clipping computed from flat shards: a norm the clip needs
    is an all-reduce of shard-local partial sums, so no full gradient
    materializes (one all-reduce of a scalar for the global norm, of a
    vector for per-parameter norms)."""
    if grad_clip is None:
        return shards
    from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)
    if isinstance(grad_clip, ClipGradByValue):
        return {n: g.clamp(grad_clip.min, grad_clip.max)
                for n, g in shards.items()}
    if isinstance(grad_clip, ClipGradByGlobalNorm):
        local = sum(g.float().square().sum() for g in shards.values())
        norm = torch.sqrt(group.all_reduce_(local))
        scale = torch.clamp(grad_clip.clip_norm / torch.clamp(norm,
                                                              min=1e-12),
                            max=1.0)
        return {n: (g.float() * scale).to(g.dtype) for n, g in shards.items()}
    if isinstance(grad_clip, ClipGradByNorm):
        sq = group.all_reduce_(torch.stack([g.float().square().sum()
                                            for g in shards.values()]))
        scale = torch.clamp(grad_clip.clip_norm / torch.clamp(
            torch.sqrt(sq), min=1e-12), max=1.0)
        return {n: (g.float() * s).to(g.dtype)
                for (n, g), s in zip(shards.items(), scale)}
    raise TypeError(f"unsupported grad clip for grad_comm: {type(grad_clip)}")


# ---------------------------------------------------------------------------
# packed (sharded) slot / accumulator storage


def packed_shape(pshape, n):
    return (n, -(-(_numel(pshape) or 1) // n))


def pack_array(arr, n):
    """Param-shaped tensor -> its (n, cols) packed layout."""
    return _padded_rows(arr, n, packed_shape(arr.shape, n)[1])


def unpack_array(arr2d, shape, dtype=None):
    out = arr2d.reshape(-1)[:_numel(shape)].view(shape)
    return out.to(dtype) if dtype is not None else out


def _pack_leaf(v, pshape, n, rank):
    """To this replica's packed row (1, cols) (``rank`` given) or the full
    (n, cols) layout; a leaf already packed passes through."""
    packed = packed_shape(pshape, n)
    if tuple(v.shape) == packed and tuple(v.shape) != tuple(pshape):
        full = v
    else:
        full = pack_array(v, n)
    return full if rank is None else full[rank:rank + 1].clone()


def _unpack_leaf(v, pshape):
    """To param shape; a param-shaped leaf passes through."""
    return v if tuple(v.shape) == tuple(pshape) else unpack_array(v, pshape)


def pack_opt_state(state, params, n, rank=None):
    """Optimizer slots to the packed layout: (n, cols), or this replica's
    row (1, cols) with ``rank``."""
    return {"step": state["step"],
            "slots": {name: {k: _pack_leaf(v, tuple(params[name].shape), n,
                                           rank)
                             for k, v in sl.items()}
                      for name, sl in state["slots"].items()}}


def pack_accum(gacc, params, n, rank=None):
    return {name: _pack_leaf(a, tuple(params[name].shape), n, rank)
            for name, a in gacc.items()}


def unpack_opt_state(state, params):
    return {"step": state["step"],
            "slots": {name: {k: _unpack_leaf(v, tuple(params[name].shape))
                             for k, v in sl.items()}
                      for name, sl in state["slots"].items()}}


def unpack_accum(gacc, params):
    return {name: _unpack_leaf(a, tuple(params[name].shape))
            for name, a in gacc.items()}


# ---------------------------------------------------------------------------
# config resolution


@dataclass
class GradCommConfig:
    n: int
    weight_update_sharding: bool
    wire_dtype: object            # None (native) | torch.bfloat16 | torch.int8
    bucket_bytes: int
    plan: BucketPlan = None
    # dp rung: 'ring' (the library's reduce-scatter) or 'fused' (row 10
    # for float buckets on an fp32 or bf16 wire)
    backend: str = "ring"


_warned = set()


def _warn_once(key, msg):
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg)


def resolve(group, optimizer, mp=1):
    """Whether the explicit schedule applies to a step over ``group``: a
    ``GradCommConfig``, or None for the default schedule (a plain mean
    all-reduce of the gradients; the reference's GSPMD dp). Per flags, as
    the reference decides:

    * ``FLAGS_grad_comm`` False/"off": never;
    * True/"on": whenever supported;
    * "auto": when ``FLAGS_weight_update_sharding``, a compressed
      ``FLAGS_allreduce_dtype`` or ``FLAGS_comm_backend``'s dp=ring /
      dp=fused asks for it.

    Where the reference falls back to its GSPMD schedule (dp=gspmd, a
    non-elementwise optimizer under weight-update sharding, an unsupported
    clip) this returns None with its warning. The composed dp x mp step
    (``mp > 1``) raises, naming its ROADMAP item."""
    flags = get_flags(["FLAGS_grad_comm", "FLAGS_weight_update_sharding",
                       "FLAGS_allreduce_dtype", "FLAGS_grad_bucket_bytes"])
    req = comm_backend.requested("dp")
    mode = flags["FLAGS_grad_comm"]
    if mode is False or mode in ("off", "0"):
        if req in ("ring", "fused"):
            _warn_once(("dp-off", req),
                       f"FLAGS_comm_backend='dp={req}' ignored because "
                       f"FLAGS_grad_comm is off — set FLAGS_grad_comm="
                       f"'auto' (or 'on') to activate the explicit dp "
                       f"schedule")
        return None
    wus = bool(flags["FLAGS_weight_update_sharding"])
    raw = flags["FLAGS_allreduce_dtype"]
    if raw not in WIRE_DTYPES:
        _warn_once(("dtype", raw),
                   f"FLAGS_allreduce_dtype={raw!r} unknown; using float32")
        raw = "float32"
    wire = WIRE_DTYPES[raw]
    if req == "gspmd":
        if wus or wire is not None:
            _warn_once("dp-gspmd",
                       "FLAGS_comm_backend='dp=gspmd' keeps the plain "
                       "all-reduce schedule, so FLAGS_weight_update_sharding"
                       "/FLAGS_allreduce_dtype are ignored — set "
                       "FLAGS_comm_backend='dp=ring' (or 'dp=fused') to "
                       "activate them")
        return None
    explicit = mode in (True, "on", "1") or req in ("ring", "fused")
    if not explicit and not (wus or wire is not None):
        return None
    if group is None or group.n <= 1:
        return None
    if mp > 1:
        raise NotImplementedError(_COMPOSED)
    backend = req or "ring"

    def bail(key, msg):
        _warn_once(key, msg + " — falling back to the plain all-reduce "
                   "schedule")
        return None

    if wus and not optimizer.supports_sharded_update():
        return bail(("opt", type(optimizer).__name__),
                    f"{type(optimizer).__name__} does not support a "
                    f"shard-local weight update (non-elementwise rule)")
    grad_clip = getattr(optimizer, "_grad_clip", None)
    if grad_clip is not None:
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue)
        if not isinstance(grad_clip, (ClipGradByGlobalNorm, ClipGradByNorm,
                                      ClipGradByValue)):
            return bail(("clip", type(grad_clip).__name__),
                        f"unsupported grad clip {type(grad_clip).__name__}")
    return GradCommConfig(n=int(group.n), weight_update_sharding=wus,
                          wire_dtype=wire,
                          bucket_bytes=int(flags["FLAGS_grad_bucket_bytes"]),
                          backend=backend)


# ---------------------------------------------------------------------------
# step counters


_lock = threading.Lock()


def _zero_counters():
    return {"steps": 0, "collectives": 0, "reduce_bytes": 0,
            "reduce_bytes_by_dtype": {}, "gather_bytes": 0, "buckets": 0,
            "payload_bytes": 0, "padded_bytes": 0, "fused_dispatches": 0,
            "backend": {}}


_counters = _zero_counters()


@dataclass
class StepComm:
    """Static per-step communication record of one schedule."""
    reduce_bytes_by_dtype: dict = field(default_factory=dict)
    gather_bytes: int = 0
    collectives: int = 0
    buckets: int = 0
    payload_bytes: int = 0
    padded_bytes: int = 0
    fused_dispatches: int = 0     # row 10 calls + row 11 gathers (fused)
    backend: str = "ring"


def make_step_record(plan, wire_dtype, weight_update_sharding,
                     with_update=True, backend="ring"):
    """Byte / collective ledger of one executed step of this plan. The
    explicit all-reduce baseline (weight_update_sharding=False) counts
    reduce-scatter + gradient all-gather as reduce bytes (= ring
    all-reduce); the sharded-update schedule counts the reduce-scatter as
    reduce and the param all-gather as gather (none on a micro step,
    ``with_update=False``). On the fused rung each float bucket's
    reduce-scatter is one row-10 call and each gather one row-11 gather,
    counted in ``fused_dispatches``."""
    rec = StepComm(backend=backend)
    by_dtype, coll = plan.reduce_record(
        wire_dtype, two_sided=not weight_update_sharding)
    if backend == "fused":
        rs_k = sum(1 for b in plan.buckets
                   if b.dtype.is_floating_point and wire_dtype is not
                   torch.int8)
        ag_k = len(plan.buckets) if (not weight_update_sharding
                                     or with_update) else 0
        rec.fused_dispatches = rs_k + ag_k
    rec.reduce_bytes_by_dtype = by_dtype
    rec.collectives = coll
    rec.buckets = len(plan.buckets)
    rec.payload_bytes = plan.payload_bytes()
    rec.padded_bytes = plan.padded_bytes()
    if weight_update_sharding and with_update:
        gb, gcoll = plan.gather_record()
        rec.gather_bytes = gb
        rec.collectives += gcoll
    return rec


def record_step(rec):
    if rec is None:
        return
    with _lock:
        _counters["steps"] += 1
        _counters["collectives"] += rec.collectives
        _counters["gather_bytes"] += rec.gather_bytes
        _counters["buckets"] += rec.buckets
        _counters["payload_bytes"] += rec.payload_bytes
        _counters["padded_bytes"] += rec.padded_bytes
        _counters["fused_dispatches"] += rec.fused_dispatches
        _counters["backend"]["dp"] = rec.backend
        for k, v in rec.reduce_bytes_by_dtype.items():
            _counters["reduce_bytes"] += v
            d = _counters["reduce_bytes_by_dtype"]
            d[k] = d.get(k, 0) + v


def comm_counters():
    with _lock:
        out = dict(_counters)
        out["reduce_bytes_by_dtype"] = dict(out["reduce_bytes_by_dtype"])
        out["backend"] = dict(out["backend"])
    out["bucket_fill"] = (out["payload_bytes"] / out["padded_bytes"]
                          if out["padded_bytes"] else 0.0)
    return out


def reset_comm_counters():
    global _counters
    with _lock:
        _counters = _zero_counters()
