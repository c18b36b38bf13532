"""Fused GEMM + collective ops for tensor parallelism, and the bucketed
reduce-scatter and all-gather of data-parallel gradient communication
(counterpart of ``paddle_tpu/ops/pallas_kernels/fused_collectives.py:
361-779`` and its ``gemm_ag_reference`` and ``rs_bucket_reference``,
:1014 and :1032).

Data parallelism: ``fused_rs_bucket`` and ``fused_ag_bucket``, rows 10
and 11 (below, after the training ops), the reduce-scatter of one
gradient bucket and the all-gather of one updated param row of
``distributed/grad_comm.py`` on the fused dp rung; row 11 also carries
the mp serving engine's data gathers. Each call is one launch of a
hand-written pull kernel (``csrc/rs_bucket.cu``, ``csrc/ag_bucket.cu``)
over symmetric peer buffers (``distributed/peer.py``): every rank writes
its operand into its staging region, and the kernel reads the peers'
staging over NVLink through CUDA IPC mappings made once per group,
synchronising with flags in device memory; no NCCL hop and no host round
trip. Their results are the plain rings' bit for bit.

Training (sequence parallelism): ``fused_ag_gemm`` and ``fused_gemm_rs``,
the differentiable ring all-gather + GEMM (ColumnParallel forward) and
GEMM + ring reduce-scatter (RowParallel forward) of
``fused_collectives.py:731-779``. Each one's backward is the other's
kernel plus the ring weight-gradient kernel (``ops/ring_gemm.py``):

* ``fused_ag_gemm(x, w)``: ``dx = gemm_rs(g, w^T)``, ``dw = ag_accum(x,
  g)``;
* ``fused_gemm_rs(y, w)``: ``dy = ag_gemm(g, w^T)``, ``dw = ag_accum(g,
  y)^T``.

The forward saves the seq shard x (not the gathered sequence), and the
backward rings it again, as the TPU kernel does. CPU tensors take the
plain versions; CUDA tensors the kernels, or raise.

Serving:

Replaces three TPU kernels:

* ``_gemm_ag_kernel`` (:448, through ``fused_gemm_ag``, the pallas_call at
  :699): a rank's full-contraction column block ``x @ w_r`` of a
  column-parallel projection, the blocks all-gathered in rank order, so
  the result is ``x @ w`` with w's columns in their logical order;
* ``_gemm_ag_q_kernel`` (:498, ``fused_gemm_ag(scale=)``, :710): the same
  over an int8/fp8 weight shard, ``(x @ wq_r) * s_r``;
* ``_ag_bucket_kernel`` (:409, ``fused_ag_bucket``, :667): the all-gather
  of a flat row, (cols,) -> (n, cols).

The TPU kernels keep a rank's GEMM output block out of device memory
between the epilogue and the transfer, and move it around a ring with
in-kernel remote DMAs. On Hopper rows 12-13 are two launches on the
stream (three where the GEMM splits k): the hand-written GEMM of
``csrc/quant_gemm.cu`` (row 3's kernels, the same bits: bf16 weights
without a scale against bf16 or fp32 x, fp32 weights against fp32 x for
an LM head passed at fp32, int8/fp8 weights with their scale), whose
epilogue stores the block ``[R, F/n]`` straight into this rank's slot of
the group's ``"gemm_ag"`` peer channel (two slots, by call parity;
``distributed/peer.py``), then ``csrc/gemm_ag.cu``'s gather: one flag per
rank and call published into every peer's signal pad, and the ``[R, F]``
output copied from every rank's slot over NVLink, block p at columns
``p F/n``. No NCCL or gloo collective, no host round trip and no relayout
copy (the reference's ``transpose(1, 0, 2)``, :722). The serving engine
opens the channel at build for its largest block
(``reserve_gemm_ag``), so it never grows in mid-run. ``fused_ag_bucket``
is row 11 above: the row is copied into the peer staging and one launch
pulls every rank's.

What bounds them on an H100: at decode (R = 8 rows) the GEMM reads its
weight shard once (bytes: 2048 x 512 bf16 is 2.1 MB, 0.6 us at 3.35
TB/s), and the gather receives R x F x (n - 1) / n elements per rank, a
few KB: latency (the launch, one NVLink round trip for the flag, one for
the loads), not NVLink's 450 GB/s.

Beside each: the plain version (``gemm_ag_plain``, ``ag_bucket_plain``):
the plain GEMM (``generation._matmul``, or the quantized GEMM's plain
algebra) and an out-of-place all-gather of the blocks concatenated in
rank order, ``gemm_ag_reference``'s algebra; the ring of blocking hops
with each step's row copied into its slot. ``gemm_ag_peer_plain`` is rows
12-13's peer schedule in plain form over every rank's shard at once. The
wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernels or raise. ``fused_gemm_ag`` counts its calls
(``.calls``), its kernel launches (``.launches``: the GEMM's one or two
and the gather's) and its calls by shape (``.shapes``);
``fused_ag_bucket`` its calls, launches (one a call) and calls by row
length.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..cuda_build import load_library
from ..distributed import peer as _peer
from ..models.generation import _proj
from . import quant_gemm as _qg
from . import ring_gemm as _rg

# the kernel against its plain version: quant_gemm's readings and
# tolerances, per element relative to (|plain| + the row's rms) and per
# row in L2; the two sum in different orders and, at bf16 with a scale,
# round a different number of times (ops/quant_gemm.py)
error_vs_plain = _qg.error_vs_plain
within_tolerance = _qg.within_tolerance
ELEMENT_TOL = _qg.ELEMENT_TOL
ROW_TOL = _qg.ROW_TOL


def unsupported_reason(K, F, w_dtype, x_dtype):
    """Why the fused GEMM cannot take a [K, F] shard of ``w_dtype`` against
    ``x_dtype`` rows, or None: bf16 weights (no scale) and int8/fp8
    weights (with a scale) against bf16 or fp32 x; fp32 weights (no
    scale, an LM head passed at fp32) against fp32 x."""
    reasons = []
    if K % 16:
        reasons.append(f"contraction dim {K} not a multiple of 16")
    if F % 16:
        reasons.append(f"shard width {F} not a multiple of 16")
    if w_dtype not in _qg.LIB_W_DTYPES:
        reasons.append(f"weight dtype {w_dtype} not bfloat16/float32/int8/"
                       f"float8_e4m3fn")
    if x_dtype not in _qg.X_DTYPES:
        reasons.append(f"x dtype {x_dtype} not bfloat16/float32")
    elif w_dtype == torch.float32 and x_dtype != torch.float32:
        reasons.append(f"float32 weights need float32 x, not {x_dtype}")
    return "; ".join(reasons) or None


def _gather_cat(group, y):
    """Every rank's block y [..., F] concatenated along the last axis in
    rank order (out of place): the plain versions' gather."""
    return torch.cat(group.all_gather_list(y.contiguous()), dim=-1)


def _gemm_block(x, w, scale):
    """This rank's block ``x @ w_r`` (times ``scale``) in plain ops."""
    if scale is None:
        return _proj(x, w.to(x.dtype))
    return _qg.quant_gemm_plain(x, w, scale)


def gemm_ag_plain(x, w, group, scale=None):
    """``x [..., K] @ w_r [K, F/n]`` (times ``scale`` [F/n] for an int8/fp8
    shard), every rank's block gathered along the last axis: [..., F]."""
    return _gather_cat(group, _gemm_block(x, w, scale))


def ag_bucket_plain(row, group):
    """The ring of ``fused_ag_bucket`` over ``group``'s blocking hops, each
    ring step's row copied into its slot: (cols,) on every rank -> (n,
    cols) in rank order."""
    n, idx = group.n, group.rank
    out = row.new_empty((n,) + tuple(row.shape))
    out[idx].copy_(row)
    for t in range(1, n):
        row = group.ring_shift(row)
        out[(idx - t) % n].copy_(row)
    return out


def all_gather_stack(t, group):
    """Every rank's ``t`` stacked in rank order, [n, *t.shape]: one
    all-gather into a buffer concatenated along dim 0 (the layout gloo
    also takes)."""
    n = group.n
    buf = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    group.all_gather_into(buf, t.contiguous())
    return buf.view((n,) + tuple(t.shape))


def _check_gemm(x, w, scale):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused GEMM + all-gather runs on cuda or cpu, not "
                         f"{dev}")
    for name, t in (("w", w), ("scale", scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"x [..., K] and w [K, F] disagree: "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")
    why = unsupported_reason(w.shape[0], w.shape[1], w.dtype, x.dtype)
    if w.dtype in _qg.FULL_W_DTYPES and scale is not None:
        why = (why + "; " if why else "") + \
            f"a {str(w.dtype)[6:]} weight takes no scale"
    if w.dtype in _qg.W_DTYPES and (
            scale is None or scale.dtype != torch.float32
            or tuple(scale.shape) != (w.shape[1],)):
        why = (why + "; " if why else "") + \
            f"an int8/fp8 weight needs a float32 scale [{w.shape[1]}]"
    for name, t in (("x", x), ("w", w), ("scale", scale)):
        if t is None:
            continue
        if not t.is_contiguous():
            why = (why + "; " if why else "") + f"{name} is not contiguous"
        elif t.data_ptr() % 16:
            why = (why + "; " if why else "") + f"{name} is not 16-byte " \
                "aligned"
    if why:
        raise ValueError(f"fused GEMM + all-gather kernel: {why}")


# ------------------------------------- GEMM + all-gather (rows 12-13)
# rows 12-13's peer channel: this rank's GEMM block twice, by call parity
GEMM_AG_CHANNEL = "gemm_ag"
GEMM_AG_ALIGN = 256             # a slot starts on a multiple of this


def gemm_ag_staging_bytes(blocks):
    """The ``"gemm_ag"`` staging that holds the largest of ``blocks``
    (``(rows, cols, itemsize)`` of the blocks a caller will gather) in
    each of its two slots."""
    most = max(R * F * size for R, F, size in blocks)
    return 2 * (-(-most // GEMM_AG_ALIGN) * GEMM_AG_ALIGN)


def gemm_ag_slot(capacity, call):
    """(parity, byte offset) of the slot that call number ``call`` (1, 2,
    ...) of a channel writes and reads in every rank's staging of
    ``capacity`` bytes: slot ``call & 1``, half the staging (aligned down)
    apart."""
    par = call & 1
    return par, par * (capacity // 2 // GEMM_AG_ALIGN * GEMM_AG_ALIGN)


def gemm_ag_peer_plain(x, ws, rank, scales=None, calls=0, capacity=None):
    """Rows 12-13's peer schedule in plain form over every rank's shard at
    once (``ws[p]`` rank p's [K, F/n], ``scales[p]`` its scale or None),
    for rank ``rank``'s call number ``calls + 1``: each rank's block is
    stored, as bytes, into the slot of that call's parity in a staging of
    ``capacity`` bytes (default: ``gemm_ag_staging_bytes`` of the block),
    and the output's 16-byte units are copied out of the slots as the
    gather kernel copies them, sources in the order rank + 1, rank + 2,
    ..., block p at columns p F/n. The same bits as ``gemm_ag_plain``."""
    n = len(ws)
    scales = [None] * n if scales is None else scales
    blocks = [_gemm_block(x, w, s) for w, s in zip(ws, scales)]
    lead, Fl = blocks[0].shape[:-1], blocks[0].shape[-1]
    rows = [b.reshape(-1, Fl).contiguous().view(torch.uint8) for b in blocks]
    R, row_bytes = rows[0].shape
    if capacity is None:
        capacity = gemm_ag_staging_bytes([(R, row_bytes, 1)])
    _, off = gemm_ag_slot(capacity, calls + 1)
    staging = [torch.zeros(capacity, dtype=torch.uint8) for _ in range(n)]
    for st, r in zip(staging, rows):
        st[off:off + r.numel()] = r.reshape(-1)
    out = torch.empty((R, n, row_bytes // 16, 16), dtype=torch.uint8)
    for k in range(n):
        src = (rank + 1 + k) % n
        out[:, src] = staging[src][off:off + R * row_bytes].view(
            R, row_bytes // 16, 16)
    return out.view(-1).view(blocks[0].dtype).view(lead + (n * Fl,))


def gemm_ag_exact(x, w, group, scale=None):
    """Rows 12-13's result as row 3's kernel and an exact all-gather give
    it on CUDA: this rank's ``gemm_into`` block into a buffer of its own,
    every rank's gathered through the group and concatenated in rank
    order. ``fused_gemm_ag`` must give these bits."""
    K, Fl = w.shape
    own = torch.empty((x.numel() // K, Fl), dtype=x.dtype, device=x.device)
    _qg.gemm_into(x.reshape(-1, K), w, scale, own)
    return _gather_cat(group, own).view(x.shape[:-1] + (group.n * Fl,))


@functools.lru_cache(maxsize=None)
def _gemm_ag_library():
    lib = load_library("gemm_ag", "gemm_ag.cu")
    p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
    lib.gemm_ag_launch.argtypes = [p, p, i, i, i, i, ll, ll, i, p, p, p,
                                   ull, ull, p]
    lib.gemm_ag_launch.restype = i
    lib.gemm_ag_error_string.argtypes = [i]
    lib.gemm_ag_error_string.restype = ctypes.c_char_p
    return lib


def build_gemm_ag():
    """Build (or load the cached builds of) rows 12-13's libraries now:
    the GEMM's, the gather's and the peer-memory library."""
    _peer.build()
    _qg.build()
    _gemm_ag_library()


def reserve_gemm_ag(group, blocks):
    """Open ``group``'s ``"gemm_ag"`` channel with room for the largest of
    ``blocks`` (``(rows, cols, itemsize)``): collective, every rank at the
    same call. A call whose block does not fit grows the channel
    (collectively), so a caller that reserves its largest block up front
    never tears the channel down in mid-run."""
    return _peer.channel(group, GEMM_AG_CHANNEL, gemm_ag_staging_bytes(blocks))


def fused_gemm_ag(x, w, group, scale=None):
    """Column-parallel projection ``x [..., K] @ w`` from this rank's column
    shard ``w_r [K, F/n]`` (bf16, fp32 against fp32 x; or int8/fp8 with
    ``scale`` [F/n] fp32): returns [..., F] in x's dtype, the blocks in
    rank order. CPU tensors take ``gemm_ag_plain``. A CUDA call launches
    the GEMM into this rank's slot of the group's ``"gemm_ag"`` channel and
    ``csrc/gemm_ag.cu``'s gather, or raises; it makes no collective call
    of ``group`` or ``torch.distributed`` (only the channel's set-up, at
    the group's first call unless ``reserve_gemm_ag`` made it). Collective:
    every rank of ``group`` makes the same calls in the same order."""
    if x.device.type == "cpu":
        return gemm_ag_plain(x, w, group, scale)
    _check_gemm(x, w, scale)
    why = _check_group(x, group, "x")
    lead = x.shape[:-1]
    K, Fl = w.shape
    x2 = x.reshape(-1, K)
    R = x2.shape[0]
    if R == 0:
        why.append("x has no rows")
    if why:
        raise ValueError("fused GEMM + all-gather kernel: " + "; ".join(why))
    row = 12 if scale is None else 13
    n, rank = group.n, group.rank
    _peer.raise_for(0, row, rank, None)        # an earlier kernel trapped
    row_bytes = Fl * x.element_size()
    ch = reserve_gemm_ag(group, [(R, row_bytes, 1)])
    call = ch.calls + 1
    par, off = gemm_ag_slot(ch.capacity, call)
    stride = gemm_ag_slot(ch.capacity, 1)[1]      # slot 0 to slot 1
    gemm_launches = _qg.gemm_into(x2, w, scale,
                                  ch.view((R, Fl), x.dtype, off))
    out = torch.empty((R, n * Fl), dtype=x.dtype, device=x.device)
    lib = _gemm_ag_library()
    with torch.cuda.device(x.device):
        rc = lib.gemm_ag_launch(
            ch.data, ch.pads, n, rank, row, R, row_bytes, stride, par,
            out.data_ptr(), _peer.error_pointer(), ch.beats, ch.timeout_ns,
            ch.backstop_ns, torch.cuda.current_stream(x.device).cuda_stream)
    _peer.raise_for(rc, row, rank,
                    lambda c: lib.gemm_ag_error_string(c).decode())
    ch.calls = call
    fused_gemm_ag.calls += 1
    fused_gemm_ag.launches += gemm_launches + 1
    fused_gemm_ag.shapes[(R, K, Fl, str(w.dtype)[6:])] += 1
    return out.view(lead + (n * Fl,))


def reset_gemm_ag_counts():
    fused_gemm_ag.launches = 0
    fused_gemm_ag.calls = 0
    fused_gemm_ag.shapes = collections.Counter()


reset_gemm_ag_counts()


# ------------------------------------------------- all-gather (row 11)
AG_CHANNEL = "ag_bucket"


@functools.lru_cache(maxsize=None)
def _ag_library():
    lib = load_library("ag_bucket", "ag_bucket.cu")
    p = ctypes.c_void_p
    lib.ag_pull_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, p, p, p,
                                   ctypes.c_ulonglong, ctypes.c_ulonglong,
                                   p]
    lib.ag_pull_launch.restype = ctypes.c_int
    lib.ag_bucket_error_string.argtypes = [ctypes.c_int]
    lib.ag_bucket_error_string.restype = ctypes.c_char_p
    return lib


def build_ag_bucket():
    """Build (or load the cached builds of) row 11's kernel library and
    the peer-memory library now."""
    _peer.build()
    _ag_library()


def ag_bucket_pull_plain(row, group):
    """The pull kernel's algebra in plain ops: slot p of the (n, cols)
    result is rank p's row, read from every rank (an all-gather), in rank
    order."""
    return torch.stack(group.all_gather_list(row.contiguous()))


def ag_bucket_staging(group, numel, dtype):
    """A (numel,) row of ``dtype`` in this rank's row-11 staging on a CUDA
    group: a ``fused_ag_bucket`` operand written here is not copied at the
    call."""
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    return _peer.channel(group, AG_CHANNEL, nbytes).view((numel,), dtype)


def _check_group(t, group, what):
    why = []
    if t.device.type != "cuda":
        why.append(f"{what} on {t.device}, not cuda")
    elif getattr(group, "device", None) != t.device:
        why.append(f"{what} on {t.device}, the group on "
                   f"{getattr(group, 'device', None)}")
    n = getattr(group, "n", 0)
    if not 2 <= n <= _peer.MAX_RANKS:
        why.append(f"a group of {n} ranks (the kernels take 2 to "
                   f"{_peer.MAX_RANKS})")
    return why


def fused_ag_bucket(row, group):
    """Row 11: (cols,) on every rank -> (n, cols) in rank order. A CUDA row
    is copied into this rank's staging (unless it is the staging view of
    ``ag_bucket_staging``) and one kernel launch pulls every rank's row
    into its slot; CPU rows take ``ag_bucket_plain``. Counts its calls
    (``.calls``), launches (``.launches``, one a call) and calls by row
    length (``.shapes``)."""
    if row.device.type == "cpu":
        return ag_bucket_plain(row, group)
    why = _check_group(row, group, "row")
    if row.dim() != 1 or not row.is_contiguous() or row.numel() == 0:
        why.append(f"fused_ag_bucket takes a contiguous flat row, got shape "
                   f"{tuple(row.shape)}")
    if why:
        raise ValueError("ag_bucket kernel: " + "; ".join(why))
    _peer.raise_for(0, 11, group.rank, None)   # an earlier kernel trapped
    n = group.n
    nbytes = row.numel() * row.element_size()
    ch = _peer.channel(group, AG_CHANNEL, nbytes)
    stage = ch.view(row.shape, row.dtype)
    if row.data_ptr() != stage.data_ptr():
        stage.copy_(row)
    out = torch.empty((n,) + tuple(row.shape), dtype=row.dtype,
                      device=row.device)
    lib = _ag_library()
    with torch.cuda.device(row.device):
        rc = lib.ag_pull_launch(
            ch.data, ch.pads, n, group.rank, nbytes, out.data_ptr(),
            _peer.error_pointer(), ch.beats, ch.timeout_ns, ch.backstop_ns,
            torch.cuda.current_stream(row.device).cuda_stream)
    _peer.raise_for(rc, 11, group.rank,
                    lambda c: lib.ag_bucket_error_string(c).decode())
    fused_ag_bucket.launches += 1
    fused_ag_bucket.calls += 1
    fused_ag_bucket.shapes[row.shape[0]] += 1
    return out


def reset_ag_bucket_counts():
    fused_ag_bucket.launches = 0
    fused_ag_bucket.calls = 0
    fused_ag_bucket.shapes = collections.Counter()


reset_ag_bucket_counts()


# ------------------------------------------------- training (rows 7 - 9)
class _FusedAgGemm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _rg.ring_ag_gemm(x.contiguous(), w, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = _rg.ring_gemm_rs(g, w, ctx.group, transpose_w=True)
        dw = _rg.ring_ag_accum(x.contiguous(), g, ctx.group).to(w.dtype)
        return dx, dw, None


class _FusedGemmRs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, w, group):
        ctx.save_for_backward(y, w)
        ctx.group = group
        return _rg.ring_gemm_rs(y.contiguous(), w, group)

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.contiguous()
        dy = _rg.ring_ag_gemm(g, w, ctx.group, transpose_w=True)
        dw = _rg.ring_ag_accum(g, y.contiguous(), ctx.group,
                               transpose=True).to(w.dtype)
        return dy, dw, None


def fused_ag_gemm(x, w, group):
    """ColumnParallel forward: the seq shard x [B, s, A] all-gathered over
    the ring while each chunk is GEMMed with the column shard w [A, F]:
    [B, n*s, F] (differentiable)."""
    return _FusedAgGemm.apply(x, w, group)


def fused_gemm_rs(y, w, group):
    """RowParallel forward: the partial y [B, S, F] GEMMed with the row shard
    w [F, A] and reduce-scattered over the ring in fp32: this rank's seq
    shard [B, S/n, A] (differentiable)."""
    return _FusedGemmRs.apply(y, w, group)


# ------------------------------------------------- data parallel (row 10)
# Replaces ``_rs_bucket_kernel`` (:361, through ``fused_rs_bucket`` :642):
# grad_comm's ring reduce-scatter of an (n, cols) bucket of this replica's
# flat gradients into its reduced (cols,) fp32 row, each hop's traveling
# accumulator on a fp32 or bf16 wire, accumulated in fp32 on receipt
# ("part + received"). Unrolled, rank i's row is
#   acc = f32(x_{i+1}[i]);  for k = 2 .. n: acc = f32(wire(acc)) + x_{i+k}[i]
# and the pull kernel of ``csrc/rs_bucket.cu`` computes exactly that, in
# that order and with those roundings, from row i of every rank's staging,
# so it equals the plain ring bit for bit. The ``/ n`` mean and the cast
# back to the bucket dtype stay with the caller, as in the reference
# (grad_comm.py:306-309).
RS_CHANNEL = "rs_bucket"
RS_PART_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RS_WIRE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rs_bucket_plain(x, group, wire_dtype=None):
    """The ring of ``rs_bucket_reference`` over ``group``'s blocking hops:
    (n, cols) local rows -> this rank's (cols,) fp32 row, summed over the
    ranks with each hop's accumulator cast to ``wire_dtype`` (None:
    fp32)."""
    wire = wire_dtype or torch.float32
    n, idx = group.n, group.rank
    acc = x[(idx - 1) % n].float()
    for t in range(1, n):
        recv = group.ring_shift(acc.to(wire))
        acc = recv.float() + x[(idx - t - 1) % n].float()
    return acc


def rs_bucket_pull_plain(x, group, wire_dtype=None):
    """The pull kernel's algebra in plain ops: row ``rank`` of every rank's
    (n, cols) bucket (read through an all-gather) summed in the ring's
    order, ``acc = f32(wire(acc)) + x_{rank+k}[rank]`` for k = 2..n from
    ``acc = x_{rank+1}[rank]``; equal to ``rs_bucket_plain`` bit for
    bit."""
    wire = wire_dtype or torch.float32
    n, i = group.n, group.rank
    every = group.all_gather_list(x.contiguous())
    acc = every[(i + 1) % n][i].float()
    for k in range(2, n + 1):
        acc = acc.to(wire).float() + every[(i + k) % n][i].float()
    return acc


@functools.lru_cache(maxsize=None)
def _rs_library():
    lib = load_library("rs_bucket", "rs_bucket.cu")
    p = ctypes.c_void_p
    lib.rs_pull_launch.argtypes = [ctypes.c_int, ctypes.c_int, p, p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, p, p, p,
                                   ctypes.c_ulonglong, ctypes.c_ulonglong,
                                   p]
    lib.rs_pull_launch.restype = ctypes.c_int
    lib.rs_bucket_error_string.argtypes = [ctypes.c_int]
    lib.rs_bucket_error_string.restype = ctypes.c_char_p
    return lib


def build_rs_bucket():
    """Build (or load the cached builds of) row 10's kernel library and
    the peer-memory library now."""
    _peer.build()
    _rs_library()


def rs_bucket_staging(group, shape, dtype):
    """An (n, cols) bucket of ``dtype`` in this rank's row-10 staging on a
    CUDA group: a ``fused_rs_bucket`` operand packed here is not copied at
    the call."""
    nbytes = shape[0] * shape[1] * torch.empty((), dtype=dtype).element_size()
    return _peer.channel(group, RS_CHANNEL, nbytes).view(shape, dtype)


def fused_rs_bucket(x, group, wire_dtype=None):
    """Row 10: (n, cols) local gradient rows (fp32 or bf16) -> this rank's
    (cols,) fp32 row summed over ``group``'s n ranks, in the ring's order
    with each term's accumulator rounded to ``wire_dtype`` (None: fp32; or
    bf16). A CUDA bucket is copied into this rank's staging (unless it is
    the view of ``rs_bucket_staging``) and one kernel launch pulls row
    ``rank`` of every rank's; CPU tensors take ``rs_bucket_plain``.
    Counts its calls (``.calls``), launches (``.launches``, one a call)
    and calls by (cols, wire) (``.shapes``)."""
    if x.device.type == "cpu":
        return rs_bucket_plain(x, group, wire_dtype)
    wire = wire_dtype or torch.float32
    why = _check_group(x, group, "bucket")
    n = getattr(group, "n", 0)
    if x.dim() != 2 or x.shape[0] != n or not x.is_contiguous() or \
            x.numel() == 0:
        why.append(f"fused_rs_bucket takes a contiguous ({n}, cols) bucket, "
                   f"got {tuple(x.shape)}")
    if x.dtype not in RS_PART_DTYPES:
        why.append(f"part dtype {x.dtype} not float32/bfloat16")
    if wire not in RS_WIRE_DTYPES:
        why.append(f"wire dtype {wire} not float32/bfloat16")
    if why:
        raise ValueError("rs_bucket kernel: " + "; ".join(why))
    _peer.raise_for(0, 10, group.rank, None)   # an earlier kernel trapped
    cols = x.shape[1]
    ch = _peer.channel(group, RS_CHANNEL, x.numel() * x.element_size())
    stage = ch.view(x.shape, x.dtype)
    if x.data_ptr() != stage.data_ptr():
        stage.copy_(x)
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    lib = _rs_library()
    with torch.cuda.device(x.device):
        rc = lib.rs_pull_launch(
            RS_PART_DTYPES[x.dtype], RS_WIRE_DTYPES[wire], ch.data, ch.pads,
            n, group.rank, cols, out.data_ptr(), _peer.error_pointer(),
            ch.beats, ch.timeout_ns, ch.backstop_ns,
            torch.cuda.current_stream(x.device).cuda_stream)
    _peer.raise_for(rc, 10, group.rank,
                    lambda c: lib.rs_bucket_error_string(c).decode())
    fused_rs_bucket.launches += 1
    fused_rs_bucket.calls += 1
    fused_rs_bucket.shapes[(cols, str(wire)[6:])] += 1
    return out


def reset_rs_bucket_counts():
    fused_rs_bucket.launches = 0
    fused_rs_bucket.calls = 0
    fused_rs_bucket.shapes = collections.Counter()


reset_rs_bucket_counts()
