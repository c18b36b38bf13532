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
in-kernel remote DMAs. On Hopper the GEMM's transfer is NCCL's
all-gather outside the kernel (``torch.distributed``); the arithmetic is
the hand-written GEMM of ``csrc/quant_gemm.cu`` (bf16 weights without a
scale against bf16 or fp32 x, fp32 weights against fp32 x for an LM
head passed at fp32; int8/fp8 weights with their scale), whose epilogue
stores the block straight into this rank's slot of the gather buffer
``[n * R, F/n]`` (concatenated along dim 0). The gather then runs in
place on that buffer, so no copy is made between the GEMM and the
collective, the property the TPU kernel has. The relayout of the
gathered ``[n, R, F/n]`` to ``[R, F]`` (``transpose(1, 0, 2)`` in the
reference too, :722) is PyTorch. ``fused_ag_bucket`` is row 11 above:
the row is copied into the peer staging and one launch pulls every
rank's.

What bounds them on an H100: at decode (R = 8 rows) the GEMM reads its
weight shard once (bytes: 2048 x 512 bf16 is 2.1 MB, 0.6 us at 3.35
TB/s), and the all-gather moves R x F x (n - 1) / n elements per rank,
a few KB: latency, not NVLink's 450 GB/s. Fusing the GEMM's epilogue
with stores into the peers' buffers (the peer channels of rows 10-11)
is later work (ROADMAP Queue A step 4).

Beside each: the plain version (``gemm_ag_plain``, ``ag_bucket_plain``):
the plain GEMM (``generation._matmul``, or the quantized GEMM's plain
algebra) and an out-of-place all-gather of the blocks concatenated in
rank order, ``gemm_ag_reference``'s algebra; the ring of blocking hops
with each step's row copied into its slot. The wrappers take the plain
version for CPU tensors only; for CUDA tensors they launch the kernel or
raise. ``fused_gemm_ag.launches`` and ``fused_ag_bucket.launches`` count
kernel launches (``fused_gemm_ag.shapes`` the same by shape,
``fused_ag_bucket.shapes`` its calls by row length).
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


def gemm_ag_plain(x, w, group, scale=None):
    """``x [..., K] @ w_r [K, F/n]`` (times ``scale`` [F/n] for an int8/fp8
    shard), every rank's block gathered along the last axis: [..., F]."""
    if scale is None:
        y = _proj(x, w.to(x.dtype))
    else:
        y = _qg.quant_gemm_plain(x, w, scale)
    return _gather_cat(group, y)


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


def fused_gemm_ag(x, w, group, scale=None):
    """Column-parallel projection ``x [..., K] @ w`` from this rank's column
    shard ``w_r [K, F/n]`` (bf16, fp32 against fp32 x; or int8/fp8 with
    ``scale`` [F/n] fp32):
    the kernel writes ``x @ w_r`` into this rank's slot of the gather
    buffer, which is gathered in place; returns [..., F] in x's dtype, the
    blocks in rank order. CPU tensors take ``gemm_ag_plain``."""
    if x.device.type == "cpu":
        return gemm_ag_plain(x, w, group, scale)
    _check_gemm(x, w, scale)
    lead = x.shape[:-1]
    K, Fl = w.shape
    x2 = x.reshape(-1, K)
    R = x2.shape[0]
    n, r = group.n, group.rank
    buf = torch.empty((n * R, Fl), dtype=x.dtype, device=x.device)
    slot = buf[r * R:(r + 1) * R]
    _qg.gemm_into(x2, w, scale, slot)
    fused_gemm_ag.launches += 1
    fused_gemm_ag.shapes[(R, K, Fl, str(w.dtype)[6:])] += 1
    group.all_gather_into(buf, slot)
    return buf.view(n, R, Fl).transpose(0, 1).reshape(lead + (n * Fl,))


fused_gemm_ag.launches = 0
fused_gemm_ag.shapes = collections.Counter()


# ------------------------------------------------- all-gather (row 11)
AG_CHANNEL = "ag_bucket"


@functools.lru_cache(maxsize=None)
def _ag_library():
    lib = load_library("ag_bucket", "ag_bucket.cu")
    p = ctypes.c_void_p
    lib.ag_pull_launch.argtypes = [p, p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, p, p,
                                   ctypes.c_ulonglong, p]
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
            _peer.error_pointer(), ch.timeout_ns,
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
                                   ctypes.c_longlong, p, p,
                                   ctypes.c_ulonglong, p]
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
            ch.timeout_ns, torch.cuda.current_stream(x.device).cuda_stream)
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
