"""Fused GEMM + collective ops for tensor parallelism, and the bucketed
ring reduce-scatter of data-parallel gradient communication (counterpart
of ``paddle_tpu/ops/pallas_kernels/fused_collectives.py:361-779`` and its
``gemm_ag_reference`` and ``rs_bucket_reference``, :1014 and :1032).

Data parallelism: ``fused_rs_bucket``, row 10 (below, after the training
ops), the reduce-scatter of one gradient bucket of
``distributed/grad_comm.py`` on the fused dp rung.

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
in-kernel remote DMAs. On Hopper the transfer is NCCL's all-gather
outside the kernel (``torch.distributed``); the arithmetic is the
hand-written GEMM of ``csrc/quant_gemm.cu`` (bf16 weights without a
scale against bf16 or fp32 x, fp32 weights against fp32 x for an LM
head passed at fp32; int8/fp8 weights with their scale), whose epilogue
stores the block straight into this rank's slot of the gather buffer
``[n * R, F/n]`` (concatenated along dim 0). The gather then runs in
place on that buffer, so no copy is made between the GEMM and the
collective, the property the TPU kernel has. The relayout of the
gathered ``[n, R, F/n]`` to ``[R, F]`` (``transpose(1, 0, 2)`` in the
reference too, :722) is PyTorch. ``fused_ag_bucket``'s TPU kernel is the
ring of remote copies that places each row in its slot; its port is the
same ring (below, row 11): NCCL send/recv hops forward the rows, and the
hand-written copy of ``csrc/ag_bucket.cu`` places each ring step's row
in its slot of the output.

What bounds them on an H100: at decode (R = 8 rows) the GEMM reads its
weight shard once (bytes: 2048 x 512 bf16 is 2.1 MB, 0.6 us at 3.35
TB/s), and the all-gather moves R x F x (n - 1) / n elements per rank,
a few KB: latency, not NVLink's 450 GB/s. Fusing the two into one kernel
whose epilogue stores into the peers' buffers over NVLink (CUDA IPC,
flag synchronisation) is later work (ROADMAP Queue B 11-13).

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
@functools.lru_cache(maxsize=None)
def _ag_library():
    lib = load_library("ag_bucket", "ag_bucket.cu")
    p = ctypes.c_void_p
    lib.ag_bucket_step_launch.argtypes = [p, p, ctypes.c_longlong, p]
    lib.ag_bucket_step_launch.restype = ctypes.c_int
    lib.ag_bucket_error_string.argtypes = [ctypes.c_int]
    lib.ag_bucket_error_string.restype = ctypes.c_char_p
    return lib


def build_ag_bucket():
    """Build (or load the cached build of) row 11's kernel library now."""
    _ag_library()


def ag_bucket_step(src, dst):
    """One ring step of row 11 through the kernel: ``dst`` (a slot of the
    output) <- ``src`` (the step's row), CUDA rows of one dtype and
    length; returns ``dst``. Raises for what the kernel does not take."""
    why = []
    for name, t in (("src", src), ("dst", dst)):
        if t.device.type != "cuda":
            why.append(f"{name} on {t.device}, not cuda")
        if t.dim() != 1 or not t.is_contiguous():
            why.append(f"{name} is not a contiguous row")
    if src.dtype != dst.dtype or src.shape != dst.shape or \
            src.device != dst.device:
        why.append(f"src {src.dtype} {tuple(src.shape)} and dst "
                   f"{dst.dtype} {tuple(dst.shape)} differ")
    if why:
        raise ValueError("ag_bucket kernel: " + "; ".join(why))
    lib = _ag_library()
    with torch.cuda.device(src.device):
        rc = lib.ag_bucket_step_launch(
            src.data_ptr(), dst.data_ptr(), src.numel() * src.element_size(),
            torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ag_bucket kernel launch failed ({rc}): "
                           f"{lib.ag_bucket_error_string(rc).decode()}")
    fused_ag_bucket.launches += 1
    return dst


def fused_ag_bucket(row, group):
    """Row 11: (cols,) on every rank -> (n, cols) in rank order. CUDA rows
    run the ring: the row goes to the right and each received row is
    forwarded as it arrived (n - 1 NCCL hops), while a kernel launch per
    ring step places the step's row in its slot. CPU rows take
    ``ag_bucket_plain``. Counts its calls (``.calls``), launches
    (``.launches``) and calls by row length (``.shapes``)."""
    if row.device.type == "cpu":
        return ag_bucket_plain(row, group)
    if row.device.type != "cuda":
        raise ValueError(f"fused all-gather runs on cuda or cpu, not "
                         f"{row.device}")
    if row.dim() != 1 or not row.is_contiguous():
        raise ValueError(f"fused_ag_bucket takes a contiguous flat row, got "
                         f"shape {tuple(row.shape)}")
    n, idx = group.n, group.rank
    out = torch.empty((n,) + tuple(row.shape), dtype=row.dtype,
                      device=row.device)
    hop = group.ring_shift_async(row) if n > 1 else None
    ag_bucket_step(row, out[idx])
    for t in range(1, n):
        recv = hop.wait()
        if t < n - 1:
            hop = group.ring_shift_async(recv)
        ag_bucket_step(recv, out[(idx - t) % n])
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
# ("part + received"). The hops are NCCL send/recv pairs
# (``MPGroup.ring_shift_async``); each ring step launches the hand-written
# elementwise pass of ``csrc/rs_bucket.cu``, which writes the next hop's
# send buffer (and, at the last step, the output row) from the received
# row and this step's part. It is the same IEEE fp32 add and the same
# round-to-nearest-even cast as the plain version's, so the two are equal
# bit for bit. The ``/ n`` mean and the cast back to the bucket dtype stay
# with the caller, as in the reference (grad_comm.py:306-309).
RS_PART_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RS_WIRE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rs_bucket_step_plain(part, recv, wire_dtype):
    """One ring step: (acc, acc cast to the wire) with acc = part in fp32
    at the first step (``recv`` None), else float(recv) + part."""
    acc = part.float() if recv is None else recv.float() + part.float()
    return acc, acc.to(wire_dtype)


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
        acc, _ = rs_bucket_step_plain(x[(idx - t - 1) % n], recv, wire)
    return acc


@functools.lru_cache(maxsize=None)
def _rs_library():
    lib = load_library("rs_bucket", "rs_bucket.cu")
    p = ctypes.c_void_p
    lib.rs_bucket_step_launch.argtypes = [ctypes.c_int, ctypes.c_int, p, p,
                                          p, p, ctypes.c_longlong, p]
    lib.rs_bucket_step_launch.restype = ctypes.c_int
    lib.rs_bucket_error_string.argtypes = [ctypes.c_int]
    lib.rs_bucket_error_string.restype = ctypes.c_char_p
    return lib


def build_rs_bucket():
    """Build (or load the cached build of) row 10's kernel library now."""
    _rs_library()


def _ptr(t):
    return None if t is None else t.data_ptr()


def rs_bucket_step(part, recv, wire_dtype, out=True, send=True):
    """One ring step through the kernel on CUDA tensors: part (cols,) fp32
    or bf16, recv (cols,) in the wire dtype or None; returns (out fp32 or
    None, send in the wire dtype or None) as ``rs_bucket_step_plain``
    computes them. Raises for what the kernel does not take."""
    why = []
    if part.device.type != "cuda":
        why.append(f"part on {part.device}, not cuda")
    if part.dtype not in RS_PART_DTYPES:
        why.append(f"part dtype {part.dtype} not float32/bfloat16")
    if wire_dtype not in RS_WIRE_DTYPES:
        why.append(f"wire dtype {wire_dtype} not float32/bfloat16")
    if part.dim() != 1 or not part.is_contiguous():
        why.append("part is not a contiguous row")
    if recv is not None and (recv.dtype != wire_dtype or
                             recv.shape != part.shape or
                             recv.device != part.device or
                             not recv.is_contiguous()):
        why.append("recv is not a contiguous row of the wire dtype beside "
                   "part")
    if not (out or send):
        why.append("neither out nor send asked for")
    if why:
        raise ValueError("rs_bucket kernel: " + "; ".join(why))
    o = torch.empty(part.shape, dtype=torch.float32, device=part.device) \
        if out else None
    s = torch.empty(part.shape, dtype=wire_dtype, device=part.device) \
        if send else None
    lib = _rs_library()
    with torch.cuda.device(part.device):
        rc = lib.rs_bucket_step_launch(
            RS_PART_DTYPES[part.dtype], RS_WIRE_DTYPES[wire_dtype],
            part.data_ptr(), _ptr(recv), _ptr(o), _ptr(s), part.numel(),
            torch.cuda.current_stream(part.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rs_bucket kernel launch failed ({rc}): "
                           f"{lib.rs_bucket_error_string(rc).decode()}")
    fused_rs_bucket.launches += 1
    return o, s


def fused_rs_bucket(x, group, wire_dtype=None):
    """Row 10: (n, cols) local gradient rows -> this rank's (cols,) fp32
    row summed over ``group``'s n ranks, each hop at ``wire_dtype`` (None:
    fp32; or bf16). CUDA tensors run the ring: n kernel launches (one per
    ring step) and n - 1 NCCL hops; CPU tensors take ``rs_bucket_plain``.
    Counts its calls (``.calls``), launches (``.launches``) and calls by
    (cols, wire) (``.shapes``)."""
    if x.device.type == "cpu":
        return rs_bucket_plain(x, group, wire_dtype)
    wire = wire_dtype or torch.float32
    if x.dim() != 2 or x.shape[0] != group.n or not x.is_contiguous():
        raise ValueError(f"fused_rs_bucket takes a contiguous ({group.n}, "
                         f"cols) bucket, got {tuple(x.shape)}")
    n, idx = group.n, group.rank
    out, hop = None, None
    for t in range(n):
        part = x[(idx - t - 1) % n]
        recv = hop.wait() if hop is not None else None
        last = t == n - 1
        out, send = rs_bucket_step(part, recv, wire, out=last,
                                   send=not last)
        if not last:
            hop = group.ring_shift_async(send)
    fused_rs_bucket.calls += 1
    fused_rs_bucket.shapes[(x.shape[1], str(wire)[6:])] += 1
    return out


def reset_rs_bucket_counts():
    fused_rs_bucket.launches = 0
    fused_rs_bucket.calls = 0
    fused_rs_bucket.shapes = collections.Counter()


reset_rs_bucket_counts()
