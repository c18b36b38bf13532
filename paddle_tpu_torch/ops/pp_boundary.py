"""The pipeline-boundary kernels of the fused pp rung: the stage's last GEMM
with its hop to the next stage, and its backward (counterpart of
``paddle_tpu/ops/pallas_kernels/fused_collectives.py:776-970``).

Replaces two TPU kernels:

* row 14, ``_gemm_ppsend_kernel`` (:792, via ``fused_gemm_ppsend`` :925):
  the stage tail ``y = r + (x @ w + b)`` (x the last block's gelu
  activation [R, 4H], w its down projection [4H, H], r the residual
  [R, H]), y sent to the next stage. Here ``gemm_ppsend`` launches the
  hand-written wgmma GEMM of ``csrc/pp_gemm.cu`` (TMA-fed, 128 x 256
  tiles) with its bias + residual epilogue, one launch over all R rows,
  and ``FusedGemmPpSend`` posts y's hop on NCCL's stream after it;
* row 15, ``_gemm_pprecv_kernel`` (:826): the backward. ``FusedGemmPpSend``
  waits for the next stage's cotangent of y (``gwire``, the reverse hop),
  and ``gemm_pprecv`` launches the elementwise kernel ``dr = gy + gwire``
  and then one GEMM launch holding both products' tiles: mode NT for
  ``dx = dr @ w^T`` (bf16) and mode TN for ``dw = x^T @ dr`` (fp32);
  ``db`` is ``dr`` summed over the caller's ``rows`` split outside the
  kernels, as at :964-969.

The TPU kernel sends y in C chunks from its epilogue and consumes the
received cotangent chunk by chunk; one receive and one add launch stand
for that here (see the source's note for what a chunked, epilogue-driven
send would need).

Beside them, the plain versions (``gemm_ppsend_plain``,
``gemm_pprecv_plain``): the reference's unfused algebra (:942-970) in
PyTorch, with the op order of the block tail ``r + (x @ w + b)`` and the
products autograd takes for it (``dr @ w^T``, ``x^T @ dr``), so on the CPU
the fused rung is the ring rung bit for bit. The wrappers take the plain
version for CPU tensors only; for CUDA tensors they launch the kernels or
raise. Each counts its calls (``.calls``) and kernel launches
(``.launches``: one for row 14, two for row 15). ``pprecv_gemms`` runs row
15's GEMM launch alone, for one product or both (the products timed
apart; not counted).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..cuda_build import load_library, wait_record
from . import ring_gemm as rg
# the kernels against their plain versions: ring_gemm's readings and gates
from .ring_gemm import (ELEMENT_TOL, TILE_TOL, error_vs_plain,  # noqa: F401
                        within_tolerance)


def unsupported_reason(R, K, F, dtype):
    """Why the kernels cannot run the tail of [R, K] x [K, F] on ``dtype``
    operands, or None."""
    return rg.unsupported_reason(R, F, K, dtype)


# ----------------------------------------------------------- plain versions
def _rows2(t):
    return t.reshape(-1, t.shape[-1])


def gemm_ppsend_plain(x, w, b, r):
    """``r + (x @ w + b)``, the reference's op order (each op rounded in
    the operands' dtype); x [..., K], r [..., F]."""
    return r + (x @ w + b)


def _products_plain(dr, x, w, products=("dx", "dw")):
    """(dx, dw) of ``gemm_pprecv_plain`` from dr, each None unless named
    in ``products``."""
    dr2 = _rows2(dr)
    return (dr2.mm(w.t()).view(x.shape) if "dx" in products else None,
            _rows2(x).t().float().mm(dr2.float())
            if "dw" in products else None)


def gemm_pprecv_plain(gy, gwire, x, w, rows=None):
    """The backward of the tail from its two cotangents: (dx, dw, db, dr)
    with ``dr = gy + gwire``, ``dx = dr @ w^T`` in the operands' dtype,
    ``dw = x^T @ dr`` with fp32 products and sums (a no-op cast in fp32),
    and ``db`` = dr summed over the leading dims of ``rows`` (default: all
    but the last) in dr's dtype. x [..., K], w [K, F], gwire [..., F]."""
    dr = gy + gwire
    dx, dw = _products_plain(dr, x, w)
    rows = tuple(dr.shape[:-1]) if rows is None else tuple(rows)
    db = dr.reshape(rows + (dr.shape[-1],)).sum(tuple(range(len(rows))))
    return dx, dw, db, dr


# ----------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("pp_gemm", "pp_gemm.cu")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pp_send_gemm_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.pp_recv_gemm_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.pp_add_launch.argtypes = [p, p, p, ll, p]
    for name in ("pp_send_gemm_launch", "pp_recv_gemm_launch",
                 "pp_add_launch"):
        getattr(lib, name).restype = i
    lib.pp_gemm_wait_record.argtypes = [p]
    lib.pp_gemm_wait_record.restype = None
    lib.pp_gemm_error_string.argtypes = [i]
    lib.pp_gemm_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library now."""
    _library()


def wait_timeout_record():
    """The record of rows 14-15's first mbarrier wait that timed out (a
    dict of ``cuda_build.WAIT_RECORD_FIELDS``), or None."""
    return wait_record(_library().pp_gemm_wait_record)


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed ({rc}): "
                           f"{_library().pp_gemm_error_string(rc).decode()}"
                           f"; mbarrier wait record: {wait_timeout_record()}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _recv_gemms(dr, x, w, dx, dw, which, dev):
    """Row 15's GEMM launch on ``dev``'s current stream: dx [R, K] = dr @
    w^T (bf16) if ``which & 1``, dw [K, F] = x^T @ dr (fp32) if ``which &
    2``; contiguous operands."""
    K, F = w.shape
    with torch.cuda.device(dev):
        rc = _library().pp_recv_gemm_launch(
            dr.data_ptr(), x.data_ptr(), w.data_ptr(),
            0 if dx is None else dx.data_ptr(),
            0 if dw is None else dw.data_ptr(), x.numel() // K, K, F, which,
            _stream(dev))
    _raise_on(rc, "gemm_pprecv GEMM")


def gemm_ppsend(x, w, b, r):
    """Row 14: ``y = r + (x @ w + b)``, x [..., K], w [K, F], b [F], r
    [..., F] -> y shaped like r. CPU tensors take ``gemm_ppsend_plain``;
    CUDA tensors launch the kernel once over all rows, or raise."""
    if x.device.type == "cpu":
        return gemm_ppsend_plain(x, w, b, r)
    K, F = w.shape
    R = x.numel() // K
    if x.shape[-1] != K or tuple(r.shape[:-1]) != tuple(x.shape[:-1]) or \
            r.shape[-1] != F or tuple(b.shape) != (F,):
        raise ValueError(f"gemm_ppsend: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} and r "
                         f"{tuple(r.shape)} disagree")
    rg._check("gemm_ppsend", (x, w, b, r), R, F, K)
    y = torch.empty_like(r)
    with torch.cuda.device(x.device):
        rc = _library().pp_send_gemm_launch(x.data_ptr(), w.data_ptr(),
                                            b.data_ptr(), r.data_ptr(),
                                            y.data_ptr(), R, K, F,
                                            _stream(x.device))
    _raise_on(rc, "gemm_ppsend")
    gemm_ppsend.launches += 1
    gemm_ppsend.calls += 1
    return y


def gemm_pprecv(gy, gwire, x, w, rows=None):
    """Row 15: (dx, dw, db, dr) as ``gemm_pprecv_plain`` gives them (dw in
    fp32). CPU tensors take the plain version; CUDA tensors launch the
    add and the GEMM of both products, or raise."""
    if gwire.device.type == "cpu":
        return gemm_pprecv_plain(gy, gwire, x, w, rows)
    K, F = w.shape
    R = x.numel() // K
    if x.shape[-1] != K or gwire.numel() != R * F or \
            gy.shape != gwire.shape:
        raise ValueError(f"gemm_pprecv: gy {tuple(gy.shape)}, gwire "
                         f"{tuple(gwire.shape)}, x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} disagree")
    rg._check("gemm_pprecv", (gy, gwire, x, w), R, F, K)
    dev = x.device
    dr = torch.empty_like(gwire)
    with torch.cuda.device(dev):
        rc = _library().pp_add_launch(gy.data_ptr(), gwire.data_ptr(),
                                      dr.data_ptr(), dr.numel(),
                                      _stream(dev))
    _raise_on(rc, "gemm_pprecv add")
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dw = torch.empty((K, F), dtype=torch.float32, device=dev)
    _recv_gemms(dr, x, w, dx, dw, 3, dev)
    gemm_pprecv.launches += 2
    gemm_pprecv.calls += 1
    rows = tuple(dr.shape[:-1]) if rows is None else tuple(rows)
    db = dr.reshape(rows + (F,)).sum(tuple(range(len(rows))))
    return dx, dw, db, dr


def pprecv_gemms(dr, x, w, products=("dx", "dw")):
    """Row 15's GEMM launch alone on a given dr [..., F]: (dx, dw) as
    ``gemm_pprecv`` computes them, each None unless named in
    ``products`` (one launch runs the ones named: the products of a call
    timed apart from the add and from each other). CPU tensors take the
    plain products. Not counted."""
    K, F = w.shape
    if dr.device.type == "cpu":
        return _products_plain(dr, x, w, products)
    R = x.numel() // K
    if x.shape[-1] != K or dr.numel() != R * F:
        raise ValueError(f"pprecv_gemms: dr {tuple(dr.shape)}, x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)} disagree")
    rg._check("pprecv_gemms", (dr, x, w), R, F, K)
    which = ("dx" in products) + 2 * ("dw" in products)
    if not which:
        raise ValueError(f"pprecv_gemms: no product in {products}")
    dev = x.device
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev) \
        if "dx" in products else None
    dw = torch.empty((K, F), dtype=torch.float32, device=dev) \
        if "dw" in products else None
    _recv_gemms(dr, x, w, dx, dw, which, dev)
    return dx, dw


KERNELS = (gemm_ppsend, gemm_pprecv)


def reset_counts():
    for k in KERNELS:
        k.launches = 0
        k.calls = 0


reset_counts()


# ------------------------------------------------- the fused boundary op
class FusedGemmPpSend(torch.autograd.Function):
    """``y = r + (x @ w + b)`` through row 14, y posted to the group's
    next rank; the backward waits for that rank's cotangent of what it
    received (the reverse hop) and runs row 15 on it plus y's own
    cotangent. ``post(hop)`` keeps the forward's posted hop until the
    caller waits for it. Neither hop may run inside a checkpoint: a
    recompute would post it again on this rank alone."""

    @staticmethod
    def forward(ctx, x, w, b, r, group, post):
        y = gemm_ppsend(x, w, b, r)
        post(group.stage_hops_async(send_next=y))
        ctx.save_for_backward(x, w)
        ctx.group = group
        ctx.meta = (tuple(y.shape), y.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        shape, dtype, b_dtype = ctx.meta
        _, gwire = ctx.group.stage_hops_async(
            recv_next=(shape, dtype)).wait()
        dx, dw, db, dr = gemm_pprecv(gy, gwire, x, w)
        return dx, dw.to(w.dtype), db.to(b_dtype), dr, None, None


def fused_gemm_ppsend(x, w, b, r, group, post):
    """The stage tail of the fused rung (``FusedGemmPpSend``): y, with its
    hop to ``group``'s next rank posted through ``post``."""
    return FusedGemmPpSend.apply(x, w, b, r, group, post)
