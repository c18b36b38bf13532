"""Ring all-gather + GEMM, GEMM + ring reduce-scatter and the ring weight
gradient of sequence-parallel training: the hand-written CUDA kernel
(``csrc/ring_gemm.cu``), its wrappers and their plain PyTorch versions
(counterpart of ``paddle_tpu/ops/pallas_kernels/fused_collectives.py``
:201-360 and :575-650, and of the ring algebra of
``paddle_tpu/distributed/tp_overlap.py:121-160`` and
``fused_collectives.py:993-1011``).

Replaces three TPU kernels, each a ring of n steps over an ``MPGroup``
(rank ``i``, right neighbour ``i + 1``):

* ``ring_ag_gemm`` (``_ag_gemm_kernel``): the seq shard x [B, s, A] rings
  past every rank; step t GEMMs the chunk in hand, owned by
  ``src = (i - t) mod n``, against w [A, F] into block-row ``src`` of the
  output [B, n*s, F];
* ``ring_gemm_rs`` (``_gemm_rs_kernel``): step t GEMMs the rows of chunk
  ``c = (i - t - 1) mod n`` of the partial y [B, S, F] against w [F, A]
  and adds them, in fp32, to the traveling accumulator just received
  (``recv + part``); after n steps rank i holds chunk i summed over the
  ranks, [B, s, A];
* ``ring_ag_accum`` (``_ag_accum_kernel``): the ring operand r [B, s, A]
  rings past as in ``ring_ag_gemm`` and step t adds ``r_src^T @
  stat_src`` (stat's rows of chunk src) to an fp32 [A, Bf] sum: the
  weight gradient of both.

The TPU kernels move chunks with in-kernel remote DMAs; here a hop is an
NCCL point-to-point pair outside the kernel (``MPGroup.ring_shift_async``)
and each step launches one GEMM of ``csrc/ring_gemm.cu``, whose epilogue
does the ring's arithmetic (the block-row store, ``recv + part``, ``+=``).
``ring_ag_gemm`` and ``ring_ag_accum`` post hop t+1 before step t's GEMM,
so the transfer runs under the GEMM; ``ring_gemm_rs`` waits for the
partial it adds and then launches (see the source's note).
``transpose_w`` reads a weight stored [F, A] as its transpose in the
kernel (the backward's ``w^T``), without a copy.

Beside each, its plain version (``ag_gemm_plain``, ``gemm_rs_plain``,
``ag_accum_plain``): the same ring schedule over the group's blocking hops
with fp32 products and sums (``tp_overlap``'s ring rung runs the same
loops in the compute dtype, so in fp32 the two are the same bits). The
wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise. Each wrapper counts its kernel's
launches (``.launches``, n per call), its calls (``.calls``) and its
calls by shape (``.shapes``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..cuda_build import load_library

MODES = {"NN": 0, "NT": 1, "TN": 2}

# The kernel against its plain version, per element:
# |kernel - plain| <= ELEMENT_TOL * (|plain| + rms of plain's row), and
# per 128-row tile ||kernel - plain|| <= TILE_TOL * ||plain||. Both sum
# exact bf16 products in fp32, in different orders; a bf16 output rounds
# once in each (up to 2^-8 relative apart where the sums straddle a
# rounding boundary), an fp32 output differs by summation order only.
ELEMENT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TILE_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
TILE_ROWS = 128


def error_vs_plain(got, want):
    """Readings of a kernel output against the plain version's, over its
    rows (the last dim is the row): max abs error, the worst element's
    error over (|plain| + row rms), the worst 128-row tile's relative L2
    error."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    err = (g - w).abs()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    element = float((err / (w.abs() + rms).clamp(min=1e-30)).max())
    tile = 0.0
    for lo in range(0, g.shape[0], TILE_ROWS):
        d = (g[lo:lo + TILE_ROWS] - w[lo:lo + TILE_ROWS]).norm()
        tile = max(tile, float(d / w[lo:lo + TILE_ROWS].norm().clamp(
            min=1e-30)))
    return {"max_abs": float(err.max()), "element": element, "tile": tile}


def within_tolerance(readings, dtype):
    return (readings["element"] <= ELEMENT_TOL[dtype]
            and readings["tile"] <= TILE_TOL[dtype])


def unsupported_reason(M, N, K, dtype):
    """Why the kernel cannot run a step GEMM of [M, K] x [K, N] on
    ``dtype`` operands, or None."""
    reasons = []
    for name, v in (("rows", M), ("columns", N), ("contraction", K)):
        if v % 16:
            reasons.append(f"{name} {v} not a multiple of 16")
    if dtype != torch.bfloat16:
        reasons.append(f"operands {dtype} not bfloat16")
    return "; ".join(reasons) or None


# ----------------------------------------------------------- plain versions
def _mm32(a, b):
    """a @ b with fp32 products and sums (exact products of bf16 values)."""
    return a.float() @ b.float()


def _chunk_mm(mm, a, w):
    """``mm`` of a chunk [B, s, K] with w [K, N] as one 2-D product over
    its B*s rows: [B, s, N]. Always 2-D, so the same BLAS call runs
    whether or not autograd records it (3-D matmul picks its kernel by
    ``requires_grad``, which changes the summation order)."""
    return mm(a.reshape(-1, a.shape[-1]), w).view(a.shape[:-1] + (-1,))


def ring_ag(x, w, group, mm, shift):
    """The ring all-gather + GEMM schedule: step t GEMMs the chunk in hand
    (``mm``) into block-row ``(rank - t) mod n``, then ``shift``s it to
    the right neighbour; returns [B, n*s, F]."""
    n, rank = group.n, group.rank
    parts = [None] * n
    chunk = x
    for t in range(n):
        parts[(rank - t) % n] = _chunk_mm(mm, chunk, w)
        if t < n - 1:
            chunk = shift(chunk)
    return torch.cat(parts, dim=1)


def ring_rs(y, w, group, mm, shift):
    """The GEMM + ring reduce-scatter schedule: step t adds ``mm`` of the
    rows of chunk ``(rank - t - 1) mod n`` to the accumulator just
    received (``recv + part``) and ``shift``s it on; returns this rank's
    chunk [B, s, A] summed over the ranks, in ``mm``'s dtype."""
    n, rank = group.n, group.rank
    s = y.shape[1] // n
    acc = None
    for t in range(n):
        c = (rank - t - 1) % n
        part = _chunk_mm(mm, y[:, c * s:(c + 1) * s], w)
        acc = part if acc is None else acc + part
        if t < n - 1:
            acc = shift(acc)
    return acc


def ag_gemm_plain(x, w, group, transpose_w=False):
    """x [B, s, A] @ w [A, F] (``transpose_w``: w stored [F, A]) over the
    ring: [B, n*s, F] in x's dtype, each block-row rounded once."""
    w = w.t() if transpose_w else w
    return ring_ag(x, w, group, lambda a, b: _mm32(a, b).to(x.dtype),
                   group.ring_shift)


def gemm_rs_plain(y, w, group, transpose_w=False):
    """y [B, S, F] @ w [F, A] (``transpose_w``: w stored [A, F]) reduced
    over the ring in fp32: this rank's chunk [B, S/n, A] in y's dtype."""
    w = w.t() if transpose_w else w
    return ring_rs(y, w, group, _mm32, group.ring_shift).to(y.dtype)


def ag_accum_plain(r, stat, group, transpose=False):
    """fp32 sum over the ring steps of ``r_src^T @ stat_src`` ([A, Bf]; with
    ``transpose`` its transpose [Bf, A]), r [B, s, A] the ring operand,
    stat [B, S, Bf] stationary."""
    n, rank = group.n, group.rank
    s = r.shape[1]
    acc = None
    chunk = r
    for t in range(n):
        src = (rank - t) % n
        st = stat[:, src * s:(src + 1) * s]
        part = _mm32(chunk.reshape(-1, chunk.shape[-1]).t(),
                     st.reshape(-1, st.shape[-1]))
        acc = part if acc is None else acc + part
        if t < n - 1:
            chunk = group.ring_shift(chunk)
    return acc.t().contiguous() if transpose else acc


# ----------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("ring_gemm", "ring_gemm.cu")
    row = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
           ctypes.c_int]
    lib.ring_gemm_launch.argtypes = (
        [ctypes.c_int] + row * 3 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.ring_gemm_launch.restype = ctypes.c_int
    lib.ring_gemm_error_string.argtypes = [ctypes.c_int]
    lib.ring_gemm_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library now."""
    _library()


def _rows(t, offset=0, ld=None, bstride=0, rpb=1 << 30):
    """(pointer, ld, batch stride, rows per batch) of an operand's storage
    rows: ``offset`` elements into ``t``; rows ``ld`` apart, in batches of
    ``rpb`` rows ``bstride`` apart."""
    return [t.data_ptr() + offset * t.element_size(),
            t.shape[-1] if ld is None else ld, bstride, rpb]


def launch(mode, a, b, c, M, N, K, out_bf16, addend, device):
    """One step GEMM on ``device``'s current stream: C[M, N] = addend + A @
    B (``MODES``; ``addend`` an fp32 [M, N] pointer or None), each
    operand's storage rows as ``_rows`` gives them."""
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.ring_gemm_launch(
            MODES[mode], *a, *b, *c, int(out_bf16), addend, M, N, K,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring GEMM kernel launch failed ({rc}): "
                           f"{lib.ring_gemm_error_string(rc).decode()}")


def _check(what, ts, M, N, K):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    why = unsupported_reason(M, N, K, ts[0].dtype)
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
        if t.dtype != ts[0].dtype:
            why = (why + "; " if why else "") + \
                f"operand dtypes {ts[0].dtype} and {t.dtype} differ"
        if not t.is_contiguous():
            why = (why + "; " if why else "") + "an operand is not contiguous"
        elif t.data_ptr() % 16:
            why = (why + "; " if why else "") + "an operand is not 16-byte " \
                "aligned"
    if why:
        raise ValueError(f"{what} kernel: {why}")


def ring_ag_gemm(x, w, group, transpose_w=False):
    """Ring all-gather + GEMM: x [B, s, A] (this rank's seq shard) @ w
    [A, F] (``transpose_w``: w stored [F, A]) -> [B, n*s, F] in x's dtype.
    CPU tensors take ``ag_gemm_plain``; CUDA tensors launch the kernel n
    times, one per ring step, or raise."""
    if x.device.type == "cpu":
        return ag_gemm_plain(x, w, group, transpose_w)
    B, s, A = x.shape
    F, Kw = (w.shape if transpose_w else w.shape[::-1])
    if Kw != A:
        raise ValueError(f"ring_ag_gemm: x [B, s, {A}] and w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) "
                         f"disagree")
    M = B * s
    _check("ring_ag_gemm", (x, w), M, F, A)
    n, rank = group.n, group.rank
    out = torch.empty((B, n * s, F), dtype=x.dtype, device=x.device)
    mode = "NT" if transpose_w else "NN"
    chunk = x
    for t in range(n):
        src = (rank - t) % n
        hop = group.ring_shift_async(chunk) if t < n - 1 else None
        launch(mode, _rows(chunk), _rows(w),
               _rows(out, src * s * F, F, n * s * F, s), M, F, A, True, None,
               x.device)
        ring_ag_gemm.launches += 1
        if hop is not None:
            chunk = hop.wait()
    ring_ag_gemm.calls += 1
    ring_ag_gemm.shapes[(M, A, F, transpose_w)] += 1
    return out


def ring_gemm_rs(y, w, group, transpose_w=False):
    """GEMM + ring reduce-scatter: y [B, S, F] (this rank's partial) @ w
    [F, A] (``transpose_w``: w stored [A, F]), summed over the ranks in
    fp32 on the ring: this rank's seq shard [B, S/n, A] in y's dtype. CPU
    tensors take ``gemm_rs_plain``; CUDA tensors launch the kernel n
    times, or raise."""
    if y.device.type == "cpu":
        return gemm_rs_plain(y, w, group, transpose_w)
    B, S, F = y.shape
    A, Kw = (w.shape if transpose_w else w.shape[::-1])
    n, rank = group.n, group.rank
    if Kw != F or S % n:
        raise ValueError(f"ring_gemm_rs: y {tuple(y.shape)} and w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) "
                         f"disagree, or {S} rows not divisible by {n}")
    s = S // n
    M = B * s
    _check("ring_gemm_rs", (y, w), M, A, F)
    mode = "NT" if transpose_w else "NN"
    f32 = dict(dtype=torch.float32, device=y.device)
    recv = None
    for t in range(n):
        c = (rank - t - 1) % n
        last = t == n - 1
        acc = torch.empty((B, s, A), dtype=y.dtype, device=y.device) \
            if last else torch.empty((M, A), **f32)
        launch(mode, _rows(y, c * s * F, F, S * F, s), _rows(w),
               _rows(acc, 0, A), M, A, F, last,
               None if recv is None else recv.data_ptr(), y.device)
        ring_gemm_rs.launches += 1
        if not last:
            recv = group.ring_shift_async(acc).wait()
    ring_gemm_rs.calls += 1
    ring_gemm_rs.shapes[(M, F, A, transpose_w)] += 1
    return acc


def ring_ag_accum(r, stat, group, transpose=False):
    """Ring weight gradient: the fp32 sum over the ring steps of ``r_src^T
    @ stat_src`` -> [A, Bf] (``transpose``: [Bf, A], computed as
    ``stat_src^T @ r_src``), r [B, s, A] ringing past, stat [B, S, Bf]
    stationary. CPU tensors take ``ag_accum_plain``; CUDA tensors launch
    the kernel n times, or raise."""
    if r.device.type == "cpu":
        return ag_accum_plain(r, stat, group, transpose)
    B, s, A = r.shape
    n, rank = group.n, group.rank
    Bs, S, Bf = stat.shape
    if Bs != B or S != n * s:
        raise ValueError(f"ring_ag_accum: r {tuple(r.shape)} and stat "
                         f"{tuple(stat.shape)} disagree (stat must be "
                         f"[B, n*s, Bf])")
    K = B * s
    M, N = (Bf, A) if transpose else (A, Bf)
    _check("ring_ag_accum", (r, stat), M, N, K)
    out = torch.empty((M, N), dtype=torch.float32, device=r.device)
    chunk = r
    for t in range(n):
        src = (rank - t) % n
        hop = group.ring_shift_async(chunk) if t < n - 1 else None
        ring_rows = _rows(chunk)
        stat_rows = _rows(stat, src * s * Bf, Bf, S * Bf, s)
        a, b = (stat_rows, ring_rows) if transpose else (ring_rows,
                                                          stat_rows)
        launch("TN", a, b, _rows(out), M, N, K, False,
               out.data_ptr() if t > 0 else None, r.device)
        ring_ag_accum.launches += 1
        if hop is not None:
            chunk = hop.wait()
    ring_ag_accum.calls += 1
    ring_ag_accum.shapes[(K, M, N, transpose)] += 1
    return out


KERNELS = (ring_ag_gemm, ring_gemm_rs, ring_ag_accum)


def reset_counts():
    for k in KERNELS:
        k.launches = 0
        k.calls = 0
        k.shapes = collections.Counter()


reset_counts()
