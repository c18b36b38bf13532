"""Ring all-gather + GEMM, GEMM + reduce-scatter and the ring weight
gradient of sequence-parallel training: the hand-written CUDA kernels
(``csrc/ag_gemm.cu``, ``csrc/gemm_rs.cu``), their wrappers and their
plain PyTorch versions (counterpart of
``paddle_tpu/ops/pallas_kernels/fused_collectives.py`` :201-360 and
:575-650, and of the ring algebra of
``paddle_tpu/distributed/tp_overlap.py:121-160`` and
``fused_collectives.py:993-1011``).

Replaces three TPU kernels, each a ring of n steps over an ``MPGroup``
(rank ``i``, right neighbour ``i + 1``):

* ``ring_ag_gemm`` (``_ag_gemm_kernel``): the seq shard x [B, s, A] rings
  past every rank; step t GEMMs the chunk in hand, owned by
  ``src = (i - t) mod n``, against w [A, F] into block-row ``src`` of the
  output [B, n*s, F];
* ``ring_gemm_rs`` (``_gemm_rs_kernel``): the partial y [B, S, F] @ w
  [F, A], chunk by chunk, reduced over the ranks in fp32: rank i holds
  chunk i summed over the ranks, [B, s, A], in the ring's order
  ``((p_{i+1} + p_{i+2}) + ...) + p_i``;
* ``ring_ag_accum`` (``_ag_accum_kernel``): the ring operand r [B, s, A]
  rings past as in ``ring_ag_gemm`` and step t adds ``r_src^T @
  stat_src`` (stat's rows of chunk src) to an fp32 [A, Bf] sum: the
  weight gradient of both.

The TPU kernels move chunks with in-kernel remote DMAs. Here every chunk
moves through symmetric peer buffers (``distributed/peer.py``), with no
NCCL hop and no host round trip. Rows 7 and 9 (one channel,
``"ag_gemm"``, 2 + n bf16 slots of a chunk): a pull launch of
``csrc/ag_gemm.cu`` publishes this rank's chunk into its slot and copies
each peer's chunk over NVLink into a local gather slot, while the GEMM
launch (wgmma, row 8's core) computes the own chunk, then each remote
chunk as it lands; row 9 sums the chunks' fp32 partials in the ring's
order. Row 8 (channel ``"gemm_rs"``): one launch of ``csrc/gemm_rs.cu``'s
wgmma GEMM computes every chunk, remote chunks first, and its epilogue
stores each remote tile straight into the destination rank's slot over
NVLink; a second launch at the destination sums the slots in the ring's
order. Given the same partials each sum is the plain ring's bit for bit.
``transpose_w`` reads a weight stored [F, A] as its transpose in the
kernel (the backward's ``w^T``), without a copy.

Beside each, its plain version (``ag_gemm_plain``, ``gemm_rs_plain``,
``ag_accum_plain``): the same ring schedule over the group's blocking hops
with fp32 products and sums (``tp_overlap``'s ring rung runs the same
loops in the compute dtype, so in fp32 the two are the same bits).
``ag_gemm_peer_plain``, ``gemm_rs_peer_plain`` and ``ag_accum_peer_plain``
are the peer schedules in plain form over every rank's inputs at once.
The wrappers take the plain version for CPU tensors only; for CUDA
tensors they launch the kernels or raise. Each wrapper counts its kernel
launches (``.launches``: two per call, the pull and the GEMM for rows 7
and 9, the GEMM and the reduce for row 8), its calls (``.calls``) and its
calls by shape (``.shapes``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..cuda_build import load_library
from ..distributed import peer as _peer

MODES = {"NN": 0, "NT": 1, "TN": 2}
RS_CHANNEL = "gemm_rs"      # row 8's peer channel: 2n fp32 slots of a chunk
RS_TILE_ROWS = 128          # csrc/gemm_rs.cu's kBM: s must be a multiple
# rows 7 and 9's peer channel: 2 + n bf16 slots of a chunk (this rank's
# chunk by call parity, then the gather slots). The two rows share it: their
# calls run in stream order and the pad's call counter numbers them as one
# sequence, so a slot is reused only after its readers have freed it,
# whichever row wrote it
AG_CHANNEL = "ag_gemm"
ACCUM_TILE_ROWS = 64        # csrc/ag_gemm.cu's kBK: row 9's s a multiple
ACCUM_MAX_TILES = 1024      # row 9's counters a call (peer_barrier.cuh)

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


def ring_order_sum(parts, rank):
    """Rank ``rank``'s chunk from the fp32 partials of every rank
    (``parts[src]``), summed in the ring's order: src = rank + 1 first,
    rank itself last, one fp32 add a term (``ring_rs``'s arithmetic)."""
    n = len(parts)
    acc = parts[(rank + 1) % n]
    for k in range(2, n + 1):
        acc = acc + parts[(rank + k) % n]
    return acc


def gemm_rs_peer_plain(ys, ws, transpose_w=False):
    """Row 8's peer schedule in plain form over all n ranks' inputs (``ys``
    [B, S, F], ``ws`` [F, A] or stored [A, F], one per rank): every rank's
    fp32 partial of chunk c goes into slot [c][src] (``_mm32``), then each
    destination sums its slots in the ring's order. Returns every rank's
    chunk [B, S/n, A] in y's dtype; the same bits as ``gemm_rs_plain`` on
    each rank."""
    n = len(ys)
    s = ys[0].shape[1] // n
    slots = [[None] * n for _ in range(n)]
    for src, (y, w) in enumerate(zip(ys, ws)):
        w = w.t() if transpose_w else w
        for c in range(n):
            slots[c][src] = _chunk_mm(_mm32, y[:, c * s:(c + 1) * s], w)
    return [ring_order_sum(slots[c], c).to(ys[0].dtype) for c in range(n)]


def ag_gemm_peer_plain(xs, w, transpose_w=False):
    """Row 7's peer schedule in plain form over all n ranks' chunks (``xs``
    [B, s, A], one per rank) for one rank's w [A, F] (``transpose_w``:
    stored [F, A]): each gathered chunk src GEMMed into block-row src of
    [B, n*s, F], rounded once to x's dtype. The same bits as that rank's
    ``ag_gemm_plain``."""
    w = w.t() if transpose_w else w
    return torch.cat([_chunk_mm(lambda a, b: _mm32(a, b).to(x.dtype), x, w)
                      for x in xs], dim=1)


def ag_accum_peer_plain(rs, stat, rank, transpose=False):
    """Row 9's peer schedule in plain form over all n ranks' ring operands
    (``rs`` [B, s, A], one per rank) for rank ``rank``'s stationary stat
    [B, n*s, Bf]: the fp32 partial of each chunk src = rank - t (``r_src^T
    @ stat_src``; ``transpose``: ``stat_src^T @ r_src``, [Bf, A]), summed
    in ring-step order t = 0, 1, ..., one fp32 add a term, as the kernel's
    last block of a tile sums them."""
    n, s = len(rs), rs[0].shape[1]
    acc = None
    for t in range(n):
        src = (rank - t) % n
        r = rs[src].reshape(-1, rs[src].shape[-1])
        st = stat[:, src * s:(src + 1) * s].reshape(-1, stat.shape[-1])
        part = _mm32(st.t(), r) if transpose else _mm32(r.t(), st)
        acc = part if acc is None else acc + part
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
def _rs_library():
    lib = load_library("gemm_rs", "gemm_rs.cu")
    p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
    lib.gemm_rs_launch.argtypes = [i, p, p, p] + [i] * 6 + [p, p, ll, p, p,
                                                            ull, ull, p]
    lib.gemm_rs_launch.restype = i
    lib.gemm_rs_local_launch.argtypes = [i, p, p, p] + [i] * 6 + [p]
    lib.gemm_rs_local_launch.restype = i
    lib.gemm_rs_wait_record.argtypes = [p]
    lib.gemm_rs_wait_record.restype = None
    lib.gemm_rs_error_string.argtypes = [i]
    lib.gemm_rs_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _ag_library():
    lib = load_library("ag_gemm", "ag_gemm.cu")
    p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
    peers = [p, p, ll, p, p, ull, ull, p]
    lib.ag_gemm_launch.argtypes = [i, p, p, p] + [i] * 6 + peers
    lib.ag_accum_launch.argtypes = [i, p, p, p, p] + [i] * 6 + peers
    lib.ag_gemm_local_launch.argtypes = [i, p, p, p] + [i] * 6 + [p]
    lib.ag_accum_local_launch.argtypes = [i, p, p, p, p, p] + [i] * 6 + [p]
    for name in ("ag_gemm_launch", "ag_accum_launch", "ag_gemm_local_launch",
                 "ag_accum_local_launch"):
        getattr(lib, name).restype = i
    lib.ag_accum_tiles.argtypes = [i] * 6
    lib.ag_accum_tiles.restype = i
    lib.ag_gemm_wait_record.argtypes = [p]
    lib.ag_gemm_wait_record.restype = None
    lib.ag_gemm_error_string.argtypes = [i]
    lib.ag_gemm_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached builds of) the kernel libraries now."""
    _rs_library()
    _ag_library()


def ag_wait_timeout_record():
    """The record of rows 7 and 9's first mbarrier wait that timed out (a
    dict of ``cuda_build.WAIT_RECORD_FIELDS``), or None."""
    from ..cuda_build import wait_record
    return wait_record(_ag_library().ag_gemm_wait_record)


def rs_wait_timeout_record():
    """The record of row 8's first mbarrier wait that timed out (a dict of
    ``cuda_build.WAIT_RECORD_FIELDS``), or None."""
    from ..cuda_build import wait_record
    return wait_record(_rs_library().gemm_rs_wait_record)


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


def _peer_group_reason(n):
    return (None if 2 <= n <= _peer.MAX_RANKS else
            f"a group of {n} ranks (the peer channels take 2 to "
            f"{_peer.MAX_RANKS})")


def _ag_shapes(x, w, n, transpose_w):
    """(B, s, A, F) of a row-7 call over n ranks, or ValueError when the
    operands disagree or the kernel cannot take them."""
    B, s, A = x.shape
    F, Kw = (w.shape if transpose_w else w.shape[::-1])
    if Kw != A:
        raise ValueError(f"ring_ag_gemm: x [B, s, {A}] and w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) "
                         f"disagree")
    _check("ring_ag_gemm", (x, w), B * s, F, A)
    why = _peer_group_reason(n)
    if why:
        raise ValueError(f"ring_ag_gemm kernel: {why}")
    return B, s, A, F


def _ag_channel(group, x):
    """``group``'s rows 7 and 9 channel with 2 + n slots of x's bytes, and
    the bytes between its slots (the same on every rank)."""
    k = 2 + group.n
    ch = _peer.channel(group, AG_CHANNEL, k * x.numel() * x.element_size())
    return ch, ch.capacity // k // 16 * 16


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ring_ag_gemm(x, w, group, transpose_w=False):
    """Ring all-gather + GEMM: x [B, s, A] (this rank's seq shard) @ w
    [A, F] (``transpose_w``: w stored [F, A]) -> [B, n*s, F] in x's dtype.
    CPU tensors take ``ag_gemm_plain``; CUDA tensors launch
    ``ag_gemm.cu``'s pull and GEMM (every rank's chunk gathered through
    the group's ``"ag_gemm"`` peer channel), or raise. Collective: every
    rank of ``group`` makes the same calls in the same order."""
    if x.device.type == "cpu":
        return ag_gemm_plain(x, w, group, transpose_w)
    B, s, A, F = _ag_shapes(x, w, group.n, transpose_w)
    n, rank = group.n, group.rank
    _peer.raise_for(0, 7, rank, None)          # an earlier kernel trapped
    ch, slot = _ag_channel(group, x)
    out = torch.empty((B, n * s, F), dtype=x.dtype, device=x.device)
    lib = _ag_library()
    with torch.cuda.device(x.device):
        rc = lib.ag_gemm_launch(
            MODES["NT" if transpose_w else "NN"], x.data_ptr(),
            w.data_ptr(), out.data_ptr(), B, s, A, F, n, rank,
            ch.data, ch.pads, slot, _peer.error_pointer(), ch.beats,
            ch.timeout_ns, ch.backstop_ns, _stream(x.device))
    _peer.raise_for(rc, 7, rank,
                    lambda c: lib.ag_gemm_error_string(c).decode())
    ring_ag_gemm.launches += 2
    ring_ag_gemm.calls += 1
    ring_ag_gemm.shapes[(B * s, A, F, transpose_w)] += 1
    return out


def ag_gemm_local(xs, w, rank, transpose_w=False):
    """Row 7's GEMM alone, without peers: every chunk of xs [n, B, s, A]
    (rank p's x at p) @ w into [B, n*s, F], in rank ``rank``'s order (the
    products of a call, timed apart from the transfer). Not counted."""
    n = xs.shape[0]
    B, s, A, F = _ag_shapes(xs[0], w, n, transpose_w)
    out = torch.empty((B, n * s, F), dtype=xs.dtype, device=xs.device)
    lib = _ag_library()
    with torch.cuda.device(xs.device):
        rc = lib.ag_gemm_local_launch(
            MODES["NT" if transpose_w else "NN"], xs.data_ptr(),
            w.data_ptr(), out.data_ptr(), B, s, A, F, n, rank,
            _stream(xs.device))
    if rc != 0:
        raise RuntimeError(f"row 7 GEMM launch failed ({rc}): "
                           f"{lib.ag_gemm_error_string(rc).decode()}")
    return out


def _rs_shapes(y, w, n, transpose_w):
    """(B, S, F, A, s) of a row-8 call over n ranks, or ValueError when the
    operands disagree or the kernel cannot take them."""
    B, S, F = y.shape
    A, Kw = (w.shape if transpose_w else w.shape[::-1])
    if Kw != F or S % n:
        raise ValueError(f"ring_gemm_rs: y {tuple(y.shape)} and w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}) "
                         f"disagree, or {S} rows not divisible by {n}")
    s = S // n
    _check("ring_gemm_rs", (y, w), B * s, A, F)
    why = []
    if s % RS_TILE_ROWS:
        why.append(f"a chunk of {s} rows is not a multiple of "
                   f"{RS_TILE_ROWS} (a tile would straddle a batch row)")
    if _peer_group_reason(n):
        why.append(_peer_group_reason(n))
    if why:
        raise ValueError("ring_gemm_rs kernel: " + "; ".join(why))
    return B, S, F, A, s


def ring_gemm_rs(y, w, group, transpose_w=False):
    """GEMM + reduce-scatter: y [B, S, F] (this rank's partial) @ w [F, A]
    (``transpose_w``: w stored [A, F]), summed over the ranks in fp32 in
    the ring's order: this rank's seq shard [B, S/n, A] in y's dtype. CPU
    tensors take ``gemm_rs_plain``; CUDA tensors launch ``gemm_rs.cu``'s
    GEMM (its remote tiles stored into the peers' slots) and its reduce,
    or raise. Collective: every rank of ``group`` makes the same calls in
    the same order (the first opens the group's ``"gemm_rs"`` channel)."""
    if y.device.type == "cpu":
        return gemm_rs_plain(y, w, group, transpose_w)
    B, S, F, A, s = _rs_shapes(y, w, group.n, transpose_w)
    n, rank = group.n, group.rank
    _peer.raise_for(0, 8, rank, None)          # an earlier kernel trapped
    slot = B * s * A
    ch = _peer.channel(group, RS_CHANNEL, 2 * n * slot * 4)
    stride = ch.capacity // (2 * n * 4) // 4 * 4
    out = torch.empty((B, s, A), dtype=y.dtype, device=y.device)
    lib = _rs_library()
    with torch.cuda.device(y.device):
        rc = lib.gemm_rs_launch(
            MODES["NT" if transpose_w else "NN"], y.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, S, F, A, n, rank, ch.data, ch.pads, stride,
            _peer.error_pointer(), ch.beats, ch.timeout_ns, ch.backstop_ns,
            torch.cuda.current_stream(y.device).cuda_stream)
    _peer.raise_for(rc, 8, rank,
                    lambda c: lib.gemm_rs_error_string(c).decode())
    ring_gemm_rs.launches += 2
    ring_gemm_rs.calls += 1
    ring_gemm_rs.shapes[(B * s, F, A, transpose_w)] += 1
    return out


def gemm_rs_local(y, w, n, rank, transpose_w=False):
    """Row 8's GEMM alone, without peers: every chunk's fp32 partial of y
    [B, S, F] @ w, [n, B*S/n, A], in rank ``rank``'s tile order (the
    products of a call, timed apart from the transfer). Not counted."""
    B, S, F, A, s = _rs_shapes(y, w, n, transpose_w)
    out = torch.empty((n, B * s, A), dtype=torch.float32, device=y.device)
    lib = _rs_library()
    with torch.cuda.device(y.device):
        rc = lib.gemm_rs_local_launch(
            MODES["NT" if transpose_w else "NN"], y.data_ptr(), w.data_ptr(),
            out.data_ptr(), B, S, F, A, n, rank,
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row 8 GEMM launch failed ({rc}): "
                           f"{lib.gemm_rs_error_string(rc).decode()}")
    return out


def _accum_shapes(r, stat, n, transpose):
    """(B, s, A, Bf, M, N) of a row-9 call over n ranks, or ValueError
    when the operands disagree or the kernel cannot take them."""
    B, s, A = r.shape
    Bs, S, Bf = stat.shape
    if Bs != B or S != n * s:
        raise ValueError(f"ring_ag_accum: r {tuple(r.shape)} and stat "
                         f"{tuple(stat.shape)} disagree (stat must be "
                         f"[B, n*s, Bf])")
    M, N = (Bf, A) if transpose else (A, Bf)
    _check("ring_ag_accum", (r, stat), M, N, B * s)
    why = [w for w in (_peer_group_reason(n),) if w]
    if s % ACCUM_TILE_ROWS:
        why.append(f"a chunk of {s} rows per batch row is not a multiple "
                   f"of {ACCUM_TILE_ROWS} (a k step would straddle a batch "
                   f"row)")
    tiles = -(-M // 128) * -(-N // 256)
    if tiles > ACCUM_MAX_TILES:
        why.append(f"{tiles} output tiles of 128 x 256 (the kernel's "
                   f"counters take {ACCUM_MAX_TILES})")
    if why:
        raise ValueError("ring_ag_accum kernel: " + "; ".join(why))
    return B, s, A, Bf, M, N


def ring_ag_accum(r, stat, group, transpose=False):
    """Ring weight gradient: the fp32 sum over the ring steps of ``r_src^T
    @ stat_src`` -> [A, Bf] (``transpose``: [Bf, A], computed as
    ``stat_src^T @ r_src``), r [B, s, A] ringing past, stat [B, S, Bf]
    stationary. CPU tensors take ``ag_accum_plain``; CUDA tensors launch
    ``ag_gemm.cu``'s pull and GEMM (every rank's r gathered through the
    group's ``"ag_gemm"`` peer channel; the chunks' fp32 partials summed
    in ring order), or raise. Collective, as ``ring_ag_gemm``."""
    if r.device.type == "cpu":
        return ag_accum_plain(r, stat, group, transpose)
    n, rank = group.n, group.rank
    B, s, A, Bf, M, N = _accum_shapes(r, stat, n, transpose)
    _peer.raise_for(0, 9, rank, None)          # an earlier kernel trapped
    ch, slot = _ag_channel(group, r)
    out = torch.empty((M, N), dtype=torch.float32, device=r.device)
    ws = torch.empty((n, M, N), dtype=torch.float32, device=r.device)
    lib = _ag_library()
    with torch.cuda.device(r.device):
        rc = lib.ag_accum_launch(
            int(transpose), r.data_ptr(), stat.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, s, A, Bf, n, rank, ch.data,
            ch.pads, slot, _peer.error_pointer(), ch.beats, ch.timeout_ns,
            ch.backstop_ns, _stream(r.device))
    _peer.raise_for(rc, 9, rank,
                    lambda c: lib.ag_gemm_error_string(c).decode())
    ring_ag_accum.launches += 2
    ring_ag_accum.calls += 1
    ring_ag_accum.shapes[(B * s, M, N, transpose)] += 1
    return out


def ag_accum_local(rs, stat, rank, transpose=False):
    """Row 9's GEMM alone, without peers: rs [n, B, s, A] (rank p's r at
    p) against stat, summed as ``ring_ag_accum`` sums, in rank ``rank``'s
    order. Not counted."""
    n = rs.shape[0]
    B, s, A, Bf, M, N = _accum_shapes(rs[0], stat, n, transpose)
    dev = rs.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = torch.empty((n, M, N), dtype=torch.float32, device=dev)
    lib = _ag_library()
    split = torch.zeros(lib.ag_accum_tiles(B, s, A, Bf, n, int(transpose)),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ag_accum_local_launch(
            int(transpose), rs.data_ptr(), stat.data_ptr(), out.data_ptr(),
            ws.data_ptr(), split.data_ptr(), B, s, A, Bf, n, rank,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"row 9 GEMM launch failed ({rc}): "
                           f"{lib.ag_gemm_error_string(rc).decode()}")
    return out


KERNELS = (ring_ag_gemm, ring_gemm_rs, ring_ag_accum)


def reset_counts():
    for k in KERNELS:
        k.launches = 0
        k.calls = 0
        k.shapes = collections.Counter()


reset_counts()
