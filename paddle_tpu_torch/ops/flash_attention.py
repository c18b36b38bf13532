"""Flash attention on [B, S, H, D]: the hand-written CUDA kernels
(``csrc/flash_sm90.cu``: forward, dQ and dK/dV, wgmma fed by TMA), their
wrappers, their plain PyTorch versions, and the differentiable
``flash_attention_bshd``.

Counterpart of ``paddle_tpu/ops/pallas_kernels/flash_attention.py``
(``_fwd_kernel`` through ``_pallas_forward``, ``flash_attention_bshd`` and
its custom VJP) and ``flash_attention_bwd.py`` (``_dq_kernel``,
``_dkv_kernel`` through ``flash_attention_backward``). Three kernels:

* ``flash_forward``  -> (O [B, Sq, H, D], LSE [B*H, Sq] fp32);
* ``flash_dq``       -> dQ, from P recomputed with the LSE;
* ``flash_dkv``      -> (dK, dV) [B, Sk, H, D].

q is [B, Sq, H, D] and k, v [B, Sk, H, D]: the query and key lengths may
differ, and causal masking is top-left, ``key <= query`` by position, as
in the reference's kernel (``flash_attention.py:122-125``).

``delta = rowsum(dO * O)`` is plain PyTorch, as the reference computes it
in XLA outside its kernels. The softmax scale is ``D ** -0.5`` of the true
head dim; nothing is padded.

Every function takes an additive ``bias`` broadcastable as (B|1, H|1, Sq,
Sk), added to the scaled scores before the softmax, and dropout on the
normalised probabilities at rate ``dropout_p`` under a 64-bit Philox
``key`` (``ops/philox.py``: the keep bit of each (b, h, query, key) is the
same in all three kernels). As in the reference: the row sum uses P before
dropout, O takes ``keep P / (1 - p)``, dV the dropped P and dS the dropped
dP, ``dS = P (dP' - delta)``; the bias gets no gradient. A row whose every
score is at most ``MASKED_ROW`` (a bool mask's -1e30 over the whole row)
gets O = 0 and LSE = ``MASKED_LSE``, so the backward's P underflows to 0,
as the reference's kernel does (its composed path averages such a row).
Segment ids ``(q_ids [B, Sq], k_ids [B, Sk])`` keep a score only where
the two ids are equal (``flash_attention_bwd.py:57``); a query whose id
no key shares is such a row. ``flash_attention_varlen`` packs
``[total, H, D]`` sequences into one row with such ids, padding to the
tile with id -1 for queries and -2 for keys (the reference's :360-399).

Each wrapper takes its plain version only for tensors on the CPU. On CUDA
it launches its kernel or raises: the kernels take bfloat16 or float16,
head_dim 64 or 128, any lengths, and an fp32 or bf16 bias; any other case
raises and names the switches that route attention elsewhere:
``GPTConfig.use_flash=False`` (``ops/blockwise_attention.py``) and
``FLAGS_use_flash_attention=False`` (the composed SDPA of the BERT and
Transformer layers). fp32 operands are not ported (ROADMAP Queue B 4).
Each wrapper counts its kernel's launches in ``<wrapper>.launches``.

The plain versions are dense fp32 attention following
``blockwise_attention``'s algebra, with the LSE and delta the reference
defines; they are the kernels' oracle in the tests and in
``chip_smoke.py``, which hold the kernels to them with ``error_vs_plain``
and ``within_tolerance``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..cuda_build import load_library, wait_record
from ..framework import random
from . import philox

SUPPORTED_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float16)
UNPORTED_FEATURES = "fp32 operands: ROADMAP Queue B 4"
# q and key ids of the varlen pack's padding (the reference's -1 / -2)
PAD_Q_ID, PAD_K_ID = -1, -2
# a row whose largest score is at or below MASKED_ROW is fully masked; its
# LSE is MASKED_LSE (the reference's 0.5 * _NEG_INF and -_NEG_INF,
# flash_attention.py:148-157)
MASKED_ROW = -5e29
MASKED_LSE = 1e30


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ----------------------------------------------------------- plain versions
def _heads(t):
    """[B, S, H, D] -> fp32 [B, H, S, D]."""
    return t.float().permute(0, 2, 1, 3)


def _scores(q, k, causal, scale, bias=None, segment_ids=None):
    """fp32 scores [B, H, Sq, Sk] of ``q * scale`` against k plus the bias;
    -inf where the segment ids differ and, when causal, where the key
    comes after the query (top-left: key <= query by position)."""
    s = (_heads(q) * scale) @ _heads(k).transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    if segment_ids is not None:
        qs, ks = _check_segments(q, k, segment_ids)
        same = qs[:, None, :, None] == ks[:, None, None, :]
        s = s.masked_fill(~same, float("-inf"))
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _check_segments(q, k, segment_ids):
    """The (q ids, k ids) of ``segment_ids``, checked to be integer [B,
    Sq] and [B, Sk] on q's device."""
    qs, ks = segment_ids
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    if tuple(qs.shape) != (B, Sq) or tuple(ks.shape) != (B, Sk) or \
            qs.device != q.device or ks.device != q.device or \
            qs.is_floating_point() or ks.is_floating_point():
        raise ValueError(f"segment ids must be integer [{B}, {Sq}] and "
                         f"[{B}, {Sk}] on {q.device}, got {qs.dtype} "
                         f"{tuple(qs.shape)} and {ks.dtype} "
                         f"{tuple(ks.shape)}")
    return qs, ks


def _keep(s, dropout_p, key):
    """The kernels' keep mask [B, H, Sq, Sk] for scores s, or None."""
    if not dropout_p:
        return None
    return philox.keep_mask(*s.shape, dropout_p, key, device=s.device)


def _drop(x, keep, dropout_p):
    """keep x / (1 - p), or x itself without dropout."""
    return x if keep is None else torch.where(keep, x / (1 - dropout_p), 0.0)


def flash_forward_plain(q, k, v, causal=True, scale=None, bias=None,
                        dropout_p=0.0, key=0, segment_ids=None):
    """The forward kernel's plain version: (O in q's dtype, LSE [B*H, Sq]
    fp32)."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, _scale(q, scale), bias, segment_ids)
    # P = exp(s - max) / its row sum, as the kernels normalise: exp(s -
    # LSE) would not sum to 1 where a bias of -1e9 leaves the scores and
    # their LSE one fp32 value apart (ulp 64)
    m = s.amax(-1, keepdim=True)
    dead = m <= MASKED_ROW
    e = torch.exp(s - torch.where(dead, 0.0, m))
    l = e.sum(-1, keepdim=True)
    lse = torch.where(dead, MASKED_LSE, m + torch.log(l)).squeeze(-1)
    p = _drop(torch.where(dead, 0.0, e / torch.where(dead, 1.0, l)),
              _keep(s, dropout_p, key), dropout_p)
    o = p @ _heads(v)
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(B * H, Sq))


def _grad_terms(q, k, v, do, lse, delta, causal, scale, bias, dropout_p,
                key, segment_ids):
    """The dropped P and dS [B, H, Sq, Sk] fp32, recomputed from the
    LSE."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, scale, bias, segment_ids)
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))         # masked -> 0
    keep = _keep(s, dropout_p, key)
    dp = _drop(_heads(do) @ _heads(v).transpose(-1, -2), keep, dropout_p)
    ds = p * (dp - delta.reshape(B, H, Sq, 1)) * scale
    return _drop(p, keep, dropout_p), ds


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, scale=None,
                   bias=None, dropout_p=0.0, key=0, segment_ids=None):
    """The dQ kernel's plain version: dS K, in q's dtype."""
    _, ds = _grad_terms(q, k, v, do, lse, delta, causal, _scale(q, scale),
                        bias, dropout_p, key, segment_ids)
    return (ds @ _heads(k)).permute(0, 2, 1, 3).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, scale=None,
                    bias=None, dropout_p=0.0, key=0, segment_ids=None):
    """The dK/dV kernel's plain version: (dS^T Q, P'^T dO) in k's and v's
    dtypes, P' the dropped P."""
    p, ds = _grad_terms(q, k, v, do, lse, delta, causal, _scale(q, scale),
                        bias, dropout_p, key, segment_ids)
    dk = ds.transpose(-1, -2) @ _heads(q)
    dv = p.transpose(-1, -2) @ _heads(do)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B*H, Sq] (the reference's
    ``flash_attention_bwd.py:222``)."""
    B, S, H, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                # [B, S, H]
    return d.permute(0, 2, 1).reshape(B * H, S).contiguous()


# A kernel output against its plain version. Both round their output to
# bf16 (or fp16); the kernels also round P and dS to it for the tensor
# cores and sum in another order. So a right kernel's error in an element
# is a few bf16 ulps (2**-8 relative; fp16's are 8x finer) of the
# element, plus a rounding residue of
# the terms summed into its row, which scale with the row, not with the
# element: an element near 0 in a row of large values (the first rows of
# causal attention) errs by a small share of the row's rms. It stays far
# under 1 % in the L2 norm of every 128-row tile of one (b, h), where one
# wrong or missing tile of keys or queries costs tens of percent in the
# tiles it touches.
ELEMENT_RTOL = 2e-2      # per element: |got - want| <= ELEMENT_RTOL |want|
ELEMENT_ATOL = 2e-2      #   + ELEMENT_ATOL * max(rms(row), rms(want))
TILE_REL = 1e-2          # per tile: ||got - want|| <= TILE_REL ||want||
TILE_ROWS = 128
LSE_TOL = 1e-4           # fp32 LSE on both sides: atol = rtol


def error_vs_plain(got, want):
    """Readings of a kernel output [B, S, H, D] against its plain version:
    ``max_abs``; ``element``, the worst |got - want| / (ELEMENT_ATOL *
    max(rms of the element's row of D, rms(want)) + ELEMENT_RTOL *
    |want|), which the tolerance holds to 1;
    ``rel_l2`` over the whole tensor; ``tile_rel_l2``, the worst relative
    L2 error of one (b, h, TILE_ROWS-row tile), held to TILE_REL."""
    g, w = got.float(), want.float()
    diff = g - w
    scale = torch.maximum(w.square().mean(-1, keepdim=True).sqrt(),
                          w.square().mean().sqrt())
    element = diff.abs() / (ELEMENT_ATOL * scale + ELEMENT_RTOL * w.abs())
    B, S, H, D = w.shape
    n = -(-S // TILE_ROWS)

    def tile_norms(t):                                  # [B, n, H]
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n * TILE_ROWS - S))
        return t.view(B, n, TILE_ROWS, H, D).transpose(2, 3).reshape(
            B, n, H, TILE_ROWS * D).norm(dim=-1)

    tile = tile_norms(diff) / tile_norms(w).clamp_min(1e-30)
    return {"max_abs": float(diff.abs().max()),
            "element": float(element.max()),
            "rel_l2": float(diff.norm() / w.norm()),
            "tile_rel_l2": float(tile.max())}


def within_tolerance(readings):
    """True when ``error_vs_plain`` readings pass both gates."""
    return readings["element"] <= 1 and readings["tile_rel_l2"] <= TILE_REL


# ---------------------------------------------------------------- kernels
def unsupported_reason(head_dim, dtype):
    """Why the kernels cannot take this head dim and dtype, or None."""
    reasons = []
    if head_dim not in SUPPORTED_HEAD_DIMS:
        reasons.append(f"head_dim {head_dim} not in {SUPPORTED_HEAD_DIMS}")
    if dtype not in KERNEL_DTYPES:
        reasons.append(f"dtype {dtype} is not bfloat16 or float16 "
                       f"({UNPORTED_FEATURES})")
    return "; ".join(reasons) or None


_LL = ctypes.POINTER(ctypes.c_longlong)
_INTS = [ctypes.c_int] * 7             # B, Sq, Sk, H, D, causal, fp16
# maps, scale; bias, its strides, dropout, threshold, key, 1 / (1 - p);
# q ids, key ids and their SEG_TILE-row ranges; the stream
_TAIL = [_LL, ctypes.c_float, ctypes.c_void_p, _LL, ctypes.c_int,
         ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_float] + \
    [ctypes.c_void_p] * 5


def bind(lib):
    """Set the argument and result types of a build of
    ``csrc/flash_sm90.cu`` (a ctypes library); returns it."""
    lib.flash_sm90_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + _INTS + _TAIL)
    lib.flash_sm90_dq_launch.argtypes = (
        [ctypes.c_void_p] * 7 + _INTS + _TAIL)
    lib.flash_sm90_dkv_launch.argtypes = (
        [ctypes.c_void_p] * 8 + _INTS + _TAIL)
    for fn in (lib.flash_sm90_fwd_launch, lib.flash_sm90_dq_launch,
               lib.flash_sm90_dkv_launch):
        fn.restype = ctypes.c_int
    lib.flash_sm90_wait_record.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.flash_sm90_wait_record.restype = None
    lib.flash_sm90_error_string.argtypes = [ctypes.c_int]
    lib.flash_sm90_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm90_library():
    """The three kernels' library (``csrc/flash_sm90.cu``)."""
    return bind(load_library("flash_sm90", "flash_sm90.cu"))


def build():
    """Build (or load the cached build of) the kernel library now."""
    _sm90_library()


def wait_timeout_record():
    """What the first mbarrier wait of a flash kernel (the forward, dQ or
    dK/dV) that timed out in this process was waiting for (a dict of
    ``cuda_build.WAIT_RECORD_FIELDS``: the kernel's PERF.md row, 4, 5 or
    6, its block, its warp, 8 being the forward's or dQ's producer, the
    barrier, the parity and the loop step), or None. Reads host memory
    only, so it works after the kernel's trap has left the CUDA context
    unusable."""
    return wait_record(_sm90_library().flash_sm90_wait_record)


def _readable(t):
    """True when the kernels can read t [B, S, H, D] in place: last dim
    contiguous, other strides and the base 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def _check(q, k, v, *rest):
    """Validate the operands of a kernel launch: q (and dO, ``rest``)
    [B, Sq, H, D], k and v [B, Sk, H, D]."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, S, H, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    why = unsupported_reason(q.shape[-1], q.dtype)
    if why:
        raise ValueError(
            f"flash attention kernel: {why}; set GPTConfig.use_flash=False "
            f"(GPT: ops/blockwise_attention.py) or "
            f"FLAGS_use_flash_attention=False (SDPA, BERT, Transformer: the "
            f"composed path)")
    named = (("k", k), ("v", v)) + tuple(
        (f"operand {i}", t) for i, t in enumerate(rest))
    for name, t in named:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        want = k.shape if name in ("k", "v") else q.shape
        if t.shape != want or (t.shape[0], *t.shape[2:]) != (
                q.shape[0], *q.shape[2:]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; q is "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}: k and "
                             f"v share [B, Sk, H, D], dO is q's shape")
    for name, t in (("q", q),) + named:
        if not _readable(t):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")


# The kernels skip a tile of keys against a tile of queries when the
# ranges of their segment ids do not meet; the ranges come per SEG_TILE
# rows (the least tile of any kernel's loop) from ``segment_ranges``.
SEG_TILE = 64


def segment_ranges(ids):
    """[B, ceil(S / SEG_TILE), 2] int32: the least and the greatest id of
    each SEG_TILE-row tile of ids [B, S] (a ragged last tile over its own
    rows)."""
    B, S = ids.shape
    n = -(-S // SEG_TILE)
    t = torch.cat([ids, ids[:, -1:].expand(B, n * SEG_TILE - S)], 1)
    t = t.view(B, n, SEG_TILE)
    return torch.stack([t.amin(-1), t.amax(-1)], -1).to(
        torch.int32).contiguous()


def _segment_args(q, k, segment_ids):
    """(q ids, k ids, their ranges) as contiguous int32 tensors on q's
    device, or four Nones."""
    if segment_ids is None:
        return (None,) * 4
    qs, ks = (t.to(torch.int32).contiguous()
              for t in _check_segments(q, k, segment_ids))
    return qs, ks, segment_ranges(qs), segment_ranges(ks)


def _extra_args(q, k, bias, dropout_p, key, segment_ids):
    """The launch arguments of the features: (tensors to keep alive until
    the launch is queued, then bias, its element strides over (B, H, Sq,
    Sk) with 0 on a broadcast dimension, dropout, threshold, key,
    1 / (1 - p), q ids, k ids and their ranges). A bf16 bias becomes fp32
    first."""
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    strides = (ctypes.c_longlong * 4)()
    if bias is not None:
        if bias.dim() != 4 or bias.device != q.device or \
                bias.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"bias must be a 4-D fp32 or bf16 tensor on "
                             f"{q.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.float()
        try:
            strides[:] = bias.expand(B, H, Sq, Sk).stride()
        except RuntimeError as e:
            raise ValueError(f"bias of shape {tuple(bias.shape)} does not "
                             f"broadcast to {(B, H, Sq, Sk)}") from e
    seg = _segment_args(q, k, segment_ids)
    drop = bool(dropout_p)
    return ((bias, *seg), bias.data_ptr() if bias is not None else None,
            strides, int(drop), philox.threshold(dropout_p),
            int(key) & (2 ** 64 - 1), 1.0 / (1.0 - float(dropout_p)),
            *(t.data_ptr() if t is not None else None for t in seg))


def _check_stats(q, *stats):
    B, Sq, H, _ = q.shape
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, Sq) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"lse/delta must be contiguous float32 "
                             f"[{B * H}, {Sq}] on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")


# The TMA tiles of csrc/flash_sm90.cu: a load brings TMA_BOX_COLS columns
# of one head (128 bytes, the row of the 128-byte swizzle) over a tile's
# rows; a d=128 tile is two such boxes.
TMA_BOX_COLS = 64
FWD_ROWS = 128           # forward: q rows per block, keys per loop step
DKV_KEYS = 128           # dK/dV: keys per block
DKV_Q_ROWS = 64          # dK/dV: q rows per step
DQ_Q_ROWS = 128          # dQ: q rows per block
DQ_KEYS = 64             # dQ: keys per step


def tensor_map_args(t, rows):
    """The arguments of ``cuTensorMapEncodeTiled`` for one [B, S, H, D]
    operand of a flash kernel, innermost dimension first:
    ``dims`` (D, H, S, B); ``strides``, the byte strides of H, S and B, the
    caller's own (so the qkv split is read in place); ``box``, the tile a
    load brings: TMA_BOX_COLS columns of one head by ``rows`` rows of one
    batch. The map's S is the true length: TMA fills the rows of a box
    past it with zeros, and the kernels mask them. Raises for a layout the
    kernels cannot read in place (``_readable``), which ``_for_kernel``
    copies first."""
    if t.dim() != 4 or not _readable(t):
        raise ValueError(f"TMA needs a [B, S, H, D] tensor with a "
                         f"contiguous last dim and 16-byte aligned rows, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    item = t.element_size()
    B, S, H, D = t.shape
    sb, ss, sh, _ = t.stride()
    return {"dims": (D, H, S, B),
            "strides": (sh * item, ss * item, sb * item),
            "box": (TMA_BOX_COLS, 1, rows, 1)}


def _map_records(*operands):
    """The 11 values per (tensor, rows) that csrc/flash_sm90.cu reads:
    dims, strides, box."""
    vals = []
    for t, rows in operands:
        a = tensor_map_args(t, rows)
        vals += [*a["dims"], *a["strides"], *a["box"]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(rc, what, error_string):
    if rc != 0:
        raise RuntimeError(f"flash {what} kernel launch failed ({rc}): "
                           f"{error_string(rc).decode()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sizes(q, k):
    """The launch's ints: B, Sq, Sk, H, D, and the element type (1:
    float16, 0: bfloat16); causal goes between them."""
    B, Sq, H, D = q.shape
    return (B, Sq, k.shape[1], H, D), int(q.dtype == torch.float16)


def flash_forward(q, k, v, causal=True, scale=None, bias=None,
                  dropout_p=0.0, key=0, segment_ids=None):
    """(O [B, Sq, H, D] in q's dtype, LSE [B*H, Sq] fp32). CPU tensors take
    the plain version; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale, bias, dropout_p,
                                   key, segment_ids)
    _check(q, k, v)
    keep_alive, *extra = _extra_args(q, k, bias, dropout_p, key, segment_ids)
    lib = _sm90_library()
    dims, half = _sizes(q, k)
    B, Sq, _, H, _ = dims
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    maps = _map_records((q, FWD_ROWS), (k, FWD_ROWS), (v, FWD_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *dims, int(causal), half, maps,
            _scale(q, scale), *extra, _stream(q))
    del keep_alive
    _raise_on(rc, "forward", lib.flash_sm90_error_string)
    flash_forward.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal=True, scale=None, bias=None,
             dropout_p=0.0, key=0, segment_ids=None):
    """dQ [B, Sq, H, D] in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the dQ kernel."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, scale, bias,
                              dropout_p, key, segment_ids)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    keep_alive, *extra = _extra_args(q, k, bias, dropout_p, key, segment_ids)
    lib = _sm90_library()
    dims, half = _sizes(q, k)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    maps = _map_records((q, DQ_Q_ROWS), (k, DQ_KEYS), (v, DQ_KEYS),
                        (do, DQ_Q_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
            int(causal), half, maps, _scale(q, scale), *extra, _stream(q))
    del keep_alive
    _raise_on(rc, "dQ", lib.flash_sm90_error_string)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=True, scale=None, bias=None,
              dropout_p=0.0, key=0, segment_ids=None):
    """(dK, dV) [B, Sk, H, D] in the input dtype. CPU tensors take the
    plain version; CUDA tensors launch the dK/dV kernel."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, scale, bias,
                               dropout_p, key, segment_ids)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    keep_alive, *extra = _extra_args(q, k, bias, dropout_p, key, segment_ids)
    lib = _sm90_library()
    dims, half = _sizes(q, k)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    maps = _map_records((q, DKV_Q_ROWS), (k, DKV_KEYS), (v, DKV_KEYS),
                        (do, DKV_Q_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, int(causal), half, maps, _scale(q, scale), *extra,
            _stream(q))
    del keep_alive
    _raise_on(rc, "dK/dV", lib.flash_sm90_error_string)
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, causal=True, scale=None,
                             bias=None, dropout_p=0.0, key=0,
                             segment_ids=None):
    """(dQ, dK, dV) of flash attention from the forward's O and LSE:
    delta in PyTorch, then the dQ and the dK/dV kernels."""
    delta = attention_delta(o, do)
    feats = (bias, dropout_p, key, segment_ids)
    dq = flash_dq(q, k, v, do, lse, delta, causal, scale, *feats)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale, *feats)
    return dq, dk, dv


def _for_kernel(t):
    """t itself where the kernels can read it in place, else a contiguous
    copy (CUDA only; the plain versions read any layout)."""
    return t if t.device.type != "cuda" or _readable(t) else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward kernel saving O and the fp32 LSE; backward = delta + the dQ
    and dK/dV kernels (the reference's ``_vjp_fwd`` / ``_vjp_bwd``). The
    bias, the segment ids and the dropout key are constants: no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bias, dropout_p, key, q_ids,
                k_ids):
        q, k, v = (_for_kernel(t) for t in (q, k, v))
        seg = None if q_ids is None else (q_ids, k_ids)
        o, lse = flash_forward(q, k, v, causal, scale, bias, dropout_p, key,
                               seg)
        ctx.save_for_backward(q, k, v, o, lse, bias, q_ids, k_ids)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout_p, ctx.key = dropout_p, key
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, q_ids, k_ids = ctx.saved_tensors
        seg = None if q_ids is None else (q_ids, k_ids)
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, _for_kernel(do), ctx.causal, ctx.scale, bias,
            ctx.dropout_p, ctx.key, seg)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_bshd(q, k, v, causal=True, bias=None, segment_ids=None,
                         dropout_p=0.0, dropout_seed=None, scale=None):
    """Differentiable flash attention, q [B, Sq, H, D] and k, v [B, Sk, H,
    D], output in q's dtype. ``scale`` defaults to ``D ** -0.5``. ``bias``
    is additive, broadcastable as (B|1, H|1, Sq, Sk); ``segment_ids`` is
    (q ids [B, Sq], k ids [B, Sk]); neither gets a gradient.
    ``dropout_seed`` is the 64-bit Philox key of the dropout, drawn from
    ``framework.random.philox_key()`` when None."""
    dropout_p = float(dropout_p)
    key = 0
    if dropout_p:
        if dropout_seed is None:
            dropout_seed = random.philox_key()
        key = int(dropout_seed) & (2 ** 64 - 1)
    if bias is not None:
        bias = bias.detach()
    q_ids, k_ids = (None, None) if segment_ids is None else (
        t.detach() for t in segment_ids)
    return _FlashAttention.apply(q, k, v, bool(causal), scale, bias,
                                 dropout_p, key, q_ids, k_ids)


def varlen_segment_ids(cu_seqlens, total, padded):
    """int32 [padded]: the segment of each of ``padded`` packed tokens
    (token t lies in segment ``searchsorted(cu_seqlens, t, right)``), the
    padding from ``total`` on at -1."""
    t = torch.arange(padded, dtype=torch.int64, device=cu_seqlens.device)
    seg = torch.searchsorted(cu_seqlens.to(torch.int64), t, right=True)
    return torch.where(t < total, seg, -1).to(torch.int32)


def flash_attention_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal=True,
                           scale=None, dropout_p=0.0, dropout_seed=None,
                           block=FWD_ROWS):
    """Packed varlen flash attention (the reference's
    ``flash_attention_varlen``, flash_attention.py:360-399): q [Tq, H, D],
    k, v [Tk, H, D], ``cu_seqlens_*`` [n + 1] cumulative offsets; returns
    [Tq, H, D]. The tokens are padded to a multiple of ``block`` and
    attend within their segment; q padding has id -1 and key padding -2,
    so padded rows match nothing. Causal masking is by position in the
    pack, per sequence when ``cu_seqlens_q == cu_seqlens_k`` (the
    reference's contract for ``causal=True``)."""
    Tq, Tk = q.shape[0], k.shape[0]

    def pad(x, T):
        rem = (-T) % block
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, rem)), T + rem

    (qp, Tq_p), (kp, Tk_p), (vp, _) = pad(q, Tq), pad(k, Tk), pad(v, Tk)
    qseg = varlen_segment_ids(cu_seqlens_q, Tq, Tq_p)
    kseg = varlen_segment_ids(cu_seqlens_k, Tk, Tk_p)
    kseg = torch.where(kseg < 0, PAD_K_ID, kseg)
    out = flash_attention_bshd(qp[None], kp[None], vp[None], causal, None,
                               (qseg[None], kseg[None]), dropout_p,
                               dropout_seed, scale)
    return out[0, :Tq]
