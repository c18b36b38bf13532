"""Flash attention on [B, S, H, D]: the hand-written CUDA kernels
(``csrc/flash_sm90.cu``: forward, dQ and dK/dV, wgmma fed by TMA), their
wrappers, their plain PyTorch versions, and the differentiable
``flash_attention_bshd``.

Counterpart of ``paddle_tpu/ops/pallas_kernels/flash_attention.py``
(``_fwd_kernel`` through ``_pallas_forward``, ``flash_attention_bshd`` and
its custom VJP) and ``flash_attention_bwd.py`` (``_dq_kernel``,
``_dkv_kernel`` through ``flash_attention_backward``). Three kernels:

* ``flash_forward``  -> (O [B, S, H, D], LSE [B*H, S] fp32);
* ``flash_dq``       -> dQ, from P recomputed with the LSE;
* ``flash_dkv``      -> (dK, dV).

``delta = rowsum(dO * O)`` is plain PyTorch, as the reference computes it
in XLA outside its kernels. The softmax scale is ``D ** -0.5`` of the true
head dim; nothing is padded.

Each wrapper takes its plain version only for tensors on the CPU. On CUDA
it launches its kernel or raises: the kernels take bfloat16, head_dim 64
or 128 and equal q and key lengths; any other case raises and names
``use_flash=False``, the reference's own knob (``GPTConfig``) that
routes attention through ``ops/blockwise_attention.py``. Additive bias,
segment ids, dropout and varlen packing are not ported (ROADMAP Queue B 4,
rest) and raise ``NotImplementedError``. Each wrapper counts its kernel's
launches in ``<wrapper>.launches``.

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

from ..cuda_build import load_library

SUPPORTED_HEAD_DIMS = (64, 128)
UNPORTED_FEATURES = "ROADMAP Queue B 4 (rest)"


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ----------------------------------------------------------- plain versions
def _heads(t):
    """[B, S, H, D] -> fp32 [B, H, S, D]."""
    return t.float().permute(0, 2, 1, 3)


def _scores(q, k, causal, scale):
    """fp32 scores [B, H, Sq, Sk] of ``q * scale`` against k, entries above
    the diagonal at -inf when causal."""
    s = (_heads(q) * scale) @ _heads(k).transpose(-1, -2)
    if causal:
        Sq, Sk = s.shape[-2:]
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_forward_plain(q, k, v, causal=True, scale=None):
    """The forward kernel's plain version: (O in q's dtype, LSE [B*H, Sq]
    fp32)."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, _scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)                    # [B, H, Sq]
    o = torch.exp(s - lse[..., None]) @ _heads(v)
    return (o.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(B * H, Sq))


def _grad_terms(q, k, v, do, lse, delta, causal, scale):
    """P and dS [B, H, Sq, Sk] fp32, recomputed from the LSE."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))         # masked -> 0
    dp = _heads(do) @ _heads(v).transpose(-1, -2)
    ds = p * (dp - delta.reshape(B, H, Sq, 1)) * scale
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, scale=None):
    """The dQ kernel's plain version: dS K, in q's dtype."""
    _, ds = _grad_terms(q, k, v, do, lse, delta, causal, _scale(q, scale))
    return (ds @ _heads(k)).permute(0, 2, 1, 3).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, scale=None):
    """The dK/dV kernel's plain version: (dS^T Q, P^T dO) in k's and v's
    dtypes."""
    p, ds = _grad_terms(q, k, v, do, lse, delta, causal, _scale(q, scale))
    dk = ds.transpose(-1, -2) @ _heads(q)
    dv = p.transpose(-1, -2) @ _heads(do)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, [B*H, S] (the reference's
    ``flash_attention_bwd.py:222``)."""
    B, S, H, _ = o.shape
    d = (do.float() * o.float()).sum(-1)                # [B, S, H]
    return d.permute(0, 2, 1).reshape(B * H, S).contiguous()


# A kernel output against its plain version. Both round their output to
# bf16; the kernels also round P and dS to bf16 for the tensor cores and
# sum in another order. So a right kernel's error in an element is a few
# bf16 ulps (2**-8 relative) of the element, plus a rounding residue of
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
    if dtype != torch.bfloat16:
        reasons.append(f"dtype {dtype} is not bfloat16")
    return "; ".join(reasons) or None


_LL = ctypes.POINTER(ctypes.c_longlong)
_INTS = [ctypes.c_int] * 5
_TAIL = [_LL, ctypes.c_float, ctypes.c_void_p]


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


WAIT_RECORD_FIELDS = ("code", "row", "block_x", "block_y", "warp",
                      "barrier", "parity", "step")


def wait_timeout_record():
    """What the first mbarrier wait of a flash kernel (the forward, dQ or
    dK/dV) that timed out in this process was waiting for (a dict of
    WAIT_RECORD_FIELDS: the kernel's PERF.md row, 4, 5 or 6, its block,
    its warp, 8 being the forward's or dQ's producer, the barrier, the
    parity and the loop step), or None. Reads host memory only, so it
    works after the kernel's trap has left the CUDA context unusable."""
    out = (ctypes.c_int * len(WAIT_RECORD_FIELDS))()
    _sm90_library().flash_sm90_wait_record(out)
    return dict(zip(WAIT_RECORD_FIELDS, out)) if out[0] else None


def _readable(t):
    """True when the kernels can read t [B, S, H, D] in place: last dim
    contiguous, other strides and the base 16-byte aligned."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:3]))


def _check(q, k, v, *rest):
    """Validate the [B, S, H, D] operands of a kernel launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    why = unsupported_reason(q.shape[-1], q.dtype)
    if why:
        raise ValueError(
            f"flash attention kernel: {why}; set GPTConfig.use_flash=False "
            f"to run attention through ops/blockwise_attention.py")
    for name, t in (("k", k), ("v", v)) + tuple(
            (f"operand {i}", t) for i, t in enumerate(rest)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise NotImplementedError(
                f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}: "
                f"the kernels take equal q and key lengths "
                f"({UNPORTED_FEATURES})")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (f"operand {i}", t) for i, t in enumerate(rest)):
        if not _readable(t):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")


def _check_stats(q, *stats):
    B, S, H, _ = q.shape
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B * H, S) or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"lse/delta must be contiguous float32 "
                             f"[{B * H}, {S}] on {q.device}, got {t.dtype} "
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


def flash_forward(q, k, v, causal=True, scale=None):
    """(O [B, S, H, D] in q's dtype, LSE [B*H, S] fp32). CPU tensors take
    the plain version; CUDA tensors launch the forward kernel."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, scale)
    _check(q, k, v)
    lib = _sm90_library()
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    maps = _map_records((q, FWD_ROWS), (k, FWD_ROWS), (v, FWD_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, int(causal), maps,
            _scale(q, scale), _stream(q))
    _raise_on(rc, "forward", lib.flash_sm90_error_string)
    flash_forward.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal=True, scale=None):
    """dQ [B, S, H, D] in q's dtype. CPU tensors take the plain version;
    CUDA tensors launch the dQ kernel."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    lib = _sm90_library()
    B, S, H, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    maps = _map_records((q, DQ_Q_ROWS), (k, DQ_KEYS), (v, DQ_KEYS),
                        (do, DQ_Q_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, D,
            int(causal), maps, _scale(q, scale), _stream(q))
    _raise_on(rc, "dQ", lib.flash_sm90_error_string)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=True, scale=None):
    """(dK, dV) [B, S, H, D] in the input dtype. CPU tensors take the
    plain version; CUDA tensors launch the dK/dV kernel."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, do)
    _check_stats(q, lse, delta)
    lib = _sm90_library()
    B, S, H, D = q.shape
    dk = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    maps = _map_records((q, DKV_Q_ROWS), (k, DKV_KEYS), (v, DKV_KEYS),
                        (do, DKV_Q_ROWS))
    with torch.cuda.device(q.device):
        rc = lib.flash_sm90_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, D, int(causal), maps, _scale(q, scale), _stream(q))
    _raise_on(rc, "dK/dV", lib.flash_sm90_error_string)
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, causal=True, scale=None):
    """(dQ, dK, dV) of flash attention from the forward's O and LSE:
    delta in PyTorch, then the dQ and the dK/dV kernels."""
    delta = attention_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _for_kernel(t):
    """t itself where the kernels can read it in place, else a contiguous
    copy (CUDA only; the plain versions read any layout)."""
    return t if t.device.type != "cuda" or _readable(t) else t.contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward kernel saving O and the fp32 LSE; backward = delta + the dQ
    and dK/dV kernels (the reference's ``_vjp_fwd`` / ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = (_for_kernel(t) for t in (q, k, v))
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, _for_kernel(do), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=True, bias=None, segment_ids=None,
                         dropout_p=0.0, dropout_seed=None, scale=None):
    """Differentiable flash attention, [B, S, H, D] layout, output in q's
    dtype. ``scale`` defaults to ``D ** -0.5``. Bias, segment ids and
    dropout are not ported and raise."""
    unported = [name for name, off in (
        ("bias", bias is None), ("segment_ids", segment_ids is None),
        ("dropout", not dropout_p and dropout_seed is None)) if not off]
    if unported:
        raise NotImplementedError(
            f"flash attention {', '.join(unported)} is not ported yet "
            f"({UNPORTED_FEATURES})")
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
