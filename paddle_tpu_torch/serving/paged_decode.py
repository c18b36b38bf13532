"""One-token paged decode attention: the hand-written CUDA kernel
(``csrc/paged_decode.cu``), its wrapper and its plain PyTorch version.

Replaces the TPU kernel ``paddle_tpu/serving/paged_attention.py:
_decode_kernel`` (through ``paged_decode_attention``). Inputs: q
[B, nh, d] float32, the layer's pool kc_l/vc_l [P, page_size, nh, d], the
page table [B, MP] int32 and the write positions pos [B] int32; output
ctx [B, nh, d] float32 over keys 0..pos[b] of each slot.

The kernel is bound by bytes: it must read every live key and value once,
sum_b (live pages_b * page_size) * nh * d * 2 * itemsize, over the card's
3.35 TB/s (B=8 slots of 512 live tokens, nh=16, d=128, bf16: 33.5 MB,
about 10 us per layer). It walks only each slot's live pages, with
16-byte loads and one page of loads in flight; see the source for the
design.

``paged_decode_attention`` takes the plain version only for tensors on
the CPU. On CUDA it launches the kernel or raises: a failed build or
launch never falls back. ``paged_decode_attention.launches`` counts the
kernel's launches.

``paged_decode_attention_q`` is the same for an int8 or float8_e4m3fn
pool with per-page dequant scales ksc_l/vsc_l [P] float32: it replaces
``_decode_kernel_q`` (through ``paged_decode_attention_q``, the
pallas_call at paged_attention.py:221) with the int8 and fp8 instances of
the same CUDA kernel, which read half the bytes of a bf16 pool. Its plain
version ``paged_decode_q_plain`` is the reference's gather read of a
quantized pool: key scales multiply the scores after the q.k dot, values
are dequantized after their gather. Its launches count in
``paged_decode_attention_q.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..cuda_build import load_library
from ..models.generation import _attend

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_PAGE_SIZES = (8, 16, 32)
_POOL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_QUANT_POOL_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def gather_window(pool_l, table):
    """Each slot's pages in virtual order: [P, page_size, nh, d] through
    table [B, MP] -> [B, MP * page_size, nh, d]. One-byte pools move as
    uint8 (indexing is not implemented for every float8 type)."""
    B, MP = table.shape
    _, ps, nh, d = pool_l.shape
    if pool_l.element_size() == 1:
        win = pool_l.view(torch.uint8)[table].view(pool_l.dtype)
    else:
        win = pool_l[table]
    return win.reshape(B, MP * ps, nh, d)


def attend_quantized(q, kc_l, vc_l, table, pos, ksc_l, vsc_l, page_size):
    """The reference's gather read of a quantized pool, for q
    [B, T, nh, d] at positions pos [B, T]: scores against the raw keys,
    times each key page's scale after the dot; values dequantized by their
    page's scale after the gather. Returns ctx [B, T, nh, d] float32."""
    k_sc = ksc_l[table].repeat_interleave(page_size, dim=1)        # [B, S]
    v_sc = vsc_l[table].repeat_interleave(page_size, dim=1)
    vwin = gather_window(vc_l, table).float() * v_sc[:, :, None, None]
    return _attend(q, gather_window(kc_l, table), vwin, pos, k_scale=k_sc)


def paged_decode_plain(q, kc_l, vc_l, table, pos, page_size):
    """The plain version: gather every slot's window and run the masked
    softmax attention of ``paged_attention_read`` at T=1, in fp32."""
    del page_size  # implied by the pool's shape
    return _attend(q[:, None], gather_window(kc_l, table),
                   gather_window(vc_l, table), pos[:, None])[:, 0]


def paged_decode_q_plain(q, kc_l, vc_l, table, pos, ksc_l, vsc_l,
                        page_size):
    """The plain version of the quantized kernel: ``attend_quantized`` at
    T=1, in fp32."""
    return attend_quantized(q[:, None], kc_l, vc_l, table, pos[:, None],
                            ksc_l, vsc_l, page_size)[:, 0]


def unsupported_reason(head_dim, page_size, pool_dtype):
    """Why the kernel cannot take these shapes, or None when it can."""
    reasons = []
    if head_dim not in SUPPORTED_HEAD_DIMS:
        reasons.append(f"head_dim {head_dim} not in {SUPPORTED_HEAD_DIMS}")
    if page_size not in SUPPORTED_PAGE_SIZES:
        reasons.append(f"page_size {page_size} not in "
                       f"{SUPPORTED_PAGE_SIZES}")
    if pool_dtype not in _POOL_DTYPES and \
            pool_dtype not in _QUANT_POOL_DTYPES:
        reasons.append(f"pool dtype {pool_dtype} not bfloat16/float32/"
                       f"int8/float8_e4m3fn")
    return "; ".join(reasons) or None


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("paged_decode", "paged_decode.cu")
    lib.paged_decode_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
        [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_launch.restype = ctypes.c_int
    lib.paged_decode_q_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
        [ctypes.c_float, ctypes.c_void_p])
    lib.paged_decode_q_launch.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library now."""
    _library()


def _check(q, kc_l, vc_l, table, pos, page_size, dtypes):
    dev = q.device
    for name, t in (("kc_l", kc_l), ("vc_l", vc_l), ("table", table),
                    ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 3 or q.dtype != torch.float32:
        raise ValueError(f"q must be float32 [B, nh, d], got {q.dtype} "
                         f"{tuple(q.shape)}")
    B, nh, d = q.shape
    if kc_l.dim() != 4 or kc_l.shape[1:] != (page_size, nh, d) or \
            vc_l.shape != kc_l.shape or vc_l.dtype != kc_l.dtype:
        raise ValueError(f"pool must be [P, {page_size}, {nh}, {d}] twice, "
                         f"got {tuple(kc_l.shape)} / {tuple(vc_l.shape)}")
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[0] != B:
        raise ValueError(f"table must be int32 [{B}, MP], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be int32 [{B}], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    why = unsupported_reason(d, page_size, kc_l.dtype)
    if why:
        raise ValueError(f"paged decode kernel: {why}")
    if kc_l.dtype not in dtypes:
        raise ValueError(
            f"pool dtype {kc_l.dtype}: this entry takes "
            f"{sorted(str(t) for t in dtypes)} (a quantized pool goes "
            f"through paged_decode_attention_q with its page scales)")
    for name, t in (("q", q), ("kc_l", kc_l), ("vc_l", vc_l),
                    ("table", table), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kc_l", kc_l), ("vc_l", vc_l)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, kc_l, vc_l, table, pos, page_size, scales=None):
    """Check the operands and launch the kernel on the current stream: the
    bf16/fp32 instance, or with ``scales`` = (ksc_l, vsc_l) the int8/fp8
    one. Returns ctx [B, nh, d] float32."""
    if q.device.type != "cuda":
        raise ValueError(f"paged decode attention runs on cuda or cpu, not "
                         f"{q.device}")
    dtypes = _POOL_DTYPES if scales is None else _QUANT_POOL_DTYPES
    _check(q, kc_l, vc_l, table, pos, page_size, dtypes)
    P = kc_l.shape[0]
    for name, t in zip(("ksc_l", "vsc_l"), scales or ()):
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != (P,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{P}] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    lib = _library()
    entry = (lib.paged_decode_launch if scales is None
             else lib.paged_decode_q_launch)
    B, nh, d = q.shape
    out = torch.empty((B, nh, d), dtype=torch.float32, device=q.device)
    ptrs = (q, kc_l, vc_l, table, pos, *(scales or ()), out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(*(t.data_ptr() for t in ptrs), B, nh, d, page_size,
                   table.shape[1], dtypes[kc_l.dtype], 1.0 / d ** 0.5,
                   stream)
    if rc != 0:
        raise RuntimeError(
            f"paged decode kernel launch failed ({rc}): "
            f"{lib.paged_decode_error_string(rc).decode()}")
    return out


def paged_decode_attention(q, kc_l, vc_l, table, pos, page_size):
    """ctx [B, nh, d] float32 of one-token decode attention through the
    page table. CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, kc_l, vc_l, table, pos, page_size)
    out = _launch(q, kc_l, vc_l, table, pos, page_size)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_q(q, kc_l, vc_l, table, pos, ksc_l, vsc_l,
                             page_size):
    """ctx [B, nh, d] float32 of one-token decode attention over an int8
    or float8_e4m3fn pool with per-page scales ksc_l/vsc_l [P] float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    if q.device.type == "cpu":
        return paged_decode_q_plain(q, kc_l, vc_l, table, pos, ksc_l, vsc_l,
                                    page_size)
    out = _launch(q, kc_l, vc_l, table, pos, page_size, (ksc_l, vsc_l))
    paged_decode_attention_q.launches += 1
    return out


paged_decode_attention_q.launches = 0
