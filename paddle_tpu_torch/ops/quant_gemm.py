"""Weight-only quantized GEMM: the hand-written CUDA kernel
(``csrc/quant_gemm.cu``), its wrapper and its plain PyTorch version
(counterpart of ``paddle_tpu/ops/pallas_kernels/quant_gemm.py:57-156``).

Replaces the TPU kernel ``_quant_gemm_kernel`` (through
``quant_gemm_kernel``): ``x [..., K] @ wq [K, F]`` with int8 or
float8_e4m3fn weights, fp32 accumulation and the per-output-channel fp32
scale [F] multiplied in the epilogue, cast once to x's type (bf16 for the
serving blocks, fp32 for the LM head). The full-precision weight never
exists in device memory.

The plain version is the reference's jnp algebra,
``(x @ wq.astype(x.dtype)) * scale.astype(x.dtype)`` (two roundings at
bf16: after the product and after the scale), through
``generation._matmul`` so that the CPU engine keeps its bitwise promise.
The kernel rounds once, so on the card the two agree to a bf16
tolerance, not bit for bit.

``quant_gemm`` takes the plain version for tensors on the CPU, and on CUDA
only when the caller passes ``use_kernel=False``
(``FLAGS_serving_quant_kernel``). Otherwise it launches the kernel or
raises: a shape the kernel does not take is refused, never served by the
plain version. ``quant_gemm.launches`` counts the kernel's launches and
``quant_gemm.shapes`` the same launches by (R, K, F).
``lora_delta``/``compose_delta`` come with adapters (ROADMAP Queue A 9).

``gemm_into`` is the library's launcher for both callers: this module's
quantized GEMM and the tensor-parallel projections of
``ops/fused_collectives.py``, which also run bf16 (and, for an LM head
passed at fp32, fp32) weights without a scale and store the block into
this rank's slot of their peer channel. bf16 x runs the tensor-core kernel
(wgmma fed by TMA) at every row count, fp32 x the CUDA-core stream
kernel; ``plan`` says which, per shape, once.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..cuda_build import load_library, wait_record
from ..models.generation import _matmul

W_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
X_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the weight types the library takes: the quantized ones (with a scale)
# and the tensor-parallel projections' full-precision weights (no scale):
# bf16, and fp32 against fp32 x only (an LM head passed at fp32)
FULL_W_DTYPES = {torch.bfloat16: 2, torch.float32: 3}
LIB_W_DTYPES = {**W_DTYPES, **FULL_W_DTYPES}


def quant_gemm_plain(x, wq, scale):
    """``(x @ wq.to(x.dtype)) * scale.to(x.dtype)`` over any leading dims
    of x: the reference's jnp algebra."""
    lead = x.shape[:-1]
    K, F = wq.shape
    y = _matmul(x.reshape(-1, K), wq.to(x.dtype))
    return (y * scale.to(x.dtype)).reshape(lead + (F,))


# The kernel against its plain version, per element:
# |kernel - plain| <= ELEMENT_TOL * (|plain| + rms of plain's row), per
# row ||kernel - plain|| <= ROW_TOL * ||plain||, and the same per 64 x 64
# tile with TILE_TOL. bf16: the plain version rounds the product and the
# scaled product to bf16 (up to 2^-8 relative each), the kernel rounds
# once, and their fp32 sums differ in order, which shows where a row's sum
# cancels (hence the row rms term). fp32: only the summation order and one
# extra rounding differ. The tile reading catches a block of the output
# that a kernel got wrong or skipped (it then reads about 1) in a row too
# long for that block to move the row's norm. Its gate is twice the row's:
# a tile of a one-row call holds 64 values, whose relative L2 error
# scatters around the row's (an exact one-rounding emulation of the kernel
# on the CPU reads 3.5e-3 per row and up to 5.3e-3 per one-row tile at
# F = 50304, int8 and fp8).
ELEMENT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
ROW_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
TILE_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
TILE = 64


def error_vs_plain(got, want):
    """Readings of the kernel's output against the plain version's: max
    abs error, the worst element's error over (|plain| + row rms), the
    worst row's and the worst 64 x 64 tile's relative L2 error (leading
    dims folded into rows)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    element = float((err / (w.abs() + rms).clamp(min=1e-30)).max())
    row = float(((g - w).norm(dim=-1) /
                 w.norm(dim=-1).clamp(min=1e-30)).max())
    d2, w2 = (g - w).reshape(-1, w.shape[-1]), w.reshape(-1, w.shape[-1])
    R, F = w2.shape
    pad = (0, -F % TILE, 0, -R % TILE)
    d2, w2 = (torch.nn.functional.pad(t, pad).reshape(
        (R + pad[3]) // TILE, TILE, (F + pad[1]) // TILE, TILE)
        for t in (d2, w2))
    tile = float((d2.square().sum((1, 3)).sqrt() /
                  w2.square().sum((1, 3)).sqrt().clamp(min=1e-30)).max())
    return {"max_abs": float(err.max()), "element": element, "row": row,
            "tile": tile}


def within_tolerance(readings, dtype):
    return (readings["element"] <= ELEMENT_TOL[dtype]
            and readings["row"] <= ROW_TOL[dtype]
            and readings["tile"] <= TILE_TOL[dtype])


def unsupported_reason(K, F, w_dtype, x_dtype):
    """Why the kernel cannot take these shapes and types, or None."""
    reasons = []
    if K % 16:
        reasons.append(f"contraction dim {K} not a multiple of 16")
    if F % 16:
        reasons.append(f"out dim {F} not a multiple of 16 (16-byte weight "
                       f"row loads)")
    if w_dtype not in W_DTYPES:
        reasons.append(f"weight dtype {w_dtype} not int8/float8_e4m3fn")
    if x_dtype not in X_DTYPES:
        reasons.append(f"x dtype {x_dtype} not bfloat16/float32")
    return "; ".join(reasons) or None


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("quant_gemm", "quant_gemm.cu")
    lib.quant_gemm_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.quant_gemm_launch.restype = ctypes.c_int
    lib.quant_gemm_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.quant_gemm_plan.restype = ctypes.c_int
    lib.quant_gemm_wait_record.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.quant_gemm_wait_record.restype = None
    lib.quant_gemm_error_string.argtypes = [ctypes.c_int]
    lib.quant_gemm_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library now."""
    _library()


MODES = {0: "stream", 1: "tensor-core"}


@functools.lru_cache(maxsize=None)
def plan(R, K, F, w_dtype, x_dtype, device_index):
    """How one call runs on the device: (mode, rows, k splits, k rows per
    split), from the library's ``quant_gemm_plan``: mode 1, the
    tensor-core kernel, for bf16 x at row width ``rows`` (8 to 128), mode
    0, the stream kernel, for fp32 x over row groups of ``rows``; k is
    split over blocks until the launch fills the SMs once."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = lib.quant_gemm_plan(R, K, F, LIB_W_DTYPES[w_dtype],
                                 X_DTYPES[x_dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"quant GEMM plan failed ({rc}): "
                           f"{lib.quant_gemm_error_string(rc).decode()}")
    return tuple(out)


def wait_timeout_record():
    """What the first mbarrier wait of the tensor-core kernel that timed
    out in this process was waiting for (``cuda_build.wait_record``; the
    row is 3), or None."""
    return wait_record(_library().quant_gemm_wait_record)


def _check(x, wq, scale):
    dev = x.device
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if wq.dim() != 2 or x.shape[-1] != wq.shape[0]:
        raise ValueError(f"x [..., K] and wq [K, F] disagree: "
                         f"{tuple(x.shape)} / {tuple(wq.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (wq.shape[1],):
        raise ValueError(f"scale must be float32 [{wq.shape[1]}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    why = unsupported_reason(wq.shape[0], wq.shape[1], wq.dtype, x.dtype)
    for name, t in (("x", x), ("wq", wq), ("scale", scale)):
        if not t.is_contiguous():
            why = (why + "; " if why else "") + f"{name} is not contiguous"
        elif t.data_ptr() % 16:
            why = (why + "; " if why else "") + f"{name} is not 16-byte " \
                "aligned"
    if why:
        raise ValueError(f"quant GEMM kernel: {why}; set "
                         f"FLAGS_serving_quant_kernel=False to run the "
                         f"plain version")


def quant_gemm(x, wq, scale, use_kernel=True):
    """Weight-only quantized projection ``x [..., K] @ wq [K, F]`` with the
    per-output-channel scale [F] in the epilogue; out [..., F] in x's
    dtype. CPU tensors, and CUDA tensors with ``use_kernel=False``, take
    the plain version; other CUDA tensors launch the kernel on the
    current stream."""
    if not use_kernel or x.device.type == "cpu":
        return quant_gemm_plain(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant GEMM runs on cuda or cpu, not {x.device}")
    _check(x, wq, scale)
    lead = x.shape[:-1]
    K, F = wq.shape
    x2 = x.reshape(-1, K)
    out = torch.empty((x2.shape[0], F), dtype=x.dtype, device=x.device)
    gemm_into(x2, wq, scale, out)
    quant_gemm.launches += 1
    quant_gemm.shapes[(x2.shape[0], K, F)] += 1
    return out.reshape(lead + (F,))


def gemm_into(x2, w, scale, out):
    """Launch the library's GEMM ``out = (x2 @ w) * scale`` on the current
    stream of x2's CUDA device: x2 [R, K] bf16/fp32 contiguous, w [K, F]
    int8/fp8 with scale fp32 [F], or bf16 (fp32 against fp32 x) with
    ``scale=None``; ``out`` an
    [R, F] view in x2's dtype whose rows may be strided (``out.stride(0)``
    >= F, unit column stride), written in place. The caller has checked
    the operands; raises when the library refuses the launch. Returns the
    kernel launches made: 1, or 2 for a k split (its reduce)."""
    lib = _library()
    R, K = x2.shape
    F = w.shape[1]
    index = x2.device.index if x2.device.index is not None \
        else torch.cuda.current_device()
    mode, rows, splits, k_per = plan(R, K, F, w.dtype, x2.dtype, index)
    ws = (torch.empty((splits, R, F), dtype=torch.float32, device=x2.device)
          if splits > 1 else None)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = lib.quant_gemm_launch(
            x2.data_ptr(), w.data_ptr(),
            0 if scale is None else scale.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(), R, K, F, out.stride(0),
            LIB_W_DTYPES[w.dtype], X_DTYPES[x2.dtype], mode, rows, splits,
            k_per, stream)
    if rc != 0:
        raise RuntimeError(f"quant GEMM kernel launch failed ({rc}): "
                           f"{lib.quant_gemm_error_string(rc).decode()}")
    return 2 if splits > 1 else 1


quant_gemm.launches = 0
quant_gemm.shapes = collections.Counter()
