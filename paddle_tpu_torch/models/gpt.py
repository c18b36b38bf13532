"""GPT configuration and the fp32 LayerNorm (counterpart of
``paddle_tpu/models/gpt.py``).

``GPTConfig`` keeps the reference's field names and defaults, so one set
of keyword arguments builds both frameworks' configs. Fields that only
the reference's training and Pallas paths read (flash tiles, remat, pp)
are carried unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_seq_len: int = 2048
    ffn_mult: int = 4
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_flash: bool = True
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    flash_block_q: int = 256
    flash_block_k: int = 256
    tie_embeddings: bool = False
    pp_schedule: str = "1f1b"
    pp_interleave: int = 1
    vpp_stage_major: bool = False
    qkv_head_major: bool = False


# headline model family (GPT-3 sizes), identical to the reference table
GPT_CONFIGS = {
    "gpt3-125M": GPTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt3-345M": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt3-760M": GPTConfig(hidden_size=1536, num_layers=24, num_heads=16),
    "gpt3-1.3B": GPTConfig(hidden_size=2048, num_layers=24, num_heads=16),
    "gpt3-2.7B": GPTConfig(hidden_size=2560, num_layers=32, num_heads=32),
    "gpt3-6.7B": GPTConfig(hidden_size=4096, num_layers=32, num_heads=32),
    "gpt3-13B": GPTConfig(hidden_size=5120, num_layers=40, num_heads=40),
}


def compute_dtype(config) -> torch.dtype:
    """The torch dtype of ``config.compute_dtype`` (None -> float32)."""
    name = config.compute_dtype or "float32"
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtype


def ln_fp32(x, g, b, eps):
    """LayerNorm normalized in fp32, cast back to x.dtype, then scaled and
    shifted in x.dtype — the reference's exact cast order (the variance is
    the mean of squared deviations, as ``jnp.var`` computes it)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g.to(x.dtype) \
        + b.to(x.dtype)
