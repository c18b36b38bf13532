"""GPT configuration, the fp32 LayerNorm and the training block
(counterpart of ``paddle_tpu/models/gpt.py``).

``GPTConfig`` keeps the reference's field names and defaults, so one set
of keyword arguments builds both frameworks' configs. Fields that only
the reference's TPU and pipeline paths read (flash tiles, pp) are carried
unchanged.

``gpt_block_fn`` is the block the training step runs over a
``{name: tensor}`` dict of one layer's params: ``gpt_block_prelude_fn``
(everything up to the MLP's down projection) and the tail
``resid + (gact @ down_w + down_b)``. It keeps the reference's
association of the MLP residual, which is not the serving block's
``(h + up @ down_w) + down_b`` (``generation._block``): each side keeps
its own reference's rounding. ``gpt_fused_boundary`` is the last block of
a pipeline stage on the fused pp rung: the prelude, and the tail through
the boundary kernel that posts the stage's output to the next stage.

The eager model (``GPTAttention``, ``GPTMLP``, ``GPTBlock``, ``GPTModel``,
``GPTForCausalLM``, ``gpt_loss_fn``; reference gpt.py:100-258) is the
``torch.nn.Module`` form that ``jit.TrainStep`` trains: the reference
Layer's parameter names, shapes and ``named_parameters`` order, fp32
parameters cast to the compute dtype at each use, the block the algebra
of ``gpt_block_fn``, each block under the ``dots_no_batch`` remat preset
when ``config.remat`` is set, and fp32 logits [B, S, V] from the fp32
final hidden states.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.recompute import remat
from ..nn.functional import cross_entropy, linear
from ..nn.layer import (Dropout, Embedding, LayerNorm, Linear,
                        layer_named_parameters)
from ..ops.blockwise_attention import blockwise_attention
from ..ops.flash_attention import flash_attention_bshd
from ..ops.pp_boundary import fused_gemm_ppsend


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


def attention(q, k, v, config):
    """Causal attention over [B, S, nh, d] q, k, v (strided views are
    fine): the flash kernels when ``config.use_flash`` (their plain
    versions for CPU tensors), else the plain blockwise attention."""
    if config.use_flash:
        return flash_attention_bshd(q, k, v, causal=True)
    return blockwise_attention(q, k, v, causal=True)


def gpt_block_prelude_fn(config):
    """(p, x) -> (resid, gact) of one pre-LN block over x [B, S, H]: fp32
    LayerNorm, qkv GEMM, causal attention (``attention``), out GEMM and
    the post-attention residual ``resid``; fp32 LayerNorm, up GEMM and
    tanh-GELU ``gact`` [B, S, 4H] (reference gpt.py:273). With
    ``config.qkv_head_major`` the qkv columns are stored head-major,
    [nh, 3, d] (``distributed.tp_overlap.to_qkv_head_major``), and read
    so: a relabeling, the same function bit for bit."""
    nh = config.num_heads
    eps = config.layer_norm_epsilon
    head_major = config.qkv_head_major

    def prelude(p, x):
        B, S, H = x.shape
        dt = x.dtype
        h1 = ln_fp32(x, p["ln1_g"], p["ln1_b"], eps)
        qkv = h1 @ p["qkv_w"].to(dt) + p["qkv_b"].to(dt)
        # unbind: strided views the flash kernels read in place, whose
        # backward is one stack into d(qkv)
        if head_major:
            q, k, v = qkv.view(B, S, nh, 3, H // nh).unbind(3)
        else:
            q, k, v = qkv.view(B, S, 3, nh, H // nh).unbind(2)
        ctx = attention(q, k, v, config)
        x = x + (ctx.reshape(B, S, H) @ p["out_w"].to(dt) + p["out_b"].to(dt))
        h2 = ln_fp32(x, p["ln2_g"], p["ln2_b"], eps)
        up = F.gelu(h2 @ p["up_w"].to(dt) + p["up_b"].to(dt),
                    approximate="tanh")
        return x, up

    return prelude


def gpt_block_fn(config):
    """(p, x) -> x of one pre-LN block over x [B, S, H]:
    ``gpt_block_prelude_fn``, then the residual
    ``resid + (gact @ down_w + down_b)``."""
    prelude = gpt_block_prelude_fn(config)

    def block(p, x):
        x, up = prelude(p, x)
        dt = x.dtype
        return x + (up @ p["down_w"].to(dt) + p["down_b"].to(dt))

    return block


def gpt_fused_boundary(config, group, remat_policy=None):
    """``boundary(last_layer_params, h, post) -> y`` for
    ``distributed.pipeline.run_pipeline(boundary=...)`` on the fused pp
    rung (reference gpt.py:326): the stage's last block as the prelude
    (under ``remat_policy``, ``distributed.recompute``) and the tail
    ``resid + (gact @ down_w + down_b)`` through the boundary kernel
    (``ops.pp_boundary.FusedGemmPpSend``), which posts y to ``group``'s
    next rank and hands the hop to ``post``. The hop stays outside the
    checkpoint."""
    prelude = remat(gpt_block_prelude_fn(config), remat_policy)

    def boundary(p, h, post):
        resid, gact = prelude(p, h)
        dt = h.dtype
        return fused_gemm_ppsend(gact, p["down_w"].to(dt),
                                 p["down_b"].to(dt), resid, group, post)

    return boundary


# ------------------------------------------------------------ eager model
class GPTAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.cfg = config
        h = config.hidden_size
        self.qkv_proj = Linear(h, 3 * h)
        self.out_proj = Linear(h, h)

    def forward(self, x):
        B, S, H = x.shape
        nh = self.cfg.num_heads
        q, k, v = self.qkv_proj(x).view(B, S, 3, nh, H // nh).unbind(2)
        return self.out_proj(attention(q, k, v, self.cfg).reshape(B, S, H))


class GPTMLP(nn.Module):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        self.up_proj = Linear(h, config.ffn_mult * h)
        self.down_proj = Linear(config.ffn_mult * h, h)

    def forward(self, x):
        return self.down_proj(F.gelu(self.up_proj(x), approximate="tanh"))


class GPTBlock(nn.Module):
    def __init__(self, config):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln_1 = LayerNorm(h, epsilon=eps)
        self.attn = GPTAttention(config)
        self.ln_2 = LayerNorm(h, epsilon=eps)
        self.mlp = GPTMLP(config)
        self.dropout = Dropout(config.dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size)
        for emb in (self.wte, self.wpe):
            nn.init.normal_(emb.weight, 0.0, config.initializer_range)
        self.drop = Dropout(config.dropout)
        self.h = nn.ModuleList(GPTBlock(config)
                               for _ in range(config.num_layers))
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(pos)
        x = self.drop(x.to(compute_dtype(self.config)))
        for block in self.h:
            x = remat(block, "dots_no_batch")(x) if self.config.remat \
                else block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config)
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False)
            nn.init.normal_(self.lm_head.weight, 0.0,
                            config.initializer_range)

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        """The reference Layer's order (``nn.layer.layer_named_parameters``):
        ``lm_head.weight``, the embeddings and ``ln_f``, every block's
        LayerNorms, then every block's projections."""
        return layer_named_parameters(self, prefix)

    def forward(self, input_ids):
        hidden = self.gpt(input_ids).float()
        if self.lm_head is None:
            return linear(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


def gpt_loss_fn(logits, labels):
    """Next-token cross-entropy: logits [B, S, V] at positions 0 .. S-2
    against the labels at 1 .. S-1, the mean over them."""
    V = logits.shape[-1]
    return cross_entropy(logits[:, :-1, :].reshape(-1, V),
                         labels[:, 1:].reshape(-1))
