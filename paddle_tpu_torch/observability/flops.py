"""Model-FLOP estimators, the single source of every MFU number the port
prints (a copy of ``paddle_tpu/observability/flops.py``: importing the
reference would import jax).

The peak table lists NVIDIA cards by the bf16 dense tensor-core rate of
their data sheets (SXM parts, no sparsity). An unknown device kind has no
peak: ``peak_flops_bf16`` returns None and ``mfu`` then returns None, so no
MFU is printed against a guessed denominator.
"""
from __future__ import annotations

# bf16 dense peak by device-kind substring (NVIDIA data sheets)
PEAK_FLOPS_BF16 = {
    "h100": 989e12,
    "h200": 989e12,
}


def peak_flops_bf16(device_kind: str):
    """Per-card bf16 dense peak for ``torch.cuda.get_device_name()``, or
    None for a card the table does not list."""
    dk = (device_kind or "").lower()
    for k, v in PEAK_FLOPS_BF16.items():
        if k in dk:
            return v
    return None


def model_flops_per_token(cfg, seq_len):
    """GPT-family training FLOPs per token: 6N matmul + attention term
    (fwd+bwd). ``cfg`` needs hidden_size / num_layers / vocab_size /
    max_seq_len. Returns (flops_per_token, n_params)."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    n_params = 12 * L * H * H + V * H * 2 + cfg.max_seq_len * H
    attn = attention_flops_per_token(L, H, seq_len)
    return 6 * n_params + attn, n_params


def dense_flops_per_token(n_params):
    """Transformer training FLOPs per token from the parameter count alone
    (the 6N rule), for models counted by their live parameters (BERT)."""
    return 6 * int(n_params)


def attention_flops_per_token(num_layers, hidden_size, seq_len):
    """The attention term of a training step per token: 2 * 2 * S * H per
    layer forward (scores and P V), x3 with the backward."""
    return 12 * num_layers * hidden_size * seq_len


def train_step_flops(cfg, batch, seq_len):
    """Total training FLOPs of one (batch, seq) step."""
    fpt, n_params = model_flops_per_token(cfg, seq_len)
    return fpt * batch * seq_len, n_params


def mfu(flops, wall_s, peak_flops, cards=1):
    """Achieved / peak over ``cards`` cards (a parallel step's whole model
    FLOPs over its step time on n cards, n = dp x mp x pp for a hybrid
    world: ``flops / (wall_s * n * peak)``); None when any input is
    missing or degenerate."""
    if not flops or not wall_s or not peak_flops or not cards:
        return None
    return (flops / wall_s) / (peak_flops * cards)
