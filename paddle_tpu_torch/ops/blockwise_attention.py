"""Blockwise attention in plain PyTorch (counterpart of
``paddle_tpu/ops/blockwise_attention.py``).

The attention the reference trains through when its flash kernel is off
(``GPTConfig.use_flash=False`` or no TPU): an online softmax over key
blocks in fp32, differentiable by autograd. In the port it is the path
``use_flash=False`` selects, and its algebra — scores of ``q * scale``
against k, masked entries at -1e30, ``out = acc / max(l, 1e-30)`` — is the
one the flash kernels' plain versions follow.

Layout [batch, seq, heads, head_dim].
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def blockwise_attention(q, k, v, causal=True, block_k=512):
    """q, k, v: [B, S, H, D] -> [B, S, H, D] in q's dtype. The key length
    must be a multiple of ``min(block_k, Sk)``, as in the reference."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    block_k = min(block_k, Sk)
    if Sk % block_k:
        raise ValueError(f"key length {Sk} is not a multiple of block_k "
                         f"{block_k}")
    scale = D ** -0.5
    qf = (q.float() * scale).permute(0, 2, 1, 3)           # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = torch.arange(Sq, device=q.device)
    m = qf.new_full((B, H, Sq), _NEG_INF)
    l = qf.new_zeros((B, H, Sq))
    acc = torch.zeros_like(qf)
    for start in range(0, Sk, block_k):
        kb = kf[:, :, start:start + block_k]
        vb = vf[:, :, start:start + block_k]
        s = qf @ kb.transpose(-1, -2)                       # [B, H, Sq, bk]
        if causal:
            k_pos = start + torch.arange(block_k, device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                            s.new_tensor(_NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
