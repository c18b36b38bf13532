"""The functionals the eager layers and losses use (counterpart of
``paddle_tpu/nn/functional/common.py``, ``norm.py`` and ``loss.py``), in
the reference's cast order.

``linear`` keeps the reference's weight layout ``[in, out]`` and casts the
weight (and the bias) to the input's dtype before the product; it runs as
one 2-D ``torch.mm`` over the input's rows, the product the ``dots_no_batch``
remat preset saves (``distributed/recompute.py``).
"""
from __future__ import annotations

import torch


def linear(x, weight, bias=None):
    """``x [..., in] @ weight [in, out] (+ bias)``, weight and bias cast to
    x's dtype (reference nn/functional/common.py:18-26)."""
    out = torch.mm(x.reshape(-1, x.shape[-1]), weight.to(x.dtype)).view(
        x.shape[:-1] + (weight.shape[1],))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis: normalized in fp32, cast to x's
    dtype, then scaled and shifted in x's dtype (reference
    nn/functional/norm.py:17-37), the port's ``models.gpt.ln_fp32``."""
    from ..models.gpt import ln_fp32     # models imports this package
    return ln_fp32(x, weight, bias, epsilon)


def cross_entropy(input, label, ignore_index=-100):
    """Mean over the labels that are not ``ignore_index`` of the negative
    fp32 log-softmax at the label (reference nn/functional/loss.py:22-65,
    hard labels, no weight or smoothing)."""
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    nll = -logp.gather(-1, safe.long().unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.float().sum().clamp(min=1.0)


def mse_loss(input, label):
    """Mean of ``(input - label) ** 2``."""
    return (input - label).square().mean()
