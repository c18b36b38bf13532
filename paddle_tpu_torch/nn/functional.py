"""The functionals the eager layers and losses use (counterpart of
``paddle_tpu/nn/functional/common.py``, ``norm.py``, ``loss.py``,
``activation.py`` and ``attention.py``), in the reference's cast order.

``linear`` keeps the reference's weight layout ``[in, out]`` and casts the
weight (and the bias) to the input's dtype before the product; it runs as
one 2-D ``torch.mm`` over the input's rows, the product the ``dots_no_batch``
remat preset saves (``distributed/recompute.py``).

``scaled_dot_product_attention``, Paddle's ``flash_attention`` and
``flash_attn_unpadded`` run the flash kernels (``ops/flash_attention.py``,
with the mask as an additive bias, in-kernel dropout, and for the varlen
form segment ids over a packed row), or the composed ``_sdpa_reference``
when ``FLAGS_use_flash_attention`` is off: that flag is the one way to
take the composed route. A call the kernels cannot take
(``flash_unsupported_reason``) is counted in
``scaled_dot_product_attention.fallbacks`` and raises with its reason, as
every other wrapper of the port does. One such call is refused on every
device: ``is_causal`` with q and key lengths apart, which the reference
aligns two ways (its kernel top-left, ``key <= query``; its composed path
bottom-right, ``tril(k=klen - qlen)``); the port does not pick one. Both
routes draw the dropout's Philox key from ``framework.random`` and drop
the same (query, key) pairs (``ops/philox.py``), so a step through either
from the same generator state sees the same masks. ``dropout`` (hidden
dropout: no kernel in the reference either) draws ``bernoulli_`` from the
tensor's device generator of ``framework.random``.
"""
from __future__ import annotations

import torch

from ..flags import get_flags
from ..framework import random
from ..ops import flash_attention as fa
from ..ops import philox


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


def dropout(x, p=0.5, training=True):
    """Upscale-in-train dropout: ``x / (1 - p)`` where kept, 0 elsewhere
    (reference nn/functional/common.py:29-44), the keep mask drawn by
    ``bernoulli_`` from x's device generator."""
    if not training or not p:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=random.generator(x.device)).bool()
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def gelu(x, approximate=False):
    """GELU, exact (erf) unless ``approximate`` (reference
    nn/functional/activation.py:31)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


# ---------------------------------------------------------------- attention
def _mask_to_bias(mask):
    """A paddle-style attn_mask (bool keep-mask or additive float, any
    broadcastable rank) as an additive fp32 bias of rank 4: a bool mask's
    masked entries become -1e30 (reference nn/functional/attention.py:
    41-51)."""
    m = mask
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, -1e30).to(torch.float32)
    else:
        m = m.float()
    while m.dim() < 4:
        m = m.unsqueeze(0)
    return m


def _sdpa_probs(q, k, mask=None, causal=False, scale=None):
    """fp32 softmax probabilities [B, H, Sq, Sk] of q, k [B, S, H, D]."""
    s = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * s
    if causal:
        qlen, klen = logits.shape[-2:]
        cm = torch.ones(qlen, klen, dtype=torch.bool,
                        device=q.device).tril(klen - qlen)
        logits = torch.where(cm, logits, -1e30)
    if mask is not None:
        logits = logits + _mask_to_bias(mask)
    return torch.softmax(logits, dim=-1)


def _sdpa_reference(q, k, v, mask=None, causal=False, scale=None,
                    dropout_p=0.0, key=None):
    """The composed path, q, k, v [B, S, H, D]; dropout drops what the
    flash kernels would under the same Philox ``key``."""
    probs = _sdpa_probs(q, k, mask=mask, causal=causal, scale=scale)
    if dropout_p > 0.0 and key is not None:
        B, H, Sq, Sk = probs.shape
        keep = philox.keep_mask(B, H, Sq, Sk, dropout_p, key,
                                device=probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def flash_unsupported_reason(q, k, is_causal=False):
    """Why the flash path cannot take attention of q [B, Sq, H, D] against
    k [B, Sk, H, D] (the port's counterpart of the reference's
    ``flash_supported``), or None. On every device: ``is_causal`` with Sq
    != Sk, whose alignment the reference leaves two ways. On CPU tensors
    the flash wrappers run their plain versions, which take any other
    case; on CUDA the kernels take bfloat16 and float16 and head dims 64
    and 128."""
    reasons = []
    if is_causal and q.shape[1] != k.shape[1]:
        reasons.append(
            f"is_causal with q length {q.shape[1]} != key length "
            f"{k.shape[1]}: the reference's flash kernel aligns the causal "
            f"mask top-left (key <= query) and its composed path "
            f"bottom-right (tril(k=klen - qlen)); pass the mask you mean as "
            f"attn_mask")
    if q.device.type == "cuda":
        why = fa.unsupported_reason(q.shape[-1], q.dtype)
        if why:
            reasons.append(why)
        if k.dtype != q.dtype:
            reasons.append(f"k is {k.dtype}, q {q.dtype}")
    return "; ".join(reasons) or None


def _refuse(why):
    scaled_dot_product_attention.fallbacks += 1
    raise NotImplementedError(
        f"the flash attention kernels cannot take this call: {why}; set "
        f"FLAGS_use_flash_attention=False to run the composed path")


def _flash_on():
    return get_flags("FLAGS_use_flash_attention")["FLAGS_use_flash_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention of [batch, seq, heads, head_dim] tensors (reference
    nn/functional/attention.py:63-96): the flash kernels with the mask as
    an additive bias and in-kernel dropout, or the composed path when
    ``FLAGS_use_flash_attention`` is off. A call the kernels cannot take
    is counted in ``.fallbacks`` and raises; so does a kernel that fails
    to build or launch."""
    p = float(dropout_p) if training else 0.0
    pkey = random.philox_key() if p > 0.0 else None
    if _flash_on():
        why = flash_unsupported_reason(query, key, is_causal)
        if why is not None:
            _refuse(why)
        bias = None if attn_mask is None else _mask_to_bias(attn_mask)
        return fa.flash_attention_bshd(query, key, value, is_causal,
                                       bias, None, p, pkey)
    return _sdpa_reference(query, key, value, mask=attn_mask,
                           causal=is_causal, dropout_p=p, key=pkey)


scaled_dot_product_attention.fallbacks = 0


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Paddle's ``flash_attention`` (reference nn/functional/
    attention.py:117-144): (out, None) through
    ``scaled_dot_product_attention``; with ``return_softmax`` the composed
    path, returning (out, the fp32 softmax [B, H, Sq, Sk] before
    dropout), as the reference's debug mode does."""
    if not return_softmax:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal, training), None
    p = float(dropout) if training else 0.0
    probs = _sdpa_probs(query, key, causal=causal)
    dropped = probs
    if p > 0.0:
        B, H, Sq, Sk = probs.shape
        keep = philox.keep_mask(B, H, Sq, Sk, p, random.philox_key(),
                                device=probs.device)
        dropped = torch.where(keep, probs / (1.0 - p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", dropped.to(value.dtype), value)
    return out, probs


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over packed [total, heads, head_dim] tensors and
    ``cu_seqlens`` boundaries (reference nn/functional/attention.py:
    147-194): ``ops.flash_attention.flash_attention_varlen`` (the kernels
    with segment ids), or with ``FLAGS_use_flash_attention`` off the
    composed path with a dense segment mask. Returns (out, None);
    ``return_softmax`` raises, as the reference's does."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True) is a debug mode the "
            "reference does not provide either; unpack and use "
            "flash_attention")
    p = float(dropout) if training else 0.0
    pkey = random.philox_key() if p > 0.0 else None
    sm_scale = query.shape[-1] ** -0.5 if scale is None else float(scale)
    if _flash_on():
        why = flash_unsupported_reason(query[None], key[None])
        if why is not None:
            _refuse(why)
        return fa.flash_attention_varlen(query, key, value, cu_seqlens_q,
                                         cu_seqlens_k, causal, sm_scale, p,
                                         pkey), None
    qseg = fa.varlen_segment_ids(cu_seqlens_q, query.shape[0],
                                 query.shape[0])
    kseg = fa.varlen_segment_ids(cu_seqlens_k, key.shape[0], key.shape[0])
    mask = qseg[:, None] == kseg[None, :]
    return _sdpa_reference(query[None], key[None], value[None],
                           mask=mask[None, None], causal=causal,
                           scale=sm_scale, dropout_p=p, key=pkey)[0], None
