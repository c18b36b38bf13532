"""Fused LM head + softmax cross-entropy, chunked over the vocab axis
(counterpart of ``paddle_tpu/ops/fused_ce.py``).

The fp32 [N, V] logits never exist: the forward runs an online logsumexp
over ``_chunking(V, num_chunks)`` vocab chunks and gathers each row's gold
logit; the backward recomputes each chunk's logits and applies
``(softmax - onehot) * g`` chunk by chunk. At GPT-3 1.3B (B=8, S=2048,
V=50304) one fp32 logits buffer would be 3.3 GB; a chunk is an eighth.

Chunk logits are fp32 products of the input-dtype operands, as the
reference's ``preferred_element_type=f32``: on CUDA ``torch.mm(a, b,
out_dtype=torch.float32)`` (cuBLAS with fp32 output, no bf16 rounding of
the logits); on the CPU, which has no ``mm`` with an output dtype, the
operands are upcast to fp32, whose products of bf16 values are exact. The
backward casts ``(softmax - onehot) * g`` to the input dtype before its
two GEMMs and accumulates in fp32, as the reference does. The last chunk
is narrower when the chunks overrun V, which drops the reference's
padded columns instead of masking them. An optional head bias [V] (BERT's
MLM head; ``_fce_bias`` in the reference) is added to each chunk's fp32
logits and gets the column sums of the fp32 ``(softmax - onehot) * g`` as
its gradient.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function


def _chunking(V: int, num_chunks: int):
    """Chunk width (a multiple of 128 when V >= 128) covering V in at most
    ``num_chunks`` chunks, and the number of chunks."""
    c = -(-V // max(num_chunks, 1))
    c = -(-c // 128) * 128 if V >= 128 else c
    n = -(-V // c)
    return c, n


def _mm_f32(a, b):
    """a @ b with an fp32 result from operands of any float dtype."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(V, num_chunks):
    C, n = _chunking(V, num_chunks)
    return [(i * C, min((i + 1) * C, V)) for i in range(n)]


def _logits(hidden, head_w, head_b, lo, hi):
    """fp32 logits of vocab columns [lo, hi), with the head bias."""
    logits = _mm_f32(hidden, head_w[:, lo:hi])
    return logits if head_b is None else logits + head_b[lo:hi].float()


def _fwd_stats(hidden, head_w, labels, num_chunks, head_b=None):
    """Online logsumexp and gold logit over vocab chunks: (logz [N] fp32,
    gold [N] fp32)."""
    N = hidden.shape[0]
    f32 = dict(dtype=torch.float32, device=hidden.device)
    m = torch.full((N,), float("-inf"), **f32)
    s = torch.zeros(N, **f32)
    gold = torch.zeros(N, **f32)
    for lo, hi in _chunks(head_w.shape[1], num_chunks):
        logits = _logits(hidden, head_w, head_b, lo, hi)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        idx = (labels - lo).clamp(0, hi - lo - 1)
        g = logits.gather(1, idx[:, None])[:, 0]
        gold = torch.where((labels >= lo) & (labels < hi), g, gold)
        m = m_new
    return m + torch.log(s), gold


def _bwd(hidden, head_w, head_b, labels, logz, g, num_chunks):
    """(dh, dW, dB or None) of the per-token losses for cotangent g [N]."""
    N, H = hidden.shape
    V = head_w.shape[1]
    dh = torch.zeros(N, H, dtype=torch.float32, device=hidden.device)
    dW = torch.empty(H, V, dtype=torch.float32, device=hidden.device)
    dB = None if head_b is None else torch.empty(
        V, dtype=torch.float32, device=hidden.device)
    g = g.float()
    for lo, hi in _chunks(V, num_chunks):
        logits = _logits(hidden, head_w, head_b, lo, hi)
        delta = torch.exp(logits - logz[:, None])
        in_c = (labels >= lo) & (labels < hi)
        idx = (labels - lo).clamp(0, hi - lo - 1)
        delta.scatter_add_(1, idx[:, None], -in_c.float()[:, None])
        delta = delta * g[:, None]
        if dB is not None:
            dB[lo:hi] = delta.sum(0)
        dc = delta.to(hidden.dtype)
        dh += _mm_f32(dc, head_w[:, lo:hi].t())
        dW[:, lo:hi] = _mm_f32(hidden.t(), dc)
    return (dh.to(hidden.dtype), dW.to(head_w.dtype),
            None if dB is None else dB.to(head_b.dtype))


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head_w, head_b, labels, num_chunks):
        with record_function("fused_ce/forward"):
            logz, gold = _fwd_stats(hidden, head_w, labels, num_chunks,
                                    head_b)
        ctx.save_for_backward(hidden, head_w, head_b, labels, logz)
        ctx.num_chunks = num_chunks
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        hidden, head_w, head_b, labels, logz = ctx.saved_tensors
        with record_function("fused_ce/backward"):
            dh, dW, dB = _bwd(hidden, head_w, head_b, labels, logz, g,
                              ctx.num_chunks)
        return dh, dW, dB, None, None


def fused_linear_cross_entropy(hidden, head_w, labels, num_chunks=8,
                               head_b=None):
    """Per-token CE of ``softmax(hidden @ head_w [+ head_b])`` against
    ``labels`` without materializing the logits. hidden [N, H], head_w
    [H, V], head_b [V] or None, labels [N] int. Returns losses [N] fp32;
    callers apply their own mask and reduction."""
    return _FusedLinearCE.apply(hidden, head_w, head_b, labels.long(),
                                num_chunks)


def fused_lm_loss(hidden, head_w, ids, num_chunks=8, shift=True):
    """Mean next-token LM loss from final hidden states [B, S, H], head_w
    [H, V] and ids [B, S]. With ``shift``, position t predicts t+1."""
    if shift:
        hidden = hidden[:, :-1]
        labels = ids[:, 1:]
    else:
        labels = ids
    B, S, H = hidden.shape
    losses = fused_linear_cross_entropy(
        hidden.reshape(B * S, H), head_w, labels.reshape(-1), num_chunks)
    return losses.mean()
