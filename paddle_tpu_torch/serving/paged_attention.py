"""Paged attention for the serving engine (counterpart of
``paddle_tpu/serving/paged_attention.py``): the transformer forward over
a block-paged KV pool ``[L, P, page_size, nh, d]`` read through a
per-slot page table.

The fused step is both the decode and the chunked-prefill computation:
every batch row is a slot processing a T-token window at its own offset
(T=1 decode over all slots, T=chunk for one slot's prefill chunk), with
per-slot ``start``/``valid`` as tensors. Padding lanes and inactive slots
write their K/V to physical page 0, the trash page, which is never read
unmasked.

Two reads of the pool:

* the gather path (any T, any device): gather each slot's pages into
  virtual order and run the masked softmax of the oracle
  (``models.generation._attend``), so the engine's tokens equal
  ``generate_from_params``'s bit for bit on the CPU;
* the kernel (T=1 with ``use_kernel``): ``paged_decode_attention``, the
  hand-written CUDA kernel on CUDA tensors, its plain version (the same
  gather math) on CPU tensors.

Unlike the reference, which returns new pools, the pools are updated in
place (``index_put_``), where JAX donates the buffers.
"""
from __future__ import annotations

import torch

from ..models.generation import (_attend, _block, _embed, _final_logits)
from ..models.params import layer_params
from .paged_decode import gather_window, paged_decode_attention


def paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size):
    """Write one window's K/V [B, T, nh, d] into the layer's pool in place
    through the slot->page table; lanes past valid[b] (and whole inactive
    slots) go to trash page 0."""
    MP = table.shape[1]
    T = pos.shape[1]
    writable = torch.arange(T, device=pos.device)[None, :] < valid[:, None]
    li = torch.clamp(pos // page_size, max=MP - 1)
    phys = torch.where(writable, torch.gather(table, 1, li.long()), 0)
    off = pos % page_size
    kc_l.index_put_((phys, off), k.to(kc_l.dtype))
    vc_l.index_put_((phys, off), v.to(vc_l.dtype))


def paged_attention_read(q, kc_l, vc_l, table, pos, page_size, use_kernel,
                         out_dtype):
    """Attention of q [B, T, nh, d] over each slot's keys 0..pos[b, t]
    through the table; returns ctx [B, T, nh, d] in ``out_dtype``."""
    if use_kernel and q.shape[1] == 1:
        ctx = paged_decode_attention(q[:, 0].float().contiguous(), kc_l, vc_l,
                                     table, pos[:, 0].contiguous(), page_size)
        return ctx[:, None].to(out_dtype)
    return _attend(q, gather_window(kc_l, table), gather_window(vc_l, table),
                   pos).to(out_dtype)


def _layer_paged(p, h, kc_l, vc_l, table, pos, valid, nh, eps, page_size,
                 use_kernel):
    """One transformer block over h [B, T, H], each row a serving slot at
    absolute positions pos[b, :] (valid[b] of them real): K/V are
    scattered through the table, then read back with the absolute causal
    mask. The block math is the oracle's (``models.generation._block``)."""
    def attend(q, k, v):
        paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size)
        return paged_attention_read(q, kc_l, vc_l, table, pos, page_size,
                                    use_kernel, h.dtype)

    return _block(p, h, nh, eps, attend)


def paged_forward(params, config, ids, kc, vc, start, valid, table,
                  page_size, use_kernel=False, layers=None):
    """Fused chunk/decode forward: ids [B, T] is each slot's token window
    at absolute positions start[b]..start[b]+T-1 (valid[b] of them real).
    Writes the window's K/V into the pools kc/vc [L, P, page_size, nh, d]
    in place and returns the logits at each slot's position valid[b]-1
    ([B, V], float32). ``params`` is a tree prepared by
    ``models.cast_for_compute``; ``layers`` its ``layer_params`` views."""
    B, T = ids.shape
    pos = start[:, None] + torch.arange(T, device=ids.device,
                                        dtype=start.dtype)[None, :]
    x = _embed(params, config, ids, pos)
    layers = layer_params(params) if layers is None else layers
    for li, p in enumerate(layers):
        x = _layer_paged(p, x, kc[li], vc[li], table, pos, valid,
                         config.num_heads, config.layer_norm_epsilon,
                         page_size, use_kernel)
    idx = torch.clamp(valid.long() - 1, min=0)
    xlast = x[torch.arange(B, device=x.device), idx]             # [B, H]
    return _final_logits(params, config, xlast)
