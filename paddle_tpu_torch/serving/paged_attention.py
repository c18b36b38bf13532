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

Quantized serving (serving/quant.py): an int8/fp8 pool comes with
``kv_scales`` = (k_scale, v_scale) [L, P] per-page float32 scales. Writes
quantize in ``paged_kv_scatter``; reads multiply the key page's scale
into the scores after the q.k dot and dequantize V after its gather
(``paged_decode.attend_quantized``), or run the quantized decode kernel
at T=1. Quantized weight leaves carry ``<name>_s`` per-output-channel
scales and go through ``ops.quant_gemm``, the LM head too (its x is the
fp32 final LayerNorm). Without scales none of this runs and the math is
the unquantized engine's.

Tensor-parallel serving (serving/mp_forward.py): ``paged_forward(...,
mp=(group, mp_cfg))`` runs the same step on this rank's shards, its pools
holding nh/n heads, through ``mp_forward.mp_paged_forward``.
"""
from __future__ import annotations

import torch

from ..models.generation import (_attend, _block, _embed, _final_ln,
                                 _final_logits, _weight_proj)
from ..models.params import layer_params
from ..ops.quant_gemm import quant_gemm
from .paged_decode import (attend_quantized, gather_window,
                           paged_decode_attention, paged_decode_attention_q)


def new_pool(shape, dtype, device):
    """A zero KV pool. One-byte pools are made and moved as uint8 (zero
    bytes are 0 in int8 and +0.0 in float8_e4m3fn); masked keys of
    unwritten pages are read as 0 * V, which must stay finite."""
    if dtype.itemsize == 1:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _quantize_kv(x, sc, dtype):
    """One K/V window [B, T, nh, d] over its per-position page scales
    sc [B, T] in the pool's dtype: int8 rounds half to even then clips,
    fp8 clips to ±448 then casts (a torch fp8 cast does not saturate)."""
    scaled = x.float() / sc[:, :, None, None]
    if dtype == torch.int8:
        return torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)
    fmax = float(torch.finfo(dtype).max)
    return torch.clamp(scaled, -fmax, fmax).to(dtype)


def paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size,
                     ksc_l=None, vsc_l=None):
    """Write one window's K/V [B, T, nh, d] into the layer's pool in place
    through the slot->page table; lanes past valid[b] (and whole inactive
    slots) go to trash page 0. With a quantized pool the per-page scales
    ksc_l/vsc_l [P] quantize the write (the trash page keeps scale 1.0)."""
    MP = table.shape[1]
    T = pos.shape[1]
    writable = torch.arange(T, device=pos.device)[None, :] < valid[:, None]
    li = torch.clamp(pos // page_size, max=MP - 1)
    phys = torch.where(writable, torch.gather(table, 1, li.long()), 0)
    off = pos % page_size
    if ksc_l is None:
        kc_l.index_put_((phys, off), k.to(kc_l.dtype))
        vc_l.index_put_((phys, off), v.to(vc_l.dtype))
        return
    kq = _quantize_kv(k, ksc_l[phys], kc_l.dtype)
    vq = _quantize_kv(v, vsc_l[phys], vc_l.dtype)
    # one-byte pools move as uint8: index_put_ is not implemented for
    # every float8 type
    kc_l.view(torch.uint8).index_put_((phys, off), kq.view(torch.uint8))
    vc_l.view(torch.uint8).index_put_((phys, off), vq.view(torch.uint8))


def paged_attention_read(q, kc_l, vc_l, table, pos, page_size, use_kernel,
                         out_dtype, ksc_l=None, vsc_l=None):
    """Attention of q [B, T, nh, d] over each slot's keys 0..pos[b, t]
    through the table; returns ctx [B, T, nh, d] in ``out_dtype``.
    ksc_l/vsc_l [P] are a quantized pool's page scales."""
    if use_kernel and q.shape[1] == 1:
        q1, pos1 = q[:, 0].float().contiguous(), pos[:, 0].contiguous()
        if ksc_l is None:
            ctx = paged_decode_attention(q1, kc_l, vc_l, table, pos1,
                                         page_size)
        else:
            ctx = paged_decode_attention_q(q1, kc_l, vc_l, table, pos1,
                                           ksc_l, vsc_l, page_size)
        return ctx[:, None].to(out_dtype)
    if ksc_l is not None:
        return attend_quantized(q, kc_l, vc_l, table, pos, ksc_l, vsc_l,
                                page_size).to(out_dtype)
    return _attend(q, gather_window(kc_l, table), gather_window(vc_l, table),
                   pos).to(out_dtype)


def _quant_proj(wq_kernel):
    """The block's projection for a quantized tree, whose every block
    weight has its ``<name>_s`` scale: the quantized GEMM (``wq_kernel``
    routes CUDA tensors to the kernel)."""
    def proj(x, p, name):
        return quant_gemm(x, p[name], p[name + "_s"], wq_kernel)
    return proj


def _layer_paged(p, h, kc_l, vc_l, table, pos, valid, nh, eps, page_size,
                 use_kernel, ksc_l=None, vsc_l=None, proj=_weight_proj):
    """One transformer block over h [B, T, H], each row a serving slot at
    absolute positions pos[b, :] (valid[b] of them real): K/V are
    scattered through the table, then read back with the absolute causal
    mask. The block math is the oracle's (``models.generation._block``)."""
    def attend(q, k, v):
        paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size,
                         ksc_l, vsc_l)
        return paged_attention_read(q, kc_l, vc_l, table, pos, page_size,
                                    use_kernel, h.dtype, ksc_l, vsc_l)

    return _block(p, h, nh, eps, attend, proj)


def paged_forward(params, config, ids, kc, vc, start, valid, table,
                  page_size, use_kernel=False, layers=None, kv_scales=None,
                  wq_kernel=False, mp=None):
    """Fused chunk/decode forward: ids [B, T] is each slot's token window
    at absolute positions start[b]..start[b]+T-1 (valid[b] of them real).
    Writes the window's K/V into the pools kc/vc [L, P, page_size, nh, d]
    in place and returns the logits at each slot's position valid[b]-1
    ([B, V], float32). ``params`` is a tree prepared by
    ``models.cast_for_compute``; ``layers`` its ``layer_params`` views.
    ``kv_scales`` = (k_scale, v_scale) [L, P] float32 of a quantized pool;
    ``wq_kernel`` routes the quantized GEMMs of a quantized tree through
    the CUDA kernel (CPU tensors take the plain version). ``mp`` =
    (``distributed.env.MPGroup``, ``ServingMPConfig``) routes the step
    through the tensor-parallel forward on this rank's shards."""
    if mp is not None:
        from .mp_forward import mp_paged_forward
        return mp_paged_forward(params, config, ids, kc, vc, start, valid,
                                table, page_size, use_kernel, mp[0], mp[1],
                                layers=layers, kv_scales=kv_scales,
                                wq_kernel=wq_kernel)
    B, T = ids.shape
    pos = start[:, None] + torch.arange(T, device=ids.device,
                                        dtype=start.dtype)[None, :]
    x = _embed(params, config, ids, pos)
    layers = layer_params(params) if layers is None else layers
    quantized = "head_w_s" in params
    proj = _quant_proj(wq_kernel) if quantized else _weight_proj
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    for li, p in enumerate(layers):
        x = _layer_paged(p, x, kc[li], vc[li], table, pos, valid,
                         config.num_heads, config.layer_norm_epsilon,
                         page_size, use_kernel,
                         None if ksc is None else ksc[li],
                         None if vsc is None else vsc[li], proj)
    idx = torch.clamp(valid.long() - 1, min=0)
    xlast = x[torch.arange(B, device=x.device), idx]             # [B, H]
    if quantized:
        return quant_gemm(_final_ln(params, config, xlast),
                          params["head_w"], params["head_w_s"], wq_kernel)
    return _final_logits(params, config, xlast)
