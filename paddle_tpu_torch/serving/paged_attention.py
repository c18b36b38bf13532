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

Speculative decoding (serving/engine.py) adds three functions:
``paged_draft_forward`` rolls a draft tree k tokens ahead, reading the
pool read-only and carrying its own K/V in a sidecar;
``paged_verify_forward`` scores the [B, k+1] window under the served
weights, each lane reading the pool at the plain decode's [B, 1] shape
(so through the paged-decode kernels on CUDA), and returns every lane's
logits with the pre-write bytes of every position it wrote;
``paged_kv_rewind`` puts those bytes back past each slot's accepted
length.
"""
from __future__ import annotations

import math

import torch

from ..models.generation import (_attend, _block, _embed, _final_ln,
                                 _final_logits, _matmul, _weight_proj)
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


def _raw(pool):
    """A pool as it moves: one-byte pools as uint8 (indexing is not
    implemented for every float8 type), others as they are."""
    return pool.view(torch.uint8) if pool.element_size() == 1 else pool


def _window_slots(table, pos, lanes, page_size):
    """(phys, off) [B, T] of the window positions pos [B, T] through the
    table; lanes where ``lanes`` is False go to trash page 0."""
    MP = table.shape[1]
    li = torch.clamp(pos // page_size, max=MP - 1)
    phys = torch.where(lanes, torch.gather(table, 1, li.long()), 0)
    return phys, pos % page_size


def _lanes_below(n, T, device):
    """[B, T] mask of the lanes t < n[b]."""
    return torch.arange(T, device=device)[None, :] < n[:, None]


def paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size,
                     ksc_l=None, vsc_l=None):
    """Write one window's K/V [B, T, nh, d] into the layer's pool in place
    through the slot->page table; lanes past valid[b] (and whole inactive
    slots) go to trash page 0. With a quantized pool the per-page scales
    ksc_l/vsc_l [P] quantize the write (the trash page keeps scale 1.0)."""
    phys, off = _window_slots(
        table, pos, _lanes_below(valid, pos.shape[1], pos.device), page_size)
    if ksc_l is None:
        kc_l.index_put_((phys, off), k.to(kc_l.dtype))
        vc_l.index_put_((phys, off), v.to(vc_l.dtype))
        return
    kq = _quantize_kv(k, ksc_l[phys], kc_l.dtype)
    vq = _quantize_kv(v, vsc_l[phys], vc_l.dtype)
    _raw(kc_l).index_put_((phys, off), kq.view(torch.uint8))
    _raw(vc_l).index_put_((phys, off), vq.view(torch.uint8))


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
                 use_kernel, ksc_l=None, vsc_l=None, proj=_weight_proj,
                 per_lane=False):
    """One transformer block over h [B, T, H], each row a serving slot at
    absolute positions pos[b, :] (valid[b] of them real): K/V are
    scattered through the table, then read back with the absolute causal
    mask. The block math is the oracle's (``models.generation._block``).

    ``per_lane`` (the speculative verify) reads the pool once per window
    lane at the [B, 1] shape of the plain engine's one-token decode, so an
    accepted lane's attention is the plain decode's (through the
    paged-decode kernel on CUDA with ``use_kernel``); a [B, T] read is the
    same math in another summation order."""
    def attend(q, k, v):
        paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size,
                         ksc_l, vsc_l)
        if not per_lane:
            return paged_attention_read(q, kc_l, vc_l, table, pos,
                                        page_size, use_kernel, h.dtype,
                                        ksc_l, vsc_l)
        return torch.cat([paged_attention_read(
            q[:, t:t + 1], kc_l, vc_l, table, pos[:, t:t + 1], page_size,
            use_kernel, h.dtype, ksc_l, vsc_l) for t in range(q.shape[1])],
            dim=1)

    return _block(p, h, nh, eps, attend, proj)


def _head_logits(params, config, x, wq_kernel=False):
    """Final LayerNorm + LM head over x [..., H] in fp32 -> [..., V], the
    rows flattened into one GEMM; a quantized tree's head goes through the
    quantized GEMM (``wq_kernel`` routes CUDA tensors to the kernel)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "head_w_s" in params:
        out = quant_gemm(_final_ln(params, config, x2), params["head_w"],
                         params["head_w_s"], wq_kernel)
    else:
        out = _final_logits(params, config, x2)
    return out.reshape(lead + (out.shape[-1],))


def _window_positions(start, T):
    """Absolute positions [B, T] of windows starting at start [B]."""
    return start[:, None] + torch.arange(T, device=start.device,
                                         dtype=start.dtype)[None, :]


def _paged_blocks(params, config, ids, pos, kc, vc, valid, table, page_size,
                  use_kernel, layers, kv_scales, wq_kernel, per_lane=False):
    """Embedding and every block of the fused step over the window ids
    [B, T] at positions pos [B, T]: hidden states [B, T, H]."""
    x = _embed(params, config, ids, pos)
    layers = layer_params(params) if layers is None else layers
    proj = _quant_proj(wq_kernel) if "head_w_s" in params else _weight_proj
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    for li, p in enumerate(layers):
        x = _layer_paged(p, x, kc[li], vc[li], table, pos, valid,
                         config.num_heads, config.layer_norm_epsilon,
                         page_size, use_kernel,
                         None if ksc is None else ksc[li],
                         None if vsc is None else vsc[li], proj, per_lane)
    return x


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
    pos = _window_positions(start, T)
    x = _paged_blocks(params, config, ids, pos, kc, vc, valid, table,
                      page_size, use_kernel, layers, kv_scales, wq_kernel)
    idx = torch.clamp(valid.long() - 1, min=0)
    xlast = x[torch.arange(B, device=x.device), idx]             # [B, H]
    return _head_logits(params, config, xlast, wq_kernel)


# ---------------------------------------------------------------------------
# speculative decoding: the verify forward, the KV rewind, the draft forward


def paged_verify_forward(params, config, ids, kc, vc, start, valid, table,
                         page_size, use_kernel=False, layers=None,
                         kv_scales=None, wq_kernel=False):
    """The speculative verify: ``paged_forward``'s math over the window
    ids [B, T] (T = k+1: each slot's last emitted token, then the draft's
    proposals) at positions start[b]..start[b]+T-1, valid[b] of them
    written, with each lane reading the pool at the plain decode's [B, 1]
    shape. Returns the logits of every lane [B, T, V] float32 and the
    pre-write bytes of every position the window writes, saved_k/saved_v
    [L, B, T, nh, d] in the pool's storage dtype (uint8 for a one-byte
    pool), for ``paged_kv_rewind``. Lanes past valid[b] read and write
    as padding lanes do (their writes go to trash page 0)."""
    T = ids.shape[1]
    pos = _window_positions(start, T)
    phys, off = _window_slots(table, pos,
                              _lanes_below(valid, T, ids.device), page_size)
    saved_k = _raw(kc)[:, phys, off]
    saved_v = _raw(vc)[:, phys, off]
    x = _paged_blocks(params, config, ids, pos, kc, vc, valid, table,
                      page_size, use_kernel, layers, kv_scales, wq_kernel,
                      per_lane=True)
    return _head_logits(params, config, x, wq_kernel), saved_k, saved_v


def paged_kv_rewind(kc, vc, saved_k, saved_v, table, start, valid, n_emit,
                    page_size):
    """Put back, in place, the bytes the verify wrote past each slot's
    accepted length: lanes n_emit[b] <= t < valid[b] get their pre-write
    storage bytes (a quantized pool's raw bytes; its page scales never
    changed). The other lanes go to trash page 0, as padding lanes do.
    After it the pool (page 0 aside) is byte for byte that of a plain
    engine that decoded n_emit[b] tokens."""
    T = saved_k.shape[2]
    pos = _window_positions(start, T)
    lanes = _lanes_below(valid, T, start.device) & \
        ~_lanes_below(n_emit, T, start.device)
    phys, off = _window_slots(table, pos, lanes, page_size)
    _raw(kc)[:, phys, off] = saved_k
    _raw(vc)[:, phys, off] = saved_v


def _draft_attend(q, kc_l, vc_l, sk_l, sv_l, table, base_pos, i, page_size,
                  ksc_l=None, vsc_l=None):
    """The draft token's attention (q [B, 1, nh, d]) over the pool strictly
    below base_pos (the positions at and past it hold bytes the verify
    rewinds) and its sidecar lanes 0..i, in one softmax over the two; a
    quantized pool's key scales multiply the scores after the dot, its
    value scales the values. Plain torch ops, fp32; ctx [B, 1, nh, d]."""
    d = q.shape[-1]
    kwin = gather_window(kc_l, table).float()            # [B, S, nh, d]
    vwin = gather_window(vc_l, table).float()
    S, kmax = kwin.shape[1], sk_l.shape[1]
    if ksc_l is not None:
        kwin_sc = ksc_l[table].repeat_interleave(page_size, dim=1)
        vwin = vwin * vsc_l[table].repeat_interleave(
            page_size, dim=1)[:, :, None, None]
    qh = q.float().permute(0, 2, 1, 3)                   # [B, nh, 1, d]
    sc_pool = _matmul(qh, kwin.permute(0, 2, 3, 1)) / math.sqrt(d)
    if ksc_l is not None:
        sc_pool = sc_pool * kwin_sc[:, None, None, :]
    sc_side = _matmul(qh, sk_l.float().permute(0, 2, 3, 1)) / math.sqrt(d)
    pool_mask = torch.arange(S, device=q.device)[None, :] < \
        base_pos[:, None]
    side_mask = torch.arange(kmax, device=q.device) <= i
    scores = torch.cat(
        [sc_pool.masked_fill(~pool_mask[:, None, None], float("-inf")),
         sc_side.masked_fill(~side_mask, float("-inf"))], dim=-1)
    probs = torch.softmax(scores, dim=-1)                # [B, nh, 1, S+k]
    vals = torch.cat([vwin, sv_l.float()], dim=1).permute(0, 2, 1, 3)
    return _matmul(probs, vals).permute(0, 2, 1, 3)


def paged_draft_forward(params, config, tok, kc, vc, pos, table, page_size,
                        k, layers=None, kv_scales=None, wq_kernel=False):
    """The speculative draft: greedily roll the draft tree ``k`` tokens
    ahead of each slot's last emitted token tok [B] at position pos [B],
    reading the pool read-only and carrying the draft's own K/V in a
    sidecar [Ld, B, k, nh, d] of the compute dtype. ``params`` may be a
    quantized and/or shallow tree (Ld blocks: its blocks line up with the
    pool's first layers); a quantized one's GEMMs take ``quant_gemm``
    (``wq_kernel``: the kernel on CUDA). ``table`` may hold only the
    columns of pages below max(pos). Proposals are always greedy.
    Returns proposals [B, k] int64."""
    nh = config.num_heads
    d = config.hidden_size // nh
    eps = config.layer_norm_epsilon
    layers = layer_params(params) if layers is None else layers
    proj = _quant_proj(wq_kernel) if "head_w_s" in params else _weight_proj
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    dtype = params["wte"].dtype                  # the compute dtype
    side = (len(layers), tok.shape[0], k, nh, d)
    sk = torch.zeros(side, dtype=dtype, device=tok.device)
    sv = torch.zeros_like(sk)
    cur, props = tok, []
    for i in range(k):
        x = _embed(params, config, cur[:, None], (pos + i)[:, None])
        for li, p in enumerate(layers):
            def attend(q, kx, vx, li=li):
                sk[li, :, i] = kx[:, 0]
                sv[li, :, i] = vx[:, 0]
                return _draft_attend(
                    q, kc[li], vc[li], sk[li], sv[li], table, pos, i,
                    page_size, None if ksc is None else ksc[li],
                    None if vsc is None else vsc[li]).to(dtype)

            x = _block(p, x, nh, eps, attend, proj)
        cur = torch.argmax(_head_logits(params, config, x[:, 0], wq_kernel),
                           dim=-1)
        props.append(cur)
    return torch.stack(props, dim=1)
