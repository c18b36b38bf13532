"""Tensor-parallel serving forward for the paged engine (counterpart of
``paddle_tpu/serving/mp_forward.py:61-393``).

A gather-only schedule, as in the reference, so that sharding moves bytes
and never changes the arithmetic:

* every GEMM shards its OUTPUT columns and keeps the full contraction
  (qkv in head-major storage, so a contiguous shard is nh/n whole heads;
  out, down and the LM head column-sharded too), and each rank's block
  is the column slice of the one-device GEMM;
* the only collectives are all-gathers: the feature-sharded embedding,
  the attention context and the FFN activation before their
  full-contraction projections, each projection's output blocks and,
  vocab-divisible, the logits;
* the paged KV pool shards its head axis: each rank holds
  ``[L, P, page, nh/n, d]``, 1/n of the KV bytes, while the host-side page
  table, allocator and prefix cache stay global and identical on every
  rank. A quantized pool's per-page scales ``[L, P]`` are head-independent
  and stay replicated.

The reference is single-controller (one process, ``shard_map`` over an
``('mp',)`` mesh). The port is SPMD: every rank runs this forward on its
own shards, inside the same engine loop, over a
``distributed.env.MPGroup``. Three rungs, bitwise equal to each other
because only the movement of bytes differs (``ServingMPConfig.backend``):

* ``gspmd``: the local GEMM (``torch.matmul``, or the quantized GEMM),
  then one all-gather collective per gather;
* ``ring``: the same GEMM, each gather as n - 1 point-to-point hops in
  the reference's block order (``_ring_ag_last``);
* ``fused``: ``ops/fused_collectives.py``'s kernels: each projection's
  GEMM stores its block into this rank's slot of the group's
  ``"gemm_ag"`` peer channel and one gather launch copies every rank's
  block over NVLink into the [..., F] result (``fused_gemm_ag``, rows
  12-13: one flag per rank and call, no NCCL collective, no relayout);
  the data gathers run through ``fused_ag_bucket`` (row 11: the row
  copied into this rank's peer staging, one kernel launch pulling every
  rank's over NVLink). The engine opens the ``"gemm_ag"`` channel at
  build, sized by ``gemm_ag_blocks``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.tp_overlap import qkv_head_major_perm, to_qkv_head_major
from ..models.generation import _final_ln, _matmul, _proj
from ..models.gpt import compute_dtype, ln_fp32
from ..models.params import cast_for_compute, layer_params
from ..ops import fused_collectives as _fc
from ..ops.quant_gemm import quant_gemm
from . import quant as _squant
from .paged_attention import paged_attention_read, paged_kv_scatter

# leaves sharded along their last (output) axis; every other leaf is
# replicated. head_w and head_w_s shard only when the vocab divides.
_SHARDED_BLOCKS = ("qkv_w", "qkv_b", "out_w", "up_w", "up_b", "down_w",
                   "qkv_w_s", "out_w_s", "up_w_s", "down_w_s")


def shard_serving_params(params, config, n, rank, shard_vocab, device=None,
                         quant_spec=None):
    """Rank ``rank``'s shards of an ``init_gpt_params`` tree (logical qkv
    layout) for the ``n``-way serving layout, prepared for compute on
    ``device``: qkv permuted head-major, every matmul weight's output
    columns sharded (``wte`` by feature, ``head_w`` by vocab when
    ``shard_vocab``), norms and the biases added after a gather
    replicated. ``quant_spec`` quantizes the GEMM weights before sharding
    (per-output-channel quantization is column-independent, so the shards
    are the column slices of the one-device engine's quantized weights;
    pinned qkv scales relabel head-major with their columns). A
    full-precision LM head keeps the dtype the caller passed it in (bf16
    or fp32), as the reference stores the head it is given and converts
    it to fp32 only at use; the fused GEMM converts a bf16 head in
    registers."""
    H, nh = config.hidden_size, config.num_heads
    params = {**params, "blocks": to_qkv_head_major(params["blocks"], H, nh)}
    if quant_spec is not None and quant_spec.quantizes_weights:
        params = _squant.quantize_params(
            params, config, quant_spec,
            qkv_perm=qkv_head_major_perm(H, nh))

    def cut(t):
        w = t.shape[-1] // n
        return t[..., rank * w:(rank + 1) * w].contiguous()

    blocks = {k: cut(v) if k in _SHARDED_BLOCKS else v
              for k, v in params["blocks"].items()}
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["wte"] = cut(params["wte"])
    if shard_vocab:
        out["head_w"] = cut(params["head_w"])
        if "head_w_s" in params:
            out["head_w_s"] = cut(params["head_w_s"])
    out["blocks"] = blocks
    out = cast_for_compute(out, config, device)
    if params["head_w"].dtype == torch.bfloat16:
        out["head_w"] = out["head_w"].to(torch.bfloat16)
    return out


def gemm_ag_blocks(config, n, rows, head_rows, shard_vocab):
    """(rows, cols, itemsize) of the blocks the fused rung's GEMM +
    all-gathers store on a rank of an n-rank group: the out and down
    projections' [rows, H/n] in the compute dtype at a dispatch of up to
    ``rows`` rows and, when the vocab is sharded, the LM head's
    [head_rows, V/n] in fp32 (its x is the final LayerNorm's fp32)."""
    size = torch.empty((), dtype=compute_dtype(config)).element_size()
    blocks = [(rows, config.hidden_size // n, size)]
    if shard_vocab:
        blocks.append((head_rows, config.vocab_size // n, 4))
    return blocks


# ---------------------------------------------------------------------------
# the exact gathers (rank-order concatenation, no arithmetic)


def _ring_ag_last(x, group):
    """All-gather along the last axis as n - 1 ring hops: at hop t this
    rank holds the block of rank (rank - t) mod n."""
    n, r = group.n, group.rank
    Fl = x.shape[-1]
    out = x.new_empty(x.shape[:-1] + (n * Fl,))
    chunk = x.contiguous()
    for t in range(n):
        src = (r - t) % n
        out[..., src * Fl:(src + 1) * Fl] = chunk
        if t < n - 1:
            chunk = group.ring_shift(chunk)
    return out


def ag_last(x, group, backend):
    """Exact all-gather along the last axis: [..., F/n] -> [..., F], the
    blocks in rank (= logical) order. gspmd: one collective; fused: row
    11 over the flat row (``fused_ag_bucket``, which copies it into the
    peer staging and pulls every rank's in one launch)."""
    n = group.n
    if n == 1:
        return x
    if backend == "ring":
        return _ring_ag_last(x, group)
    if backend == "fused":
        out = _fc.fused_ag_bucket(x.reshape(-1), group).view(
            (n,) + tuple(x.shape))
    else:
        out = _fc.all_gather_stack(x, group)
    return out.movedim(0, -2).reshape(x.shape[:-1] + (n * x.shape[-1],))


def gemm_ag(x, w, group, backend, scale=None, wq_kernel=True):
    """Column-parallel projection: the full-contraction local block
    ``x @ w_r`` (times ``scale`` for an int8/fp8 shard) and the all-gather
    of the blocks, equal to ``x @ w`` on every rung. The fused rung runs
    ``fused_gemm_ag``; the others the local GEMM (``wq_kernel``: the
    quantized GEMM kernel on CUDA) and then their gather."""
    if backend == "fused" and group.n > 1:
        return _fc.fused_gemm_ag(x, w, group, scale=scale)
    if scale is None:
        y = _proj(x, w.to(x.dtype))
    else:
        y = quant_gemm(x, w, scale, wq_kernel)
    return ag_last(y, group, "gspmd" if backend == "fused" else backend)


def _local_proj(h, p, name, wq_kernel):
    """The local column block of the qkv or up projection (its output stays
    sharded): the weight, or the int8/fp8 weight and its scale shard."""
    s = p.get(name + "_s")
    if s is None:
        return _proj(h, p[name])
    return quant_gemm(h, p[name], s, wq_kernel)


def _mp_block(p, h, kc_l, vc_l, table, pos, valid, nh, eps, page_size,
              use_kernel, group, backend, ksc_l=None, vsc_l=None,
              wq_kernel=True):
    """One transformer block on this rank's shards: h [B, T, H] replicated,
    the weights column-sharded, the pool holding this rank's nh/n heads.
    Every step is replicated elementwise math, a full-contraction GEMM
    block, a per-head attention or an exact gather, in the association of
    the one-device block (``models.generation._block``)."""
    B, T, H = h.shape
    n = group.n
    nh_l = nh // n
    d = H // nh
    h1 = ln_fp32(h, p["ln1_g"], p["ln1_b"], eps)
    qkv = (_local_proj(h1, p, "qkv_w", wq_kernel) + p["qkv_b"]).view(
        B, T, nh_l, 3, d)                           # head-major local columns
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    paged_kv_scatter(kc_l, vc_l, k, v, table, pos, valid, page_size,
                     ksc_l, vsc_l)
    ctx = paged_attention_read(q, kc_l, vc_l, table, pos, page_size,
                               use_kernel, h.dtype, ksc_l, vsc_l)
    # the context heads gathered (rank order == logical head order), then
    # the out projection keeps the full contraction against its shard
    ctx_full = ag_last(ctx.reshape(B, T, nh_l * d), group, backend)
    h = h + (gemm_ag(ctx_full, p["out_w"], group, backend,
                     p.get("out_w_s"), wq_kernel) + p["out_b"])
    h2 = ln_fp32(h, p["ln2_g"], p["ln2_b"], eps)
    up = F.gelu(_local_proj(h2, p, "up_w", wq_kernel) + p["up_b"],
                approximate="tanh")
    act = ag_last(up, group, backend)
    return h + gemm_ag(act, p["down_w"], group, backend, p.get("down_w_s"),
                       wq_kernel) + p["down_b"]


def mp_paged_forward(params, config, ids, kc, vc, start, valid, table,
                     page_size, use_kernel, group, mp_cfg, layers=None,
                     kv_scales=None, wq_kernel=True):
    """The fused chunk/decode forward of ``paged_attention.paged_forward``
    on this rank's shards (``shard_serving_params``) and head-sharded pools
    kc/vc [L, P, page, nh/n, d], updated in place. Returns the logits
    [B, V] (float32), identical on every rank. ``kv_scales`` are a
    quantized pool's replicated (k_scale, v_scale) [L, P]."""
    backend = mp_cfg.backend
    B, T = ids.shape
    pos = start[:, None] + torch.arange(T, device=ids.device,
                                        dtype=start.dtype)[None, :]
    x = ag_last(params["wte"][ids], group, backend) + \
        params["wpe"][pos.clamp(max=config.max_seq_len - 1)]
    layers = layer_params(params) if layers is None else layers
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    for li, p in enumerate(layers):
        x = _mp_block(p, x, kc[li], vc[li], table, pos, valid,
                      config.num_heads, config.layer_norm_epsilon, page_size,
                      use_kernel, group, backend,
                      None if ksc is None else ksc[li],
                      None if vsc is None else vsc[li], wq_kernel)
    idx = torch.clamp(valid.long() - 1, min=0)
    xn = _final_ln(params, config, x[torch.arange(B, device=x.device), idx])
    head_s = params.get("head_w_s")
    if mp_cfg.shard_vocab:
        return gemm_ag(xn, params["head_w"], group, backend, head_s,
                       wq_kernel)
    if head_s is not None:
        return quant_gemm(xn, params["head_w"], head_s, wq_kernel)
    return _matmul(xn, params["head_w"].float())
