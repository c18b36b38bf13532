"""Autoregressive generation for the GPT family: the oracle
``generate_from_params`` (counterpart of ``paddle_tpu/models/generation.py``)
and the block math the serving engine shares with it.

The serving engine promises that every request's tokens equal this
oracle's, bit for bit, for any admission order. Two shape rules keep that
promise on the CPU, where BLAS picks kernels by shape:

* every matrix product goes through ``_matmul``, which runs with at least
  ``_ROW_FLOOR`` rows. MKL takes another kernel (another summation order)
  for fewer than four rows, so without the floor a row's bits would depend
  on how many rows shared the call: a one-token decode here against the
  engine's [slots, 1] decode, or a two-token prompt against a 16-token
  prefill chunk. Padding rows are zeros and are sliced off.
* the oracle's KV cache is ``config.max_seq_len`` long, the engine's
  virtual window (slot pages x page size), so attention reduces over the
  same lengths on both sides.

Masked keys get probability exactly 0 and contribute exact zeros, as in
the reference. Sampling draws one uniform per emitted token from a
per-request ``torch.Generator`` on the host and inverts the CDF of the
masked distribution; the engine draws from its own generator per request
the same way, so sampled streams agree inside the port. They do not
reproduce the reference's threefry streams.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .gpt import compute_dtype, ln_fp32
from .params import cast_for_compute, layer_params

_ROW_FLOOR = 4


def _matmul(a, b):
    """``a @ b`` with at least ``_ROW_FLOOR`` rows in a's last-but-one dim
    (see the module docstring); both operands contiguous."""
    m = a.shape[-2]
    if m >= _ROW_FLOOR:
        return torch.matmul(a.contiguous(), b.contiguous())
    pad = a.new_zeros(a.shape[:-2] + (_ROW_FLOOR - m, a.shape[-1]))
    out = torch.matmul(torch.cat([a, pad], dim=-2), b.contiguous())
    return out[..., :m, :]


def _proj(x, w):
    """``x @ w`` over any leading dims (rows flattened into one GEMM)."""
    lead = x.shape[:-1]
    return _matmul(x.reshape(-1, x.shape[-1]), w).reshape(
        lead + (w.shape[-1],))


def _attend(q, kwin, vwin, qpos, k_scale=None):
    """Causal attention of q [B, T, nh, d] over a key window kwin/vwin
    [B, S, nh, d] in virtual (absolute-position) order; query t of row b
    sees keys s <= qpos[b, t]. fp32 scores, softmax and context, as the
    reference computes them. ``k_scale`` [B, S] (a quantized pool's key
    scales) multiplies the scores after the dot. Returns ctx
    [B, T, nh, d] float32."""
    d = q.shape[-1]
    S = kwin.shape[1]
    qh = q.float().permute(0, 2, 1, 3)                    # [B, nh, T, d]
    kh = kwin.float().permute(0, 2, 3, 1)                 # [B, nh, d, S]
    scores = _matmul(qh, kh) / math.sqrt(d)               # [B, nh, T, S]
    if k_scale is not None:
        scores = scores * k_scale[:, None, None, :]
    keys = torch.arange(S, device=q.device)
    mask = keys[None, None, :] <= qpos[:, :, None]        # [B, T, S]
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    vh = vwin.float().permute(0, 2, 1, 3)                 # [B, nh, S, d]
    return _matmul(probs, vh).permute(0, 2, 1, 3)         # [B, T, nh, d]


def _weight_proj(x, p, name):
    """The block's default projection: ``x @ p[name]``."""
    return _proj(x, p[name])


def _block(p, h, nh, eps, attend, proj=_weight_proj):
    """One pre-LN transformer block over h [B, T, H]. ``attend(q, k, v)``
    writes this window's K/V to its cache and returns the attention
    context [B, T, nh, d] in h.dtype; ``proj(x, p, name)`` computes the
    projection by the weight ``name`` (the paged layer routes quantized
    weights through it). Additions keep the reference's association:
    ``(h + up @ down_w) + down_b``."""
    B, T, H = h.shape
    d = H // nh
    h1 = ln_fp32(h, p["ln1_g"], p["ln1_b"], eps)
    qkv = (proj(h1, p, "qkv_w") + p["qkv_b"]).view(B, T, 3, nh, d)
    ctx = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    h = h + (proj(ctx.reshape(B, T, H), p, "out_w") + p["out_b"])
    h2 = ln_fp32(h, p["ln2_g"], p["ln2_b"], eps)
    up = F.gelu(proj(h2, p, "up_w") + p["up_b"], approximate="tanh")
    return h + proj(up, p, "down_w") + p["down_b"]


def _layer_cached(p, h, kc, vc, start, nh, eps):
    """One block over h [B, T, H] with a contiguous KV cache
    kc/vc [B, Smax, nh, d]: positions [start, start+T) are written in
    place, then attended with the absolute causal mask."""
    B, T, _ = h.shape
    qpos = (start + torch.arange(T, device=h.device)).expand(B, T)

    def attend(q, k, v):
        kc[:, start:start + T] = k.to(kc.dtype)
        vc[:, start:start + T] = v.to(vc.dtype)
        return _attend(q, kc, vc, qpos).to(h.dtype)

    return _block(p, h, nh, eps, attend)


def _final_ln(params, config, xlast):
    """Final LayerNorm over hidden states [B, H], scaled in fp32 too."""
    return ln_fp32(xlast.float(), params["lnf_g"], params["lnf_b"],
                   config.layer_norm_epsilon)


def _final_logits(params, config, xlast):
    """Final LayerNorm + LM head in fp32: [B, H] -> [B, V]."""
    return _matmul(_final_ln(params, config, xlast), params["head_w"].float())


def _embed(params, config, ids, pos):
    """Token + position embedding in the compute dtype. Positions past
    the table clamp to its last row (the reference's ``jnp.take`` clamps
    too); only padding lanes ever reach them."""
    pos = pos.clamp(max=config.max_seq_len - 1)
    return params["wte"][ids] + params["wpe"][pos]


def _forward_cached(params, config, ids, kc, vc, start, last_index=None,
                    layers=None):
    """ids [B, T] at absolute positions [start, start+T); the cache
    kc/vc [L, B, Smax, nh, d] is updated in place. Returns the logits of
    position T-1 (or ``last_index``) [B, V]."""
    T = ids.shape[1]
    pos = start + torch.arange(T, device=ids.device)
    x = _embed(params, config, ids, pos[None])
    layers = layer_params(params) if layers is None else layers
    for li, p in enumerate(layers):
        x = _layer_cached(p, x, kc[li], vc[li], start, config.num_heads,
                          config.layer_norm_epsilon)
    xlast = x[:, -1] if last_index is None else x[:, last_index]
    return _final_logits(params, config, xlast)


def _mask_logits(logits, temperature, top_k, top_p):
    """Temperature scale, top-k cut, nucleus (top-p) cut. temperature and
    top_p are scalars or per-row [B] tensors; top_p=None skips the nucleus
    cut, and a row with top_p >= 1 keeps every token."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device).clamp(min=1e-6)
    if t.dim() == logits.dim() - 1:
        t = t[..., None]
    logits = logits / t
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        p = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
        if p.dim() == logits.dim() - 1:
            p = p[..., None]
        sorted_logits, sort_idx = torch.sort(logits, dim=-1,
                                             descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = ((cum - probs) < p) | (p >= 1.0)
        keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx,
                                                      keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def _sample(logits, u):
    """Inverse-CDF draw from softmax(logits) [B, V] with one uniform
    u [B] in [0, 1) per row. Zero-probability tokens are never drawn."""
    probs = torch.softmax(logits, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    x = (u.to(cdf.dtype) * cdf[:, -1])[:, None]
    tok = (cdf <= x).sum(-1)
    # guard the top edge (u * total rounding up to total): the last token
    # with nonzero probability
    idx = torch.arange(probs.shape[-1], device=probs.device)
    last = torch.where(probs > 0, idx, 0).amax(dim=-1)
    return torch.minimum(tok, last)


def _select_token(logits, u, do_sample, temperature, top_k, top_p):
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    return _sample(_mask_logits(logits, temperature, top_k, top_p), u)


def _verify_accept(logits, ids_next, nprop, emit, sample, temperature,
                   top_p, u, top_k):
    """The speculative accept scan over the verify window's logits
    [B, T, V] (T = k+1), on their device. Lane t's logits choose the
    token after window position t (argmax, or for the rows of ``sample``
    [B] bool an inverse-CDF draw with the uniform u[b, t]); a slot keeps
    emitting while its chosen token equals the draft's proposal for the
    next lane, ids_next [B, T] (the last lane's entry is never compared),
    and t < nprop[b]. ``sample=None`` means every row is greedy;
    temperature/top_p are per-row [B] (top_p None: no nucleus cut) and
    top_k the engine's.

    The uniforms are the draws a plain engine would make for the tokens
    a slot emits, in order: the caller draws u[b, :] from the request's
    generator and then advances it by n_emit[b] draws, so a sampled stream
    replays ``generate_from_params`` wherever the scan stops.

    Returns (toks [B, T]: lanes >= n_emit[b] are not emitted, n_emit [B]
    int64: 0 for rows with emit False, else 1 + the accepted run)."""
    B, T, V = logits.shape
    toks = torch.argmax(logits, dim=-1)
    if sample is not None:
        nucleus = None if top_p is None else top_p.repeat_interleave(T)
        drawn = _sample(_mask_logits(logits.reshape(B * T, V),
                                     temperature.repeat_interleave(T),
                                     top_k, nucleus), u.reshape(B * T))
        toks = torch.where(sample[:, None], drawn.view(B, T), toks)
    lane = torch.arange(T, device=logits.device)
    agree = (lane[None, :] < nprop[:, None]) & (toks == ids_next)
    run = torch.cumprod(agree.long(), dim=1).sum(dim=1)
    return toks, torch.where(emit, 1 + run, 0)


def _is_stop(tok, stop_token_ids):
    """Elementwise membership of tok in the stop-id tuple."""
    hit = tok == stop_token_ids[0]
    for s in stop_token_ids[1:]:
        hit = hit | (tok == s)
    return hit


def _normalize_stop(eos_token_id, stop_token_ids):
    """Merge the scalar eos alias with the stop-id list into one tuple,
    eos first (it doubles as the pad id of finished rows). None when no
    stop condition was asked for."""
    ids = []
    if eos_token_id is not None:
        ids.append(int(eos_token_id))
    if stop_token_ids is not None:
        if isinstance(stop_token_ids, (int, np.integer)):
            stop_token_ids = [stop_token_ids]
        for s in stop_token_ids:
            if int(s) not in ids:
                ids.append(int(s))
    return tuple(ids) if ids else None


def _cfg_key(config):
    return (config.num_heads, config.num_layers, config.hidden_size,
            config.layer_norm_epsilon, config.compute_dtype)


def _check_temperature(do_sample, temperature):
    if do_sample and temperature <= 0:
        raise ValueError(
            f"temperature must be > 0 when do_sample=True, got "
            f"{temperature} (use do_sample=False for greedy decoding)")


@torch.no_grad()
def generate_from_params(params, input_ids, config, max_new_tokens=32,
                         do_sample=False, temperature=1.0, top_k=None,
                         top_p=None, eos_token_id=None, seed=0,
                         stop_token_ids=None, device=None):
    """Greedy or sampled generation from a parameter tree
    (``init_gpt_params`` layout). The prompt prefills in one forward,
    then each token decodes at T=1 over a preallocated cache. Returns the
    int64 tensor [B, P + max_new_tokens] (prompt + new tokens); rows that
    hit a stop id are padded with the first stop id afterwards.

    Sampling draws one uniform per row per emitted token from a CPU
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                          device=dev)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [B, P], got {tuple(ids.shape)}")
    _check_temperature(do_sample, temperature)
    if max_new_tokens < 1:
        if max_new_tokens == 0:
            return ids
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    B, P = ids.shape
    if P + max_new_tokens > config.max_seq_len:
        raise ValueError("prompt + max_new_tokens exceeds config.max_seq_len "
                         "(wpe table)")
    params = cast_for_compute(params, config, dev)
    layers = layer_params(params)
    top_k = None if top_k in (None, 0) else min(int(top_k), config.vocab_size)
    top_p = None if top_p in (None, 1.0) else float(top_p)
    stop = _normalize_stop(eos_token_id, stop_token_ids)
    gen = torch.Generator().manual_seed(int(seed))

    nh = config.num_heads
    shape = (config.num_layers, B, config.max_seq_len, nh,
             config.hidden_size // nh)
    kc = torch.zeros(shape, dtype=compute_dtype(config), device=dev)
    vc = torch.zeros_like(kc)

    def select(logits):
        u = torch.rand(B, generator=gen).to(dev) if do_sample else None
        return _select_token(logits, u, do_sample, temperature, top_k, top_p)

    logits = _forward_cached(params, config, ids, kc, vc, 0, layers=layers)
    tok = select(logits)
    out = [tok]
    finished = (torch.zeros(B, dtype=torch.bool, device=dev) if stop is None
                else _is_stop(tok, stop))
    for i in range(max_new_tokens - 1):
        if stop is not None and bool(finished.all()):
            out.append(torch.full_like(tok, stop[0]))
            continue
        logits = _forward_cached(params, config, tok[:, None], kc, vc, P + i,
                                 layers=layers)
        tok = select(logits)
        if stop is not None:
            tok = torch.where(finished, torch.full_like(tok, stop[0]), tok)
            finished = finished | _is_stop(tok, stop)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)
