"""Tensor-parallel schedules: the serving part (counterpart of
``paddle_tpu/distributed/tp_overlap.py:196-219`` and ``:423-``).

* ``qkv_head_major_perm`` / ``to_qkv_head_major``: the column relabeling
  that makes a contiguous 1/n column shard of the qkv projection the q, k
  and v of exactly nh/n whole heads;
* ``ServingMPConfig`` / ``resolve_serving``: the serving engine's mp
  schedule (degree, rung, whether the LM head shards over the vocab);
* ``serving_step_record``: the bytes one dispatch moves and the
  collectives it issues (the engine adds it to the serving counters of
  ``serving/metrics.py`` per executed dispatch).

The training schedules (sequence-parallel blocks, GEMM + reduce-scatter)
come with the training tensor-parallel slice (ROADMAP Queue A 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import comm_backend


def qkv_head_major_perm(H, nh):
    """Column permutation [3H] taking the logical [3, nh, d] qkv layout to
    head-major [nh, 3, d]: position (h, a, dd) <- logical column
    (a, h, dd)."""
    d = H // nh
    a, h, dd = np.meshgrid(np.arange(3), np.arange(nh), np.arange(d),
                           indexing="ij")
    logical = (a * H + h * d + dd).reshape(3, nh, d)
    return logical.transpose(1, 0, 2).reshape(-1)


def to_qkv_head_major(blocks, H, nh):
    """Stacked qkv_w [L, H, 3H] / qkv_b [L, 3H] permuted to head-major (a
    relabeling: the values are the same, in other columns)."""
    perm = torch.from_numpy(qkv_head_major_perm(H, nh))
    out = dict(blocks)
    for name in ("qkv_w", "qkv_b"):
        t = blocks[name]
        out[name] = t[..., perm.to(t.device)]
    return out


@dataclass(frozen=True)
class ServingMPConfig:
    """Static mp configuration of a serving engine. ``backend`` names the
    rung: 'gspmd' (one all-gather collective per gather), 'ring' (n - 1
    point-to-point hops) or 'fused' (the hand-written kernels of
    ``ops/fused_collectives.py``). All three run the same gather-only
    arithmetic."""
    n: int
    backend: str       # 'gspmd' | 'ring' | 'fused'
    shard_vocab: bool  # LM head and logits gather sharded over the vocab


def resolve_serving(config, n, backend=None, device=None,
                    weight_dtypes=None):
    """The serving engine's mp schedule for an ``n``-rank group, or None for
    n <= 1. Raises when n does not divide the hidden size, the heads and
    the FFN width. ``backend`` None reads ``FLAGS_comm_backend`` (default
    'gspmd'). On a CUDA ``device`` the fused rung raises, naming the
    reason, where its kernels cannot take the out, down or head GEMM
    (``weight_dtypes``: their stored dtypes by leaf name, default the
    compute dtype and an fp32 head); the reference steps down to 'ring'
    there, the port never steps down."""
    n = int(n or 1)
    if n <= 1:
        return None
    H = config.hidden_size
    nh = config.num_heads
    inner = config.ffn_mult * H
    if H % n or nh % n or inner % n:
        raise ValueError(
            f"serving mp={n} must divide hidden {H}, heads {nh} and ffn "
            f"{inner} (choose an mp degree dividing all three)")
    if backend is None:
        backend = comm_backend.serving_requested() or "gspmd"
    if backend not in comm_backend.BACKENDS:
        raise ValueError(f"serving comm_backend must be one of "
                         f"{comm_backend.BACKENDS}, got {backend!r}")
    shard_vocab = config.vocab_size % n == 0
    if backend == "fused" and device is not None and \
            torch.device(device).type == "cuda":
        from ..models.gpt import compute_dtype
        from ..ops import fused_collectives as fc
        dt = compute_dtype(config)
        wd = dict(weight_dtypes or {})
        gemms = [("out_w", H, H // n, wd.get("out_w", dt), dt),
                 ("down_w", inner, H // n, wd.get("down_w", dt), dt)]
        if shard_vocab:
            gemms.append(("head_w", H, config.vocab_size // n,
                          wd.get("head_w", torch.float32), torch.float32))
        whys = [f"{name} [{K}, {F}]: {why}"
                for name, K, F, w_dtype, x_dtype in gemms
                if (why := fc.unsupported_reason(K, F, w_dtype, x_dtype))]
        if whys:
            raise ValueError(
                f"the fused serving rung cannot run this config on CUDA "
                f"({'; '.join(whys)}); choose comm_backend='ring' or "
                f"'gspmd'")
    return ServingMPConfig(n=n, backend=str(backend),
                           shard_vocab=shard_vocab)


@dataclass
class MpStepRecord:
    """Per-rank mp wire traffic of one executed dispatch."""
    collectives: int = 0          # all-gathers issued (ring: hop groups)
    ppermute_hops: int = 0        # point-to-point hops (ring rung only)
    fused_dispatches: int = 0     # fused kernel launches (fused rung)
    backend: str = "gspmd"
    ag_bytes: int = 0
    bytes_by_kind: dict = field(default_factory=dict)
    activation_bytes: int = 0     # the [R, H] activation, per rank


def serving_step_record(config, cfg: ServingMPConfig, B, T):
    """Per-rank wire ledger of one serving dispatch at window [B, T]
    (decode: [slots, 1]; prefill chunk: [1, rung]): per block the
    all-gathers of the attention context, the out projection's blocks, the
    FFN activation and the down projection's blocks, plus the embedding's
    and, vocab-sharded, the logits' (one row per slot, fp32). Each
    all-gather sends this rank's 1/n block to the n - 1 others."""
    n = cfg.n
    from ..models.gpt import compute_dtype
    item = compute_dtype(config).itemsize
    H = config.hidden_size
    inner = config.ffn_mult * H
    L = config.num_layers
    R = B * T

    def ag(F, isz=item):
        return R * F * isz * (n - 1) // n

    rec = MpStepRecord()
    rec.backend = cfg.backend
    total = ag(H) + L * (ag(H) + ag(H) + ag(inner) + ag(H))
    colls = 1 + 4 * L
    if cfg.shard_vocab:
        total += B * config.vocab_size * 4 * (n - 1) // n
        colls += 1
    rec.ag_bytes = total
    rec.collectives = colls
    rec.bytes_by_kind = {"all_gather": total}
    if cfg.backend == "ring":
        rec.ppermute_hops = colls * (n - 1)
    elif cfg.backend == "fused":
        rec.fused_dispatches = colls
    rec.activation_bytes = R * H * item
    return rec

