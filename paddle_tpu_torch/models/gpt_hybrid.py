"""The GPT pretraining step (counterpart of
``paddle_tpu/models/gpt_hybrid.py``), on one device or tensor-parallel
over an ``MPGroup``:

    ids [B, S] -> embeddings -> L x remat(block) -> final fp32 LN
      -> LM head + CE -> backward -> global-norm clip -> AdamW

The reference's ``lax.scan`` over stacked ``[L, ...]`` block leaves is a
Python loop here. The leaves stay stacked, so parameter trees cross
between the frameworks unchanged, and each leaf is ``unbind``-ed once per
step outside the checkpointed blocks: the backward of ``unbind`` is one
stack into the ``[L, ...]`` gradient, where indexing ``blocks[k][l]``
inside the loop would allocate a full-size zero gradient per layer.

Every block runs under the remat policy (``distributed/recompute.py``),
also when ``config.remat`` is False, as the reference's ``gpt_hidden``
does: the switch is ``config.remat_policy``. Under ``"full"`` the backward
reruns each block's forward, the flash forward kernel included, so the
forward kernel launches twice per layer per step.

One device: the fused vocab-chunked head + CE (``ops/fused_ce.py``).

Tensor parallel (``group=``, the SPMD counterpart of the reference's
``mesh=create_hybrid_mesh(mp=n)`` under its explicit sequence-parallel
schedule, ``tp_overlap.py``): every rank runs this step on its shards
(``params.gpt_param_specs``; qkv head-major). The vocab-sharded embedding
is a masked local lookup whose per-rank partials are reduce-scattered
over the sequence into the seq shard, and ``wpe``'s rows of the shard
are added after it; the blocks run ``tp_overlap.sp_block_fn`` on the
rung ``comm_backend`` names (``"rsag"``, ``"ring"``, ``"fused"``); the
final LN runs on the shard; the hidden states are all-gathered over the
sequence for the vocab-sharded head GEMM, and the loss is ``_lm_loss``
over vocab-sharded fp32 logits (max and sum-exp all-reduced over the
group, the gold logit from the rank that owns it). The gradients of the
replicated leaves are per-rank partial sums and are all-reduced; the
clip's global norm counts every shard once and every replicated leaf
once; AdamW updates each rank's shards.

Meshes raise and point to ``group=``; dp and pp, ZeRO stage 3, host
offload and the reference's non-sequence-parallel GSPMD all-reduce
schedule are ROADMAP Queue A items 11 and 13. The reference's live step
telemetry (``StepSampler``) waits for item 10.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import resolve_device
from ..distributed import tp_overlap as tp
from ..distributed.recompute import remat
from ..ops.fused_ce import fused_lm_loss
from .gpt import compute_dtype, gpt_block_fn
from .params import (gpt_param_specs, init_gpt_params, param_shapes,
                     shard_params)


def _lm_loss(logits, ids):
    """Shifted next-token CE in fp32 from full logits [B, S, V] (the
    reference keeps it for vocab-sharded logits and as the fused loss's
    numeric reference)."""
    lg = logits[:, :-1].float()
    lb = ids[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, lb[..., None])[..., 0]
    return (logz - gold).mean()


def final_ln_fp32(x, g, b, eps):
    """Final LayerNorm in fp32, scaled and shifted in fp32; returns fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _lm_loss_sharded(logits, ids, group):
    """``_lm_loss`` over vocab-sharded logits [B, S, V/n] (rank r holds
    vocab columns [r V/n, (r+1) V/n)): the max and the sum of exps
    all-reduced over the group, the gold logit taken from the rank that
    owns it. Every rank returns the same loss."""
    Vl = logits.shape[-1]
    lg = logits[:, :-1].float()
    lb = ids[:, 1:].long() - group.rank * Vl
    m = group.all_reduce_(lg.detach().amax(-1), "max")
    sumexp = tp.all_reduce_sum(torch.exp(lg - m[..., None]).sum(-1), group)
    logz = m + torch.log(sumexp)
    own = (lb >= 0) & (lb < Vl)
    gold = lg.gather(-1, lb.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = tp.all_reduce_sum(gold.masked_fill(~own, 0.0), group)
    return (logz - gold).mean()


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the port is SPMD: pass group= (a distributed.env.MPGroup from "
            "distributed.env.launch or init_mp_group, one process per rank) "
            "instead of a mesh; dp and pp are ROADMAP Queue A item 11")


def _schedule(config, group, comm_backend, device, seq):
    """The step's ``tp_overlap.SPConfig`` (None without a group of n > 1)."""
    if group is None or group.n <= 1:
        return None
    return tp.resolve_gpt(config, group.n, comm_backend, device, seq)


def _embed(params, ids, config, group, sp):
    dt = compute_dtype(config)
    S = ids.shape[1]
    if sp is None:
        return F.embedding(ids, params["wte"].to(dt)) + \
            params["wpe"].to(dt)[None, :S]
    # vocab-sharded lookup: this rank's rows, zeros elsewhere; the sum over
    # the ranks (exact: one addend is nonzero) lands seq-sharded
    Vl = params["wte"].shape[0]
    local = ids - group.rank * Vl
    own = (local >= 0) & (local < Vl)
    emb = F.embedding(local.clamp(0, Vl - 1), params["wte"].to(dt))
    x = tp.seq_reduce_scatter(emb.masked_fill(~own[..., None], 0), group)
    s = S // group.n
    return x + params["wpe"].to(dt)[None, group.rank * s:
                                     (group.rank + 1) * s]


def gpt_hidden(params, ids, config, mesh=None, num_microbatches=1,
               group=None, comm_backend=None):
    """Forward to final-LayerNorm hidden states in the compute dtype:
    [B, S, H], or with a ``group`` of n > 1 ranks this rank's seq shard
    [B, S/n, H] of the sequence-parallel schedule (rung
    ``comm_backend``; ``params`` this rank's shards).
    ``num_microbatches`` only matters to the pipeline, which is not
    ported."""
    _no_mesh(mesh)
    dt = compute_dtype(config)
    sp = _schedule(config, group, comm_backend, params["wte"].device,
                   ids.shape[1])
    x = _embed(params, ids, config, group, sp)
    block = remat(gpt_block_fn(config) if sp is None else
                  tp.sp_block_fn(config, group, sp.backend),
                  config.remat_policy)
    blocks = params["blocks"]
    per_layer = {k: v.unbind(0) for k, v in blocks.items()}
    for layer in range(blocks["qkv_w"].shape[0]):
        x = block({k: v[layer] for k, v in per_layer.items()}, x)
    return final_ln_fp32(x, params["lnf_g"], params["lnf_b"],
                         config.layer_norm_epsilon).to(dt)


def gpt_forward(params, ids, config, mesh=None, num_microbatches=1,
                group=None, comm_backend=None):
    """Forward to logits in the compute dtype: [B, S, V], or with a
    ``group`` of n > 1 ranks this rank's vocab shard [B, S, V/n] (the
    final hidden states all-gathered over the sequence, then the
    vocab-sharded head GEMM)."""
    hidden = gpt_hidden(params, ids, config, mesh, num_microbatches,
                        group, comm_backend)
    if group is not None and group.n > 1:
        hidden = tp.seq_all_gather(hidden, group)
    return hidden @ params["head_w"].to(hidden.dtype)


def gpt_loss(params, ids, config, group=None, comm_backend=None):
    """The training loss of ``HybridTrainStep``: mean next-token CE of the
    fused head over ``gpt_hidden``; with a ``group`` of n > 1 ranks,
    ``_lm_loss`` over the vocab-sharded logits of ``gpt_forward`` (the
    reference's mp>1 loss, ``gpt_hybrid.py:445-454``)."""
    if group is not None and group.n > 1:
        logits = gpt_forward(params, ids, config, group=group,
                             comm_backend=comm_backend)
        return _lm_loss_sharded(logits, ids, group)
    hidden = gpt_hidden(params, ids, config)
    return fused_lm_loss(hidden, params["head_w"].to(hidden.dtype), ids)


def flatten_params(tree):
    """``{"wte": t, ..., "blocks/qkv_w": t, ...}`` of a parameter tree."""
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in tree["blocks"].items()})
    return flat


def unflatten_params(flat):
    tree = {k: v for k, v in flat.items() if not k.startswith("blocks/")}
    tree["blocks"] = {k[len("blocks/"):]: v for k, v in flat.items()
                      if k.startswith("blocks/")}
    return tree


def decays(name):
    """The reference's decay mask: no weight decay for biases (``*_b``),
    LayerNorm leaves (``ln`` in the name, so ``lnf_g``/``lnf_b`` too) and
    ``wpe``; ``wte`` and ``head_w`` decay."""
    leaf = name.rsplit("/", 1)[-1]
    return not (leaf.endswith("_b") or "ln" in leaf or leaf == "wpe")


class HybridTrainStep:
    """GPT train step: ``step(ids)`` runs forward, backward, clip and the
    optimizer update, updating ``params`` and ``opt_state`` in place, and
    returns the loss as a 0-dim tensor on the device (no host sync).

    ``params``: a full tree in the logical qkv layout from
    ``params_from_numpy`` (or the port's ``init_gpt_params``), copied to
    ``device`` in ``param_dtype``; without it, ``init_gpt_params(config,
    seed)`` draws the weights. ``num_microbatches`` only matters to the
    pipeline, which is not ported.

    Tensor parallel: ``group`` (a ``distributed.env.MPGroup`` of n > 1
    ranks; every rank builds the step with the same params or seed and
    calls it with the same ids) and ``comm_backend`` (``"rsag"``,
    ``"ring"``, ``"fused"``; None reads the flags,
    ``comm_backend.train_requested``). The step stores its qkv head-major
    (on a private copy of the config) and keeps this rank's shards in
    ``params``; ``device=None`` means the group's device. ``num_params``
    counts the whole model."""

    def __init__(self, config, optimizer, mesh=None, num_microbatches=1,
                 param_dtype=torch.float32, seed=0, zero_stage=1,
                 offload=False, device=None, params=None, group=None,
                 comm_backend=None):
        _no_mesh(mesh)
        if zero_stage >= 3:
            raise NotImplementedError(
                "zero_stage >= 3 shards params over dp (ROADMAP Queue A "
                "items 11 and 13); the step keeps stage 1")
        if offload:
            raise NotImplementedError(
                "host offload of optimizer moments is not ported yet "
                "(ROADMAP Queue A item 13)")
        self.optimizer = optimizer
        self.group = group if group is not None and group.n > 1 else None
        self.device = resolve_device(
            group.device if device is None and group is not None
            else device)
        if group is not None and (
                self.device.type != group.device.type or
                self.device.index not in (None, group.device.index)):
            raise ValueError(f"the step's device {self.device} is not the "
                             f"group's {group.device}")
        head_major = config.qkv_head_major
        self._sp = None
        if self.group is not None:
            config = dataclasses.replace(config, qkv_head_major=True)
            self._sp = tp.resolve_gpt(config, self.group.n, comm_backend,
                                      self.device)
        self.config = config
        copy = params is not None     # never update the caller's tree
        if params is None:
            params = init_gpt_params(config, seed=seed, device=self.device,
                                     dtype=param_dtype)
        shapes = flatten_params(param_shapes(config))
        flat = flatten_params(params)
        if set(flat) != set(shapes):
            raise KeyError(f"param tree keys {sorted(flat)} differ from the "
                           f"config's {sorted(shapes)}")
        for name, t in flat.items():
            if tuple(t.shape) != tuple(shapes[name]):
                raise ValueError(f"param {name} has shape {tuple(t.shape)}, "
                                 f"the config needs {shapes[name]}")
        self._num_params = sum(math.prod(s) for s in shapes.values())
        self._replicated = set()
        if self.group is not None:
            params = unflatten_params({n: t.detach().to(self.device,
                                                        param_dtype)
                                       for n, t in flat.items()})
            if not head_major:
                params["blocks"] = tp.to_qkv_head_major(
                    params["blocks"], config.hidden_size, config.num_heads)
            flat = flatten_params(shard_params(params, self.group.rank,
                                               self.group.n))
            specs = flatten_params(gpt_param_specs())
            self._replicated = {n for n in flat if specs[n] is None}
            copy = True               # the shards may be views of params
        self._flat = {name: t.detach().to(self.device, param_dtype,
                                          copy=copy).requires_grad_(True)
                      for name, t in flat.items()}
        self.params = unflatten_params(self._flat)
        self.opt_state = optimizer.init_state(self._flat)
        self._wd_mask = {n: decays(n) for n in self._flat}
        self._records = {}

    def _ids(self, ids):
        return torch.as_tensor(ids).to(self.device, torch.long)

    def _backend(self):
        return None if self._sp is None else self._sp.backend

    def _record(self, shape):
        """The step's mp wire record for ids of ``shape`` (None on one
        device); raises where the schedule cannot take the sequence."""
        if self.group is None:
            return None
        if shape not in self._records:
            B, S = shape
            sp = tp.resolve_gpt(self.config, self.group.n, self._backend(),
                                self.device, S)
            self._records[shape] = tp.gpt_step_record(self.config, sp, B, S)
        return self._records[shape]

    def loss_and_grads(self, ids):
        """Forward and backward on the current params: (loss, {name:
        gradient}), the replicated leaves' gradients summed over the group
        (no clip, no update)."""
        ids = self._ids(ids)
        self._record(tuple(ids.shape))
        names = list(self._flat)
        # the record_function ranges name the step's parts in a
        # torch.profiler trace (chip_smoke.py's train profiles read them);
        # the backward gets none: autograd runs it on its own thread
        with torch.enable_grad():
            with record_function("train_step/forward"):
                loss = gpt_loss(self.params, ids, self.config, self.group,
                                self._backend())
            grads = dict(zip(names, torch.autograd.grad(
                loss, [self._flat[n] for n in names])))
        if self._replicated:
            with record_function("train_step/grad_sync"):
                self._sync_replicated(grads)
        return loss.detach(), grads

    def _sync_replicated(self, grads):
        """All-reduce the replicated leaves' gradients (per-rank partial sums
        under sequence parallelism) in one flat buffer, in place."""
        names = sorted(self._replicated)
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        self.group.all_reduce_(flat)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            grads[n] = part.view_as(grads[n])

    def __call__(self, ids):
        loss, grads = self.loss_and_grads(ids)
        names = list(grads)
        clip = getattr(self.optimizer, "_grad_clip", None)
        if clip is not None:
            with record_function("train_step/clip"):
                if self.group is None:
                    clipped = clip.apply_arrays([grads[n] for n in names])
                else:
                    clipped = clip.apply_arrays(
                        [grads[n] for n in names], group=self.group,
                        sharded=[n not in self._replicated for n in names])
                grads = dict(zip(names, clipped))
        with record_function("train_step/optimizer"):
            self.optimizer.apply_gradients(
                self._flat, grads, self.opt_state, self.optimizer.get_lr(),
                wd_mask=self._wd_mask)
        tp.record_step(self._record(tuple(self._ids(ids).shape)))
        return loss

    @torch.no_grad()
    def loss_only(self, ids):
        """Forward-only loss on the current params (no grads, no
        update)."""
        return gpt_loss(self.params, self._ids(ids), self.config,
                        self.group, self._backend())

    def num_params(self):
        """The whole model's parameter count (every rank's shards)."""
        return int(self._num_params)
