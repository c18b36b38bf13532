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

Pipeline parallel (``pp_group=``, ``num_microbatches=``, the SPMD
counterpart of the reference's ``mesh=create_hybrid_mesh(pp=n)`` under
``FLAGS_comm_backend='pp=ring'|'pp=fused'``): every rank is a stage
holding its L/n layers (``params.stage_params``); stage 0 embeds, the
blocks run through ``distributed.pipeline.run_pipeline`` on the schedule
``comm_backend.resolve_pp`` picks (GPipe or 1F1B on the ring rung, GPipe
with the boundary kernels of ``ops/pp_boundary.py`` on the fused rung),
and the last stage gathers the M microbatch outputs and runs the final
fp32 LayerNorm and the fused head + CE on the whole batch (the
reference's mp=1 loss, gpt_hybrid.py:445-450). The loss is broadcast from
the last stage, so every rank returns it; the clip's global norm sums
each stage's leaves once; AdamW updates each stage's own leaves.

Data parallel (``dp_group=``, the SPMD counterpart of the reference's
``create_hybrid_mesh(dp=n)`` with its ``P('dp')`` batch sharding): every
rank is called with the global ids and runs its B/dp rows (replica r rows
[r B/dp, (r+1) B/dp)); the loss is averaged over the replicas and the
gradients meet over the dp sub-group (``grad_comm.resolve_hybrid``): one
all-reduce a bucket, or under ZeRO-1 (``optimizer._shard_opt_states_axis
= "dp"``) the bucketed reduce-scatter, the clip from the shards, the
update of each replica's 1/dp of every leaf and slot, and the params'
all-gather (rows 10-11 on ``dp=fused``).

The three compose, one sub-group per axis of a hybrid world
(``distributed.env.init_hybrid_groups``): dp x mp, dp x pp, pp x mp and
pp x dp x mp. A step shards its tree over mp, then stages it over pp;
under pp x mp stage 0's embedding and the blocks run the
sequence-parallel schedule inside each stage (activations cross the
boundary seq-sharded, [B/M, S/mp, H]) and the last stage's mp group
computes the vocab-sharded loss. The gradients of the mp-replicated
leaves meet over mp first, then every leaf over dp; the clip counts each
element once over the three axes; the loss reaches every rank (broadcast
from the last stage, then averaged over dp).

Meshes raise and point to the groups; ZeRO stage 3 and the reference's
non-sequence-parallel GSPMD all-reduce schedule are the rest of ROADMAP
Queue A step 3; host offload is item 13. The reference's live step
telemetry (``StepSampler``) waits for item 10.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import resolve_device
from ..distributed import grad_comm as gc
from ..distributed import pipeline as pl
from ..distributed import tp_overlap as tp
from ..distributed.comm_backend import parse, resolve_pp
from ..distributed.recompute import remat
from ..ops.fused_ce import fused_lm_loss
from .gpt import compute_dtype, gpt_block_fn, gpt_fused_boundary
from .params import (gpt_param_specs, init_gpt_params, param_shapes,
                     shard_params, stage_params)


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
            "the port is SPMD: pass group= (tensor parallel), pp_group= "
            "(pipeline parallel) and dp_group= (data parallel), "
            "distributed.env.MPGroups from distributed.env.launch, "
            "init_mp_group or init_hybrid_groups (one sub-group per axis of "
            "a hybrid world), one process per rank, instead of a mesh "
            "(ROADMAP Queue A item 11)")


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
    ``num_microbatches`` is the pipeline's (``HybridTrainStep(pp_group=)``,
    which runs the blocks stage by stage); it is not read here."""
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


def _multi(group):
    return group if group is not None and group.n > 1 else None


class HybridTrainStep:
    """GPT train step: ``step(ids)`` runs forward, backward, clip and the
    optimizer update, updating ``params`` and ``opt_state`` in place, and
    returns the loss as a 0-dim tensor on the device (no host sync).

    ``params``: a full tree in the logical qkv layout from
    ``params_from_numpy`` (or the port's ``init_gpt_params``), copied to
    ``device`` in ``param_dtype``; without it, ``init_gpt_params(config,
    seed)`` draws the weights. With groups every rank builds the step with
    the same params or seed and calls it with the same (global) ids;
    ``device=None`` means the groups' device. ``num_params`` counts the
    whole model.

    ``comm_backend``: the rungs, ``"mp=fused,pp=ring,dp=fused"`` (a bare
    name applies to every axis, ``"rsag"`` to mp alone; an axis it does
    not name reads ``FLAGS_comm_backend``).

    Tensor parallel: ``group`` (a ``distributed.env.MPGroup`` of n > 1
    ranks) on the mp rung ``"rsag"``, ``"ring"`` or ``"fused"``
    (``comm_backend.train_requested`` from the flags). The step stores its
    qkv head-major (on a private copy of the config) and keeps this rank's
    shards in ``params``.

    Pipeline parallel: ``pp_group`` (rank = stage), ``num_microbatches`` M
    (it must divide the batch each replica runs) and the pp rung
    ``"ring"`` or ``"fused"`` (``comm_backend.resolve_pp``: with no pp
    rung named anywhere the step runs ``"ring"`` with
    ``config.pp_schedule``). ``params`` then keeps this stage's leaves
    only (``params.stage_params``). With ``group`` too the rung must be
    ring.

    Data parallel: ``dp_group`` (the replicas), the rung
    ``grad_comm.resolve_hybrid`` picks, ZeRO-1 when
    ``optimizer._shard_opt_states_axis == "dp"`` (``opt_state`` then
    holds this replica's (1, cols) rows of every slot)."""

    def __init__(self, config, optimizer, mesh=None, num_microbatches=1,
                 param_dtype=torch.float32, seed=0, zero_stage=1,
                 offload=False, device=None, params=None, group=None,
                 comm_backend=None, pp_group=None, dp_group=None):
        _no_mesh(mesh)
        if zero_stage >= 3:
            raise NotImplementedError(
                "zero_stage >= 3 shards params over dp (ROADMAP Queue A "
                "items 11 and 13: the rest of item 11's step 3); the step "
                "runs stage 1, optimizer states sharded over dp_group when "
                "optimizer._shard_opt_states_axis == 'dp'")
        if offload:
            raise NotImplementedError(
                "host offload of optimizer moments is not ported yet "
                "(ROADMAP Queue A item 13)")
        self.optimizer = optimizer
        self.group = _multi(group)
        self.pp_group = _multi(pp_group)
        self.dp_group = _multi(dp_group)
        self.num_microbatches = int(num_microbatches)
        given = [g for g in (group, pp_group, dp_group) if g is not None]
        self.device = resolve_device(
            given[0].device if device is None and given else device)
        for g in given:
            if self.device.type != g.device.type or \
                    self.device.index not in (None, g.device.index):
                raise ValueError(f"the step's device {self.device} is not "
                                 f"the group's {g.device}")
        rungs = parse(comm_backend)
        mp_n = self.group.n if self.group is not None else 1
        dp_n = self.dp_group.n if self.dp_group is not None else 1
        head_major = config.qkv_head_major
        self._sp = self._ppc = None
        if self.pp_group is not None:
            self._ppc = resolve_pp(config, self.pp_group.n, comm_backend,
                                   num_microbatches=self.num_microbatches,
                                   mp=mp_n, dp=dp_n, device=self.device)
        if self.group is not None:
            config = dataclasses.replace(config, qkv_head_major=True)
            self._sp = tp.resolve_gpt(config, self.group.n, rungs.get("mp"),
                                      self.device)
        self._dpc = gc.resolve_hybrid(self.dp_group, optimizer,
                                      rungs.get("dp"))
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
            copy = True               # the shards may be views of params
        if self.pp_group is not None:
            flat = flatten_params(stage_params(
                unflatten_params(flat), self.pp_group.rank,
                self.pp_group.n))
            copy = True               # the stage's blocks are views
        if self.group is not None:
            specs = flatten_params(gpt_param_specs())
            self._replicated = {n for n in flat if specs[n] is None}
        self._flat = {name: t.detach().to(self.device, param_dtype,
                                          copy=copy).requires_grad_(True)
                      for name, t in flat.items()}
        self.params = unflatten_params(self._flat)
        self.opt_state = optimizer.init_state(self._flat)
        self._wd_mask = {n: decays(n) for n in self._flat}
        self._records = {}
        self._dp_rec = None
        if self._dpc is not None:
            dpc = self._dpc
            dpc.plan = gc.BucketPlan.build(self._flat, dpc.n,
                                           dpc.bucket_bytes)
            self._dp_rec = gc.make_step_record(
                dpc.plan, None, dpc.weight_update_sharding,
                backend=dpc.backend)
            if dpc.weight_update_sharding:
                self.opt_state = gc.pack_opt_state(
                    self.opt_state, self._flat, dpc.n, self.dp_group.rank)
        # each sub-group's first collective involves every rank of it
        # (NCCL's batched point-to-point ops need that of a group's first
        # call), in one order on every rank
        for g in (self.group, self.dp_group, self.pp_group):
            if g is not None:
                g.barrier()

    def _ids(self, ids):
        return torch.as_tensor(ids).to(self.device, torch.long)

    def _rows(self, ids):
        """This replica's rows of the global ids (all of them without
        dp)."""
        g = self.dp_group
        if g is None:
            return ids
        b = ids.shape[0] // g.n
        return ids[g.rank * b:(g.rank + 1) * b]

    def _backend(self):
        return None if self._sp is None else self._sp.backend

    def step_records(self, shape):
        """The step's ledgers for global ids of ``shape``: ``{"mp": the mp
        wire record of this rank's rows (none under pp, whose stages run
        other parts of the model and 1F1B a third forward), "pp": the pp
        ledger, "dp": the gradient communication record}`` (None where the
        axis is absent); raises where the schedules cannot take the
        sequence or the batch."""
        if shape not in self._records:
            B, S = shape
            dp = self.dp_group.n if self.dp_group is not None else 1
            if B % dp:
                raise ValueError(f"batch {B} not divisible by dp={dp} (the "
                                 f"replicas take equal rows)")
            b = B // dp
            mp_n = self.group.n if self.group is not None else 1
            rec = {"mp": None, "pp": None, "dp": self._dp_rec}
            if self.group is not None:
                sp = tp.resolve_gpt(self.config, mp_n, self._backend(),
                                    self.device, S)
                if self.pp_group is None:
                    rec["mp"] = tp.gpt_step_record(self.config, sp, b, S)
            if self.pp_group is not None:
                g = self.pp_group
                resolve_pp(self.config, g.n, self._ppc.backend, batch=B,
                           num_microbatches=self.num_microbatches, mp=mp_n,
                           dp=dp)
                rec["pp"] = pl.gpt_pp_step_record(
                    self.config, self._ppc, b, S // mp_n,
                    self.num_microbatches, g.rank)
            self._records[shape] = rec
        return self._records[shape]

    def _local(self, ids):
        """Forward and backward on this replica's rows ``ids``: (the loss
        on every rank of the replica, {name: gradient}) with the
        mp-replicated leaves' gradients summed over mp (no dp sync)."""
        names = list(self._flat)
        # the record_function ranges name the step's parts in a
        # torch.profiler trace (chip_smoke.py's train profiles read them);
        # the backward gets none: autograd runs it on its own thread
        with torch.enable_grad():
            with record_function("train_step/forward"):
                loss, root = self._forward(ids)
            grads = dict(zip(names, torch.autograd.grad(
                root, [self._flat[n] for n in names])))
        if self._replicated:
            with record_function("train_step/grad_sync"):
                self._sync_replicated(grads)
        if self.pp_group is not None:
            loss = self._pp_broadcast_loss(loss)
        return loss.detach(), grads

    def loss_and_grads(self, ids):
        """Forward and backward on the current params: (loss, {name:
        gradient}), the mp-replicated leaves' gradients summed over mp and
        every gradient averaged over dp (no clip, no update)."""
        ids = self._ids(ids)
        self.step_records(tuple(ids.shape))
        loss, grads = self._local(self._rows(ids))
        dpc = self._dpc
        if dpc is not None and dpc.weight_update_sharding:
            with torch.no_grad(), record_function("grad_comm/all_gather"):
                grads = gc.all_gather_shards(
                    dpc.plan, self._reduce_scatter(grads), self.dp_group,
                    fused=dpc.backend == "fused")
        elif dpc is not None:
            grads = self._all_reduce(grads)
        return self._dp_mean(loss), grads

    def _forward(self, ids):
        """(loss, the root this rank differentiates): the loss is None on a
        stage other than the last."""
        if self.pp_group is not None:
            return self._pp_loss(ids)
        loss = gpt_loss(self.params, ids, self.config, self.group,
                        self._backend())
        return loss, loss

    def _pp_loss(self, ids):
        """This stage's part of the pipelined forward: (loss on the last
        stage, else None; the root every stage differentiates). With an
        mp group the blocks run the sequence-parallel schedule on seq
        shards [B/M, S/mp, H] and the last stage's loss is vocab-sharded."""
        g, cfg, ppc, mp, sp = (self.pp_group, self.config, self._ppc,
                               self.group, self._sp)
        first, last = g.rank == 0, g.rank == g.n - 1
        dt = compute_dtype(cfg)
        B, S = ids.shape
        if first:
            x = _embed(self.params, ids, cfg, mp, sp)
        else:                         # only stage 0's values are read
            x = torch.zeros((), dtype=dt, device=self.device).expand(
                B, S // (mp.n if mp is not None else 1), cfg.hidden_size)
        block_fn = gpt_block_fn(cfg) if sp is None else \
            tp.sp_block_fn(cfg, mp, sp.backend)
        if ppc.schedule == "gpipe":   # blocks checkpointed, hops outside
            block, pol = remat(block_fn, cfg.remat_policy), None
        else:                         # the stage-input recompute is "full"
            block = block_fn
            pol = None if cfg.remat_policy in (None, "full") else \
                cfg.remat_policy
        boundary = gpt_fused_boundary(cfg, g, cfg.remat_policy) \
            if ppc.backend == "fused" else None
        out = pl.run_pipeline(block, self.params["blocks"], x,
                              self.num_microbatches, g,
                              schedule=ppc.schedule, backend=ppc.backend,
                              wire_dtype=ppc.wire_dtype, boundary=boundary,
                              remat_policy=pol)
        if not last:
            return None, out.sum()
        hidden = final_ln_fp32(out, self.params["lnf_g"],
                               self.params["lnf_b"],
                               cfg.layer_norm_epsilon).to(dt)
        head = self.params["head_w"].to(dt)
        if mp is None:
            loss = fused_lm_loss(hidden, head, ids)
        else:
            loss = _lm_loss_sharded(tp.seq_all_gather(hidden, mp) @ head,
                                    ids, mp)
        return loss, loss

    def _pp_broadcast_loss(self, loss):
        """The last stage's loss on every rank (fp32, 0-dim)."""
        g = self.pp_group
        buf = loss.detach().float().reshape(()) if loss is not None else \
            torch.empty((), dtype=torch.float32, device=self.device)
        return g.broadcast(buf, src=g.n - 1)

    def _dp_mean(self, loss):
        """The replicas' mean of the loss (fp32, 0-dim)."""
        if self.dp_group is None:
            return loss
        return self.dp_group.all_reduce_(loss.float().clone()) / \
            self.dp_group.n

    def _sync_replicated(self, grads):
        """All-reduce the replicated leaves' gradients (per-rank partial sums
        under sequence parallelism) in one flat buffer, in place."""
        names = sorted(self._replicated)
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        self.group.all_reduce_(flat)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            grads[n] = part.view_as(grads[n])

    @torch.no_grad()
    def _all_reduce(self, grads):
        """Every gradient's mean over the replicas, full leaves, without
        ZeRO: one library all-reduce a bucket (the reference's GSPMD
        dp)."""
        dpc = self._dpc
        with record_function("train_step/grad_sync"):
            return gc.all_reduce_grads(dpc.plan, grads, self.dp_group,
                                       denom=dpc.n)

    @torch.no_grad()
    def _reduce_scatter(self, grads):
        """ZeRO-1's bucketed reduce-scatter: this replica's flat shards of
        the gradients' mean over the replicas (row 10 on ``fused``)."""
        dpc = self._dpc
        with record_function("grad_comm/reduce_scatter"):
            return gc.reduce_scatter_grads(dpc.plan, grads, self.dp_group,
                                           None, denom=dpc.n,
                                           fused=dpc.backend == "fused")

    def _clip(self, grads, shards=False):
        """The clip of ``grads`` ({name: gradient}, or this replica's flat
        shards under ZeRO-1), every element counted once over the axes."""
        clip = getattr(self.optimizer, "_grad_clip", None)
        if clip is None:
            return grads
        names = list(grads)
        sharded = None if self.group is None else \
            [n not in self._replicated for n in names]
        with record_function("train_step/clip"):
            return dict(zip(names, clip.apply_arrays(
                [grads[n] for n in names], group=self.group,
                sharded=sharded, stage_group=self.pp_group,
                dp_group=self.dp_group if shards else None)))

    def __call__(self, ids):
        ids = self._ids(ids)
        recs = self.step_records(tuple(ids.shape))
        loss, grads = self._local(self._rows(ids))
        dpc = self._dpc
        if dpc is not None and dpc.weight_update_sharding:
            shards = self._reduce_scatter(grads)
            del grads
            gc.sharded_update(self.optimizer, dpc.plan, self._flat,
                              self._clip(shards, shards=True),
                              self.opt_state, self.dp_group,
                              fused=dpc.backend == "fused",
                              wd_mask=self._wd_mask)
        else:
            if dpc is not None:
                grads = self._all_reduce(grads)
            grads = self._clip(grads)
            with record_function("train_step/optimizer"):
                self.optimizer.apply_gradients(
                    self._flat, grads, self.opt_state,
                    self.optimizer.get_lr(), wd_mask=self._wd_mask)
        tp.record_step(recs["mp"])
        pl.record_pp_step(recs["pp"])
        gc.record_step(recs["dp"])
        return self._dp_mean(loss)

    @torch.no_grad()
    def loss_only(self, ids):
        """Forward-only loss on the current params (no grads, no
        update)."""
        ids = self._ids(ids)
        self.step_records(tuple(ids.shape))
        loss, _ = self._forward(self._rows(ids))
        if self.pp_group is not None:
            loss = self._pp_broadcast_loss(loss)
        return self._dp_mean(loss)

    def num_params(self):
        """The whole model's parameter count (every rank's shards or
        stages)."""
        return int(self._num_params)
