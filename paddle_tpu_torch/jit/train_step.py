"""The eager training step over a ``torch.nn.Module`` (counterpart of
``paddle_tpu/jit/train_step.py:TrainStep``), with the explicit
data-parallel gradient communication of ``distributed/grad_comm.py``.

``TrainStep(model, loss_fn, optimizer, group=g, accumulate_steps=k)`` is
SPMD: one process per data-parallel replica, each calling the step on its
own slice of the global batch, joined by ``g`` (a
``distributed.env.MPGroup``). A call runs the forward, ``loss_fn(outputs,
*labels)`` and the gradients of every parameter the model's
``named_parameters`` names (the reference Layer's order for the port's
eager models), then, at the first call, the schedule ``grad_comm.resolve``
picks from the flags:

* no group, or a group of one: the plain step, clip and update;
* a group with the explicit schedule off: the gradients' mean all-reduce,
  then clip and the replicated update (the reference's GSPMD dp);
* the explicit schedule (``FLAGS_grad_comm`` and friends): the bucketed
  reduce-scatter of the local gradients (mean over the replicas; on
  ``dp=fused`` through row 10), clip from the shards, and then either
  (``FLAGS_weight_update_sharding``) the update on each replica's 1/n
  flat shard with its slots packed (1, cols) and a bucketed all-gather of
  the params into place, or (the explicit all-reduce baseline) a gradient
  all-gather and the replicated update. The baseline is that same
  reduce-scatter plus a gather, not one all-reduce, so the two schedules
  give the same params bit for bit by construction.

``accumulate_steps=k`` averages k calls' gradients before one update:
the micro calls reduce-scatter and accumulate (packed under
weight-update sharding), the k-th fires the update (train_step.py:676-780
of the reference). The loss returned is the replicas' mean.

The ``record_function`` ranges ``train_step/forward``,
``grad_comm/reduce_scatter`` (or ``train_step/grad_sync``),
``train_step/clip``, ``train_step/optimizer`` and ``grad_comm/all_gather``
name the parts of a call in a profile; the backward is what they leave.
Params and optimizer slots are updated in place. The step runs on the
group's device, else on ``device`` (default CUDA). ``mesh=`` and the
checkpoint state and attachments raise, naming their ROADMAP items; the
anomaly guard, the SDC sentinel (item 12) and host offload (item 13)
have no flag or option in the port yet.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..distributed import grad_comm as gc


def _unported(what, item):
    def refuse(self, *args, **kwargs):
        raise NotImplementedError(f"TrainStep.{what} is not ported yet "
                                  f"(ROADMAP Queue A item {item})")
    refuse.__name__ = what
    return refuse


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, mesh=None, group=None,
                 accumulate_steps=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the port is SPMD: pass group=, a distributed.env.MPGroup "
                "of the data-parallel replicas (one process each, from "
                "distributed.env.launch or init_mp_group), instead of a "
                "mesh")
        dev = resolve_device(device if group is None else group.device)
        if group is not None and device is not None and \
                torch.device(device) != group.device:
            raise ValueError(f"device {device} is not the group's "
                             f"{group.device}")
        self.device = dev
        self.group = group if group is not None and group.n > 1 else None
        self.model = model.to(dev)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = max(int(accumulate_steps or 1), 1)
        self._params = dict(model.named_parameters())
        self._opt_state = optimizer.init_state(self._params)
        self._grad_accum = (
            {n: torch.zeros_like(p) for n, p in self._params.items()}
            if self.accumulate_steps > 1 else None)
        self._micro = 0
        self._gc_cfg = None
        self._comm_records = None
        self._built = False

    @property
    def params(self):
        return self._params

    @property
    def opt_state(self):
        return self._opt_state

    state_for_checkpoint = _unported("state_for_checkpoint", 12)
    restore_from_checkpoint = _unported("restore_from_checkpoint", 12)
    state_dict = _unported("state_dict", 12)
    load_state_dict = _unported("load_state_dict", 12)
    attach_checkpoint = _unported("attach_checkpoint", 12)
    attach_loader = _unported("attach_loader", 12)
    attach_scaler = _unported("attach_scaler", 12)

    # -- the schedule, resolved at the first call as the reference does ----
    def _build(self):
        cfg = gc.resolve(self.group, self.optimizer)
        self._gc_cfg = cfg
        self._built = True
        if cfg is None:
            return
        n, rank = cfg.n, self.group.rank
        cfg.plan = gc.BucketPlan.build(self._params, n, cfg.bucket_bytes)
        wus = cfg.weight_update_sharding
        self._comm_records = {
            tag: gc.make_step_record(cfg.plan, cfg.wire_dtype, wus,
                                     with_update=tag != "micro",
                                     backend=cfg.backend)
            for tag in ("step", "micro", "fire")}
        if wus:
            self._opt_state = gc.pack_opt_state(self._opt_state,
                                                self._params, n, rank)
            if self._grad_accum is not None:
                self._grad_accum = gc.pack_accum(self._grad_accum,
                                                 self._params, n, rank)

    # -- one call -----------------------------------------------------------
    def _loss_and_grads(self, inputs, labels):
        with record_function("train_step/forward"):
            loss = self.loss_fn(self.model(*inputs), *labels).float()
        names = list(self._params)
        grads = torch.autograd.grad(loss, [self._params[n] for n in names],
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))

    def _clip_full(self, grads):
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        names = list(grads)
        return dict(zip(names, clip.apply_arrays([grads[n] for n in names])))

    def _update_full(self, grads, clip=True):
        """The replicated update of the full params."""
        if clip:
            with record_function("train_step/clip"):
                grads = self._clip_full(grads)
        with record_function("train_step/optimizer"):
            self.optimizer.apply_gradients(self._params, grads,
                                           self._opt_state,
                                           self.optimizer.get_lr())

    def _accumulate(self, grads):
        """Add this micro call's gradients / k to the accumulator; the
        accumulated gradients on the k-th call (the accumulator then
        zeroed for the next window), else None."""
        k = self.accumulate_steps
        acc = self._grad_accum
        fire = (self._micro + 1) % k == 0
        if not fire:
            for n, g in grads.items():
                acc[n].add_(g)
            return None
        out = {n: acc[n] + g for n, g in grads.items()}
        for a in acc.values():
            a.zero_()
        return out

    @torch.no_grad()
    def _default(self, grads):
        """Flags off: the plain step (with a group, after the gradients'
        mean all-reduce)."""
        if self.group is not None:
            n = self.group.n
            with record_function("train_step/grad_sync"):
                grads = {nm: self.group.all_reduce_(g) / n
                         for nm, g in grads.items()}
        k = self.accumulate_steps
        if k > 1:
            acc = self._grad_accum
            grads = self._accumulate(
                {nm: g.to(acc[nm].dtype) / k for nm, g in grads.items()})
            if grads is None:
                return
        self._update_full(grads)

    @torch.no_grad()
    def _explicit(self, grads):
        cfg, group = self._gc_cfg, self.group
        plan, k = cfg.plan, self.accumulate_steps
        clip = self.optimizer._grad_clip
        with record_function("grad_comm/reduce_scatter"):
            gshards = gc.reduce_scatter_grads(plan, grads, group,
                                              cfg.wire_dtype, denom=cfg.n,
                                              fused=cfg.backend == "fused")
        del grads
        if cfg.weight_update_sharding:
            if k > 1:
                acc = self._grad_accum
                gshards = self._accumulate(
                    {nm: (g / k).to(acc[nm].dtype).view(1, -1)
                     for nm, g in gshards.items()})
                if gshards is None:
                    return
                gshards = {nm: g.view(-1) for nm, g in gshards.items()}
            with record_function("train_step/clip"):
                gshards = gc.clip_shards(clip, gshards, group)
            self._sharded_update(gshards)
            return
        if k == 1:
            with record_function("train_step/clip"):
                gshards = gc.clip_shards(clip, gshards, group)
        with record_function("grad_comm/all_gather"):
            full = gc.all_gather_shards(plan, gshards, group,
                                        fused=cfg.backend == "fused")
        if k == 1:
            self._update_full(full, clip=False)
            return
        acc = self._grad_accum
        full = self._accumulate({nm: (g / k).to(acc[nm].dtype)
                                 for nm, g in full.items()})
        if full is not None:
            self._update_full(full)

    def _sharded_update(self, gshards):
        """The update on this replica's flat shards (views of the params
        where a shard holds no padding), slots packed (1, cols), then the
        params' bucketed all-gather into place."""
        cfg = self._gc_cfg
        plan, rank = cfg.plan, self.group.rank
        pshards = {nm: gc.shard_of(plan, nm, p, rank)
                   for nm, p in self._params.items()}
        state = self._opt_state
        flat = {"step": state["step"],
                "slots": {nm: {kk: v.view(-1) for kk, v in sl.items()}
                          for nm, sl in state["slots"].items()}}
        with record_function("train_step/optimizer"):
            self.optimizer.apply_gradients(pshards, gshards, flat,
                                           self.optimizer.get_lr())
        state["step"] = flat["step"]
        with record_function("grad_comm/all_gather"):
            gc.all_gather_shards(plan, pshards, self.group,
                                 fused=cfg.backend == "fused",
                                 out=self._params)

    def _to_device(self, xs):
        return tuple(torch.as_tensor(x).to(self.device)
                     for x in _as_tuple(xs))

    def __call__(self, inputs, labels):
        """One call on this replica's ``inputs`` (a tensor or a tuple fed
        to the model) and ``labels`` (likewise, fed to ``loss_fn`` after
        the outputs); returns the loss, the replicas' mean."""
        inputs, labels = self._to_device(inputs), self._to_device(labels)
        if not self._built:
            self._build()
        loss, grads = self._loss_and_grads(inputs, labels)
        k = self.accumulate_steps
        fire = (self._micro + 1) % k == 0
        rec = None
        if self._gc_cfg is None:
            self._default(grads)
        else:
            rec = self._comm_records["step" if k == 1 else
                                     "fire" if fire else "micro"]
            self._explicit(grads)
        del grads
        if self.group is not None:
            loss = self.group.all_reduce_(loss.clone()) / self.group.n
        gc.record_step(rec)
        self._micro += 1
        return loss
