"""Optimizer base: the functional update on a flat ``{name: tensor}``
dict (counterpart of ``init_state`` / ``apply_gradients`` / ``get_lr`` in
``paddle_tpu/optimizer/optimizer.py``).

The reference's update is pure and returns new arrays; the port updates
params and optimizer slots in place, under ``torch.no_grad()``, which
keeps one copy of each in device memory. The arithmetic keeps the
reference's order and types: fp32 math whatever the param dtype, slots
stored in their own dtype. With ``multi_precision`` (set by
``amp.decorate(level="O2")``) a bf16 or fp16 param gets an fp32
``"master"`` slot: the rule updates the master and the param takes its
rounded copy (reference optimizer.py:195-230). The eager ``step()`` path
and LR schedulers are not ported yet (ROADMAP Queue A items 4 and 14).
"""
from __future__ import annotations

import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    """``parameters`` is taken in the reference's argument position and
    not read: the training steps name the params they update."""

    # whether the rule is elementwise, so that it may update flat shards of
    # params, gradients and slots (weight-update sharding,
    # distributed/grad_comm.py): shard-then-update is then update-then-shard
    # bit for bit
    _elementwise_update = True
    # the mesh axis the states shard over (ZeRO-1; the reference's
    # attribute, set on an instance): "dp" makes HybridTrainStep(dp_group=)
    # keep and update 1/dp of each slot (distributed/grad_comm.py)
    _shard_opt_states_axis = None

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers are not ported yet (ROADMAP Queue A item 4); "
                "pass a float learning rate")
        self._multi_precision = bool(multi_precision)
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._coupled_wd = float(weight_decay or 0.0)

    def get_lr(self):
        return self._learning_rate

    def supports_sharded_update(self):
        return self._elementwise_update

    def _create_slots(self, p):
        raise NotImplementedError

    def init_state(self, params):
        """params: {name: tensor}. Returns ``{"step": 0, "slots": {name:
        {slot: tensor}}}``, with an fp32 ``"master"`` copy of each bf16 or
        fp16 param under ``multi_precision``; the step count lives on the
        host."""
        state = {"step": 0, "slots": {}}
        for n, p in params.items():
            slots = self._create_slots(p)
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                slots["master"] = p.detach().float().clone()
            state["slots"][n] = slots
        return state

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, lr=None, wd_mask=None):
        """Update ``params`` and ``state`` in place from ``grads`` (both
        ``{name: tensor}``; a None gradient leaves its param alone).
        ``wd_mask``: optional ``{name: bool}`` switching weight decay.
        Returns (params, state)."""
        lr = torch.tensor(self.get_lr() if lr is None else lr,
                          dtype=torch.float32)
        state["step"] += 1
        step = torch.tensor(float(state["step"]), dtype=torch.float32)
        for name, p in params.items():
            g = grads[name]
            if g is None:
                continue
            decay_on = wd_mask.get(name, True) if wd_mask else True
            if self._coupled_wd and decay_on:
                g = g + self._coupled_wd * p.to(g.dtype)
            slots = state["slots"][name]
            master = slots.get("master")
            if master is None:
                self._update(p, g, slots, lr, step, decay_on)
            else:
                self._update(master, g.float(), slots, lr, step, decay_on)
                p.copy_(master)
        return params, state

    def _update(self, p, g, slots, lr, step, decay_on):
        raise NotImplementedError
