"""Optimizer base: the functional update on a flat ``{name: tensor}``
dict (counterpart of ``init_state`` / ``apply_gradients`` / ``get_lr`` in
``paddle_tpu/optimizer/optimizer.py``).

The reference's update is pure and returns new arrays; the port updates
params and optimizer slots in place, under ``torch.no_grad()``, which
keeps one copy of each in device memory. The arithmetic keeps the
reference's order and types: fp32 math whatever the param dtype, slots
stored in their own dtype. The eager ``step()`` path, LR schedulers and
``multi_precision`` fp32 masters are not ported yet (ROADMAP Queue A
items 4 and 14).
"""
from __future__ import annotations

import torch


class Optimizer:
    """``parameters`` is taken in the reference's argument position and
    not read: the training steps name the params they update."""

    # whether the rule is elementwise, so that it may update flat shards of
    # params, gradients and slots (weight-update sharding,
    # distributed/grad_comm.py): shard-then-update is then update-then-shard
    # bit for bit
    _elementwise_update = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers are not ported yet (ROADMAP Queue A item 4); "
                "pass a float learning rate")
        if multi_precision:
            raise NotImplementedError(
                "multi_precision fp32 master weights are not ported yet "
                "(ROADMAP Queue A item 4)")
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
        {slot: tensor}}}``; the step count lives on the host."""
        return {"step": 0,
                "slots": {n: self._create_slots(p) for n, p in params.items()}}

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
            self._update(p, g, state["slots"][name], lr, step, decay_on)
        return params, state

    def _update(self, p, g, slots, lr, step, decay_on):
        raise NotImplementedError
