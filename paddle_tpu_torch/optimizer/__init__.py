"""Adam and AdamW on the functional path (counterpart of
``paddle_tpu/optimizer/__init__.py``): ``init_state`` and an in-place
``apply_gradients`` over ``{name: tensor}`` dicts, as the training steps
use them. ``parameters=`` sits in the reference's argument position; the
steps name the params themselves (``jit.TrainStep`` by the model's
``named_parameters``).

``moment_dtype`` is the storage dtype of both moments; the update math is
fp32. ``"bfloat16"`` halves the optimizer state, as bench.py uses it for
models above 1B parameters.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _dtype(name):
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown moment_dtype {name!r}")
    return dtype


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False,
                 moment_dtype="float32"):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._moment_dtype = _dtype(moment_dtype)

    def _create_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=self._moment_dtype),
                "moment2": torch.zeros_like(p, dtype=self._moment_dtype)}

    def _moments(self, g, slots, step):
        """fp32 (m, v, mhat, vhat) of this step; the new moments are
        stored into the slots."""
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m = slots["moment1"].float().mul_(b1).add_(g32 * (1 - b1))
        v = slots["moment2"].float().mul_(b2).add_(g32.square().mul_(1 - b2))
        slots["moment1"].copy_(m)
        slots["moment2"].copy_(v)
        return m / (1 - b1 ** step), v / (1 - b2 ** step)

    def _update(self, p, g, slots, lr, step, decay_on):
        mhat, vhat = self._moments(g, slots, step)
        upd = lr * mhat / (vhat.sqrt_() + self._epsilon)
        p.copy_(p.float() - upd)


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * wd)`` before the Adam step,
    for params the decay mask admits: ``apply_decay_param_fun(name)``, or,
    when it is None, every param (the reference's rule; ``HybridTrainStep``
    passes its own mask)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False, moment_dtype="float32"):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision, moment_dtype)
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, slots, lr, step, decay_on):
        mhat, vhat = self._moments(g, slots, step)
        p32 = p.float()
        if decay_on and self._wd:
            p32 = p32 * (1 - lr * self._wd)
        upd = lr * mhat / (vhat.sqrt_() + self._epsilon)
        p.copy_(p32 - upd)

    def apply_gradients(self, params, grads, state, lr=None, wd_mask=None):
        if wd_mask is None and self._apply_decay_param_fun is not None:
            wd_mask = {n: bool(self._apply_decay_param_fun(n))
                       for n in params}
        return super().apply_gradients(params, grads, state, lr, wd_mask)


__all__ = ["Optimizer", "Adam", "AdamW"]
