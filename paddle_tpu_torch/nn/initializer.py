"""Parameter initializers and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/initializer.py`` and ``layer_base.py:ParamAttr``): the
recipes the eager layers use, filling a tensor in place from the seeded
generator of ``framework.random`` for the tensor's device (the
reference's initializers draw from its seeded global key). The values
differ from the reference's for the same seed (another generator); the
tests hand the reference's values over instead.
"""
from __future__ import annotations

import math

import torch

from ..framework import random


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *k]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    @torch.no_grad()
    def __call__(self, tensor):
        """Fill ``tensor`` in place; returns it."""
        self._fill(tensor, random.generator(tensor.device))
        return tensor

    def _fill(self, tensor, gen):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def _fill(self, tensor, gen):
        tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = float(mean), float(std)

    def _fill(self, tensor, gen):
        tensor.normal_(self.mean, self.std, generator=gen)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, gen):
        fi, fo = _fans(tuple(tensor.shape))
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi) +
                                           (self.fan_out or fo)))
        tensor.normal_(0.0, std, generator=gen)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fill(self, tensor, gen):
        fi, fo = _fans(tuple(tensor.shape))
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi) +
                                             (self.fan_out or fo)))
        tensor.uniform_(-limit, limit, generator=gen)


class ParamAttr:
    """A parameter's initializer and whether it trains (reference
    python/paddle/fluid/param_attr.py). Per-parameter learning rates and
    regularizers are not ported and raise."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        if learning_rate != 1.0 or regularizer is not None or not need_clip:
            raise NotImplementedError(
                "ParamAttr's learning_rate, regularizer and need_clip are "
                "not ported (ROADMAP Queue A item 14)")
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(attr):
        """None, a ParamAttr, an Initializer, a name or False (no
        parameter) as a ParamAttr, or False."""
        if attr is None:
            return ParamAttr()
        if attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"unsupported param attr {attr!r}")


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None):
    """A float32 parameter of ``shape`` made as the reference's
    ``Layer.create_parameter`` makes it: the attr's initializer, else
    ``default_initializer``, else zeros for a bias and Xavier-uniform for
    a weight; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer or (
        Constant(0.0) if is_bias else XavierUniform())
    p = torch.nn.Parameter(init(torch.empty(tuple(shape))),
                           requires_grad=attr.trainable)
    return p
