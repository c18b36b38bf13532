"""Eager layers (counterpart of ``paddle_tpu/nn/layer/common.py``,
``norm.py``, ``activation.py``, ``container.py`` and ``loss.py``): the
part that ``jit.TrainStep`` and the eager GPT use, as ``torch.nn.Module``s
with the reference's parameter names, shapes ([in, out] for a linear
weight) and cast order.

Initial values come from torch's generator with the reference's recipes
(Xavier-uniform linear weights and zero biases, Xavier-normal embeddings,
ones / zeros LayerNorms); the tests hand the reference's values over as
numpy arrays (``models.params.layer_params_from_numpy``).
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

# torch's container and activation are the reference's (names "0", "1",
# ..., no parameters of their own)
Sequential = nn.Sequential
ReLU = nn.ReLU


def layer_named_parameters(module, prefix=""):
    """(name, parameter) in the reference Layer's order: breadth first
    over the sublayers (``Layer.named_sublayers``), each layer's own
    parameters in registration order, every parameter once. torch's own
    ``named_parameters`` goes depth first; the order decides the packing
    of ``distributed.grad_comm.BucketPlan``."""
    seen = set()
    queue = [(prefix, module)]
    while queue:
        name, layer = queue.pop(0)
        for pname, p in layer._parameters.items():
            if p is None or id(p) in seen:
                continue
            seen.add(id(p))
            yield (f"{name}.{pname}" if name else pname), p
        for sub_name, sub in layer._modules.items():
            if sub is not None:
                queue.append((f"{name}.{sub_name}" if name else sub_name,
                              sub))


class Linear(nn.Module):
    """``x @ weight + bias`` with weight [in_features, out_features];
    ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, bias_attr=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        nn.init.xavier_uniform_(self.weight)
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis of width ``normalized_shape``."""

    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))
        self.epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class Embedding(nn.Module):
    """Rows of weight [num_embeddings, embedding_dim] at integer ids."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings,
                                               embedding_dim))
        nn.init.xavier_normal_(self.weight)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Identity at ``p=0``; a positive rate in training raises: dropout
    with its Philox masks is ROADMAP Queue B 4 / Queue A item 14."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if self.p and self.training:
            raise NotImplementedError(
                "Dropout(p > 0) in training is not ported yet (ROADMAP "
                "Queue B 4, Queue A item 14); use p=0")
        return x


class MSELoss(nn.Module):
    def forward(self, input, label):
        return F.mse_loss(input, label)
