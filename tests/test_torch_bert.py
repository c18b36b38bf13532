"""The port's BERT pretraining (paddle_tpu_torch/models/bert.py: the
transformer encoder, SDPA through the flash path, the MLM head fused into
the cross-entropy with its bias, AdamW with global-norm clip, ``amp.
decorate`` O2 masters and ``jit.TrainStep``) against the reference's, on
the reference's weights handed over as numpy arrays.

A 2-layer, width-128 BERT (2 heads of 64, FFN 256, vocab 512), dropout 0
(the two frameworks' dropout masks come from different generators), a
batch of 4 x 64 with the last 8-40 tokens of each row padded, 15 % MLM
targets and NSP labels. On the CPU the port's attention runs the flash
kernels' plain versions, the reference's its composed path.

Tolerances: fp32 differs in summation order only: 1e-5 relative on the
forward's outputs and the losses, 1e-4 relative per step on the 3-step
loss trajectory, 1e-3 relative L2 on the worst parameter leaf after it.
O2 bf16: 2e-2 relative on the losses and 1e-2 on the worst matrix (bf16
keeps 8 bits; the frameworks round at other places). Under O2 the 1-D
leaves (biases, LayerNorms) are held through the optimizers' fp32
``"master"`` slots: each master's move from the shared start within
``MASTER_MOVE_TOL`` relative L2 of the reference's master's move, and
each bf16 param its master rounded. Adam moves an element by about lr a
step whatever its gradient's size, so the elements whose bf16 gradient
is near zero may step the other way in the two frameworks (the worst
vector reads 0.15); a master that does not move, or moves the wrong way,
reads 1 or more, and a LayerNorm gain updated in bf16 (an lr step is
under half its ulp at 1.0) does not move. The key biases, whose
gradient is zero in exact arithmetic (a bias adds one constant to every
score of a row), are held to how far two Adam trajectories can part,
``ADAM_APART`` absolute.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     layer_params_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

CFG_KW = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 4, 64
TOL = 1e-5
TRAJ_TOL = 1e-4
LEAF_TOL = 1e-3
BF16_TOL = 2e-2
BF16_LEAF_TOL = 1e-2
LR = 1e-3
STEPS = 3
# two Adam trajectories of STEPS steps apart: lr a step each way, times
# 1.004, the most |mhat| / sqrt(vhat) reaches in three steps at beta1
# 0.9, beta2 0.999 (Cauchy-Schwarz), and a little for the bf16 rounding
ADAM_APART = 2 * 1.01 * LR * STEPS
MASTER_MOVE_TOL = 0.25


def _batch(seed=0):
    """ids, mlm labels (-100 off target), token types, padding mask, nsp
    labels, as numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG_KW["vocab_size"], (B, S)).astype(np.int64)
    lengths = rng.integers(S - 40, S - 8, B)
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int64)
    ids = np.where(mask == 1, ids, 0)
    target = (rng.random((B, S)) < 0.15) & (mask == 1)
    labels = np.where(target, ids, -100).astype(np.int64)
    types = (np.arange(S)[None, :] >= lengths[:, None] // 2).astype(np.int64)
    nsp = rng.integers(0, 2, B).astype(np.int64)
    return ids, labels, types, mask, nsp


@pytest.fixture(scope="module")
def models():
    """The reference BERT (seeded init) and its weights as numpy."""
    paddle.seed(0)
    ref = JaxBert(JaxBertConfig(**CFG_KW))
    weights = {n: np.array(p._data) for n, p in ref.named_parameters()}
    return ref, weights


def _port(weights):
    model = BertForPretraining(BertConfig(**CFG_KW))
    return layer_params_from_numpy(model, weights)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jt(a):
    return paddle.to_tensor(a)


def test_forward_and_losses_match(models):
    ref, weights = models
    port = _port(weights)
    ids, labels, types, mask, nsp = _batch()
    want_mlm, want_nsp = ref(_jt(ids), _jt(types), _jt(mask))
    want_seq, want_pooled = ref.bert(_jt(ids), _jt(types), _jt(mask))
    t = [torch.from_numpy(a) for a in (ids, labels, types, mask, nsp)]
    with torch.no_grad():
        seq, pooled = port.bert(t[0], t[2], t[3])
        mlm, nsp_logits = port(t[0], t[2], t[3])
        loss = port.loss((mlm, nsp_logits), t[1], t[4])
        fused = port.pretraining_loss(t[0], t[1], t[2], t[3], t[4])
    for got, want in ((seq, want_seq), (pooled, want_pooled),
                      (mlm, want_mlm), (nsp_logits, want_nsp)):
        assert _rel(got.numpy(), want.numpy()) < TOL
    want_loss = ref.loss((want_mlm, want_nsp), _jt(labels), _jt(nsp))
    want_fused = ref.pretraining_loss(_jt(ids), _jt(labels), _jt(types),
                                      _jt(mask), _jt(nsp))
    assert _rel(float(loss), float(want_loss.numpy())) < TOL
    assert _rel(float(fused), float(want_fused.numpy())) < TOL
    assert _rel(float(fused), float(loss)) < TOL


class _Fused(torch.nn.Module):
    """The pretraining-loss adapter of tools_mfu_sweep.py's BERT case."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids, labels, types, mask, nsp):
        return self.inner.pretraining_loss(ids, labels, types, mask, nsp)


class _JaxFused(paddle.nn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids, labels, types, mask, nsp):
        return self.inner.pretraining_loss(ids, labels, types, mask, nsp)


def _trajectories(weights, o2):
    """STEPS jit.TrainStep steps of both frameworks from the same weights:
    (reference losses, port losses, {name: (reference, port) param},
    {name: (reference, port) fp32 master} of the leaves that have one)."""
    batch = _batch(seed=1)
    paddle.seed(0)
    jmodel = JaxBert(JaxBertConfig(**CFG_KW))
    named = dict(jmodel.named_parameters())
    for n, w in weights.items():
        named[n]._data = jax.numpy.asarray(w)
    jopt = paddle.optimizer.AdamW(LR, grad_clip=paddle.nn.ClipGradByGlobalNorm(
        1.0))
    port = _port(weights)
    topt = AdamW(LR, grad_clip=ClipGradByGlobalNorm(1.0))
    if o2:
        jmodel, jopt = paddle.amp.decorate(jmodel, jopt, level="O2",
                                           dtype="bfloat16")
        port, topt = amp.decorate(port, topt, level="O2", dtype="bfloat16")
    jstep = paddle.jit.TrainStep(_JaxFused(jmodel), lambda out: out, jopt)
    tstep = TrainStep(_Fused(port), lambda out: out, topt, device="cpu")
    jl = [float(jstep(tuple(_jt(a) for a in batch), ()).numpy())
          for _ in range(STEPS)]
    tl = [float(tstep(tuple(torch.from_numpy(a) for a in batch), ()))
          for _ in range(STEPS)]
    jp = {n.removeprefix("inner."): np.asarray(a.astype(np.float32))
          for n, a in jstep.params.items()}
    tp = {n.removeprefix("inner."): p.detach().float().numpy()
          for n, p in tstep.params.items()}
    assert set(jp) == set(tp) == set(weights)
    # each bf16 param is its fp32 master rounded
    for n, p in tstep.params.items():
        master = tstep.opt_state["slots"][n].get("master")
        assert (master is not None) == o2, n
        if o2:
            assert torch.equal(p, master.to(p.dtype)), n
    jslots = jstep.state_for_checkpoint()["opt_state"]["slots"]
    masters = {n.removeprefix("inner."): (
        np.asarray(jslots[n]["master"], np.float64),
        tstep.opt_state["slots"][n]["master"].double().numpy())
        for n in tstep.params if o2}
    return jl, tl, {n: (jp[n], tp[n]) for n in jp}, masters


def _worst_leaf(leaves, skip_vectors):
    """The worst relative L2 difference of a leaf, after holding the key
    biases to ADAM_APART absolute and leaving out, with ``skip_vectors``
    (O2), the 1-D leaves that ``_worst_master_move`` holds."""
    worst = (0.0, None)
    for n, (j, t) in leaves.items():
        if n.endswith("k_proj.bias"):
            assert np.abs(t - j).max() <= ADAM_APART, n
            continue
        if skip_vectors and j.ndim == 1:
            continue
        rel = float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30))
        worst = max(worst, (rel, n))
    return worst


def _worst_master_move(masters, weights):
    """The worst relative L2 difference of the 1-D leaves' fp32 masters'
    moves from the shared start, the key biases left to ``_worst_leaf``."""
    worst = (0.0, None)
    for n, (j, t) in masters.items():
        if j.ndim != 1 or n.endswith("k_proj.bias"):
            continue
        start = weights[n].astype(np.float64)
        rel = float(np.linalg.norm(t - j) /
                    max(np.linalg.norm(j - start), 1e-30))
        worst = max(worst, (rel, n))
    return worst


def test_three_train_steps_match_the_reference(models):
    _, weights = models
    jl, tl, leaves, _ = _trajectories(weights, o2=False)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    worst = _worst_leaf(leaves, skip_vectors=False)
    assert worst[0] < LEAF_TOL, worst


def test_three_o2_bf16_steps_match_the_reference(models):
    """amp.decorate O2: bf16 params, fp32 masters in both optimizers."""
    _, weights = models
    jl, tl, leaves, masters = _trajectories(weights, o2=True)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=BF16_TOL)
    worst = _worst_leaf(leaves, skip_vectors=True)
    assert worst[0] < BF16_LEAF_TOL, worst
    moved = _worst_master_move(masters, weights)
    assert moved[1] is not None and moved[0] < MASTER_MOVE_TOL, moved


def test_attention_dropout_runs_through_the_flash_path(models):
    """With the config's dropout the loss moves and is reproducible from
    framework.random's seed; no call falls back to the composed path."""
    from paddle_tpu_torch.framework import random
    from paddle_tpu_torch.nn import functional as F
    _, weights = models
    cfg = dataclasses.replace(BertConfig(**CFG_KW), hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    port = layer_params_from_numpy(BertForPretraining(cfg), weights)
    t = [torch.from_numpy(a) for a in _batch()]
    before = F.scaled_dot_product_attention.fallbacks
    losses = []
    for seed in (5, 5, 6):
        random.seed(seed)
        with torch.no_grad():
            losses.append(float(port.pretraining_loss(*t[:2], *t[2:])))
    assert losses[0] == losses[1] != losses[2]
    port.eval()
    with torch.no_grad():
        off = float(port.pretraining_loss(*t[:2], *t[2:]))
    assert off != losses[0]
    assert F.scaled_dot_product_attention.fallbacks == before
