"""The port's encoder-decoder Transformer (paddle_tpu_torch/nn/
transformer.py: MultiHeadAttention with kdim/vdim and its cache, the
encoder and decoder layers and stacks, ``Transformer``; models/
transformer.py: the shared embedding scaled by sqrt(d_model), sinusoidal
positions, the vocabulary projection fused into the cross-entropy)
against the reference's ``nn.Transformer`` with ``nn.Embedding`` and
``nn.Linear`` around it, on the reference's weights handed over by name
(``layer_params_from_numpy``).

A 2 + 2-layer, width-64 model (2 heads of 32, FFN 128, vocab 128),
dropout 0 (the two frameworks' dropout masks come from different
generators), a batch of 4 pairs: sources of 32 slots with 12-32 real
tokens, targets of 16 slots with 6-16, the source padding as an additive
[B, 1, 1, 32] bias of -1e9 in the encoder and the cross-attention, the
decoder's ``generate_square_subsequent_mask`` (-inf above the diagonal).
On the CPU the port's attention runs the flash kernels' plain versions
(cross-attention with 16 queries against 32 keys), the reference's its
composed path.

Tolerances, as tests/test_torch_bert.py states them: fp32 differs in
summation order only: 1e-5 relative on outputs and losses, 1e-4 relative
(max abs over the leaf's max abs) on every gradient leaf, 1e-4 relative
per step on the 3-step loss trajectory and 1e-3 relative L2 on the worst
parameter leaf after it. O2 bf16: 2e-2 relative on the losses and 1e-2
on the worst matrix; the 1-D leaves through the optimizers' fp32 masters
(``MASTER_MOVE_TOL``). The reference side's logits are fp32 products of
the projection's operands, as the port's fused cross-entropy forms them.
The key biases, whose gradient is zero in exact arithmetic, are held
absolutely: their gradients to ``ZERO_GRAD_ATOL``, their values after
Adam steps to ``ADAM_APART``.
"""
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (TransformerConfig,
                                     TransformerForTranslation,
                                     layer_params_from_numpy,
                                     translation_batch)
from paddle_tpu_torch.models.transformer import PAD_BIAS, position_encoding
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

CFG = TransformerConfig(vocab_size=128, d_model=64, nhead=2,
                        num_encoder_layers=2, num_decoder_layers=2,
                        dim_feedforward=128, dropout=0.0, max_length=64)
B, S_SRC, S_TGT = 4, 32, 16
LENGTHS = dict(src_lengths=(12, 32), tgt_lengths=(6, 16))
TOL = 1e-5
GRAD_TOL = 1e-4
ZERO_GRAD_ATOL = 1e-6
TRAJ_TOL = 1e-4
LEAF_TOL = 1e-3
BF16_TOL = 2e-2
BF16_LEAF_TOL = 1e-2
LR = 1e-3
STEPS = 3
ADAM_APART = 2 * 1.01 * LR * STEPS      # tests/test_torch_bert.py's
MASTER_MOVE_TOL = 0.25


class _JaxTranslation(paddle.nn.Layer):
    """The reference's layers under the port model's parameter names; the
    masks come in as inputs, made from the ids as the port makes them."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.word_embedding = paddle.nn.Embedding(cfg.vocab_size,
                                                  cfg.d_model)
        self.transformer = paddle.nn.Transformer(
            cfg.d_model, cfg.nhead, cfg.num_encoder_layers,
            cfg.num_decoder_layers, cfg.dim_feedforward, cfg.dropout)
        self.project = paddle.nn.Linear(cfg.d_model, cfg.vocab_size)
        self.pos = position_encoding(cfg.max_length, cfg.d_model)

    def embed(self, ids):
        x = self.word_embedding(ids) * math.sqrt(self.cfg.d_model)
        return x + paddle.to_tensor(self.pos[:ids.shape[1]]).astype(x.dtype)

    def forward(self, src, tgt, bias, causal, labels):
        h = self.transformer(self.embed(src), self.embed(tgt), bias, causal,
                             bias)
        # fp32 logits of the projection's operands in their own dtype, as
        # the port's fused cross-entropy takes them (under O2 the bf16
        # products are exact in fp32)
        logits = paddle.matmul(
            h.astype("float32"), self.project.weight.astype("float32")) + \
            self.project.bias.astype("float32")
        return paddle.nn.functional.cross_entropy(
            logits.reshape([-1, self.cfg.vocab_size]), labels.reshape([-1]),
            ignore_index=-100)


class _Loss(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, src, tgt, labels):
        return self.inner.loss(src, tgt, labels)


def _batch(seed=0):
    return translation_batch(CFG, B, S_SRC, S_TGT, seed, **LENGTHS)


def _jax_inputs(src, tgt, labels):
    bias = np.where(src == CFG.pad_id, PAD_BIAS, 0.0).astype(
        np.float32)[:, None, None, :]
    causal = paddle.nn.Transformer.generate_square_subsequent_mask(S_TGT)
    return (paddle.to_tensor(src), paddle.to_tensor(tgt),
            paddle.to_tensor(bias), causal, paddle.to_tensor(labels))


@pytest.fixture(scope="module")
def weights():
    """The reference model's seeded weights as numpy, by name."""
    paddle.seed(0)
    ref = _JaxTranslation(CFG)
    return {n: np.array(p._data) for n, p in ref.named_parameters()}


def _jax_model(weights):
    paddle.seed(0)
    model = _JaxTranslation(CFG)
    named = dict(model.named_parameters())
    for n, w in weights.items():
        named[n]._data = jax.numpy.asarray(w)
    return model


def _port(weights):
    return layer_params_from_numpy(TransformerForTranslation(CFG), weights)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_the_reference_names_load_and_the_mask_matches(weights):
    port = _port(weights)
    assert set(dict(port.named_parameters())) == set(weights)
    want = np.asarray(
        paddle.nn.Transformer.generate_square_subsequent_mask(7)._data)
    got = tnn.Transformer.generate_square_subsequent_mask(7).numpy()
    assert np.array_equal(got, want)


def test_loss_and_every_gradient_match_in_fp32(weights):
    """The fp32 loss and the gradient of every leaf at dropout 0."""
    batch = _batch()
    ref = _jax_model(weights)
    want = ref(*_jax_inputs(*batch))
    want.backward()
    want_g = {n: np.asarray(p.grad._data)
              for n, p in ref.named_parameters()}
    port = _port(weights)
    loss = port.loss(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert _rel(float(loss.detach()), float(want.numpy())) < TOL
    with torch.no_grad():
        logits = port(*(torch.from_numpy(a) for a in batch[:2]))
        want_logits = ref.project(ref.transformer(
            ref.embed(paddle.to_tensor(batch[0])),
            ref.embed(paddle.to_tensor(batch[1])),
            *_jax_inputs(*batch)[2:4], _jax_inputs(*batch)[2]))
    assert _rel(logits.numpy(), want_logits.numpy()) < TOL
    for n, p in port.named_parameters():
        g, w = p.grad.numpy(), want_g[n]
        if n.endswith("k_proj.bias"):
            assert np.abs(g - w).max() <= ZERO_GRAD_ATOL, n
        else:
            assert _rel(g, w) < GRAD_TOL, (n, _rel(g, w))


def _trajectories(weights, o2):
    """STEPS jit.TrainStep steps of both frameworks from the same weights
    (AdamW, global-norm clip 1.0): (reference losses, port losses,
    {name: (reference, port) param}, {name: (reference, port) fp32
    master} of the leaves that have one)."""
    batch = _batch(seed=1)
    jmodel = _jax_model(weights)
    jopt = paddle.optimizer.AdamW(LR, grad_clip=paddle.nn.ClipGradByGlobalNorm(
        1.0))
    port = _port(weights)
    topt = AdamW(LR, grad_clip=ClipGradByGlobalNorm(1.0))
    if o2:
        jmodel, jopt = paddle.amp.decorate(jmodel, jopt, level="O2",
                                           dtype="bfloat16")
        port, topt = amp.decorate(port, topt, level="O2", dtype="bfloat16")
    jstep = paddle.jit.TrainStep(jmodel, lambda out: out, jopt)
    tstep = TrainStep(_Loss(port), lambda out: out, topt, device="cpu")
    jl = [float(jstep(_jax_inputs(*batch), ()).numpy())
          for _ in range(STEPS)]
    tl = [float(tstep(tuple(torch.from_numpy(a) for a in batch), ()))
          for _ in range(STEPS)]
    jp = {n: np.asarray(a.astype(np.float32))
          for n, a in jstep.params.items()}
    tp = {n.removeprefix("inner."): p.detach().float().numpy()
          for n, p in tstep.params.items()}
    assert set(jp) == set(tp) == set(weights)
    masters = {}
    if o2:
        jslots = jstep.state_for_checkpoint()["opt_state"]["slots"]
        for n, p in tstep.params.items():
            master = tstep.opt_state["slots"][n]["master"]
            assert torch.equal(p, master.to(p.dtype)), n
            name = n.removeprefix("inner.")
            masters[name] = (np.asarray(jslots[name]["master"], np.float64),
                             master.double().numpy())
    return jl, tl, {n: (jp[n], tp[n]) for n in jp}, masters


def _worst_leaf(leaves, skip_vectors):
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


def test_three_train_steps_match_the_reference(weights):
    jl, tl, leaves, _ = _trajectories(weights, o2=False)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    worst = _worst_leaf(leaves, skip_vectors=False)
    assert worst[0] < LEAF_TOL, worst


def test_three_o2_bf16_steps_match_the_reference(weights):
    """amp.decorate O2: bf16 params, fp32 masters in both optimizers; the
    1-D leaves held through their masters' moves from the shared start."""
    jl, tl, leaves, masters = _trajectories(weights, o2=True)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=BF16_TOL)
    worst = _worst_leaf(leaves, skip_vectors=True)
    assert worst[0] < BF16_LEAF_TOL, worst
    moved = (0.0, None)
    for n, (j, t) in masters.items():
        if j.ndim != 1 or n.endswith("k_proj.bias"):
            continue
        start = weights[n].astype(np.float64)
        moved = max(moved, (float(np.linalg.norm(t - j) / max(
            np.linalg.norm(j - start), 1e-30)), n))
    assert moved[1] is not None and moved[0] < MASTER_MOVE_TOL, moved


# ----------------------------------------------------- the layers' forms
def _carry(ref_layer, port_layer):
    layer_params_from_numpy(port_layer, {
        n: np.array(p._data) for n, p in ref_layer.named_parameters()})
    return port_layer


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("form", ["pre-ln", "kdim-vdim", "mask-3d",
                                  "incremental-cache", "encoder-cache"])
def test_layer_forms_match_the_reference(form):
    """The forms the translation model does not use: pre-LN stacks with
    their final norm, MultiHeadAttention with kdim / vdim keys and a 3-D
    mask, the decoder's incremental cache (gen_cache, one target token a
    step against the memory) and the encoder's."""
    rng = np.random.default_rng(5)
    paddle.seed(3)
    d, nh, ff = 32, 2, 64
    x, mem = _arr(rng, 2, 6, d), _arr(rng, 2, 10, d)
    jt, tt = paddle.to_tensor, torch.from_numpy
    if form == "pre-ln":
        ref = paddle.nn.Transformer(d, nh, 2, 2, ff, 0.0,
                                    normalize_before=True)
        port = _carry(ref, tnn.Transformer(d, nh, 2, 2, ff, 0.0,
                                           normalize_before=True))
        mask = np.triu(np.full((6, 6), -np.inf, np.float32), 1)
        want = ref(jt(mem), jt(x), None, jt(mask), None)
        got = port(tt(mem), tt(x), None, tt(mask), None)
        pairs = [(got, want)]
    elif form in ("kdim-vdim", "mask-3d"):
        kw = dict(kdim=24, vdim=40) if form == "kdim-vdim" else {}
        ref = paddle.nn.MultiHeadAttention(d, nh, **kw)
        port = _carry(ref, tnn.MultiHeadAttention(d, nh, **kw))
        k = _arr(rng, 2, 10, kw.get("kdim", d))
        v = _arr(rng, 2, 10, kw.get("vdim", d))
        mask = np.where(rng.random((2, 6, 10)) < 0.8, 0.0, -1e9).astype(
            np.float32)
        mask[..., 0] = 0.0
        m = mask if form == "mask-3d" else None
        want = ref(jt(x), jt(k), jt(v), None if m is None else jt(m))
        got = port(tt(x), tt(k), tt(v), None if m is None else tt(m))
        pairs = [(got, want)]
    elif form == "incremental-cache":
        ref = paddle.nn.TransformerDecoder(
            paddle.nn.TransformerDecoderLayer(d, nh, ff, 0.0), 2)
        port = _carry(ref, tnn.TransformerDecoder(
            tnn.TransformerDecoderLayer(d, nh, ff, 0.0), 2))
        jc, tc = ref.gen_cache(jt(mem)), port.gen_cache(tt(mem))
        pairs = []
        for step in range(3):                # one token a step
            xs = x[:, step:step + 1]
            want, jc = ref(jt(xs), jt(mem), None, None, jc)
            got, tc = port(tt(xs), tt(mem), None, None, tc)
            pairs.append((got, want))
        assert tc[0][0][0].shape == (2, 3, nh, d // nh)
    else:
        ref = paddle.nn.TransformerEncoder(
            paddle.nn.TransformerEncoderLayer(d, nh, ff, 0.0), 2)
        port = _carry(ref, tnn.TransformerEncoder(
            tnn.TransformerEncoderLayer(d, nh, ff, 0.0), 2))
        want, jc = ref(jt(x), None, ref.gen_cache(jt(x)))
        got, tc = port(tt(x), None, port.gen_cache(tt(x)))
        pairs = [(got, want), (tc[1][0], jc[1][0])]
    with torch.no_grad():
        for got, want in pairs:
            assert _rel(got.detach().numpy(), want.numpy()) < TOL


def test_attention_dropout_runs_through_the_flash_path(weights):
    """With dropout the loss is reproducible from framework.random's seed
    and moves with it; no attention call falls back to the composed
    path."""
    import dataclasses
    from paddle_tpu_torch.framework import random
    from paddle_tpu_torch.nn import functional as F
    cfg = dataclasses.replace(CFG, dropout=0.1)
    port = layer_params_from_numpy(TransformerForTranslation(cfg), weights)
    t = [torch.from_numpy(a) for a in _batch()]
    before = F.scaled_dot_product_attention.fallbacks
    losses = []
    for seed in (5, 5, 6):
        random.seed(seed)
        with torch.no_grad():
            losses.append(float(port.loss(*t)))
    assert losses[0] == losses[1] != losses[2]
    assert F.scaled_dot_product_attention.fallbacks == before
