"""The port's flash attention with an additive bias and dropout
(paddle_tpu_torch/ops/flash_attention.py, ops/philox.py) against the
reference.

On CPU tensors the wrappers run the kernels' plain versions. This file
holds them, in fp32, to the reference's Pallas kernels run in interpret
mode with a bias (``_pallas_forward(..., interpret=True, bias=...)`` and
``flash_attention_backward(..., interpret=True, bias=...)``, blocks of
128): O, LSE, dQ, dK and dV, bias broadcast as (B, H), (B, 1) and (1, 1),
causal and not, and a row masked whole by a bool mask (O = 0, LSE =
+1e30). Tolerances: the reference's own bias test's 3e-5 on O and LSE
(tests/test_flash_features.py), 2e-4 on gradients (tests/test_flash_bwd.py):
the two sides differ in summation order only.

The reference's in-kernel dropout uses the TPU's generator, which
interpret mode does not emulate; the port's keep mask is Philox4x32-10,
held here to a pure-Python integer Philox (and Random123's known
answers), its keep rate to binomial bounds, and the plain path's
gradients with dropout to a dense fp64 computation on the same mask
(tolerance 1e-4: fp32 against fp64 sums of 256 terms).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _mask_to_bias
from paddle_tpu.ops.pallas_kernels.flash_attention import _pallas_forward
from paddle_tpu.ops.pallas_kernels.flash_attention_bwd import \
    flash_attention_backward as jax_flash_backward
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import philox

B, S, H = 2, 256, 2
FWD_TOL = 3e-5
GRAD_TOL = 2e-4
DENSE_TOL = 1e-4
MASK32 = 0xFFFFFFFF


def _inputs(D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _bias(shape, seed, dead_row=None):
    """An fp32 bias (shape + (S, S)); with ``dead_row``, the bias of a
    bool mask that keeps every key of every row but that one."""
    if dead_row is not None:
        keep = np.ones(shape + (S, S), bool)
        keep[..., dead_row, :] = False
        return np.array(_mask_to_bias(jnp.asarray(keep)))
    return np.random.default_rng(seed).standard_normal(
        shape + (S, S)).astype(np.float32)


def _reference(q, k, v, g, bias, causal):
    """The reference's interpret-mode kernels: (O, LSE [B*H, S], dQ, dK,
    dV), gradients for cotangent g."""
    D = q.shape[-1]
    out, (qb, kb, vb, ob, lse, scale) = _pallas_forward(
        *(jnp.asarray(a) for a in (q, k, v)), causal, block_q=128,
        block_k=128, with_residuals=True, interpret=True,
        bias=jnp.asarray(bias))
    Dp = qb.shape[-1]                       # the reference pads D to 128
    gb = jnp.pad(jnp.asarray(g), ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
    gb = gb.transpose(0, 2, 1, 3).reshape(B * H, S, Dp)
    grads = jax_flash_backward(qb, kb, vb, ob, lse, gb, scale, causal,
                               block_q=128, block_k=128, interpret=True,
                               bias=jnp.asarray(bias), num_heads=H)

    def bshd(x):
        x = np.asarray(x).reshape(B, H, S, Dp).transpose(0, 2, 1, 3)
        return x[..., :D]

    return (np.asarray(out), np.asarray(lse), *(bshd(x) for x in grads))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bias_shape", [(2, 2), (2, 1), (1, 1)])
def test_bias_matches_the_interpret_kernels(bias_shape, causal, D):
    q, k, v, g = _inputs(D, seed=D + causal)
    bias = _bias(bias_shape, seed=7)
    o_w, lse_w, dq_w, dk_w, dv_w = _reference(q, k, v, g, bias, causal)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = fa.flash_forward(*(t.detach() for t in leaves), causal,
                              bias=torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), o_w, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_w, rtol=FWD_TOL,
                               atol=FWD_TOL)
    out = fa.flash_attention_bshd(*leaves, causal=causal,
                                  bias=torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for t, w in zip(got, (dq_w, dk_w, dv_w)):
        np.testing.assert_allclose(t.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_a_fully_masked_bool_row_follows_the_kernel(causal):
    """A bool mask that masks row 37 whole becomes -1e30 over the row: O
    is 0 and the LSE +1e30 there, as in the reference's kernel, and the
    row adds nothing to dK and dV."""
    q, k, v, g = _inputs(64, seed=11)
    bias = _bias((1, 1), seed=0, dead_row=37)
    o_w, lse_w, dq_w, dk_w, dv_w = _reference(q, k, v, g, bias, causal)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = fa.flash_forward(*(t.detach() for t in leaves), causal,
                              bias=torch.from_numpy(bias))
    assert np.all(o.numpy()[:, 37] == 0) and np.all(o_w[:, 37] == 0)
    assert np.all(lse.numpy().reshape(B, H, S)[:, :, 37] == fa.MASKED_LSE)
    np.testing.assert_allclose(o.numpy(), o_w, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_w, rtol=FWD_TOL,
                               atol=FWD_TOL)
    out = fa.flash_attention_bshd(*leaves, causal=causal,
                                  bias=torch.from_numpy(bias))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert np.all(got[0].numpy()[:, 37] == 0)
    for t, w in zip(got, (dq_w, dk_w, dv_w)):
        np.testing.assert_allclose(t.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_a_bf16_bias_and_a_key_padding_bias_broadcast():
    """A [B, 1, 1, S] key-padding bias (BERT's) gives what the same bias
    materialised as [B, 1, S, S] gives; a bf16 bias what its fp32 copy
    gives."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, seed=3))
    pad = torch.zeros(B, 1, 1, S)
    pad[0, ..., 200:] = -1e4
    pad[1, ..., 100:] = -1e4
    want = fa.flash_forward(q, k, v, False, bias=pad.expand(B, 1, S, S))
    for bias in (pad, pad.to(torch.bfloat16)):
        got = fa.flash_forward(q, k, v, False, bias=bias)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ Philox
def _philox_py(c, key):
    """Philox4x32-10 in Python integers (Random123's reference
    algorithm)."""
    k0, k1 = key & MASK32, key >> 32
    x = list(c)
    for r in range(10):
        if r:
            k0 = (k0 + philox.PHILOX_W0) & MASK32
            k1 = (k1 + philox.PHILOX_W1) & MASK32
        p0, p1 = philox.PHILOX_M0 * x[0], philox.PHILOX_M1 * x[2]
        x = [(p1 >> 32) ^ x[1] ^ k0, p1 & MASK32,
             (p0 >> 32) ^ x[3] ^ k1, p0 & MASK32]
    return x


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK32,) * 4, 2 ** 64 - 1,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     0x299f31d0a4093822, (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_gives_random123s_known_answers(ctr, key, want):
    assert tuple(_philox_py(ctr, key)) == want
    got = philox.philox4x32(*(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(w) for w in got) == want


def test_plain_philox_equals_the_integer_philox():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, (4, 500), dtype=np.int64)
    key = int(rng.integers(0, 2 ** 63))
    got = philox.philox4x32(*(torch.from_numpy(c) for c in ctr), key)
    for n in range(ctr.shape[1]):
        assert [int(w[n]) for w in got] == _philox_py(
            [int(c[n]) for c in ctr], key)


def test_keep_mask_is_the_integer_philox_of_each_element():
    """keep(b, h, i, j) = word 2 (i & 1) + (j & 1) of Philox((j >> 1,
    i >> 1, b H + h, 0)) >= floor(p 2^32), for odd lengths too."""
    Bm, Hm, Sq, Sk, p, key = 2, 3, 7, 9, 0.3, 0x0123456789ABCDEF
    mask = philox.keep_mask(Bm, Hm, Sq, Sk, p, key)
    thr = philox.threshold(p)
    for b in range(Bm):
        for h in range(Hm):
            for i in range(Sq):
                for j in range(Sk):
                    w = _philox_py((j >> 1, i >> 1, b * Hm + h, 0), key)
                    want = w[2 * (i & 1) + (j & 1)] >= thr
                    assert bool(mask[b, h, i, j]) == want


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_is_within_binomial_bounds(p):
    """Over 2 x 12 x 128 x 128 draws the kept share is 1 - p within six
    standard deviations, and two keys give other masks."""
    mask = philox.keep_mask(2, 12, 128, 128, p, 1234)
    n = mask.numel()
    sd = (p * (1 - p) / n) ** 0.5
    assert abs(float(mask.float().mean()) - (1 - p)) < 6 * sd
    other = philox.keep_mask(2, 12, 128, 128, p, 1235)
    assert float((mask != other).float().mean()) > p * (1 - p)


def test_threshold_refuses_a_rate_of_one():
    assert philox.threshold(0.0) == 0
    assert philox.threshold(0.1) == int(0.1 * 2 ** 32)
    with pytest.raises(ValueError):
        philox.threshold(1.0)


# ------------------------------------------------------- dropout gradients
def _dense_f64(q, k, v, bias, keep, p, causal):
    """Dense fp64 attention with dropout on the same keep mask."""
    qh, kh, vh = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * q.shape[-1] ** -0.5 + bias.double()
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    probs = torch.softmax(s, -1)
    probs = torch.where(keep, probs / (1 - p), 0.0)
    return (probs @ vh).permute(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_dropout_gradients_match_a_dense_fp64_computation(causal):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(64, seed=21))
    bias = torch.from_numpy(_bias((2, 1), seed=4))
    p, key = 0.1, 987654321
    keep = philox.keep_mask(B, H, S, S, p, key)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_bshd(*leaves, causal=causal, bias=bias,
                                  dropout_p=p, dropout_seed=key)
    got = torch.autograd.grad(out, leaves, g)
    wleaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    want_out = _dense_f64(*wleaves, bias, keep, p, causal)
    want = torch.autograd.grad(want_out, wleaves, g.double())
    np.testing.assert_allclose(out.detach().numpy(),
                               want_out.detach().numpy(), rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=DENSE_TOL,
                                   atol=DENSE_TOL)


def test_dropout_draws_its_key_from_the_seeded_generator():
    """Without a seed, the key comes from framework.random: seeding again
    gives the same output, another seed another."""
    from paddle_tpu_torch.framework import random
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, seed=5))
    outs = []
    for s in (3, 3, 4):
        random.seed(s)
        outs.append(fa.flash_attention_bshd(q, k, v, causal=False,
                                            dropout_p=0.2))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


# -------------------------------------------------------------------- SDPA
def _mask(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "bool":          # [B, 1, S, S], no row masked whole
        keep = rng.random((B, 1, S, S)) < 0.7
        keep[..., 0] = True
        return keep
    if kind == "padding":       # BERT's additive [B, 1, 1, S]
        lengths = np.array([S, S // 2])
        keep = np.arange(S)[None, :] < lengths[:, None]
        return np.where(keep, 0.0, -1e4).astype(np.float32)[:, None, None]
    return None


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["bool", "padding", None])
def test_sdpa_matches_the_reference(kind, causal, flash):
    """The port's scaled_dot_product_attention (through the flash path,
    the kernels' plain versions on the CPU, or with
    FLAGS_use_flash_attention off the composed path) against the
    reference's (its composed path off-TPU), on rows that are not fully
    masked."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional import \
        scaled_dot_product_attention as jax_sdpa
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.nn import functional as F
    q, k, v, _ = _inputs(64, seed=31)
    mask = _mask(kind)
    want = jax_sdpa(*(paddle.to_tensor(a) for a in (q, k, v)),
                    attn_mask=None if mask is None else paddle.to_tensor(mask),
                    is_causal=causal, training=False)
    set_flags({"FLAGS_use_flash_attention": flash})
    try:
        got = F.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            attn_mask=None if mask is None else torch.from_numpy(mask),
            is_causal=causal, training=False)
    finally:
        set_flags({"FLAGS_use_flash_attention": True})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_sdpa_routes_both_ways_to_the_same_dropout_mask():
    """From the same generator state the flash path and the composed path
    drop the same (query, key) pairs: their outputs agree."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import random
    from paddle_tpu_torch.nn import functional as F
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, seed=41))
    mask = torch.from_numpy(_mask("padding"))
    outs = []
    for flash in (True, False):
        set_flags({"FLAGS_use_flash_attention": flash})
        random.seed(9)
        try:
            outs.append(F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=0.1, training=True))
        finally:
            set_flags({"FLAGS_use_flash_attention": True})
    torch.testing.assert_close(outs[0], outs[1], rtol=FWD_TOL, atol=FWD_TOL)
