"""The port's fused LM head + cross-entropy (paddle_tpu_torch/ops/
fused_ce.py) against the reference's ``fused_lm_loss`` /
``fused_linear_cross_entropy`` and ``jax.grad`` of them.

fp32 inputs from numpy with a seed; V=512 (chunks of 128 that tile V
exactly) and V=515 (chunks of 128 over 5 chunks, the last one ragged: the
reference pads and masks, the port narrows the last chunk). The two sides
differ in summation order only: tolerance 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt_hybrid import _lm_loss as jax_lm_loss
from paddle_tpu.ops.fused_ce import _chunking as jax_chunking
from paddle_tpu.ops.fused_ce import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from paddle_tpu_torch.models.gpt_hybrid import _lm_loss
from paddle_tpu_torch.ops.fused_ce import (_chunking,
                                           fused_linear_cross_entropy,
                                           fused_lm_loss)

TOL = 1e-5
B, S, H = 2, 17, 32


def _case(V, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, H)).astype(np.float32)
    head_w = (rng.standard_normal((H, V)) * 0.2).astype(np.float32)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    ids[0, -1] = V - 1                      # a label in the ragged chunk
    return hidden, head_w, ids


@pytest.mark.parametrize("V", [512, 515, 1000])
def test_chunking_is_the_reference(V):
    assert _chunking(V, 8) == jax_chunking(V, 8)


@pytest.mark.parametrize("V", [512, 515])
def test_fused_lm_loss_and_grads_match(V):
    hidden, head_w, ids = _case(V)
    jl, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jax_fused_lm_loss(h, w, jnp.asarray(ids)),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head_w))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(head_w).requires_grad_(True)
    loss = fused_lm_loss(th, tw, torch.from_numpy(ids))
    dh, dw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("V", [512, 515])
def test_per_token_losses_and_vjp_match(V):
    """The per-token losses and their pullback of a random cotangent,
    against the reference's ``fused_linear_cross_entropy``."""
    hidden, head_w, ids = _case(V, seed=1)
    h2 = hidden.reshape(-1, H)
    lab = ids.reshape(-1)
    g = np.random.default_rng(3).standard_normal(h2.shape[0]).astype(
        np.float32)
    want, pullback = jax.vjp(
        lambda h, w: jax_fused_ce(h, w, jnp.asarray(lab)),
        jnp.asarray(h2), jnp.asarray(head_w))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h2, head_w)]
    got = fused_linear_cross_entropy(leaves[0], leaves[1],
                                     torch.from_numpy(lab))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for t, w in zip(grads, pullback(jnp.asarray(g))):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_fused_loss_equals_the_plain_logits_loss():
    """The fused loss is the shifted CE of the full logits (the reference's
    ``_lm_loss``, ported beside it)."""
    hidden, head_w, ids = _case(515, seed=4)
    logits = torch.from_numpy(hidden) @ torch.from_numpy(head_w)
    plain = _lm_loss(logits, torch.from_numpy(ids))
    jplain = jax_lm_loss(jnp.asarray(hidden) @ jnp.asarray(head_w),
                         jnp.asarray(ids))
    np.testing.assert_allclose(float(plain), float(jplain), rtol=TOL)
    fused = fused_lm_loss(torch.from_numpy(hidden), torch.from_numpy(head_w),
                          torch.from_numpy(ids))
    np.testing.assert_allclose(float(fused), float(plain), rtol=TOL)


def test_bf16_operands_give_fp32_logits():
    """bf16 hidden and head: the chunk logits are fp32 products of the bf16
    values (the reference's preferred_element_type=f32), so the loss agrees
    with the reference's bf16 loss to fp32 summation order."""
    hidden, head_w, ids = _case(512, seed=5)
    jl = jax_fused_lm_loss(jnp.asarray(hidden, jnp.bfloat16),
                           jnp.asarray(head_w, jnp.bfloat16),
                           jnp.asarray(ids))
    loss = fused_lm_loss(torch.from_numpy(hidden).bfloat16(),
                         torch.from_numpy(head_w).bfloat16(),
                         torch.from_numpy(ids))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
