"""The port's fused paged forward (paddle_tpu_torch/serving/
paged_attention.py) against the reference's ``paged_forward`` on the same
weights, pool and page table, at the two shapes the engine dispatches:
[B, 1] decode and [1, chunk] prefill. fp32; 1e-4 because the GEMMs sum
in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.paged_attention import paged_forward as jax_forward
from paddle_tpu_torch.models import cast_for_compute
from paddle_tpu_torch.serving.paged_attention import (paged_forward,
                                                      paged_kv_scatter)
from torch_parity import JCFG, TCFG, jax_params, torch_params

PS = 8
MP = TCFG.max_seq_len // PS


def _pools(rng, P):
    nh = TCFG.num_heads
    d = TCFG.hidden_size // nh
    shape = (TCFG.num_layers, P, PS, nh, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _table(rng, B, P):
    """Each slot owns distinct pages (a written page is never shared)."""
    pages = rng.permutation(np.arange(1, P))[:B * MP]
    return pages.reshape(B, MP).astype(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_paged_forward_matches_reference(shape, use_kernel):
    rng = np.random.default_rng(3)
    if shape == "decode":
        B, T = 3, 1
        start = np.array([5, 17, 30], np.int32)
        valid = np.array([1, 1, 0], np.int32)     # slot 2 rides along inert
    else:
        B, T = 1, 16
        start = np.array([8], np.int32)
        valid = np.array([13], np.int32)          # 3 padding lanes
    P = 1 + B * MP
    kc, vc = _pools(rng, P)
    table = _table(rng, B, P)
    ids = rng.integers(0, TCFG.vocab_size, (B, T)).astype(np.int32)

    want_logits, want_kc, want_vc = jax_forward(
        jax_params(), JCFG, jnp.asarray(ids), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(start), jnp.asarray(valid),
        jnp.asarray(table), PS, use_kernel=False)

    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    logits = paged_forward(cast_for_compute(torch_params(), TCFG),
                           TCFG, torch.from_numpy(ids), tkc, tvc,
                           torch.from_numpy(start), torch.from_numpy(valid),
                           torch.from_numpy(table), PS, use_kernel=use_kernel)
    assert logits.shape == (B, TCFG.vocab_size)
    live = valid > 0
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(want_logits)[live],
                               rtol=1e-4, atol=1e-4)
    # page 0 is the trash page: padding lanes write it in either order
    for got, want in ((tkc, want_kc), (tvc, want_vc)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:],
                                   rtol=1e-4, atol=1e-4)


def test_scatter_routes_padding_and_inactive_slots_to_trash_page():
    nh, d = 2, 4
    kc = torch.zeros(5, PS, nh, d)
    vc = torch.zeros(5, PS, nh, d)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[6, 7, 8], [0, 1, 2]], dtype=torch.int32)
    valid = torch.tensor([3, 0], dtype=torch.int32)
    k = torch.ones(2, 3, nh, d)
    paged_kv_scatter(kc, vc, k, 2 * k, table, pos, valid, PS)
    assert kc[1, 6:8].eq(1).all() and kc[2, 0].eq(1).all()
    assert vc[2, 0].eq(2).all()
    assert kc[3:].eq(0).all()                 # the inactive slot wrote none
    assert kc[1, :6].eq(0).all() and kc[2, 1:].eq(0).all()
