"""The port's generation oracle (paddle_tpu_torch/models/generation.py)
against the reference's ``generate_from_params`` and ``_forward_cached``
on shared weights: greedy tokens equal, logits within 1e-4 (fp32, GEMM
summation order). Sampled streams use another generator than threefry,
so they are checked inside the port only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.generation import (
    _forward_cached as jax_forward_cached,
    generate_from_params as jax_generate,
)
from paddle_tpu_torch.models import (cast_for_compute, generate_from_params,
                                     init_gpt_params, param_shapes,
                                     params_from_numpy)
from paddle_tpu_torch.models.generation import _forward_cached, _mask_logits
from paddle_tpu_torch.models.gpt import GPT_CONFIGS, ln_fp32
from torch_parity import (JCFG, TCFG, jax_params, numpy_params,
                          torch_params)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, (1, n))


@pytest.mark.parametrize("plen", [1, 3, 12])
def test_greedy_tokens_equal_reference(plen):
    prompt = _prompt(plen, seed=plen)
    want = np.asarray(jax_generate(jax_params(), jnp.asarray(prompt), JCFG,
                                   max_new_tokens=8)._data)
    got = generate_from_params(torch_params(), prompt, TCFG,
                               max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_stop_ids_pad_like_reference():
    prompt = _prompt(5, seed=7)
    free = np.asarray(jax_generate(jax_params(), jnp.asarray(prompt), JCFG,
                                   max_new_tokens=8)._data)[0, 5:]
    stop = int(free[2])                  # the third greedy token stops it
    want = np.asarray(jax_generate(jax_params(), jnp.asarray(prompt), JCFG,
                                   max_new_tokens=8,
                                   stop_token_ids=[stop])._data)
    got = generate_from_params(torch_params(), prompt, TCFG,
                               max_new_tokens=8, stop_token_ids=[stop],
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 5 + 3:] == stop).all()


@pytest.mark.parametrize("start,T", [(0, 9), (9, 1), (9, 4)])
def test_forward_cached_logits_match_reference(start, T):
    """Prefill then decode-shaped windows over one cache, compared at each
    step's last-position logits."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, TCFG.vocab_size, (2, start + T))
    nh = TCFG.num_heads
    shape = (TCFG.num_layers, 2, TCFG.max_seq_len, nh,
             TCFG.hidden_size // nh)
    jkc = jnp.zeros(shape, jnp.float32)
    jvc = jnp.zeros(shape, jnp.float32)
    tkc, tvc = torch.zeros(shape), torch.zeros(shape)
    tp = cast_for_compute(torch_params(), TCFG)
    for s, e in ((0, start), (start, start + T)):
        if e == s:
            continue
        want, jkc, jvc = jax_forward_cached(jax_params(), JCFG,
                                            jnp.asarray(ids[:, s:e]), jkc,
                                            jvc, s)
        got = _forward_cached(tp, TCFG, torch.from_numpy(ids[:, s:e]),
                              tkc, tvc, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc),
                               rtol=1e-4, atol=1e-4)


def test_sampled_generation_is_seeded_and_in_range():
    prompt = _prompt(4, seed=3)
    kw = dict(max_new_tokens=10, do_sample=True, temperature=0.9,
              top_p=0.9, top_k=50, device="cpu")
    a = generate_from_params(torch_params(), prompt, TCFG, seed=5, **kw)
    b = generate_from_params(torch_params(), prompt, TCFG, seed=5, **kw)
    c = generate_from_params(torch_params(), prompt, TCFG, seed=6, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a < TCFG.vocab_size)).all()


def test_mask_logits_cuts_like_reference():
    """top-k keeps the k largest; top-p keeps the smallest prefix of the
    sorted distribution whose mass reaches p (the top token always)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 3.0]])
    out = _mask_logits(logits, 1.0, 2, None)
    assert torch.isfinite(out).tolist() == [[True, False, False, False,
                                             True]]
    probs = torch.softmax(logits, -1)[0]
    out = _mask_logits(logits, 1.0, None, float(probs.max()) - 1e-3)
    assert torch.isfinite(out).sum() == 1
    out = _mask_logits(logits, torch.tensor([0.5]), None, torch.tensor([1.0]))
    torch.testing.assert_close(out, logits / 0.5)


def test_params_round_trip_and_shapes():
    tp = torch_params()
    tree = numpy_params()
    assert torch.equal(tp["blocks"]["qkv_w"],
                       torch.from_numpy(np.array(tree["blocks"]["qkv_w"])))
    shapes = param_shapes(GPT_CONFIGS["gpt3-1.3B"])
    assert shapes["blocks"]["qkv_w"] == (24, 2048, 6144)
    assert shapes["head_w"] == (2048, 50304)
    bad = dict(tree, wte=tree["wte"][:-1])
    with pytest.raises(ValueError, match="wte"):
        params_from_numpy(bad, TCFG, device="cpu")
    mine = init_gpt_params(TCFG, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine["blocks"].items()} == \
        param_shapes(TCFG)["blocks"]
    assert torch.equal(mine["blocks"]["ln1_g"],
                       torch.ones_like(mine["blocks"]["ln1_g"]))
    assert abs(float(mine["wte"].std()) - TCFG.initializer_range) < 2e-3


def test_ln_fp32_cast_order_matches_reference():
    from paddle_tpu.models.gpt import ln_fp32 as jax_ln
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jax_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                  jnp.asarray(b), 1e-5)
    got = ln_fp32(torch.from_numpy(x).bfloat16(), torch.from_numpy(g),
                  torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_default_device_refuses_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_from_params(torch_params(), _prompt(3), TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gpt_params(TCFG)
