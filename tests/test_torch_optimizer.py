"""The port's functional AdamW/Adam (paddle_tpu_torch/optimizer), gradient
clipping (paddle_tpu_torch/nn/clip.py) and FLOP estimators
(paddle_tpu_torch/observability/flops.py) against the reference.

Params and gradients come from numpy with a seed and go to both sides.
The port updates in place; the reference returns new arrays. fp32 math on
both sides in the same op order: tolerance 1e-6 relative on the params
after 5 steps (fp32 moments) and one bf16 ulp (2^-8 relative) where the
moments are stored in bf16, whose rounding may flip on a last-bit
difference of the fp32 value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxGlobalNorm
from paddle_tpu.nn.clip import ClipGradByNorm as JaxByNorm
from paddle_tpu.nn.clip import ClipGradByValue as JaxByValue
from paddle_tpu.observability import flops as jax_flops
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.models import GPT_CONFIGS
from paddle_tpu_torch.models.gpt_hybrid import decays
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.observability import flops
from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = {"wte": (40, 8), "blocks/qkv_w": (2, 8, 24), "blocks/ln1_g": (2, 8),
          "blocks/up_b": (2, 32), "wpe": (16, 8), "head_w": (8, 40)}


def _params(rng):
    return {n: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(rng, step):
    return {n: (rng.standard_normal(s) * (0.1 + step)).astype(np.float32)
            for n, s in SHAPES.items()}


def _run_both(jax_opt, torch_opt, steps=5, dtype="float32", mask=None):
    rng = np.random.default_rng(0)
    params = _params(rng)
    jp = {n: jnp.asarray(a, dtype) for n, a in params.items()}
    tp = {n: torch.from_numpy(a).to(getattr(torch, dtype))
          for n, a in params.items()}
    jstate = jax_opt.init_state(jp)
    tstate = torch_opt.init_state(tp)
    for step in range(steps):
        g = _grads(rng, step)
        jp, jstate = jax_opt.apply_gradients(
            jp, {n: jnp.asarray(a, dtype) for n, a in g.items()}, jstate,
            wd_mask=mask)
        out, _ = torch_opt.apply_gradients(
            tp, {n: torch.from_numpy(a).to(getattr(torch, dtype))
                 for n, a in g.items()}, tstate, wd_mask=mask)
        assert out is tp                     # updated in place
    assert tstate["step"] == int(jstate["step"]) == steps
    return jp, jstate, tp, tstate


def _close(t, j, rtol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j).astype(np.float32), rtol=rtol,
                               atol=rtol * 1e-2)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_with_decay_mask(moment_dtype):
    mask = {n: decays(n) for n in SHAPES}
    assert mask == {"wte": True, "blocks/qkv_w": True, "blocks/ln1_g": False,
                    "blocks/up_b": False, "wpe": False, "head_w": True}
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              moment_dtype=moment_dtype)
    jp, js, tp, ts = _run_both(JaxAdamW(**kw), AdamW(**kw), mask=mask)
    rtol = 1e-6 if moment_dtype == "float32" else 2 ** -8
    for n in SHAPES:
        _close(tp[n], jp[n], rtol)
        for slot in ("moment1", "moment2"):
            assert ts["slots"][n][slot].dtype == getattr(torch, moment_dtype)
            _close(ts["slots"][n][slot], js["slots"][n][slot],
                   max(rtol, 2 ** -8 if moment_dtype == "bfloat16" else 0))


def test_adamw_decay_only_where_the_mask_allows():
    """Zero gradients: Adam's step is 0, so each param moves by the decay
    alone — p * (1 - lr * wd) where the mask allows, unchanged elsewhere."""
    opt = AdamW(1e-1, weight_decay=0.5)
    p = {"a": torch.ones(3), "b": torch.ones(3)}
    state = opt.init_state(p)
    opt.apply_gradients(p, {"a": torch.zeros(3), "b": torch.zeros(3)},
                        state, wd_mask={"a": True, "b": False})
    torch.testing.assert_close(p["a"], torch.full((3,), 0.95))
    torch.testing.assert_close(p["b"], torch.ones(3))


def test_adamw_bf16_params_match():
    kw = dict(learning_rate=1e-2, weight_decay=0.1, moment_dtype="bfloat16")
    jp, _, tp, _ = _run_both(JaxAdamW(**kw), AdamW(**kw), dtype="bfloat16")
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16
        _close(tp[n], jp[n], 2 ** -7)


@pytest.mark.parametrize("weight_decay", [None, 0.1])
def test_adam_matches(weight_decay):
    """Adam, with and without coupled (L2-into-grad) weight decay."""
    jp, _, tp, _ = _run_both(JaxAdam(3e-3, weight_decay=weight_decay),
                             Adam(3e-3, weight_decay=weight_decay))
    for n in SHAPES:
        _close(tp[n], jp[n], 1e-6)


def test_lr_schedulers_and_masters_are_not_ported():
    """LR schedulers still raise; ``multi_precision`` masters are ported
    (test_multi_precision_masters_match) and no longer do."""
    with pytest.raises(NotImplementedError, match="item 4"):
        AdamW(learning_rate=lambda step: 1e-3)
    assert AdamW(1e-3, multi_precision=True)._multi_precision


@pytest.mark.parametrize("opt", ["adamw", "adam"])
def test_multi_precision_masters_match(opt):
    """bf16 params with fp32 masters (reference optimizer.py:195-230): the
    master is updated in fp32 and the param takes its bf16 rounding. After
    5 steps the masters agree to 1e-6 relative (fp32 math in one order),
    the params to one bf16 ulp (a last-bit difference of the master may
    round the other way)."""
    mk = {"adamw": (JaxAdamW, AdamW), "adam": (JaxAdam, Adam)}[opt]
    # Adam's coupled decay adds wd * p to a bf16 gradient, which the two
    # frameworks round at other places: it is held in fp32 above
    wd = 0.01 if opt == "adamw" else None
    jp, jstate, tp, tstate = _run_both(
        mk[0](3e-3, weight_decay=wd, multi_precision=True),
        mk[1](3e-3, weight_decay=wd, multi_precision=True),
        dtype="bfloat16")
    for n in SHAPES:
        master = tstate["slots"][n]["master"]
        assert master.dtype == torch.float32
        assert tp[n].dtype == torch.bfloat16
        _close(master, jstate["slots"][n]["master"], 1e-6)
        _close(tp[n], jp[n], 2 ** -8)
        assert torch.equal(tp[n], master.to(torch.bfloat16))


def test_masters_only_for_low_precision_params():
    opt = AdamW(1e-3, multi_precision=True)
    state = opt.init_state({"a": torch.zeros(3, dtype=torch.bfloat16),
                            "b": torch.zeros(3)})
    assert "master" in state["slots"]["a"]
    assert "master" not in state["slots"]["b"]


def test_decorate_o2_matches_the_reference():
    """amp.decorate(level="O2") casts every float param to bf16 in place
    and turns masters on, as the reference's decorate does; O1 changes
    nothing."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import Linear
    jmodel = paddle.nn.Linear(4, 3)
    tmodel = Linear(4, 3)
    weight = tmodel.weight
    jopt, topt = JaxAdamW(1e-3), AdamW(1e-3)
    jmodel, jopt = paddle.amp.decorate(jmodel, jopt, level="O2",
                                       dtype="bfloat16")
    tmodel, topt = amp.decorate(tmodel, topt, level="O2", dtype="bfloat16")
    assert tmodel.weight is weight
    for (jn, jp_), (tn, tp_) in zip(jmodel.named_parameters(),
                                    tmodel.named_parameters()):
        assert jn == tn
        assert str(jp_._data.dtype) == "bfloat16" == str(tp_.dtype)[6:]
    assert jopt._multi_precision is topt._multi_precision is True
    other = Linear(4, 3)
    assert amp.decorate(other, level="O1") is other
    assert other.weight.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches(dtype, clip_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in SHAPES.values()]
    want = JaxGlobalNorm(clip_norm).apply_arrays(
        [jnp.asarray(g, dtype) for g in grads])
    got = ClipGradByGlobalNorm(clip_norm).apply_arrays(
        [torch.from_numpy(g).to(getattr(torch, dtype)) for g in grads])
    for t, j in zip(got, want):
        assert str(t.dtype).endswith(dtype)
        _close(t, j, 1e-6 if dtype == "float32" else 2 ** -8)


def test_clip_by_norm_and_value_match():
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in SHAPES.values()]
    for jclip, tclip in ((JaxByNorm(0.7), ClipGradByNorm(0.7)),
                         (JaxByValue(0.3), ClipGradByValue(0.3))):
        want = jclip.apply_arrays([jnp.asarray(g) for g in grads])
        got = tclip.apply_arrays([torch.from_numpy(g) for g in grads])
        for t, j in zip(got, want):
            _close(t, j, 1e-6)


@pytest.mark.parametrize("name", ["gpt3-125M", "gpt3-1.3B", "gpt3-13B"])
def test_flop_formulas_are_the_reference(name):
    cfg = GPT_CONFIGS[name]
    for seq in (512, 2048):
        assert flops.model_flops_per_token(cfg, seq) == \
            jax_flops.model_flops_per_token(cfg, seq)
        assert flops.train_step_flops(cfg, 8, seq) == \
            jax_flops.train_step_flops(cfg, 8, seq)


def test_peak_table_lists_the_cards_and_nothing_else():
    fpt, n = flops.model_flops_per_token(GPT_CONFIGS["gpt3-1.3B"], 2048)
    assert n == 1_418_199_040 and fpt == 9_717_153_792
    assert flops.peak_flops_bf16("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops_bf16("NVIDIA H200") == 989e12
    assert flops.peak_flops_bf16("TPU v5 lite") is None
    assert flops.mfu(1e12, 1.0, None) is None
    assert flops.mfu(989e12, 1.0, 989e12) == 1.0


def test_dense_flops_per_token_is_the_reference():
    for n in (1, 110_000_000, 1_315_000_000):
        assert flops.dense_flops_per_token(n) == \
            jax_flops.dense_flops_per_token(n)
    assert flops.attention_flops_per_token(12, 768, 128) == \
        12 * 12 * 768 * 128
