"""The port's flash attention with segment ids, q and key lengths apart,
fp16 operands and -inf masks (paddle_tpu_torch/ops/flash_attention.py),
its varlen packing and the functionals over it (nn/functional.py:
flash_attn_unpadded, flash_attention, the causal-alignment refusal of
scaled_dot_product_attention) against the reference.

On CPU tensors the wrappers run the kernels' plain versions. They are
held to the reference's Pallas kernels run in interpret mode
(``_pallas_forward(..., interpret=True, segment_ids=..., bias=...)`` and
``flash_attention_backward(..., interpret=True, ...)``, blocks of 128):
O, LSE, dQ, dK and dV, causal top-left with Sq < Sk and Sq > Sk, rows
whose segment no key shares and rows masked whole by a -inf bias (O = 0,
LSE = +1e30 on both sides). The port's ``flash_attention_varlen`` is held
to the reference's (its interpret kernels, forward and backward), and
``F.flash_attn_unpadded`` / ``F.flash_attention`` to the reference's
functionals (their composed path off-TPU).

Tolerances, those of tests/test_torch_flash_features.py: 3e-5 on O, LSE
and forward outputs, 2e-4 on gradients (the sides differ in summation
order only); on fp16 operands both sides compute in fp32 and round the
output to fp16, so one fp16 ulp (2**-10 relative) is added to each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_kernels.flash_attention import (
    _pallas_forward, flash_attention_varlen as jax_varlen)
from paddle_tpu.ops.pallas_kernels.flash_attention_bwd import \
    flash_attention_backward as jax_flash_backward
from paddle_tpu_torch.ops import flash_attention as fa

FWD_TOL = 3e-5
GRAD_TOL = 2e-4
FP16_ULP = 2.0 ** -10


def _bshd(x, B, H, S, D):
    x = np.asarray(x, np.float32).reshape(B, H, S, -1).transpose(0, 2, 1, 3)
    return x[..., :D]


def _reference(q, k, v, g, causal, bias=None, seg=None):
    """The reference's interpret-mode kernels: (O, LSE [B*H, Sq], dQ, dK,
    dV) for cotangent g; q, g [B, Sq, H, D], k, v [B, Sk, H, D]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    # the reference's kernel takes the bias with whole (Sq, Sk) dims
    kw = dict(bias=None if bias is None else jnp.asarray(np.broadcast_to(
        bias, bias.shape[:2] + (Sq, Sk))),
              segment_ids=None if seg is None else tuple(
                  jnp.asarray(s, jnp.int32) for s in seg))
    out, (qb, kb, vb, ob, lse, scale) = _pallas_forward(
        *(jnp.asarray(a) for a in (q, k, v)), causal, block_q=128,
        block_k=128, with_residuals=True, interpret=True, **kw)
    Dp = qb.shape[-1]
    gb = jnp.pad(jnp.asarray(g), ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
    gb = gb.transpose(0, 2, 1, 3).reshape(B * H, Sq, Dp).astype(qb.dtype)
    dq, dk, dv = jax_flash_backward(qb, kb, vb, ob, lse, gb, scale, causal,
                                    block_q=128, block_k=128,
                                    interpret=True, num_heads=H, **kw)
    return (np.asarray(out, np.float32), np.asarray(lse),
            _bshd(dq, B, H, Sq, D), _bshd(dk, B, H, Sk, D),
            _bshd(dv, B, H, Sk, D))


# (B, Sq, Sk, H, D, causal, dtype, bias kind, segment kind)
CASES = [
    (2, 256, 256, 2, 64, True, "fp32", None, "packed"),
    (2, 256, 256, 2, 128, False, "fp32", None, "dead-rows"),
    (2, 128, 256, 2, 64, True, "fp32", None, None),
    (2, 128, 256, 2, 64, False, "fp32", "pad", None),
    (2, 256, 128, 2, 128, True, "fp32", None, None),
    (2, 256, 128, 2, 64, False, "fp32", "pad", "packed"),
    (2, 256, 256, 2, 64, True, "fp16", None, None),
    (2, 128, 256, 2, 64, False, "fp16", "pad", "packed"),
    (2, 128, 128, 2, 64, False, "fp32", "square-inf", None),
    (2, 128, 128, 2, 64, False, "fp32", "inf-row", None),
]


def _case_inputs(case, seed):
    B, Sq, Sk, H, D, causal, dt, kind, segs = case
    rng = np.random.default_rng(seed)
    dtype = np.float16 if dt == "fp16" else np.float32
    q, g = (rng.standard_normal((B, Sq, H, D)).astype(dtype)
            for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(dtype)
            for _ in range(2))
    bias = None
    if kind == "pad":                       # key padding, [B, 1, 1, Sk]
        keep = np.arange(Sk)[None, :] < np.array([Sk, Sk // 2])[:, None]
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None]
    elif kind == "square-inf":              # the decoder's mask
        bias = np.where(np.tril(np.ones((Sq, Sk))) == 1, 0.0,
                        -np.inf).astype(np.float32)[None, None]
    elif kind == "inf-row":                 # row 37 masked whole by -inf
        bias = np.zeros((1, 1, Sq, Sk), np.float32)
        bias[..., 37, :] = -np.inf
    seg = None
    if segs == "packed":                    # rising ids, documents apart
        seg = (np.sort(rng.integers(0, 4, (B, Sq)), axis=1),
               np.sort(rng.integers(0, 4, (B, Sk)), axis=1))
    elif segs == "dead-rows":               # q id 9 matches no key
        seg = (rng.integers(0, 3, (B, Sq)), rng.integers(0, 3, (B, Sk)))
        seg[0][:, 40:48] = 9
    return q, k, v, g, bias, seg


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-Sq{}-Sk{}-H{}-"
                         "D{}-{}-{}-{}-{}".format(*c[:5], "causal" if c[5]
                                                  else "full", *c[6:]))
def test_plain_versions_match_the_interpret_kernels(case):
    B, Sq, Sk, H, D, causal, dt, kind, segs = case
    q, k, v, g, bias, seg = _case_inputs(case, seed=Sq + Sk + D)
    want = _reference(q, k, v, g, causal, bias, seg)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    tseg = None if seg is None else tuple(torch.from_numpy(s) for s in seg)
    tbias = None if bias is None else torch.from_numpy(bias)
    o, lse = fa.flash_forward(*tq, causal, bias=tbias, segment_ids=tseg)
    leaves = [t.clone().requires_grad_(True) for t in tq]
    out = fa.flash_attention_bshd(*leaves, causal=causal, bias=tbias,
                                  segment_ids=tseg)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert o.dtype == out.dtype == tq[0].dtype
    ulp = FP16_ULP if dt == "fp16" else 0.0
    np.testing.assert_allclose(o.float().numpy(), want[0],
                               rtol=FWD_TOL + ulp, atol=FWD_TOL + ulp)
    np.testing.assert_allclose(lse.numpy(), want[1], rtol=FWD_TOL,
                               atol=FWD_TOL)
    for t, w in zip(grads, want[2:]):
        np.testing.assert_allclose(t.float().numpy(), w,
                                   rtol=GRAD_TOL + ulp, atol=GRAD_TOL + ulp)
    dead = None
    if segs == "dead-rows":
        dead = slice(40, 48)
    elif kind == "inf-row":
        dead = slice(37, 38)
    if dead is not None:                    # O = 0, LSE = +1e30 there
        assert np.all(o.numpy()[:, dead] == 0)
        assert np.all(want[0][:, dead] == 0)
        assert np.all(lse.numpy().reshape(B, H, Sq)[:, :, dead] ==
                      fa.MASKED_LSE)
        assert np.all(grads[0].numpy()[:, dead] == 0)


def test_segment_ranges_bound_every_tile():
    """segment_ranges: each SEG_TILE-row tile's least and greatest id, the
    ragged last tile over its own rows only."""
    ids = torch.tensor([[0, 0, 1, 1, 2] * 30], dtype=torch.int32)  # S=150
    r = fa.segment_ranges(ids)
    assert r.shape == (1, 3, 2) and r.dtype == torch.int32
    for t in range(3):
        tile = ids[0, t * fa.SEG_TILE:(t + 1) * fa.SEG_TILE]
        assert r[0, t].tolist() == [int(tile.min()), int(tile.max())]


# ------------------------------------------------------------ varlen
def _pack(seed, lengths, H=2, D=64):
    rng = np.random.default_rng(seed)
    T = int(sum(lengths))
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return [rng.standard_normal((T, H, D)).astype(np.float32)
            for _ in range(2)], cu


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_varlen_matches_the_reference(causal):
    """flash_attention_varlen, forward and backward: the port's (padded to
    128 with ids -1 / -2) against the reference's (padded to 256). Causal
    with cu_seqlens_q == cu_seqlens_k, the reference's contract; full with
    other key documents."""
    (q, g), cu_q = _pack(1, [70, 130, 45, 90])
    if causal:
        (k, v), cu_k = _pack(2, [70, 130, 45, 90])
    else:
        (k, v), cu_k = _pack(2, [100, 30, 160, 21])

    def ref(q_, k_, v_):
        return jax_varlen(q_, k_, v_, jnp.asarray(cu_q), jnp.asarray(cu_k),
                          causal=causal)

    want, pullback = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = pullback(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention_varlen(*leaves, torch.from_numpy(cu_q),
                                    torch.from_numpy(cu_k), causal=causal)
    got_g = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for t, w in zip(got_g, want_g):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_varlen_segment_ids_pad_with_the_reference_ids():
    cu = torch.tensor([0, 3, 5], dtype=torch.int32)
    ids = fa.varlen_segment_ids(cu, 5, 8)
    assert ids.tolist() == [1, 1, 1, 2, 2, -1, -1, -1]


# -------------------------------------------------------- functionals
def _flag(on):
    from paddle_tpu_torch.flags import set_flags
    set_flags({"FLAGS_use_flash_attention": on})


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "composed"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attn_unpadded_matches_the_reference(causal, flash):
    """Both routes of the port (the varlen path through the kernels'
    plain versions, and the composed path with its dense segment mask)
    against the reference's flash_attn_unpadded (its composed path off
    the TPU), with an explicit scale."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional import flash_attn_unpadded as jax_unpadded
    from paddle_tpu_torch.nn import functional as F
    (q, k), cu = _pack(3, [60, 100, 40])
    (v, _), _ = _pack(4, [60, 100, 40])
    want, none = jax_unpadded(*(paddle.to_tensor(a) for a in (q, k, v, cu,
                                                              cu)),
                              scale=0.1, causal=causal, training=False)
    _flag(flash)
    try:
        got, got_none = F.flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v, cu, cu)), scale=0.1,
            causal=causal, training=False)
    finally:
        _flag(True)
    assert none is None and got_none is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    with pytest.raises(NotImplementedError, match="return_softmax"):
        F.flash_attn_unpadded(*(torch.from_numpy(a) for a in (q, k, v, cu,
                                                               cu)),
                              return_softmax=True)


@pytest.mark.parametrize("return_softmax", [False, True],
                         ids=["out", "softmax"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_the_reference(causal, return_softmax):
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional import flash_attention as jax_flash
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    want = jax_flash(*(paddle.to_tensor(a) for a in (q, k, v)),
                     causal=causal, return_softmax=return_softmax,
                     training=False)
    got = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, return_softmax=return_softmax,
                            training=False)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    if return_softmax:
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("is_causal", [True, False],
                         ids=["causal", "full"])
def test_sdpa_with_q_and_key_lengths_apart(is_causal):
    """Sq = 64 against Sk = 128: without is_causal the flash path (plain
    versions here) matches the reference's SDPA; with is_causal the port
    refuses the call on the flash route, counted, since the reference's
    kernel aligns the mask top-left and its composed path bottom-right,
    and its composed route matches the reference's composed path."""
    import paddle_tpu as paddle
    from paddle_tpu.nn.functional import \
        scaled_dot_product_attention as jax_sdpa
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 64, 2, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
            for _ in range(2))
    mask = np.where(rng.random((2, 1, 64, 128)) < 0.8, 0.0, -1e4).astype(
        np.float32)
    want = jax_sdpa(*(paddle.to_tensor(a) for a in (q, k, v)),
                    attn_mask=paddle.to_tensor(mask), is_causal=is_causal,
                    training=False)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    if is_causal:
        before = F.scaled_dot_product_attention.fallbacks
        with pytest.raises(NotImplementedError,
                           match="top-left.*bottom-right"):
            F.scaled_dot_product_attention(
                *args, attn_mask=torch.from_numpy(mask), is_causal=True,
                training=False)
        assert F.scaled_dot_product_attention.fallbacks == before + 1
        _flag(False)
    try:
        got = F.scaled_dot_product_attention(
            *args, attn_mask=torch.from_numpy(mask), is_causal=is_causal,
            training=False)
    finally:
        _flag(True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
