"""The port's flash attention (paddle_tpu_torch/ops/flash_attention.py)
against the reference's Pallas kernels run in interpret mode on the CPU,
and the port's blockwise attention against the reference's.

On CPU tensors the wrappers run the kernels' plain versions, so this file
holds the plain forward (O, LSE) and the autograd gradients to the
reference's ``flash_attention_interpret`` / ``flash_attention_backward(
interpret=True)`` at blocks of 128, in fp32. Tolerances are the reference's
own kernel test's (tests/test_flash_bwd.py): 2e-5 forward, 2e-4 gradients;
the two sides differ in summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.blockwise_attention import \
    blockwise_attention as jax_blockwise
from paddle_tpu.ops.pallas_kernels.flash_attention import \
    flash_attention_interpret
from paddle_tpu.ops.pallas_kernels.flash_attention_bwd import \
    flash_attention_backward as jax_flash_backward
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.blockwise_attention import blockwise_attention

B, S, H = 2, 256, 2
FWD_TOL = 2e-5
GRAD_TOL = 2e-4


def _inputs(D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_the_interpret_kernel(causal, D):
    q, k, v, _ = _inputs(D)
    out, (_, _, _, _, lse, _) = flash_attention_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128)
    o, tlse = fa.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_the_interpret_kernels(causal, D):
    q, k, v, g = _inputs(D, seed=1)
    _, (qb, kb, vb, ob, lse, scale) = flash_attention_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128)
    Dp = qb.shape[-1]                       # the reference pads D to 128
    gb = jnp.pad(jnp.asarray(g), ((0, 0), (0, 0), (0, 0), (0, Dp - D)))
    gb = gb.transpose(0, 2, 1, 3).reshape(B * H, S, Dp)
    want = jax_flash_backward(qb, kb, vb, ob, lse, gb, scale, causal,
                              block_q=128, block_k=128, interpret=True)

    leaves = _leaves(q, k, v)
    out = fa.flash_attention_bshd(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for t, w in zip(got, want):
        w = np.asarray(w).reshape(B, H, S, Dp).transpose(0, 2, 1, 3)[..., :D]
        np.testing.assert_allclose(t.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_wrappers_equal_their_plain_versions_on_cpu(causal):
    """On CPU tensors each wrapper is its plain version and counts no
    launch; the backward wrapper computes delta as the reference does."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(64, seed=2))
    counts = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o, lse = fa.flash_forward(q, k, v, causal)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, o, lse, g, causal)
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == counts
    delta = (g * o).sum(-1).permute(0, 2, 1).reshape(B * H, S)
    torch.testing.assert_close(fa.attention_delta(o, g), delta)
    torch.testing.assert_close(
        dq, fa.flash_dq_plain(q, k, v, g, lse, delta, causal))
    want_dk, want_dv = fa.flash_dkv_plain(q, k, v, g, lse, delta, causal)
    torch.testing.assert_close(dk, want_dk)
    torch.testing.assert_close(dv, want_dv)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_the_reference(causal):
    q, k, v, g = _inputs(64, seed=3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    import jax
    want, pullback = jax.vjp(
        lambda a, b, c: jax_blockwise(a, b, c, causal=causal, block_k=128),
        jq, jk, jv)
    leaves = _leaves(q, k, v)
    out = blockwise_attention(*leaves, causal=causal, block_k=128)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for t, w in zip(got, pullback(jnp.asarray(g))):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_flash_and_blockwise_agree_with_a_ragged_length():
    """S=200, not a multiple of any block: the plain flash path and the
    blockwise path (one key block) give the same attention."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 2, 64)).astype(
        np.float32)) for _ in range(3))
    o, _ = fa.flash_forward(q, k, v, True)
    torch.testing.assert_close(o, blockwise_attention(q, k, v, True),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("kwargs", [
    {"segment_ids": (torch.zeros(B, S, dtype=torch.int32),) * 2},
], ids=["segment_ids"])
def test_unported_features_raise(kwargs):
    """Segment ids are ported: one segment over every token is plain
    attention, and ids of the wrong shape raise. What is still unported,
    fp32 operands on the kernels, is named with its queue."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((B, S, H, 64)).astype(
        np.float32))
    torch.testing.assert_close(fa.flash_attention_bshd(q, q, q, **kwargs),
                               fa.flash_attention_bshd(q, q, q),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="segment ids must be"):
        fa.flash_forward(q, q, q, segment_ids=tuple(
            t[:, :8] for t in kwargs["segment_ids"]))
    assert "Queue B 4" in fa.UNPORTED_FEATURES
    assert "Queue B 4" in fa.unsupported_reason(64, torch.float32)


def test_unsupported_reason_names_the_kernel_limits():
    assert fa.unsupported_reason(128, torch.bfloat16) is None
    assert fa.unsupported_reason(64, torch.bfloat16) is None
    assert fa.unsupported_reason(64, torch.float16) is None
    assert "float32" in fa.unsupported_reason(64, torch.float32)
    assert "head_dim 96" in fa.unsupported_reason(96, torch.bfloat16)
    assert "float32" in fa.unsupported_reason(128, torch.float32)


def test_kernel_gate_passes_rounding_and_catches_a_missing_key_tile():
    """``error_vs_plain`` / ``within_tolerance``, the gate that holds the
    kernels to their plain versions on the card: a bf16 rounding of the
    plain output passes, and one 64-key tile dropped for the last 128
    queries of a causal S=1024 fails it."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1024, 2, 64)).astype(
        np.float32)) for _ in range(3))
    want, _ = fa.flash_forward_plain(q, k, v, True)
    ok = fa.error_vs_plain(want.bfloat16(), want)
    assert fa.within_tolerance(ok), ok
    s = fa._scores(q, k, True, 64 ** -0.5)
    s[:, :, 896:, 512:576] = float("-inf")
    dropped = (torch.softmax(s, -1) @ fa._heads(v)).permute(0, 2, 1, 3)
    bad = fa.error_vs_plain(dropped.bfloat16(), want)
    assert not fa.within_tolerance(bad), bad
    assert bad["tile_rel_l2"] > 10 * fa.TILE_REL


# ----------------------------------------------- TMA tensor-map arguments
# ``tensor_map_args`` is what the flash kernels' launches hand to
# cuTensorMapEncodeTiled: checked here on CPU tensors, byte for byte.
def test_tensor_map_args_of_a_contiguous_tensor():
    t = torch.zeros(2, 256, 4, 128, dtype=torch.bfloat16)
    a = fa.tensor_map_args(t, fa.FWD_ROWS)
    assert a == {"dims": (128, 4, 256, 2),
                 "strides": (128 * 2, 4 * 128 * 2, 256 * 4 * 128 * 2),
                 "box": (fa.TMA_BOX_COLS, 1, 128, 1)}
    # a box row is the 128-byte swizzle's row: two boxes span d=128
    assert fa.TMA_BOX_COLS * t.element_size() == 128


@pytest.mark.parametrize("D", [64, 128])
def test_tensor_map_args_read_the_qkv_split_in_place(D):
    """q, k, v of the model's [B, S, 3, H, D] qkv tensor: the same dims,
    the qkv tensor's own strides, bases H*D elements apart; nothing is
    copied."""
    B, S, H = 2, 256, 4
    qkv = torch.zeros(B, S, 3, H, D, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    for i, t in enumerate((q, k, v)):
        assert fa._for_kernel(t) is t
        a = fa.tensor_map_args(t, fa.DKV_KEYS)
        assert a["dims"] == (D, H, S, B)
        assert a["strides"] == (D * 2, 3 * H * D * 2, S * 3 * H * D * 2)
        assert a["box"] == (fa.TMA_BOX_COLS, 1, fa.DKV_KEYS, 1)
        assert t.data_ptr() - qkv.data_ptr() == i * H * D * 2
        assert all(s % 16 == 0 for s in a["strides"])


@pytest.mark.parametrize("S", [1, 65, 129, 200])
def test_tensor_map_args_keep_a_ragged_length(S):
    """The map's S is the true length, not rounded to a tile: TMA fills
    the rows of a box past S with zeros, and the kernels mask them. The
    launch hands the kernel 11 values an operand, in argument order."""
    t = torch.zeros(1, S, 2, 64, dtype=torch.bfloat16)
    assert fa.tensor_map_args(t, fa.DKV_Q_ROWS)["dims"] == (64, 2, S, 1)
    rec = list(fa._map_records((t, fa.DKV_Q_ROWS), (t, fa.DKV_KEYS)))
    assert rec == [64, 2, S, 1, 128, 256, S * 256, 64, 1, 64, 1,
                   64, 2, S, 1, 128, 256, S * 256, 64, 1, 128, 1]


@pytest.mark.parametrize("D", [64, 128])
def test_dq_tensor_map_args_read_the_qkv_split_in_place(D):
    """The dQ kernel's four operands from the model's qkv split and a
    contiguous dO: q and dO in boxes of DQ_Q_ROWS rows, k and v in boxes
    of DQ_KEYS, each with its own tensor's strides, in the launch's
    argument order; nothing is copied."""
    B, S, H = 2, 256, 4
    qkv = torch.zeros(B, S, 3, H, D, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    rec = list(fa._map_records((q, fa.DQ_Q_ROWS), (k, fa.DQ_KEYS),
                               (v, fa.DQ_KEYS), (do, fa.DQ_Q_ROWS)))
    split = [D * 2, 3 * H * D * 2, S * 3 * H * D * 2]
    dense = [D * 2, H * D * 2, S * H * D * 2]
    want = []
    for strides, rows in ((split, fa.DQ_Q_ROWS), (split, fa.DQ_KEYS),
                          (split, fa.DQ_KEYS), (dense, fa.DQ_Q_ROWS)):
        want += [D, H, S, B, *strides, fa.TMA_BOX_COLS, 1, rows, 1]
    assert rec == want
    assert all(fa._for_kernel(t) is t for t in (q, k, v, do))
    # a key tile of the dQ loop is whole 128-byte swizzle periods (8 rows)
    assert fa.DQ_KEYS % 8 == 0 and fa.DQ_Q_ROWS % 64 == 0


@pytest.mark.parametrize("S", [1, 63, 65, 129, 200])
def test_dq_tensor_map_args_keep_a_ragged_length(S):
    """At a length that is no multiple of dQ's tiles the maps carry the
    true S, which the kernel masks (keys) and does not store (q rows)."""
    t = torch.zeros(1, S, 2, 128, dtype=torch.bfloat16)
    for rows in (fa.DQ_Q_ROWS, fa.DQ_KEYS):
        a = fa.tensor_map_args(t, rows)
        assert a["dims"] == (128, 2, S, 1)
        assert a["box"] == (fa.TMA_BOX_COLS, 1, rows, 1)
        assert a["strides"] == (256, 512, S * 512)


def test_tensor_map_args_refuse_what_the_kernels_copy_first():
    """A transposed view has no contiguous last dim: the map refuses it,
    and ``_for_kernel`` (on CUDA) hands the kernels a contiguous copy,
    whose map has the copy's strides."""
    base = torch.zeros(2, 64, 4, 96, dtype=torch.bfloat16)
    view = base.transpose(1, 3)                     # [2, 96, 4, 64]
    assert not fa._readable(view)
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.tensor_map_args(view, 64)
    copy = view.contiguous()
    assert fa.tensor_map_args(copy, 64)["strides"] == (
        64 * 2, 4 * 64 * 2, 96 * 4 * 64 * 2)
    with pytest.raises(ValueError, match="B, S, H, D"):
        fa.tensor_map_args(torch.zeros(4, 8, dtype=torch.bfloat16), 64)
