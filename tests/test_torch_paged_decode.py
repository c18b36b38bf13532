"""The port's paged-decode attention (paddle_tpu_torch/serving/
paged_decode.py): its plain version against the reference's Pallas kernel
run in interpret mode, and the wrapper's CPU routing. The hand-written
kernel itself is tested on a card by tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.paged_attention import paged_decode_attention as \
    jax_paged_decode
from paddle_tpu_torch.serving.paged_decode import (
    paged_decode_attention, paged_decode_plain, unsupported_reason)


def _case(rng, B, nh, d, ps, MP, P, pos):
    q = rng.standard_normal((B, nh, d)).astype(np.float32)
    kc = rng.standard_normal((P, ps, nh, d)).astype(np.float32)
    vc = rng.standard_normal((P, ps, nh, d)).astype(np.float32)
    table = rng.integers(1, P, (B, MP)).astype(np.int32)
    # pages past each slot's last live page are unmapped (trash page 0)
    for b, p in enumerate(pos):
        table[b, p // ps + 1:] = 0
    return q, kc, vc, table, np.asarray(pos, np.int32)


# pos covers 0, page boundaries (ps-1, ps) and the last position
_POS = {8: [0, 7, 8, 31], 16: [0, 15, 16, 63]}


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [8, 16])
def test_plain_matches_reference_kernel_interpret(pool_dtype, ps):
    """Same inputs through the Pallas kernel (interpret mode, as
    tests/test_paged_serving.py runs it) and the port's plain version:
    fp32 math over the same pool values, 2e-5 (summation order)."""
    rng = np.random.default_rng(0)
    B, nh, d, MP = 4, 8, 128, 64 // ps
    q, kc, vc, table, pos = _case(rng, B, nh, d, ps, MP, 11, _POS[ps])
    want = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kc, getattr(jnp, pool_dtype)),
        jnp.asarray(vc, getattr(jnp, pool_dtype)), jnp.asarray(table),
        jnp.asarray(pos), page_size=ps, interpret=True)
    tdt = getattr(torch, pool_dtype)
    got = paged_decode_plain(torch.from_numpy(q),
                             torch.from_numpy(kc).to(tdt),
                             torch.from_numpy(vc).to(tdt),
                             torch.from_numpy(table), torch.from_numpy(pos),
                             ps)
    assert got.dtype == torch.float32 and got.shape == (B, nh, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(1)
    q, kc, vc, table, pos = _case(rng, 3, 2, 64, 8, 4, 9, [0, 9, 30])
    args = [torch.from_numpy(a) for a in (q, kc, vc, table, pos)]
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, 8)
    assert paged_decode_attention.launches == before
    assert torch.equal(got, paged_decode_plain(*args, 8))


def test_unsupported_reason_names_each_problem():
    assert unsupported_reason(128, 16, torch.bfloat16) is None
    assert unsupported_reason(64, 8, torch.float32) is None
    why = unsupported_reason(80, 12, torch.float16)
    assert "head_dim 80" in why and "page_size 12" in why and "float16" in why


@pytest.mark.parametrize("quantized", [False, True])
def test_wrappers_refuse_devices_other_than_cuda_and_cpu(quantized):
    """Both entries share one launcher, which neither falls back nor
    counts on a device that is neither CPU nor CUDA."""
    from paddle_tpu_torch.serving.paged_decode import paged_decode_attention_q
    meta = dict(device="meta")
    q = torch.empty(2, 2, 64, **meta)
    table = torch.empty(2, 4, dtype=torch.int32, **meta)
    pos = torch.empty(2, dtype=torch.int32, **meta)
    if quantized:
        kc = torch.empty(9, 8, 2, 64, dtype=torch.int8, **meta)
        sc = torch.empty(9, **meta)
        fn, args = paged_decode_attention_q, (q, kc, kc, table, pos, sc, sc, 8)
    else:
        kc = torch.empty(9, 8, 2, 64, **meta)
        fn, args = paged_decode_attention, (q, kc, kc, table, pos, 8)
    before = fn.launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fn(*args)
    assert fn.launches == before


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source and the shared headers of
    csrc/, so an edited header rebuilds every source that may include it."""
    from paddle_tpu_torch import cuda_build
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "conv.cuh"\n')
    (tmp_path / "conv.cuh").write_text("// one\n")
    _, first = cuda_build._target("k", "k.cu")
    assert cuda_build._target("k", "k.cu")[1] == first
    (tmp_path / "conv.cuh").write_text("// two\n")
    assert cuda_build._target("k", "k.cu")[1] != first


def test_build_digest_covers_defines(tmp_path, monkeypatch):
    """A ``-D`` variant of a source (the flash kernels' forced-timeout
    test build) is a library of its own: the digest covers the defines,
    and the shipped build is never the variant's."""
    from paddle_tpu_torch import cuda_build
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// k\n")
    plain = cuda_build._target("k", "k.cu")[1]
    stuck = cuda_build._target("k", "k.cu", ("FLASH_SM90_STUCK",))[1]
    assert stuck != plain
    assert cuda_build._target("k", "k.cu", ())[1] == plain
    assert cuda_build._flags(("A", "B=2"))[-2:] == ("-DA", "-DB=2")
