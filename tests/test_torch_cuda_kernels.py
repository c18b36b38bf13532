"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on an NVIDIA card. Every test here is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is False. The file imports neither
jax nor the reference package, so on a machine without jax it runs
without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving.paged_decode import (paged_decode_attention,
                                                   paged_decode_plain)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernel, no CPU mode)")
    return torch.device("cuda")


def _case(rng, B, nh, d, ps, MP, P, pos):
    q = rng.standard_normal((B, nh, d)).astype(np.float32)
    kc = rng.standard_normal((P, ps, nh, d)).astype(np.float32)
    vc = rng.standard_normal((P, ps, nh, d)).astype(np.float32)
    table = rng.integers(1, P, (B, MP)).astype(np.int32)
    for b, p in enumerate(pos):
        table[b, p // ps + 1:] = 0
    return q, kc, vc, table, np.asarray(pos, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain_on_card(cuda_device, pool_dtype):
    """The serving slice's shapes: 8 slots, 16 heads of 128, page 16, 128
    slot pages; fp32 accumulation over the same pool values."""
    rng = np.random.default_rng(2)
    pos = [0, 15, 16, 31, 511, 1023, 1500, 2047]
    q, kc, vc, table, pos = _case(rng, 8, 16, 128, 16, 128, 1025, pos)
    tdt = getattr(torch, pool_dtype)
    args = [torch.from_numpy(q).to(cuda_device),
            torch.from_numpy(kc).to(cuda_device, tdt),
            torch.from_numpy(vc).to(cuda_device, tdt),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(pos).to(cuda_device)]
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, 16)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_plain(*args, 16)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_inputs(cuda_device):
    q = torch.zeros(2, 2, 128, device=cuda_device)
    kc = torch.zeros(5, 16, 2, 128, device=cuda_device, dtype=torch.bfloat16)
    table = torch.zeros(2, 4, device=cuda_device, dtype=torch.int32)
    pos = torch.zeros(2, device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kc, kc, table.long(), pos, 16)
    with pytest.raises(ValueError, match="float32"):
        paged_decode_attention(q.half(), kc, kc, table, pos, 16)
    kc12 = kc[:, :12].contiguous()
    with pytest.raises(ValueError, match="page_size 12"):
        paged_decode_attention(q, kc12, kc12, table, pos, 12)


@pytest.mark.cuda
def test_engine_decodes_through_the_kernel_on_card(cuda_device):
    """A small bf16 engine on the card: every decode dispatch launches the
    kernel once per layer, and its greedy tokens match the same engine
    decoding through the gather path on at least the first token."""
    from paddle_tpu_torch.flags import get_flags, set_flags
    from paddle_tpu_torch.models import GPTConfig, init_gpt_params
    from paddle_tpu_torch.serving import (Engine, Request,
                                          reset_serving_counters,
                                          serving_counters)
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    params = init_gpt_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77, 130)]
    runs = []
    old = get_flags()
    try:
        for kernel in (True, False):
            set_flags({"FLAGS_serving_paged_kernel": kernel})
            eng = Engine(params=params, config=cfg, num_slots=4,
                         prefill_chunk=64, device=cuda_device)
            reset_serving_counters()
            paged_decode_attention.launches = 0
            reqs = [Request(p, max_new_tokens=6) for p in prompts]
            res = eng.run(reqs)
            c = serving_counters()
            want = c["decode_dispatches"] * cfg.num_layers if kernel else 0
            assert paged_decode_attention.launches == want
            assert eng.pool.balance()["refcounts_accounted"]
            runs.append([res[r.request_id].tokens for r in reqs])
    finally:
        set_flags(old)
    for a, b in zip(*runs):
        assert len(a) == len(b) == 6 and a[0] == b[0]
