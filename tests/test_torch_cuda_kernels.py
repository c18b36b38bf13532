"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on an NVIDIA card (rows 10-11's one-launch collectives on
ranks that share the card). Every test here is marked ``cuda`` and skips
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


# ------------------------------------------------------- flash attention
# Each output is held to its plain version per element and per 128-row
# tile of each (b, h) (``error_vs_plain`` / ``within_tolerance``, whose
# comment gives the reason: bf16 in and out, fp32 accumulation, P and dS
# rounded to bf16 for the tensor cores). The LSE is fp32 on both sides and
# differs only in summation order (atol = rtol = LSE_TOL).
# The kernels (csrc/flash_sm90.cu) work in tiles of 128 rows (forward q
# rows and keys, dQ q rows, dK/dV keys) and 64 rows (dQ keys, dK/dV q
# rows), with TMA boxes of 64 columns: the lengths below put the ragged
# edge on every side of those tiles, at both head dims, causal and full,
# at B*H = 1 and at the train step's B*H = 128.
FLASH_EDGE_S = (1, 63, 64, 65, 127, 128, 129, 200, 2048)
FLASH_CASES = [  # (B, S, H, D, causal)
    (8, 2048, 16, 128, True),
    (2, 2048, 16, 128, True),
    (2, 2048, 16, 128, False),
    (2, 200, 16, 128, True),
    (2, 200, 16, 128, False),
    (2, 333, 4, 64, True),
] + [(1, S, 1, D, causal) for S in FLASH_EDGE_S for D in (64, 128)
     for causal in (True, False)]


def _flash_inputs(device, B, S, H, D, seed=0):
    """bf16 q, k, v as strided views of one [B, S, 3, H, D] qkv tensor (the
    model's split), and a contiguous dO, all from numpy with a seed."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, D)).astype(
        np.float32)).to(device, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(device, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    return q, k, v, do


# At S=1 each query sees one key with all the weight, so dP = delta and
# dS = 0 in exact arithmetic: dQ and dK are fp32 rounding residue on both
# sides (~1e-6 at unit-normal inputs), which no relative gate can read.
# They are held to an absolute 1e-3 instead, under one bf16 ulp of the
# outputs that are not zero by cancellation (|values| 0.1-1 here).
CANCELLED_ATOL = 1e-3


def _assert_close_to_plain(name, got, want):
    from paddle_tpu_torch.ops import flash_attention as fa
    readings = fa.error_vs_plain(got, want)
    assert fa.within_tolerance(readings), (name, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "B{}-S{}-H{}-D{}-{}".format(
                             *c[:4], "causal" if c[4] else "full"))
def test_flash_kernels_match_plain_on_card(cuda_device, case):
    """Forward O and LSE, dQ, dK and dV of the three kernels against their
    plain versions, on the same strided inputs (the qkv split), at every
    tile edge of FLASH_EDGE_S."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, S, H, D, causal = case
    q, k, v, do = _flash_inputs(cuda_device, B, S, H, D)
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o, lse = fa.flash_forward(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal)
    dq_ref = fa.flash_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    for t in (o, lse, dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    torch.testing.assert_close(lse, lse_ref, atol=fa.LSE_TOL,
                               rtol=fa.LSE_TOL)
    for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        if S == 1 and name in ("dq", "dk"):
            err = float((got.float() - want.float()).abs().max())
            assert err <= CANCELLED_ATOL, (name, err)
        else:
            _assert_close_to_plain(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(8, 2048, 16, 128, True),
                                  (1, 129, 2, 64, False)],
                         ids=["train-step", "B1-S129-H2-D64-full"])
def test_flash_kernels_give_the_same_bits_on_every_call(cuda_device, case):
    """Each O, LSE, dQ, dK and dV row is computed by one block in a fixed
    order (no atomics): two calls on the same inputs give the same bits.
    No mbarrier wait timed out on the way."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, S, H, D, causal = case
    q, k, v, do = _flash_inputs(cuda_device, B, S, H, D, seed=5)
    o, lse = fa.flash_forward(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    first = (o, lse, fa.flash_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_dkv(q, k, v, do, lse, delta, causal))
    o2, lse2 = fa.flash_forward(q, k, v, causal)
    second = (o2, lse2, fa.flash_dq(q, k, v, do, lse, delta, causal),
              *fa.flash_dkv(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), first, second):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int16
        assert torch.equal(a.view(bits), b.view(bits)), name
    assert fa.wait_timeout_record() is None


# A flash kernel in a process of its own, from a build of
# csrc/flash_sm90.cu with FLASH_SM90_STUCK defined: every stage's full
# barrier there expects one arrival that never comes, so the kernel's
# first wait on a stage outlasts that build's 1 s bound and traps. Prints
# whether synchronising raised and the wait record, as JSON, on its last
# line.
STUCK_SCRIPT = """
import json, sys
import torch
from paddle_tpu_torch import cuda_build
from paddle_tpu_torch.ops import flash_attention as fa
lib = fa.bind(cuda_build.load_library("flash_sm90_stuck", "flash_sm90.cu",
                                      ("FLASH_SM90_STUCK",)))
fa._sm90_library = lambda: lib
row = int(sys.argv[1])
q, k, v, do = (torch.randn(1, 256, 2, 64, device="cuda").bfloat16()
               for _ in range(4))
lse, delta = torch.zeros(2, 2, 256, device="cuda")
call = {4: lambda: fa.flash_forward(q, k, v),
        5: lambda: fa.flash_dq(q, k, v, do, lse, delta),
        6: lambda: fa.flash_dkv(q, k, v, do, lse, delta)}[row]
try:
    call()
    torch.cuda.synchronize()
    raised = False
except RuntimeError:
    raised = True
print(json.dumps({"raised": raised, "record": fa.wait_timeout_record()}))
"""


@pytest.mark.cuda
def test_flash_wait_timeouts_trap_with_a_record_on_card(cuda_device):
    """Rows 4, 5 and 6 with a stage barrier that never completes (the
    FLASH_SM90_STUCK test build, each row in a process of its own, one
    after the other: a context that faults while another spins on the
    same card can leave the other hung): each launch traps instead of
    hanging, and ``wait_timeout_record()`` names its row, a consumer or
    producer warp of the block and the barrier it waited on."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    from paddle_tpu_torch import cuda_build
    cuda_build.build_all({"flash_sm90_stuck": "flash_sm90.cu"},
                         ("FLASH_SM90_STUCK",))   # once, here
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    for row in (4, 5, 6):
        proc = subprocess.run([sys.executable, "-c", STUCK_SCRIPT, str(row)],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=120)
        lines = proc.stdout.strip().splitlines()
        assert lines, (row, proc.stderr[-2000:])
        got = json.loads(lines[-1])
        rec = got["record"]
        assert got["raised"], (row, got)
        assert rec is not None and rec["code"] == 1 and rec["row"] == row, \
            (row, rec)
        assert 0 <= rec["warp"] <= 8 and rec["block_y"] < 2, (row, rec)
        assert rec["barrier"] >= 1 and rec["step"] >= 0, (row, rec)


@pytest.mark.cuda
def test_peer_barrier_timeout_leaves_a_filled_record_on_card(cuda_device,
                                                             tmp_path):
    """Row 10 on a four-rank group sharing the card, called by rank 0
    alone, at 4M columns: every block of its grid (264 on an H100) waits
    at the entry barrier for three peers that never arrive, so hundreds
    of waits time out at once. The kernel traps (synchronising raises),
    the error record is filled in before the trap ends the grid (row 10,
    rank 0, the entry barrier, epoch 1, a peer that never came), and the
    next call raises naming it."""
    import torch_dp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import fused_collectives as fc
    fc.build_rs_bucket()         # once, here: the ranks only load it
    outs = env.launch(4, ranks.card_forced_timeout, 1 << 22, 2.0,
                      layout="shared", timeout_s=300, init_dir=tmp_path)
    got = outs[0]
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 1 and rec["row"] == 10 and rec["rank"] == 0, rec
    assert rec["at_end"] == 0 and rec["epoch"] == 1, rec
    assert rec["peer"] in (1, 2, 3) and rec["seen"] == 0, rec
    assert rec["block"] >= 0, rec
    assert "row 10: rank 0's entry barrier at epoch 1" in got["next_call"]
    assert outs[1:] == [{}, {}, {}]


@pytest.mark.cuda
def test_flash_autograd_runs_the_kernels_on_card(cuda_device):
    """flash_attention_bshd's backward goes through the dQ and dK/dV
    kernels and matches the plain gradients."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do = _flash_inputs(cuda_device, 2, 256, 4, 128, seed=1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out = fa.flash_attention_bshd(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, True)
    delta = fa.attention_delta(o_ref, do)
    want = (fa.flash_dq_plain(q, k, v, do, lse_ref, delta, True),
            *fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, True))
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        _assert_close_to_plain(name, got, ref)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernels_do_not_take(cuda_device):
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.zeros(1, 64, 2, 128, device=cuda_device)
    for t in (q, q.half()):
        with pytest.raises(ValueError, match="use_flash=False"):
            fa.flash_forward(t, t, t)
    q96 = torch.zeros(1, 64, 2, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="use_flash=False"):
        fa.flash_forward(q96, q96, q96)
    qb = q.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Queue B 4"):
        fa.flash_forward(qb, qb[:, :32], qb[:, :32])
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_forward(qb.transpose(1, 3), qb.transpose(1, 3),
                         qb.transpose(1, 3))


@pytest.mark.cuda
def test_flash_autograd_copies_layouts_the_kernels_cannot_read(cuda_device):
    """A transposed input and the stride-0 gradient of ``.sum()`` are
    copied to a readable layout by the autograd function, not refused."""
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(3)
    base = [torch.from_numpy(rng.standard_normal((2, 64, 4, 96)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3)]
    leaves = [t.requires_grad_(True) for t in base]
    q, k, v = (t.transpose(1, 3) for t in leaves)      # [2, 96, 4, 64]
    assert not fa._readable(q)
    fa.flash_attention_bshd(q, k, v, causal=True).float().sum().backward()
    ones = torch.ones(2, 96, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    o, lse = fa.flash_forward_plain(qc, kc, vc, True)
    delta = fa.attention_delta(o, ones)
    want = (fa.flash_dq_plain(qc, kc, vc, ones, lse, delta, True),
            *fa.flash_dkv_plain(qc, kc, vc, ones, lse, delta, True))
    for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, want):
        _assert_close_to_plain(name, leaf.grad.transpose(1, 3), ref)


# ------------------------------------------------------- quantized serving
# GPT-3 1.3B's quantized GEMMs, K x F: qkv, out, up, down, and the LM head
QUANT_GEMM_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192),
                     (8192, 2048), (2048, 50304)]
QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quantized_weight(rng, K, F, dtype, device):
    from paddle_tpu_torch.serving.quant import _quantize_leaf
    w = torch.from_numpy((rng.standard_normal((K, F)) * 0.02).astype(
        np.float32)).to(device)
    return _quantize_leaf(w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quant_gemm_matches_plain_on_card(cuda_device, dtype, x_dtype):
    """Every 1.3B shape at R = 1, 8, 24 and 256 rows (the stream kernel,
    its k splits and row groups, and the bf16 tile kernel), per element
    and per row (ops/quant_gemm.py states the tolerance and its reason)."""
    from paddle_tpu_torch.ops.quant_gemm import (error_vs_plain, quant_gemm,
                                                 quant_gemm_plain,
                                                 within_tolerance)
    rng = np.random.default_rng(11)
    xdt = getattr(torch, x_dtype)
    for K, F in QUANT_GEMM_SHAPES:
        wq, s = _quantized_weight(rng, K, F, dtype, cuda_device)
        for R in (1, 8, 24, 256):
            x = torch.from_numpy(rng.standard_normal((R, K)).astype(
                np.float32)).to(cuda_device, xdt)
            before = quant_gemm.launches
            got = quant_gemm(x, wq, s)
            torch.cuda.synchronize()
            assert quant_gemm.launches == before + 1
            assert got.dtype == xdt and got.shape == (R, F)
            assert bool(torch.isfinite(got).all())
            readings = error_vs_plain(got, quant_gemm_plain(x, wq, s))
            assert within_tolerance(readings, xdt), (K, F, R, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quant_paged_decode_matches_plain_on_card(cuda_device, dtype):
    """The serving shapes (8 slots, 16 heads of 128, page 16, 128 slot
    pages) over an int8/fp8 pool with page scales in [0.01, 0.1]."""
    from paddle_tpu_torch.serving.paged_decode import (
        paged_decode_attention_q, paged_decode_q_plain)
    rng = np.random.default_rng(12)
    pos = [0, 15, 16, 31, 511, 1023, 1500, 2047]
    q, kc, vc, table, pos = _case(rng, 8, 16, 128, 16, 128, 1025, pos)
    tdt = QUANT_DTYPES[dtype]

    def pool(a):
        if dtype == "int8":
            return torch.from_numpy(np.clip(np.round(a * 40), -127, 127)
                                    .astype(np.int8)).to(cuda_device)
        return torch.from_numpy(a * 100).to(cuda_device).clamp(
            -448, 448).to(tdt)

    ksc, vsc = (torch.from_numpy(rng.uniform(0.01, 0.1, 1025).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    args = [torch.from_numpy(q).to(cuda_device), pool(kc), pool(vc),
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(pos).to(cuda_device), ksc, vsc, 16]
    before = paged_decode_attention_q.launches
    got = paged_decode_attention_q(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention_q.launches == before + 1
    torch.testing.assert_close(got, paged_decode_q_plain(*args), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.cuda
def test_quant_wrappers_refuse_bad_inputs(cuda_device):
    from paddle_tpu_torch.ops.quant_gemm import quant_gemm
    from paddle_tpu_torch.serving.paged_decode import (
        paged_decode_attention, paged_decode_attention_q)
    rng = np.random.default_rng(13)
    wq, s = _quantized_weight(rng, 64, 96, "int8", cuda_device)
    x = torch.zeros(4, 64, device=cuda_device, dtype=torch.bfloat16)
    for bad in (lambda: quant_gemm(x[:, :40], wq[:40], s),          # K % 16
                lambda: quant_gemm(x, wq[:, :90].contiguous(), s[:90]),
                lambda: quant_gemm(x.half(), wq, s),
                lambda: quant_gemm(x.t().contiguous().t(), wq, s),
                lambda: quant_gemm(x, wq.float(), s)):
        with pytest.raises(ValueError,
                           match="FLAGS_serving_quant_kernel=False"):
            bad()
    with pytest.raises(ValueError, match="scale must be float32"):
        quant_gemm(x, wq, s.half())
    q = torch.zeros(2, 2, 128, device=cuda_device)
    pool = torch.zeros(5, 16, 2, 128, device=cuda_device, dtype=torch.int8)
    table = torch.zeros(2, 4, device=cuda_device, dtype=torch.int32)
    pos = torch.zeros(2, device=cuda_device, dtype=torch.int32)
    sc = torch.ones(5, device=cuda_device)
    with pytest.raises(ValueError, match="paged_decode_attention_q"):
        paged_decode_attention(q, pool, pool, table, pos, 16)
    with pytest.raises(ValueError, match="this entry takes"):
        bf = pool.to(torch.bfloat16)
        paged_decode_attention_q(q, bf, bf, table, pos, sc, sc, 16)
    with pytest.raises(ValueError, match="ksc_l must be"):
        paged_decode_attention_q(q, pool, pool, table, pos, sc[:4], sc, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_engine_launches_both_kernels_on_card(cuda_device, dtype):
    """A small bf16 engine at quant=dtype: each decode dispatch launches
    the quantized paged-decode kernel once per layer (the bf16 one never),
    each dispatch the quant GEMM kernel 4 times per layer plus the head;
    the first greedy token matches the same engine on the plain paths."""
    from paddle_tpu_torch.flags import get_flags, set_flags
    from paddle_tpu_torch.models import GPTConfig, init_gpt_params
    from paddle_tpu_torch.ops.quant_gemm import quant_gemm
    from paddle_tpu_torch.serving import (Engine, Request,
                                          reset_serving_counters,
                                          serving_counters)
    from paddle_tpu_torch.serving.paged_decode import (
        paged_decode_attention, paged_decode_attention_q)
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    params = init_gpt_params(cfg, seed=0, device=cuda_device,
                             dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77, 130)]
    runs = []
    old = get_flags()
    try:
        for kernel in (True, False):
            set_flags({"FLAGS_serving_paged_kernel": kernel,
                       "FLAGS_serving_quant_kernel": kernel})
            eng = Engine(params=params, config=cfg, num_slots=4,
                         prefill_chunk=64, device=cuda_device, quant=dtype)
            assert eng._kc.dtype == QUANT_DTYPES[dtype]
            reset_serving_counters()
            counts = (paged_decode_attention, paged_decode_attention_q,
                      quant_gemm)
            for f in counts:
                f.launches = 0
            reqs = [Request(p, max_new_tokens=6) for p in prompts]
            res = eng.run(reqs)
            c = serving_counters()
            L = cfg.num_layers
            want = ((0, c["decode_dispatches"] * L,
                     c["paged_steps"] * (4 * L + 1)) if kernel
                    else (0, 0, 0))
            assert tuple(f.launches for f in counts) == want
            assert eng.pool.balance()["refcounts_accounted"]
            runs.append([res[r.request_id].tokens for r in reqs])
    finally:
        set_flags(old)
    for a, b in zip(*runs):
        assert len(a) == len(b) == 6 and a[0] == b[0]


# the tensor-parallel serving slice's GEMMs at mp = 4 over GPT-3 1.3B:
# (K, F/4) of the out and down projections (bf16 x) and the LM head shard
# (fp32 x)
MP_GEMM_SHAPES = [(2048, 512), (8192, 512)]
MP_HEAD_SHAPE = (2048, 12576)
# a launch with enough output tiles (256 rows x 8192) for the tile kernel
# to store without a k split, so its own epilogue writes the strided slot
MP_DIRECT_SHAPE = (2048, 8192)


class _StubGroup:
    """A rank of an n-rank group without a process group: rank r's block
    is this rank's times (r + 1), so every block differs and a block in
    the wrong place shows."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def _block(self, inp, r):
        return inp * (r + 1)

    def all_gather_into(self, out, inp):
        src = inp.clone()
        rows = src.shape[0]
        for r in range(self.n):
            out[r * rows:(r + 1) * rows].copy_(self._block(src, r))
        return out

    def all_gather_list(self, inp):
        return [self._block(inp, r) for r in range(self.n)]


def _mp_weight(rng, K, F, w_dtype, device):
    w = torch.from_numpy((rng.standard_normal((K, F)) * 0.02).astype(
        np.float32)).to(device)
    if w_dtype == "bf16":
        return w.to(torch.bfloat16), None
    from paddle_tpu_torch.serving.quant import _quantize_leaf
    return _quantize_leaf(w, w_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["bf16", "int8", "fp8"])
def test_fused_gemm_slot_matches_plain_on_card(cuda_device, w_dtype):
    """The bf16 instances (no scale) and the quantized ones, writing into
    a strided slot (row stride > F) and into a rank's slot of the dim-0
    gather buffer, at the slice's shapes (R = 8 and 256 bf16 rows; the
    head shard at 8 fp32 rows) and one launch whose tiles fill the card
    without a k split: per element and per row against the plain GEMM;
    the rest of the buffer untouched."""
    from paddle_tpu_torch.models.generation import _proj
    from paddle_tpu_torch.ops import fused_collectives as fc
    from paddle_tpu_torch.ops.quant_gemm import gemm_into, quant_gemm_plain
    rng = np.random.default_rng(12)
    cases = [(K, F, R, torch.bfloat16) for K, F in MP_GEMM_SHAPES
             for R in (8, 256)] + [MP_HEAD_SHAPE + (8, torch.float32),
                                   MP_DIRECT_SHAPE + (256, torch.bfloat16)]
    for K, F, R, xdt in cases:
        w, s = _mp_weight(rng, K, F, w_dtype, cuda_device)
        x = torch.from_numpy(rng.standard_normal((R, K)).astype(
            np.float32)).to(cuda_device, xdt)
        want = (_proj(x, w.to(xdt)) if s is None
                else quant_gemm_plain(x, w, s))
        wide = torch.full((R, F + 48), 7.0, dtype=xdt, device=cuda_device)
        gemm_into(x, w, s, wide[:, 16:16 + F])
        buf = torch.full((4 * R, F), 7.0, dtype=xdt, device=cuda_device)
        gemm_into(x, w, s, buf[2 * R:3 * R])
        torch.cuda.synchronize()
        for got in (wide[:, 16:16 + F], buf[2 * R:3 * R]):
            readings = fc.error_vs_plain(got, want)
            assert fc.within_tolerance(readings, xdt), (K, F, R, readings)
        assert bool((wide[:, :16] == 7).all() and (wide[:, 16 + F:] == 7)
                    .all())
        assert bool((buf[:2 * R] == 7).all() and (buf[3 * R:] == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["bf16", "int8", "fp8"])
def test_fused_gemm_ag_wrapper_on_card(cuda_device, w_dtype):
    """The wrapper: the kernel's block in the rank's slot, gathered (a stub
    group here) and laid out as [R, n * F] in rank order; launches
    counted; refusals for what the kernel does not take."""
    from paddle_tpu_torch.ops import fused_collectives as fc
    rng = np.random.default_rng(13)
    K, F = MP_GEMM_SHAPES[0]
    w, s = _mp_weight(rng, K, F, w_dtype, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2, 4, K)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    group = _StubGroup(4, 1)
    before = fc.fused_gemm_ag.launches
    got = fc.fused_gemm_ag(x, w, group, s)
    torch.cuda.synchronize()
    assert fc.fused_gemm_ag.launches == before + 1
    assert got.shape == (2, 4, 4 * F)
    want = fc.gemm_ag_plain(x, w, group, s)
    assert fc.within_tolerance(fc.error_vs_plain(got, want), torch.bfloat16)
    # the [R, n * F] columns in rank order: block r is (r + 1) x the
    # rank's own (rank 1's slot is the kernel's output, times 2)
    own = got[..., F:2 * F] / 2
    for r in range(4):
        assert fc.within_tolerance(fc.error_vs_plain(
            got[..., r * F:(r + 1) * F], own * (r + 1)), torch.bfloat16), r
    with pytest.raises(ValueError, match="not contiguous"):
        fc.fused_gemm_ag(x.transpose(0, 1), w, group, s)
    if s is None:
        with pytest.raises(ValueError, match="takes no scale"):
            fc.fused_gemm_ag(x, w, group, torch.ones(F, device=cuda_device))
    else:
        with pytest.raises(ValueError, match="needs a float32 scale"):
            fc.fused_gemm_ag(x, w, group, None)


@pytest.mark.cuda
def test_fp32_head_instance_matches_plain_on_card(cuda_device):
    """An LM head shard passed at fp32: fp32 weights against fp32 x (the
    stream kernel, no scale) at the head shard of mp = 4 and at one row,
    into a strided slot, per element and per row against the plain GEMM;
    fp32 weights against bf16 x are refused."""
    from paddle_tpu_torch.models.generation import _proj
    from paddle_tpu_torch.ops import fused_collectives as fc
    from paddle_tpu_torch.ops.quant_gemm import gemm_into
    rng = np.random.default_rng(14)
    K, F = MP_HEAD_SHAPE
    w = torch.from_numpy((rng.standard_normal((K, F)) * 0.02).astype(
        np.float32)).to(cuda_device)
    for R in (8, 1):
        x = torch.from_numpy(rng.standard_normal((R, K)).astype(
            np.float32)).to(cuda_device)
        want = _proj(x, w)
        wide = torch.full((R, F + 32), 7.0, device=cuda_device)
        gemm_into(x, w, None, wide[:, 16:16 + F])
        torch.cuda.synchronize()
        got = wide[:, 16:16 + F]
        readings = fc.error_vs_plain(got, want)
        assert fc.within_tolerance(readings, torch.float32), (R, readings)
        assert bool((wide[:, :16] == 7).all() and (wide[:, 16 + F:] == 7)
                    .all())
    assert fc.unsupported_reason(K, F, torch.float32, torch.float32) is None
    with pytest.raises(ValueError, match="float32 weights need float32 x"):
        fc.fused_gemm_ag(x.to(torch.bfloat16), w, _StubGroup(4, 0))


@pytest.mark.cuda
def test_fused_engine_serves_an_fp32_head_on_card(cuda_device, tmp_path):
    """``Engine(mp=2, comm_backend="fused")`` from fp32 params at a bf16
    compute dtype, whose LM head is not bf16-exact: the two ranks share
    the card over gloo. The head stays fp32 and runs the fp32 instance;
    tokens and logits are the same on both ranks, and one step's logits
    agree with the one-card engine's within 5 % of max |logit| (the bf16
    blocks sum in another order)."""
    import torch_mp_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops import quant_gemm
    from paddle_tpu_torch.serving import Engine, paged_decode
    # built here, once, so that the ranks only load the libraries
    quant_gemm.build()
    paged_decode.build()
    params = ranks.card_params(cuda_device)
    head = params["head_w"]
    assert not torch.equal(head.to(torch.bfloat16).float(), head)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 40, 77)]
    max_new = [4, 4, 4]
    outs = env.launch(2, ranks.fp32_head_engine, prompts, max_new,
                      layout="shared", timeout_s=300, init_dir=tmp_path)
    K, V = 256, 512
    for o in outs:
        assert o["head_dtype"] == "torch.float32"
        assert o["shapes"].get((1, K, V // 2, "float32"), 0) > 0
        assert o["shapes"].get((4, K, V // 2, "float32"), 0) > 0
        assert o["tokens"] == outs[0]["tokens"]
        np.testing.assert_array_equal(o["logits"], outs[0]["logits"])
    single = Engine(params=params, config=GPTConfig(**ranks.CARD_CFG_KW),
                    device=cuda_device, **ranks.CARD_ENGINE_KW)
    want = ranks._step_logits(single, prompts)
    got = outs[0]["logits"]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.cuda
def test_ring_kernels_match_plain_on_card(cuda_device, tmp_path):
    """The ring all-gather + GEMM, GEMM + ring reduce-scatter and ring
    weight-gradient kernels (``ops/ring_gemm.py``), each plain and with its
    weight read transposed, against their plain versions on two ranks
    sharing the card over gloo: per element and per 128-row tile, at a
    shape with ragged tiles and one of several tiles; n launches per
    call."""
    import torch_tp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import ring_gemm
    ring_gemm.build()            # once, here: the ranks only load it
    outs = env.launch(2, ranks.card_kernels, 3, layout="shared",
                      timeout_s=300, init_dir=tmp_path)
    calls = 2 * len(ranks.CARD_SHAPES)       # plain and transposed
    for o in outs:
        for case, readings, ok in o["readings"]:
            assert ok, (case, readings)
        for name in ("ring_ag_gemm", "ring_gemm_rs", "ring_ag_accum"):
            assert o["counts"][name] == (calls, 2 * calls), name


@pytest.mark.cuda
def test_ring_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    """fp32 operands, a width that is not a multiple of 16 and a
    non-contiguous operand raise (one rank: nothing reaches a hop)."""
    from paddle_tpu_torch.ops import ring_gemm
    group = _StubGroup(2, 0)
    x = torch.zeros(2, 16, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not bfloat16"):
        ring_gemm.ring_ag_gemm(x.float(), w.float(), group)
    with pytest.raises(ValueError, match="columns 40 not a multiple of 16"):
        ring_gemm.ring_ag_gemm(x, torch.zeros_like(w[:, :8]).repeat(1, 5),
                               group)
    with pytest.raises(ValueError, match="not contiguous"):
        ring_gemm.ring_ag_gemm(x.transpose(0, 1), w, group)


@pytest.mark.cuda
def test_pp_boundary_kernels_match_plain_on_card(cuda_device, tmp_path):
    """Rows 14 (y = r + (x @ w + b)) and 15 (dr = gy + gwire, dx, dw) of
    ``ops/pp_boundary.py`` against their plain versions on two ranks
    sharing the card over gloo: per element and per 128-row tile, dr and
    db bit for bit, at a shape with ragged tiles and one of several
    tiles; the boundary op's hop delivers y byte for byte; one launch a
    row-14 call, three a row-15 call."""
    import torch_pp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import pp_boundary
    pp_boundary.build()          # once, here: the ranks only load it
    outs = env.launch(2, ranks.card_kernels, 4, layout="shared",
                      timeout_s=300, init_dir=tmp_path)
    n = len(ranks.CARD_SHAPES)
    for o in outs:
        for case, readings, ok in o["readings"]:
            assert ok, (case, readings)
    assert outs[1]["hops"] == [True] * n
    assert outs[0]["counts"]["gemm_ppsend"] == (2 * n, 2 * n)
    assert outs[1]["counts"]["gemm_ppsend"] == (n, n)
    for o in outs:
        assert o["counts"]["gemm_pprecv"] == (n, 3 * n)


@pytest.mark.cuda
def test_pp_boundary_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    """fp32 operands, a width that is not a multiple of 16 and a
    non-contiguous operand raise; nothing falls back to the plain path."""
    from paddle_tpu_torch.ops import pp_boundary as ppb
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    x, w = torch.zeros(32, 64, **bf), torch.zeros(64, 48, **bf)
    b, r = torch.zeros(48, **bf), torch.zeros(32, 48, **bf)
    before = (ppb.gemm_ppsend.launches, ppb.gemm_pprecv.launches)
    with pytest.raises(ValueError, match="not bfloat16"):
        ppb.gemm_ppsend(x.float(), w.float(), b.float(), r.float())
    with pytest.raises(ValueError, match="columns 40 not a multiple of 16"):
        ppb.gemm_ppsend(x, w[:, :40].contiguous(), b[:40].contiguous(),
                        r[:, :40].contiguous())
    with pytest.raises(ValueError, match="not contiguous"):
        ppb.gemm_pprecv(r, r, x, w.t().contiguous().t())
    assert (ppb.gemm_ppsend.launches, ppb.gemm_pprecv.launches) == before


@pytest.fixture(scope="module")
def shared_rows(tmp_path_factory):
    """Rows 10-11's card checks (``torch_dp_train_ranks.card_rows``) on 2
    and 4 gloo ranks sharing the card (the ``shared`` layout), one spawn
    per degree for all the tests below: {n: the ranks' results}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernel, no CPU mode)")
    import torch_dp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import fused_collectives as fc
    fc.build_rs_bucket()         # once, here: the ranks only load them
    fc.build_ag_bucket()
    return {n: env.launch(n, ranks.card_rows, 6, layout="shared",
                          timeout_s=300,
                          init_dir=tmp_path_factory.mktemp(f"rows{n}"))
            for n in (2, 4)}


@pytest.mark.cuda
def test_rs_bucket_ring_matches_plain_on_card(cuda_device, shared_rows):
    """Row 10's whole call (``fused_rs_bucket``, one pull launch over the
    peer staging) on two and four ranks sharing the card: equal to the
    plain ring bit for bit at every width, fp32 and bf16 parts and wires;
    one launch a call."""
    import torch_dp_train_ranks as ranks
    for n, outs in shared_rows.items():
        calls = len(ranks.CARD_COLS) * len(ranks.PART_DTYPES) * \
            len(ranks.WIRE_DTYPES)
        for o in (o["ring"] for o in outs):
            for case, same in o["readings"]:
                assert same, (n, case)
            assert o["counts"] == (calls, calls)


@pytest.mark.cuda
def test_rs_bucket_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    """An fp16 part, an int8 wire, a bucket of the wrong row count, a
    strided bucket, a bucket on another device than the group's and
    groups of 1 and 9 ranks raise before any collective; nothing falls
    back to the plain ring, and no launch is counted."""
    import types
    from paddle_tpu_torch.ops import fused_collectives as fc
    dev = torch.zeros(1, device=cuda_device).device      # cuda:<index>
    group = types.SimpleNamespace(n=2, rank=0, device=dev, peer_channels={})
    x = torch.zeros(2, 64, device=cuda_device)
    before = (fc.fused_rs_bucket.launches, fc.fused_rs_bucket.calls)
    with pytest.raises(ValueError, match="part dtype"):
        fc.fused_rs_bucket(x.half(), group)
    with pytest.raises(ValueError, match="wire dtype"):
        fc.fused_rs_bucket(x, group, torch.int8)
    with pytest.raises(ValueError, match=r"contiguous \(2, cols\)"):
        fc.fused_rs_bucket(torch.zeros(3, 64, device=cuda_device), group)
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_rs_bucket(torch.zeros(64, 2, device=cuda_device).t(), group)
    with pytest.raises(ValueError, match="the group on"):
        fc.fused_rs_bucket(x, types.SimpleNamespace(
            n=2, rank=0, device=torch.device("cpu"), peer_channels={}))
    for n in (1, 9):
        with pytest.raises(ValueError, match=f"a group of {n} ranks"):
            fc.fused_rs_bucket(torch.zeros(n, 64, device=cuda_device),
                               types.SimpleNamespace(
                                   n=n, rank=0, device=dev,
                                   peer_channels={}))
    assert not group.peer_channels
    assert (fc.fused_rs_bucket.launches, fc.fused_rs_bucket.calls) == before


@pytest.mark.cuda
def test_ag_bucket_ring_matches_plain_on_card(cuda_device, shared_rows):
    """Row 11's whole call (``fused_ag_bucket``, one pull launch over the
    peer staging) on two and four ranks sharing the card: the gathered (n,
    cols) equals the plain ring bit for bit at every length, fp32 and
    bf16; one launch a call."""
    import torch_dp_train_ranks as ranks
    for n, outs in shared_rows.items():
        calls = len(ranks.CARD_COLS) * len(ranks.PART_DTYPES)
        for o in (o["ag_ring"] for o in outs):
            for case, same in o["readings"]:
                assert same, (n, case)
            assert o["counts"] == (calls, calls)


@pytest.mark.cuda
def test_ag_bucket_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    """A 2-D row, a strided row, an empty row, a row on another device
    than the group's and a group of one rank raise before any collective;
    nothing falls back to a library gather, and no launch is counted."""
    import types
    from paddle_tpu_torch.ops import fused_collectives as fc
    dev = torch.zeros(1, device=cuda_device).device      # cuda:<index>
    group = types.SimpleNamespace(n=2, rank=0, device=dev, peer_channels={})
    before = (fc.fused_ag_bucket.launches, fc.fused_ag_bucket.calls)
    with pytest.raises(ValueError, match="contiguous flat row"):
        fc.fused_ag_bucket(torch.zeros(4, 4, device=cuda_device), group)
    with pytest.raises(ValueError, match="contiguous flat row"):
        fc.fused_ag_bucket(torch.zeros(64, 2, device=cuda_device)[:, 0],
                           group)
    with pytest.raises(ValueError, match="contiguous flat row"):
        fc.fused_ag_bucket(torch.zeros(0, device=cuda_device), group)
    with pytest.raises(ValueError, match="the group on"):
        fc.fused_ag_bucket(torch.zeros(64, device=cuda_device),
                           types.SimpleNamespace(
                               n=2, rank=0, device=torch.device("cpu"),
                               peer_channels={}))
    with pytest.raises(ValueError, match="a group of 1 ranks"):
        fc.fused_ag_bucket(torch.zeros(64, device=cuda_device),
                           types.SimpleNamespace(n=1, rank=0, device=dev,
                                                 peer_channels={}))
    assert not group.peer_channels
    assert (fc.fused_ag_bucket.launches, fc.fused_ag_bucket.calls) == before


@pytest.mark.cuda
def test_rows_10_11_survive_back_to_back_reuse_on_card(cuda_device,
                                                        shared_rows):
    """200 back-to-back calls of rows 10 and 11, alternating, at widths in
    a bucket plan's order with a many-block bucket and odd widths mixed in
    (so the staging grows mid-run and grids of one and of many blocks
    follow each other), with no host synchronisation between calls, on
    two and four ranks sharing the card: every result equals its plain
    ring bit for bit, one launch a call."""
    import torch_dp_train_ranks as ranks
    half = ranks.REUSE_CALLS // 2
    for n, outs in shared_rows.items():
        for o in (o["reuse"] for o in outs):
            assert len(o["readings"]) == ranks.REUSE_CALLS
            for case, same in o["readings"]:
                assert same, (n, case)
            assert o["counts"] == ((half, half), (half, half))


@pytest.mark.cuda
def test_peer_channels_close_and_reopen_on_card(cuda_device, shared_rows):
    """Rows 10-11's channels on two and four ranks sharing the card: open,
    closed, reopened and closed again. Each process holds 2 (n - 1) peer
    mappings while both channels are open and none after each close, the
    group keeps no channel after a close, and the calls after the reopen
    still equal their plain rings."""
    for n, outs in shared_rows.items():
        for o in (o["teardown"] for o in outs):
            assert all(o["readings"]), (n, o["readings"])
            assert o["mappings"] == [0, 2 * (n - 1), 0, 2 * (n - 1), 0], n
