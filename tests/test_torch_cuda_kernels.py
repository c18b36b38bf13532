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


# the split kernel's cases: (B, live tokens) at the main path's 512 and a
# long 2048 (a table of 128 pages: 16 splits of 8 pages), one slot and
# eight; and a batch of positions mid-page, on page and split edges and
# ending before the last split, so whole splits are masked
DECODE_SPLIT_CASES = [(1, [511]), (8, [511] * 8), (1, [2047]), (8, [2047] * 8),
                      (8, [0, 7, 127, 128, 129, 700, 1029, 2046])]
POOL_KINDS = ("bfloat16", "int8", "fp8")


def _decode_pool(a, kind, device):
    """A bf16 pool, or an int8 / fp8 one spread over the type's range."""
    if kind == "bfloat16":
        return torch.from_numpy(a).to(device, torch.bfloat16)
    if kind == "int8":
        return torch.from_numpy(np.clip(np.round(a * 40), -127, 127).astype(
            np.int8)).to(device)
    return torch.from_numpy(a * 100).to(device).clamp(-448, 448).to(
        torch.float8_e4m3fn)


def _decode_args(device, kind, B, pos, seed):
    rng = np.random.default_rng(seed)
    P = 257                     # slots' pages drawn from it, repeats and all
    q, kc, vc, table, pos = _case(rng, B, 16, 128, 16, 128, P, pos)
    args = [torch.from_numpy(q).to(device), _decode_pool(kc, kind, device),
            _decode_pool(vc, kind, device),
            torch.from_numpy(table).to(device),
            torch.from_numpy(pos).to(device)]
    if kind != "bfloat16":
        args += [torch.from_numpy(rng.uniform(0.01, 0.1, P).astype(
            np.float32)).to(device) for _ in range(2)]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=lambda c: f"B{c[0]}-{max(c[1]) + 1}")
def test_paged_decode_splits_match_plain_on_card(cuda_device, kind, case):
    """Rows 1-2's split kernel (pages cut into splits of 8, bulk page
    loads, the splits joined in order) at B = 1 and 8, 512 and 2048 live
    tokens and mixed positions, over bf16, int8 and fp8 pools: within
    1e-3 of the plain version (fp32 sums in another order; the gate of
    the serving-shape tests above), one launch a call, the same bits on a
    second call."""
    from paddle_tpu_torch.serving import paged_decode as pd
    B, pos = case
    args = _decode_args(cuda_device, kind, B, pos, seed=30 + B)
    fn = pd.paged_decode_attention if kind == "bfloat16" else \
        pd.paged_decode_attention_q
    plain = pd.paged_decode_plain if kind == "bfloat16" else \
        pd.paged_decode_q_plain
    before = fn.launches
    got = fn(*args, 16)
    again = fn(*args, 16)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, plain(*args, 16), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_paged_decode_calls_back_to_back_give_the_same_bits_on_card(
        cuda_device):
    """Calls of different shapes one after another with no host
    synchronisation (each call's join launch overlapping the next call's
    splits' start), then every result the same bits as alone."""
    from paddle_tpu_torch.serving import paged_decode as pd
    cases = [_decode_args(cuda_device, "bfloat16", B, pos, seed=40 + i)
             for i, (B, pos) in enumerate(DECODE_SPLIT_CASES)]
    alone = []
    for args in cases:
        alone.append(pd.paged_decode_attention(*args, 16))
        torch.cuda.synchronize()
    mixed = [pd.paged_decode_attention(*cases[i % len(cases)], 16)
             for i in range(3 * len(cases))]
    torch.cuda.synchronize()
    for i, got in enumerate(mixed):
        assert torch.equal(got, alone[i % len(cases)]), i
    assert pd.wait_timeout_record() is None


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
    with pytest.raises(ValueError, match="no pages"):
        paged_decode_attention(q, kc, kc, table[:, :0], pos, 16)


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
    alone, at 4M columns, while its three peers' processes end (a second
    after the group barrier, as a crash would): every block of its grid
    (264 on an H100) waits at the entry barrier for peers that never
    arrive, so hundreds of waits give up at once, within a few timeouts
    of 2 s. The kernel
    traps (synchronising raises), the error record is filled in before
    the trap ends the grid (code 1: a heartbeat stood still; row 10,
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
    assert got["seconds"] < 30, got
    assert "row 10: rank 0's entry barrier at epoch 1" in got["next_call"]
    assert "the process is gone" in got["next_call"]
    assert outs[1:] == [{}, {}, {}]


# Two ranks of one group sharing the card, each a process of its own (not
# env.launch's ranks, whose failures env.launch itself reports): both make
# one row-11 gather, then rank 1 fails outside the peer kernels, by an
# uncaught exception in its main thread ("main") or in a thread of its
# own ("thread"), while a non-daemon thread keeps its process alive.
# Rank 0 gathers again and waits for it. Prints rank 0's readings as JSON.
LINGER_SCRIPT = """
import json, os, sys, threading, time
import torch
from paddle_tpu_torch.distributed import env, peer
from paddle_tpu_torch.ops import fused_collectives as fc
rank, init_file, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
group = env.init_mp_group(rank, 2, init_file, "shared", timeout_s=300)
row = fc.ag_bucket_staging(group, 1 << 20, torch.float32)
row.fill_(rank)
fc.fused_ag_bucket(row, group)
torch.cuda.synchronize()
group.barrier()
if rank == 1:
    threading.Thread(target=time.sleep, args=(120,)).start()  # lingers
    if mode == "thread":
        threading.Thread(target=lambda: 1 / 0).start()
        time.sleep(120)
    raise RuntimeError("rank 1 fails outside the peer kernels")
group.peer_channels[fc.AG_CHANNEL].timeout_ns = int(LINGER_TIMEOUT_S * 1e9)
t0 = time.perf_counter()
fc.fused_ag_bucket(row, group)
try:
    torch.cuda.synchronize()
    raised = None
except RuntimeError as e:
    raised = str(e)
print(json.dumps({"raised": raised, "seconds": time.perf_counter() - t0,
                  "record": peer.error_record()}), flush=True)
os._exit(0)
"""
LINGER_TIMEOUT_S = 2.0
LINGER_SLACK_S = 20.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["main", "thread"])
def test_a_failed_lingering_rank_stops_its_heartbeat_on_card(cuda_device,
                                                             tmp_path,
                                                             mode):
    """The exception hooks that the heartbeat installs stop a failed
    rank's heartbeat though its process lingers: rank 0's row-11 gather
    gives up on it with record code 1 (the heartbeat stood still) within
    the timeout plus slack, not at the 300 s backstop (code 2)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    from paddle_tpu_torch.ops import fused_collectives as fc
    fc.build_ag_bucket()         # once, here: the ranks only load it
    from paddle_tpu_torch.distributed import peer
    peer.build()
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    script = LINGER_SCRIPT.replace("LINGER_TIMEOUT_S",
                                   repr(LINGER_TIMEOUT_S))
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), init,
                               mode], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    try:
        out, err = procs[0].communicate(timeout=240)
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    lines = out.strip().splitlines()
    assert lines, err[-3000:]
    got = json.loads(lines[-1])
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 1 and rec["row"] == 11 and rec["rank"] == 0, rec
    assert rec["peer"] == 1, rec
    assert got["seconds"] < LINGER_TIMEOUT_S + LINGER_SLACK_S, got


@pytest.mark.cuda
def test_peer_barrier_backstop_ends_a_wait_for_a_live_peer_on_card(
        cuda_device, tmp_path):
    """Row 10 on a four-rank group sharing the card, called by rank 0
    alone while the three peers stay alive (their heartbeats beat) and
    never call: the waits outlast the 1 s timeout and give up only at the
    backstop, shortened to 5 s (code 2), with the record filled in and
    the next call naming it."""
    import torch_dp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import fused_collectives as fc
    fc.build_rs_bucket()         # once, here: the ranks only load it
    outs = env.launch(4, ranks.card_forced_timeout, 1 << 22, 1.0, 5.0,
                      layout="shared", timeout_s=300, init_dir=tmp_path)
    got = outs[0]
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 2 and rec["row"] == 10 and rec["rank"] == 0, rec
    assert rec["peer"] in (1, 2, 3) and rec["beat"] > 0, rec
    assert got["seconds"] >= 5.0, got
    assert "row 10: rank 0's entry barrier at epoch 1" in got["next_call"]
    assert "alive and stuck" in got["next_call"]


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
    with pytest.raises(ValueError,
                       match="Queue B 4.*FLAGS_use_flash_attention=False"):
        fa.flash_forward(q, q, q)
    q96 = torch.zeros(1, 64, 2, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="use_flash=False"):
        fa.flash_forward(q96, q96, q96)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="k and v share"):
        fa.flash_forward(qb, qb[:, :32], qb[:, :16])
    with pytest.raises(ValueError, match="segment ids must be"):
        fa.flash_forward(qb, qb, qb, segment_ids=(
            torch.zeros(1, 64, device=cuda_device, dtype=torch.int32),
            torch.zeros(1, 32, device=cuda_device, dtype=torch.int32)))
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


# ---------------------------------------- flash with a bias and dropout
# The kExtra instances of csrc/flash_sm90.cu (an additive fp32 bias read
# through its strides, in-kernel Philox dropout) against their plain
# versions on the same inputs, key and bias, with the gates above: lengths
# off every tile (65, 129, 200, 333) and BERT's (32, 128, 12, 64);
# key-padding (-1e4), per-head and full biases, fp32 and bf16; a row masked
# whole by a bool mask (-1e30: O = 0, LSE = +1e30).
FLASH_FEATURE_CASES = [  # (B, S, H, D, causal, bias, dropout_p)
    (32, 128, 12, 64, False, "pad", 0.1),
    (2, 200, 4, 64, False, "pad", 0.1),
    (2, 129, 3, 128, False, "head", 0.1),
    (2, 333, 2, 64, True, "full-bf16", 0.1),
    (1, 65, 2, 128, True, "pad", 0.0),
    (2, 200, 2, 64, False, None, 0.3),
    (1, 200, 2, 64, False, "dead-row", 0.1),
    (1, 128, 1, 128, True, "dead-row", 0.0),
]
FEATURE_KEY = 0x5DEECE66D1234567


def _feature_bias(rng, device, kind, B, S, H):
    if kind is None:
        return None
    if kind == "pad":                     # BERT's [B, 1, 1, S]
        lengths = rng.integers(S // 2, S + 1, B)
        keep = np.arange(S)[None, :] < lengths[:, None]
        return torch.from_numpy(np.where(keep, 0.0, -1e4).astype(
            np.float32)).to(device)[:, None, None, :]
    if kind == "head":
        return torch.from_numpy(rng.standard_normal((1, H, S, S)).astype(
            np.float32)).to(device)
    if kind == "full-bf16":
        return torch.from_numpy(rng.standard_normal((B, H, S, S)).astype(
            np.float32)).to(device, torch.bfloat16)
    keep = np.ones((B, 1, S, S), bool)      # "dead-row": row 37 masked
    keep[:, :, 37] = False
    return torch.from_numpy(np.where(keep, 0.0, -1e30).astype(
        np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_FEATURE_CASES,
                         ids=lambda c: "B{}-S{}-H{}-D{}-{}-{}-p{}".format(
                             *c[:4], "causal" if c[4] else "full", c[5],
                             c[6]))
def test_flash_features_match_plain_on_card(cuda_device, case):
    from paddle_tpu_torch.ops import flash_attention as fa
    B, S, H, D, causal, kind, p = case
    rng = np.random.default_rng(S + H)
    q, k, v, do = _flash_inputs(cuda_device, B, S, H, D, seed=S)
    bias = _feature_bias(rng, cuda_device, kind, B, S, H)
    feats = dict(bias=bias, dropout_p=p, key=FEATURE_KEY)
    o, lse = fa.flash_forward(q, k, v, causal, **feats)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, **feats)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, **feats)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal, **feats)
    dq_ref = fa.flash_dq_plain(q, k, v, do, lse_ref, delta, causal, **feats)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal,
                                        **feats)
    for t in (o, lse, dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    torch.testing.assert_close(lse, lse_ref, atol=fa.LSE_TOL,
                               rtol=fa.LSE_TOL)
    if kind == "dead-row":
        assert bool((o[:, 37] == 0).all()) and bool((dq[:, 37] == 0).all())
        assert bool((lse.view(B, H, S)[:, :, 37] == fa.MASKED_LSE).all())
    for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        _assert_close_to_plain(name, got, want)


# ------------------- flash with segment ids, Sq != Sk, fp16, a -inf mask
# Every instance the Transformer, varlen and fp16 paths reach, against the
# plain versions on the same inputs, with the gates above: q and key
# lengths apart (both ways, causal top-left, ragged against every tile),
# fp16 operands, the decoder's -inf square mask, segment ids (a varlen
# pack whose padding rows match no key: O = 0, LSE = +1e30; ids in no
# order, which no tile skip can use), each with and without the bias and
# dropout. k and v are strided views of one [B, Sk, 2, H, D] tensor.
FLASH_NEW_CASES = [  # (B, Sq, Sk, H, D, causal, dtype, bias, p, segments)
    (32, 128, 256, 8, 64, False, "bf16", "pad", 0.1, None),   # cross
    (32, 128, 128, 8, 64, False, "bf16", "square-inf", 0.1, None),
    (2, 200, 333, 2, 128, True, "bf16", None, 0.0, None),
    (2, 333, 200, 2, 64, True, "bf16", None, 0.0, None),
    (1, 129, 65, 2, 128, False, "fp16", None, 0.0, None),
    (2, 512, 512, 4, 128, True, "fp16", None, 0.0, None),
    (2, 256, 256, 12, 64, False, "fp16", "pad", 0.1, None),
    (2, 65, 300, 3, 128, True, "fp16", "head", 0.2, None),
    (1, 1024, 1024, 4, 128, True, "bf16", None, 0.0, "varlen"),
    (1, 1024, 1024, 4, 64, True, "fp16", None, 0.1, "varlen"),
    (1, 896, 1152, 2, 128, False, "bf16", None, 0.0, "varlen"),
    (2, 300, 500, 2, 64, False, "fp16", "pad", 0.1, "shuffled"),
    (2, 200, 200, 2, 128, True, "bf16", "pad", 0.0, "shuffled"),
]
TORCH_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _new_case_inputs(device, case, seed):
    """q, k, v, dO and the features (bias, segment ids) of a
    FLASH_NEW_CASES case, from numpy with a seed."""
    from paddle_tpu_torch.ops import flash_attention as fa
    B, Sq, Sk, H, D, causal, dt, kind, p, segs = case
    rng = np.random.default_rng(seed)
    dtype = TORCH_DTYPES[dt]

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)

    q, do = arr(B, Sq, H, D), arr(B, Sq, H, D)
    k, v = arr(B, Sk, 2, H, D).unbind(2)
    bias = None
    if kind == "pad":                     # key padding, [B, 1, 1, Sk]
        lengths = rng.integers(Sk // 2, Sk + 1, B)
        keep = np.arange(Sk)[None, :] < lengths[:, None]
        bias = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(
            np.float32)).to(device)[:, None, None, :]
    elif kind == "square-inf":            # the decoder's [Sq, Sk] mask
        m = np.where(np.tril(np.ones((Sq, Sk))) == 1, 0.0, -np.inf)
        bias = torch.from_numpy(m.astype(np.float32)).to(device)[None, None]
    elif kind == "head":
        bias = torch.from_numpy(rng.standard_normal((1, H, Sq, Sk)).astype(
            np.float32)).to(device)
    seg = None
    if segs == "varlen":                  # five documents, then padding
        real = min(Sq, Sk) - 100
        cu = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, real), 4, False)), [real]])

        def ids(S, pad_id):
            t = np.arange(S)
            return np.where(t < real, np.searchsorted(cu, t, "right"),
                            pad_id)
        seg = (ids(Sq, fa.PAD_Q_ID), ids(Sk, fa.PAD_K_ID))
    elif segs == "shuffled":
        seg = (rng.integers(0, 3, (B, Sq)), rng.integers(0, 3, (B, Sk)))
    if seg is not None:
        seg = tuple(torch.from_numpy(np.broadcast_to(
            np.asarray(s, np.int32), (B, len(s) if np.ndim(s) == 1
                                      else s.shape[1])).copy()).to(device)
                    for s in seg)
    feats = dict(bias=bias, dropout_p=p, key=FEATURE_KEY, segment_ids=seg)
    return q, k, v, do, feats


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_NEW_CASES,
                         ids=lambda c: "B{}-Sq{}-Sk{}-H{}-D{}-{}-{}-{}-p{}-{}"
                         .format(*c[:5], "causal" if c[5] else "full",
                                 *c[6:]))
def test_flash_new_features_match_plain_on_card(cuda_device, case):
    from paddle_tpu_torch.ops import flash_attention as fa
    B, Sq, Sk, H, D, causal, dt, kind, p, segs = case
    q, k, v, do, feats = _new_case_inputs(cuda_device, case, Sq + Sk)
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    o, lse = fa.flash_forward(q, k, v, causal, **feats)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, **feats)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, **feats)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert o.dtype == dq.dtype == dk.dtype == TORCH_DTYPES[dt]
    assert o.shape == q.shape and dk.shape == dv.shape == k.shape
    o_ref, lse_ref = fa.flash_forward_plain(q, k, v, causal, **feats)
    dq_ref = fa.flash_dq_plain(q, k, v, do, lse_ref, delta, causal, **feats)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, causal,
                                        **feats)
    for t in (o, lse, dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    torch.testing.assert_close(lse, lse_ref, atol=fa.LSE_TOL,
                               rtol=fa.LSE_TOL)
    if segs == "varlen":                   # the padding rows: dead
        dead = feats["segment_ids"][0][0] == fa.PAD_Q_ID
        assert bool(dead.any())
        assert bool((o[:, dead] == 0).all()) and bool((dq[:, dead] == 0).all())
        assert bool((lse.view(B, H, Sq)[:, :, dead] == fa.MASKED_LSE).all())
    for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        _assert_close_to_plain(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_flash_varlen_and_unpadded_run_the_kernels_on_card(cuda_device, dt):
    """flash_attention_varlen and F.flash_attn_unpadded over a pack of
    five documents (cu_seqlens), causal, forward and backward through the
    kernels, against the same pack's plain versions on the CPU."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(7)
    lengths = rng.integers(100, 400, 5)
    cu = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(
        np.int32))
    T = int(cu[-1])
    x = [torch.from_numpy(rng.standard_normal((T, 4, 128)).astype(
        np.float32)).to(TORCH_DTYPES[dt]) for _ in range(4)]
    before = (fa.flash_forward.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    leaves = [t.to(cuda_device).requires_grad_(True) for t in x[:3]]
    out = fa.flash_attention_varlen(*leaves, cu.to(cuda_device),
                                    cu.to(cuda_device), causal=True)
    grads = torch.autograd.grad(out, leaves, x[3].to(cuda_device))
    out2, none = F.flash_attn_unpadded(*leaves, cu.to(cuda_device),
                                       cu.to(cuda_device), causal=True)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, out2)
    assert (fa.flash_forward.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == (before[0] + 2, before[1] + 1,
                                       before[2] + 1)
    # the plain versions on the same operands in their own dtype, so the
    # backward's delta comes from the rounded O, as the kernels' does
    cpu = [t.clone().requires_grad_(True) for t in x[:3]]
    want = fa.flash_attention_varlen(*cpu, cu, cu, causal=True)
    want_g = torch.autograd.grad(want, cpu, x[3])
    for name, got, ref in (("o", out, want), ("dq", grads[0], want_g[0]),
                           ("dk", grads[1], want_g[1]),
                           ("dv", grads[2], want_g[2])):
        _assert_close_to_plain(name, got.cpu()[None], ref[None])


@pytest.mark.cuda
def test_sdpa_counts_and_logs_what_the_kernels_cannot_take(cuda_device):
    """fp32 CUDA tensors: the call is counted in ``.fallbacks`` and raises
    with its reason and the flag that takes the composed path, no kernel
    launched; with the flag off the composed path runs; bf16: the forward
    kernel, no fallback."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(2, 64, 2, 64, device=cuda_device)
    before = F.scaled_dot_product_attention.fallbacks
    launches = fa.flash_forward.launches
    with pytest.raises(NotImplementedError,
                       match="is not bfloat16.*FLAGS_use_flash_attention"):
        F.scaled_dot_product_attention(q, q, q, training=False)
    assert F.scaled_dot_product_attention.fallbacks == before + 1
    assert fa.flash_forward.launches == launches
    set_flags({"FLAGS_use_flash_attention": False})
    try:
        out = F.scaled_dot_product_attention(q, q, q, training=False)
    finally:
        set_flags({"FLAGS_use_flash_attention": True})
    torch.testing.assert_close(out, F._sdpa_reference(q, q, q))
    assert fa.flash_forward.launches == launches
    qb = q.bfloat16()
    F.scaled_dot_product_attention(qb, qb, qb, training=False)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == launches + 1
    assert F.scaled_dot_product_attention.fallbacks == before + 1


# Mask read-outs, exact for each kernel: D = S = 128, q = 0 and no bias,
# so every score is 0, every P is 1 / S and the LSE is log S; then
#   forward  V = I:                      O[i, j]  = keep(i, j) / ((1-p) S)
#   dK/dV    dO = I:                     dV[j, i] = keep(i, j) / ((1-p) S)
#   dQ       K = I, delta = 0, every row of dO and of V e_0 (dO V^T = 1):
#                                        dQ[i, j] = keep(i, j) scale / ((1-p) S)
# so an output is nonzero exactly where the kernel kept the pair, which
# must be the plain Philox mask bit for bit.
READOUT_P = 0.25


def _readout(device, kernel, B=2, H=3, S=128):
    from paddle_tpu_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    eye = torch.eye(S, device=device)[None, :, None, :].expand(
        B, S, H, S).contiguous()
    e0 = torch.zeros(B, S, H, S, device=device)
    e0[..., 0] = 1
    zero = torch.zeros(B, S, H, S, device=device)
    lse = torch.full((B * H, S), float(np.log(S)), device=device)
    feats = dict(dropout_p=READOUT_P, key=FEATURE_KEY)
    if kernel == "forward":
        out, _ = fa.flash_forward(zero.to(bf), zero.to(bf), eye.to(bf),
                                  False, **feats)
        got = out.permute(0, 2, 1, 3)                  # [B, H, i, j]
    elif kernel == "dkv":
        _, dv = fa.flash_dkv(zero.to(bf), zero.to(bf), zero.to(bf),
                             eye.to(bf), lse, torch.zeros_like(lse), False,
                             **feats)
        got = dv.permute(0, 2, 3, 1)                   # [B, H, i, j]
    else:
        got = fa.flash_dq(zero.to(bf), eye.to(bf), e0.to(bf), e0.to(bf),
                          lse, torch.zeros_like(lse), False,
                          **feats).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    return got.float()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
def test_each_kernels_dropout_mask_is_the_plain_philox_mask(cuda_device,
                                                            kernel):
    from paddle_tpu_torch.ops import philox
    got = _readout(cuda_device, kernel)
    B, H, S, _ = got.shape
    want = philox.keep_mask(B, H, S, S, READOUT_P, FEATURE_KEY,
                            device=cuda_device)
    assert torch.equal(got != 0, want)
    scale = 128 ** -0.5 if kernel == "dq" else 1.0
    value = scale / ((1 - READOUT_P) * S)
    torch.testing.assert_close(got[want], torch.full_like(got[want], value),
                               rtol=1e-2, atol=0)


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
    """Every 1.3B shape at R = 1, 8, 24 and 256 rows (bf16 x: the
    tensor-core kernel, split and not; fp32 x: the stream kernel, its k
    splits and row groups), per element, per row and per 64 x 64 tile
    (ops/quant_gemm.py states the tolerance and its reason)."""
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


# The tensor-core kernel's edges: row counts around its row widths (8,
# 16, 32, 64, 128) and past one block of 128 rows; K of one k16 slice, a
# tail past a 64-row stage and 8192 (many stages, k split); F not a
# multiple of a block's 128 columns, and the LM head's width.
TC_ROWS = (1, 7, 8, 9, 16, 17, 64, 255, 256, 300)
TC_SHAPES = [(16, 2064), (2064, 2064), (8192, 2064)]
TC_WIDE = (2064, 50304)
TC_WIDE_ROWS = (1, 8, 256, 300)
GEMM_KINDS = ("int8", "fp8", "bf16", "fp32")


def _gemm_weight(gen, K, F, kind, device):
    """A [K, F] weight of ``kind`` from ``gen`` and its scale (None for
    bf16 and fp32)."""
    w = torch.randn(K, F, generator=gen, device=device) * 0.02
    if kind in ("bf16", "fp32"):
        return w.to({"bf16": torch.bfloat16, "fp32": torch.float32}[kind]), \
            None
    from paddle_tpu_torch.serving.quant import _quantize_leaf
    return _quantize_leaf(w, kind)


def _gemm_plain(x, w, s):
    from paddle_tpu_torch.models.generation import _proj
    from paddle_tpu_torch.ops.quant_gemm import quant_gemm_plain
    return _proj(x, w.to(x.dtype)) if s is None else \
        quant_gemm_plain(x, w, s)


def _gemm_cases_vs_plain(device, kind, x_dtype, cases, seed):
    """``gemm_into`` at each (K, F, R) into a strided slot (row stride F +
    48) whose neighbours must stay untouched, held per element, per row
    and per 64 x 64 tile against the plain GEMM. Returns the plans."""
    from paddle_tpu_torch.ops import quant_gemm as qg
    gen = torch.Generator(device=device).manual_seed(seed)
    plans, weights = [], {}
    for K, F, R in cases:
        if (K, F) not in weights:
            weights.clear()
            weights[(K, F)] = _gemm_weight(gen, K, F, kind, device)
        w, s = weights[(K, F)]
        x = torch.randn(R, K, generator=gen, device=device).to(x_dtype)
        wide = torch.full((R, F + 48), 7.0, dtype=x_dtype, device=device)
        qg.gemm_into(x, w, s, wide[:, 16:16 + F])
        torch.cuda.synchronize()
        plans.append(qg.plan(R, K, F, w.dtype, x_dtype, device.index or 0))
        got = wide[:, 16:16 + F]
        readings = qg.error_vs_plain(got, _gemm_plain(x, w, s))
        assert bool(torch.isfinite(got).all()), (kind, K, F, R)
        assert qg.within_tolerance(readings, x_dtype), (kind, K, F, R,
                                                        readings)
        assert bool((wide[:, :16] == 7).all() and
                    (wide[:, 16 + F:] == 7).all()), (kind, K, F, R)
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8", "bf16"])
def test_quant_gemm_tensor_core_kernel_matches_plain_on_card(cuda_device,
                                                             kind):
    """bf16 x against int8, fp8 and bf16 weights: every row count of
    TC_ROWS at every shape of TC_SHAPES, and the head's width at
    TC_WIDE_ROWS, into a strided slot; every call runs the tensor-core
    kernel (plan mode 1), with and without a k split."""
    cases = [(K, F, R) for K, F in TC_SHAPES for R in TC_ROWS] + \
        [TC_WIDE + (R,) for R in TC_WIDE_ROWS]
    plans = _gemm_cases_vs_plain(cuda_device, kind, torch.bfloat16, cases,
                                 seed=21)
    assert {p[0] for p in plans} == {1}
    assert {p[2] > 1 for p in plans} == {True, False}
    assert {p[1] for p in plans} == {8, 16, 32, 64, 128}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GEMM_KINDS)
def test_quant_gemm_stream_kernel_matches_plain_on_card(cuda_device, kind):
    """fp32 x (the LM head's) against every weight type: row groups 1 to
    16 and past them, K of one k16 slice and past a 256-row chunk, F not a
    multiple of a strip, into a strided slot; every call runs the stream
    kernel (plan mode 0)."""
    cases = [(K, 2064, R) for K in (16, 2064) for R in (1, 7, 9, 17)]
    plans = _gemm_cases_vs_plain(cuda_device, kind, torch.float32, cases,
                                 seed=22)
    assert {p[0] for p in plans} == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_quant_gemm_gives_the_same_bits_on_every_call_on_card(cuda_device,
                                                              kind):
    """Split launches (8 rows of the out and down shapes: partial tiles
    added in split order by a second pass) and unsplit ones (256 rows of
    up; 300 rows of qkv over three row blocks): the same bits on two
    calls."""
    from paddle_tpu_torch.ops import quant_gemm as qg
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    splits = set()
    for K, F, R in ((2048, 2048, 8), (8192, 2048, 8), (2048, 8192, 256),
                    (2048, 6144, 300)):
        w, s = _gemm_weight(gen, K, F, kind, cuda_device)
        x = torch.randn(R, K, generator=gen, device=cuda_device).to(
            torch.bfloat16)
        outs = [torch.empty(R, F, dtype=torch.bfloat16, device=cuda_device)
                for _ in range(2)]
        for o in outs:
            qg.gemm_into(x, w, s, o)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), (kind, K, F, R)
        splits.add(qg.plan(R, K, F, w.dtype, torch.bfloat16,
                           cuda_device.index or 0)[2] > 1)
    assert splits == {True, False}


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


# ---------------------------------------------------- speculative decoding
# The verify dispatch runs [B, k+1] windows: at 8 slots and k = 4 the
# quantized GEMMs take 40 rows (bf16 x for the blocks, fp32 for the head),
# and each of the k+1 lanes reads the pool at the plain decode's shape.
VERIFY_ROWS = 40
VERIFY_LANES = 5
VERIFY_POS = [0, 11, 12, 27, 507, 1019, 1500, 2043]   # lane 0; +4 fits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quant_gemm_at_the_verify_rows_matches_plain_on_card(cuda_device,
                                                             dtype):
    """Every 1.3B block shape at 40 bf16 rows (the tensor-core kernel) and
    the LM head at 40 fp32 rows (the stream kernel), per element, row and
    tile against the plain version, one launch a call."""
    from paddle_tpu_torch.ops.quant_gemm import (error_vs_plain, quant_gemm,
                                                 quant_gemm_plain,
                                                 within_tolerance)
    rng = np.random.default_rng(14)
    for K, F in QUANT_GEMM_SHAPES:
        xdt = torch.float32 if F == 50304 else torch.bfloat16
        wq, s = _quantized_weight(rng, K, F, dtype, cuda_device)
        x = torch.from_numpy(rng.standard_normal((VERIFY_ROWS, K)).astype(
            np.float32)).to(cuda_device, xdt)
        before = quant_gemm.launches
        got = quant_gemm(x, wq, s)
        torch.cuda.synchronize()
        assert quant_gemm.launches == before + 1
        assert got.dtype == xdt and bool(torch.isfinite(got).all())
        readings = error_vs_plain(got, quant_gemm_plain(x, wq, s))
        assert within_tolerance(readings, xdt), (K, F, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", POOL_KINDS)
def test_paged_decode_per_lane_verify_reads_match_plain_on_card(cuda_device,
                                                                kind):
    """The verify's attention read: lane t of 8 slots at position pos + t
    (over page edges, to the table's last position) through rows 1-2,
    one call a lane, each within 1e-3 of the plain version."""
    from paddle_tpu_torch.serving import paged_decode as pd
    args = _decode_args(cuda_device, kind, 8,
                        [p + VERIFY_LANES - 1 for p in VERIFY_POS], seed=50)
    fn = pd.paged_decode_attention if kind == "bfloat16" else \
        pd.paged_decode_attention_q
    plain = pd.paged_decode_plain if kind == "bfloat16" else \
        pd.paged_decode_q_plain
    base = torch.tensor(VERIFY_POS, dtype=torch.int32, device=cuda_device)
    before = fn.launches
    for t in range(VERIFY_LANES):
        lane = list(args)
        lane[4] = base + t
        got = fn(*lane, 16)
        torch.testing.assert_close(got, plain(*lane, 16), rtol=1e-3,
                                   atol=1e-3)
    assert fn.launches == before + VERIFY_LANES


def _small_gpt(device):
    from paddle_tpu_torch.models import GPTConfig, init_gpt_params
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    return cfg, init_gpt_params(cfg, seed=0, device=device,
                                dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_spec_engine_verifies_through_the_kernels_on_card(cuda_device,
                                                          quant):
    """A small speculative engine (k = 4, int8 self-draft) on the card:
    every decode dispatch is a verify dispatch launching the paged-decode
    kernel once per layer per lane; its quantized GEMMs run the kernel at
    4 x 5 rows (the verify) and 4 rows (the draft), none of the plain
    [4, 1] decode; the first greedy token of each request is the plain
    engine's."""
    from paddle_tpu_torch.ops.quant_gemm import quant_gemm
    from paddle_tpu_torch.serving import (Engine, Request,
                                          reset_serving_counters,
                                          serving_counters)
    from paddle_tpu_torch.serving.paged_decode import (
        paged_decode_attention, paged_decode_attention_q)
    cfg, params = _small_gpt(cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77, 130)]
    runs = []
    for k in (4, 0):
        eng = Engine(params=params, config=cfg, num_slots=4, prefill_chunk=64,
                     device=cuda_device, quant=quant, speculate_k=k)
        reset_serving_counters()
        for f in (paged_decode_attention, paged_decode_attention_q,
                  quant_gemm):
            f.launches = 0
        quant_gemm.shapes.clear()
        reqs = [Request(p, max_new_tokens=9) for p in prompts]
        res = eng.run(reqs)
        c = serving_counters()
        runs.append([res[r.request_id].tokens for r in reqs])
        assert eng.pool.balance()["refcounts_accounted"]
        if not k:
            continue
        L = cfg.num_layers
        assert c["decode_dispatches"] == c["verify_dispatches"] > 0
        reads = c["verify_dispatches"] * L * (k + 1)
        decode = paged_decode_attention if quant is None else \
            paged_decode_attention_q
        other = paged_decode_attention_q if quant is None else \
            paged_decode_attention
        assert decode.launches == reads and other.launches == 0
        rows = {}
        for (R, _, _), n in quant_gemm.shapes.items():
            rows[R] = rows.get(R, 0) + n
        assert rows.get(4, 0) == c["draft_dispatches"] * k * (4 * L + 1)
        assert rows.get(4 * (k + 1), 0) == (
            0 if quant is None else c["verify_dispatches"] * (4 * L + 1))
        assert 0 < c["draft_dispatches"] <= c["verify_dispatches"]
    for a, b in zip(*runs):
        assert len(a) == len(b) == 9 and a[0] == b[0]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_kv_rewind_restores_the_pre_dispatch_bytes_on_card(cuda_device,
                                                           quant):
    """A verify window of 5 lanes over 4 slots through the kernels, then a
    rewind to 1..4 accepted lanes: every pool byte (page 0 aside) is the
    pre-dispatch byte except at the accepted positions, which were
    written."""
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.paged_attention import (
        _raw, paged_kv_rewind, paged_verify_forward)
    cfg, params = _small_gpt(cuda_device)
    eng = Engine(params=params, config=cfg, num_slots=4, prefill_chunk=64,
                 device=cuda_device, quant=quant)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for pool in (eng._kc, eng._vc):      # stale values everywhere
        a = torch.randn(pool.shape, generator=gen, device=cuda_device)
        if quant is None:
            pool.copy_(a)
        else:
            _raw(pool).copy_((a * 40).round().clamp(-127, 127).to(
                torch.int8).view(torch.uint8))
    before = [p.view(torch.uint8).clone() for p in (eng._kc, eng._vc)]
    i32 = dict(dtype=torch.int32, device=cuda_device)
    table = torch.arange(1, 17, **i32).view(4, 4)
    start = torch.tensor([3, 14, 30, 47], **i32)
    valid = torch.full((4,), 5, **i32)
    n_emit = torch.tensor([1, 2, 3, 4], **i32)
    ids = torch.randint(0, 512, (4, 5), generator=gen, device=cuda_device)
    logits, sk, sv = paged_verify_forward(
        eng.params, cfg, ids, eng._kc, eng._vc, start, valid, table, 16,
        use_kernel=True, kv_scales=eng._kv_scales,
        wq_kernel=eng.quant_kernel)
    paged_kv_rewind(eng._kc, eng._vc, sk, sv, table, start, valid, n_emit,
                    16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits[torch.arange(4), n_emit.long() - 1])
                .all())
    accepted = torch.zeros(eng._kc.shape[1:3], dtype=torch.bool,
                           device=cuda_device)
    for b in range(4):
        for t in range(int(n_emit[b])):
            p = int(start[b]) + t
            accepted[int(table[b, p // 16]), p % 16] = True
    for pool, old in zip((eng._kc, eng._vc), before):
        same = (pool.view(torch.uint8) == old).flatten(3).all(
            dim=(0, 3))                                          # [P, ps]
        assert bool(same[1:][~accepted[1:]].all())
        assert not bool(same[accepted].any())


# the tensor-parallel serving slice's GEMMs at mp = 4 over GPT-3 1.3B:
# (K, F/4) of the out and down projections (bf16 x) and the LM head shard
# (fp32 x)
MP_GEMM_SHAPES = [(2048, 512), (8192, 512)]
MP_HEAD_SHAPE = (2048, 12576)
# a launch with enough output tiles (256 rows x 8192) for the tensor-core
# kernel to store without a k split, so the block's own epilogue writes
# the strided slot (a split launch's second pass writes it otherwise)
MP_DIRECT_SHAPE = (2048, 8192)


class _StubGroup:
    """A rank of an n-rank group without a process group, for the
    refusals that come before any group or channel is reached."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank


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
def test_fused_gemm_ag_wrapper_on_card(cuda_device, w_dtype, gemm_ag_runs):
    """The wrapper on 2 and 4 ranks sharing the card (and on 4 cards where
    the machine has them), each rank's shard its own: at the out shard of
    mp = 4 the [R, n * F] result within the plain version's gates, bit
    for bit the ranks' ``gemm_into`` blocks all-gathered in rank order;
    refusals, before any channel opens, for what the kernel does not
    take."""
    from paddle_tpu_torch.ops import fused_collectives as fc
    for run, outs in gemm_ag_runs.items():
        for o in outs:
            got = [(case, ok) for case, _, ok in o["readings"]
                   if case[0] in ("plain", "exact") and case[1] == w_dtype
                   and case[2] == "out"]
            assert len(got) == 10 and all(ok for _, ok in got), (run, got)
    rng = np.random.default_rng(13)
    K, F = MP_GEMM_SHAPES[0]
    w, s = _mp_weight(rng, K, F, w_dtype, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2, 4, K)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    group = _StubGroup(4, 1)
    before = (fc.fused_gemm_ag.calls, fc.fused_gemm_ag.launches)
    with pytest.raises(ValueError, match="not contiguous"):
        fc.fused_gemm_ag(x.transpose(0, 1), w, group, s)
    if s is None:
        with pytest.raises(ValueError, match="takes no scale"):
            fc.fused_gemm_ag(x, w, group, torch.ones(F, device=cuda_device))
    else:
        with pytest.raises(ValueError, match="needs a float32 scale"):
            fc.fused_gemm_ag(x, w, group, None)
    assert (fc.fused_gemm_ag.calls, fc.fused_gemm_ag.launches) == before


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
    shape whose chunk is not a whole number of tiles (rows 7 and 9: 48 and
    192 rows against 128-row tiles; A and F past the tiles' edges) and one
    of several tiles; two launches a call (rows 7 and 9: the pull and the
    GEMM; row 8: the GEMM and the reduce)."""
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
    """fp32 operands, a width that is not a multiple of 16, a
    non-contiguous operand, row 9's chunk of s rows that is not a
    multiple of its 64-row k step, and groups of 1 and 9 ranks (the peer
    channels take 2 to 8) raise before any channel opens; nothing falls
    back to a ring or to NCCL, and no launch is counted."""
    import types
    from paddle_tpu_torch.ops import ring_gemm
    group = types.SimpleNamespace(n=2, rank=0, device=torch.device(
        cuda_device), peer_channels={})
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    x = torch.zeros(2, 16, 64, **bf)
    w = torch.zeros(64, 32, **bf)
    before = [(k.calls, k.launches) for k in ring_gemm.KERNELS]
    with pytest.raises(ValueError, match="not bfloat16"):
        ring_gemm.ring_ag_gemm(x.float(), w.float(), group)
    with pytest.raises(ValueError, match="columns 40 not a multiple of 16"):
        ring_gemm.ring_ag_gemm(x, torch.zeros_like(w[:, :8]).repeat(1, 5),
                               group)
    with pytest.raises(ValueError, match="not contiguous"):
        ring_gemm.ring_ag_gemm(x.transpose(0, 1), w, group)
    r = torch.zeros(2, 96, 64, **bf)
    with pytest.raises(ValueError, match="96 rows per batch row is not a "
                                         "multiple of 64"):
        ring_gemm.ring_ag_accum(r, torch.zeros(2, 192, 32, **bf), group)
    with pytest.raises(ValueError, match="not bfloat16"):
        ring_gemm.ring_ag_accum(x.float(), torch.zeros(
            2, 32, 32, device=cuda_device), group)
    for n in (1, 9):
        g = types.SimpleNamespace(n=n, rank=0, device=group.device,
                                  peer_channels={})
        with pytest.raises(ValueError, match=f"a group of {n} ranks"):
            ring_gemm.ring_ag_gemm(x, w, g)
        with pytest.raises(ValueError, match=f"a group of {n} ranks"):
            ring_gemm.ring_ag_accum(torch.zeros(2, 64, 64, **bf),
                                    torch.zeros(2, 64 * n, 32, **bf), g)
        assert not g.peer_channels
    assert not group.peer_channels
    assert [(k.calls, k.launches) for k in ring_gemm.KERNELS] == before


@pytest.mark.cuda
def test_pp_boundary_kernels_match_plain_on_card(cuda_device, tmp_path):
    """Rows 14 (y = r + (x @ w + b)) and 15 (dr = gy + gwire, dx, dw) of
    ``ops/pp_boundary.py`` against their plain versions on two ranks
    sharing the card over gloo: per element and per 128-row tile, dr and
    db bit for bit, at ``CARD_SHAPES`` (ragged tiles of the 128 x 256
    wgmma tiling in every dimension, and several full tiles); the
    boundary op's hop delivers y byte for byte; one launch a row-14
    call, two a row-15 call (the add, then both products' GEMM)."""
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
        assert o["counts"]["gemm_pprecv"] == (n, 2 * n)


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
    """The peer-buffer card checks (``torch_dp_train_ranks.card_rows``:
    row 8's, rows 7 and 9's, rows 12-13's, then rows 10-11's) on 2 and 4
    gloo ranks sharing the card (the ``shared`` layout), one spawn per
    degree for all the tests below: {n: the ranks' results}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernel, no CPU mode)")
    import torch_dp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import fused_collectives as fc
    from paddle_tpu_torch.ops import ring_gemm
    fc.build_rs_bucket()         # once, here: the ranks only load them
    fc.build_ag_bucket()
    fc.build_gemm_ag()
    ring_gemm.build()
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
def test_rows_10_11_survive_a_late_peer_on_card(cuda_device, shared_rows):
    """On two and four ranks sharing the card, with the barrier timeout
    shortened to 1.5 s, the last rank sleeps three timeouts between two
    calls (``torch_dp_train_ranks.card_late``): the others wait in rows
    10 and 11's entry barriers through it (longer than two timeouts)
    without giving up, no rank's error record is set, and all three
    results equal their plain rings bit for bit."""
    import torch_dp_train_ranks as ranks
    for n, outs in shared_rows.items():
        lates = [o["late"] for o in outs]
        assert [o["late"] for o in lates] == [False] * (n - 1) + [True]
        for r, o in enumerate(lates):
            assert all(same for _, same in o["readings"]), (n, r, o)
            assert o["code"] == 0, (n, r, o)
            if not o["late"]:
                assert o["waited"] > 2 * ranks.LATE_TIMEOUT_S, (n, r, o)


@pytest.mark.cuda
def test_peer_channels_close_and_reopen_on_card(cuda_device, shared_rows):
    """Rows 10-11's channels on two and four ranks sharing the card: open,
    closed, reopened and closed again. Each process holds 2 (n - 1) peer
    mappings while both channels are open and none after each close, the
    group keeps no channel and no heartbeat after a close, and the calls
    after the reopen
    still equal their plain rings."""
    for n, outs in shared_rows.items():
        for o in (o["teardown"] for o in outs):
            assert all(o["readings"]), (n, o["readings"])
            assert o["mappings"] == [0, 2 * (n - 1), 0, 2 * (n - 1), 0], n


# ------------------------------------------- row 8 over the peer buffers
@pytest.fixture(scope="module")
def row8_runs(shared_rows, tmp_path_factory):
    """Row 8's card checks (``torch_tp_train_ranks.card_row8``) on 2 and 4
    gloo ranks sharing the card (from the ``shared_rows`` spawns) and,
    where the machine has 4 cards, on 4 NCCL ranks with a card each:
    {(layout, n): the ranks' results}."""
    import torch_tp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    runs = {("shared", n): [o["row8"] for o in outs]
            for n, outs in shared_rows.items()}
    if torch.cuda.device_count() >= 4:
        runs[("per_card", 4)] = env.launch(
            4, ranks.card_row8, 8, layout="per_card", timeout_s=600,
            init_dir=tmp_path_factory.mktemp("row8per_card"))
    return runs


@pytest.mark.cuda
def test_row8_matches_plain_on_card(cuda_device, row8_runs):
    """NN and NT at every ``ROW8_SHAPES`` (tile edges, several tiles, a
    main-path chunk) on every layout the machine has: per element and per
    128-row tile against ``gemm_rs_plain`` (its gates, ops/ring_gemm.py),
    two launches a call (the GEMM and the reduce)."""
    import torch_tp_train_ranks as ranks
    calls = 2 * 2 * len(ranks.ROW8_SHAPES) + ranks.ROW8_REUSE_CALLS
    for run, outs in row8_runs.items():
        for o in outs:
            for case, r, ok in o["readings"]:
                if case[0] == "plain":
                    assert ok, (run, case, r)
            assert o["counts"] == (calls, 2 * calls), run


@pytest.mark.cuda
def test_row8_gives_the_same_bits_on_every_call_on_card(cuda_device,
                                                        row8_runs):
    """A second call of each case, and every one of the back-to-back calls
    (modes and shapes alternating, the slots reused by call parity, no
    host synchronisation between them), gives the first call's bits."""
    for run, outs in row8_runs.items():
        for o in outs:
            for case, _, same in o["readings"]:
                if case[0] in ("same bits", "reuse"):
                    assert same, (run, case)


@pytest.mark.cuda
def test_row8_survives_a_late_peer_on_card(cuda_device, row8_runs):
    """With the channel's timeout shortened to 1.5 s the last rank sleeps
    three timeouts before a call; the others wait for its partial in
    their reduce (longer than two timeouts) without giving up, no rank's
    error record is set, and every rank's result is the same bits as
    that case's first call."""
    import torch_tp_train_ranks as ranks
    for run, outs in row8_runs.items():
        n = len(outs)
        assert [o["late"] for o in outs] == [False] * (n - 1) + [True]
        for r, o in enumerate(outs):
            assert o["code"] == 0, (run, r)
            late = [same for case, _, same in o["readings"]
                    if case[0] == "late"]
            assert late == [True], (run, r)
            if not o["late"]:
                assert o["waited"] > 2 * ranks.ROW8_LATE_TIMEOUT_S, (run, r)


@pytest.mark.cuda
def test_row8_gone_peer_leaves_a_filled_record_on_card(cuda_device,
                                                       tmp_path):
    """Row 8 on two ranks sharing the card, called by rank 0 alone while
    its peer's process ends a second after the group barrier: rank 0's
    reduce waits for the peer's partial, gives up once the peer's
    heartbeat has stood still for the 2 s timeout, fills the error record
    (code 1, row 8, rank 0, the reduce's wait, call 1, peer 1) and traps;
    synchronising raises and the next call names it."""
    import torch_tp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import ring_gemm
    ring_gemm.build()            # once, here: the ranks only load it
    outs = env.launch(2, ranks.card_row8_gone_peer, 2.0, layout="shared",
                      timeout_s=300, init_dir=tmp_path)
    got = outs[0]
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 1 and rec["row"] == 8 and rec["rank"] == 0, rec
    assert rec["at_end"] == 1 and rec["epoch"] == 1 and rec["peer"] == 1, rec
    assert got["seconds"] < 30, got
    assert "row 8: rank 0's reduce's wait for a partial at epoch 1" in \
        got["next_call"]
    assert "the process is gone" in got["next_call"]
    assert outs[1:] == [{}]


# -------------------------------------- rows 7 and 9 over the peer buffers
@pytest.fixture(scope="module")
def ag_runs(shared_rows, tmp_path_factory):
    """Rows 7 and 9's card checks (``torch_tp_train_ranks.card_ag``) on 2
    and 4 gloo ranks sharing the card (from the ``shared_rows`` spawns)
    and, where the machine has 4 cards, on 4 NCCL ranks with a card each:
    {(layout, n): the ranks' results}."""
    import torch_tp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    runs = {("shared", n): [o["ag"] for o in outs]
            for n, outs in shared_rows.items()}
    if torch.cuda.device_count() >= 4:
        runs[("per_card", 4)] = env.launch(
            4, ranks.card_ag, 9, layout="per_card", timeout_s=600,
            init_dir=tmp_path_factory.mktemp("agper_card"))
    return runs


@pytest.mark.cuda
def test_rows_7_9_match_plain_on_card(cuda_device, ag_runs):
    """Rows 7 (NN, NT) and 9 (plain, transposed) at every ``AG_SHAPES`` /
    ``ACCUM_SHAPES`` (a chunk under one tile or 1.5 tiles with A and F
    past the tiles' edges, several tiles, a main-path chunk) on every
    layout the machine has: per element and per 128-row tile against the
    plain rings (their gates, ops/ring_gemm.py), two launches a call (the
    pull and the GEMM)."""
    import torch_tp_train_ranks as ranks
    n_ag = 2 * len(ranks.AG_SHAPES)                 # the cases of each row
    n_cases = n_ag + 2 * len(ranks.ACCUM_SHAPES)
    reuse_ag = sum((5 * i) % n_cases < n_ag
                   for i in range(ranks.AG_REUSE_CALLS))
    calls = {"ring_ag_gemm": 2 * n_ag + reuse_ag,
             "ring_ag_accum": 2 * (n_cases - n_ag) + ranks.AG_REUSE_CALLS -
             reuse_ag}
    for run, outs in ag_runs.items():
        for o in outs:
            for case, r, ok in o["readings"]:
                if case[0] == "plain":
                    assert ok, (run, case, r)
            for name, c in calls.items():
                assert o["counts"][name] == (c, 2 * c), run


@pytest.mark.cuda
def test_rows_7_9_give_the_same_bits_on_every_call_on_card(cuda_device,
                                                           ag_runs):
    """A second call of each case, and every one of the back-to-back calls
    (rows, modes and shapes alternating, the slots reused by call parity,
    no host synchronisation between them), gives the first call's
    bits."""
    for run, outs in ag_runs.items():
        for o in outs:
            for case, _, same in o["readings"]:
                if case[0] in ("same bits", "reuse"):
                    assert same, (run, case)


@pytest.mark.cuda
def test_rows_7_9_survive_a_late_peer_on_card(cuda_device, ag_runs):
    """With the channels' timeout shortened to 1.5 s the last rank sleeps
    three timeouts before a row-7 and a row-9 call; the others wait for
    its chunk (longer than two timeouts) without giving up, no rank's
    error record is set, and both results are the same bits as their
    cases' first calls."""
    import torch_tp_train_ranks as ranks
    for run, outs in ag_runs.items():
        n = len(outs)
        assert [o["late"] for o in outs] == [False] * (n - 1) + [True]
        for r, o in enumerate(outs):
            assert o["code"] == 0, (run, r)
            late = [same for case, _, same in o["readings"]
                    if case[0] == "late"]
            assert late == [True, True], (run, r)
            if not o["late"]:
                assert o["waited"] > 2 * ranks.AG_LATE_TIMEOUT_S, (run, r)


@pytest.mark.cuda
def test_row7_gone_peer_leaves_a_filled_record_on_card(cuda_device,
                                                       tmp_path):
    """Row 7 on two ranks sharing the card, called by rank 0 alone while
    its peer's process ends a second after the group barrier: rank 0's
    pull publishes its chunk, then its wait for the peer's chunk (or its
    GEMM's wait for the gathered chunk) gives up once the peer's
    heartbeat has stood still for the 2 s timeout, fills the error record
    (code 1, row 7, rank 0, call 1, peer 1) and traps; synchronising
    raises and the next call names it."""
    import torch_tp_train_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import ring_gemm
    ring_gemm.build()            # once, here: the ranks only load it
    outs = env.launch(2, ranks.card_ag_gone_peer, 2.0, layout="shared",
                      timeout_s=300, init_dir=tmp_path)
    got = outs[0]
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 1 and rec["row"] == 7 and rec["rank"] == 0, rec
    assert rec["at_end"] in (1, 2) and rec["epoch"] == 1, rec
    assert rec["peer"] == 1, rec
    assert got["seconds"] < 30, got
    where = ("pull's wait for a peer's chunk" if rec["at_end"] == 1 else
             "GEMM's wait for a gathered chunk")
    assert f"row 7: rank 0's {where} at epoch 1" in got["next_call"]
    assert "the process is gone" in got["next_call"]
    assert outs[1:] == [{}]


# ------------------------------------- rows 12-13 over the peer buffers
@pytest.fixture(scope="module")
def gemm_ag_runs(shared_rows, tmp_path_factory):
    """Rows 12-13's card checks (``torch_mp_ranks.card_gemm_ag``) on 2 and
    4 gloo ranks sharing the card (from the ``shared_rows`` spawns) and,
    where the machine has 4 cards, on 4 NCCL ranks with a card each:
    {(layout, n): the ranks' results}."""
    import torch_mp_ranks as ranks
    from paddle_tpu_torch.distributed import env
    runs = {("shared", n): [o["gemm_ag"] for o in outs]
            for n, outs in shared_rows.items()}
    if torch.cuda.device_count() >= 4:
        runs[("per_card", 4)] = env.launch(
            4, ranks.card_gemm_ag, 10, layout="per_card", timeout_s=600,
            init_dir=tmp_path_factory.mktemp("gemm_ag_per_card"))
    return runs


@pytest.mark.cuda
def test_rows_12_13_match_plain_on_card(cuda_device, gemm_ag_runs):
    """Every kind (bf16, int8, fp8 shards; an fp32 head shard) at every
    ``GEMM_AG_CARD_CASES`` (ragged rows 1, 5 and 130, decode's 8, a full
    chunk, the down shard, the head shard at fp32 x) on every layout the
    machine has: within ``gemm_ag_plain``'s gates (error_vs_plain), the
    calls and launches counted (the GEMM's one or two and the gather's a
    call)."""
    import torch_mp_ranks as ranks
    n_cases = len(ranks.GEMM_AG_KINDS) * len(ranks.GEMM_AG_CARD_CASES) + 1
    for run, outs in gemm_ag_runs.items():
        for o in outs:
            plain = [(case, r, ok) for case, r, ok in o["readings"]
                     if case[0] == "plain"]
            assert len(plain) == n_cases, run
            assert all(ok for _, _, ok in plain), (run, plain)
            assert o["counts"] == o["want_counts"], run


@pytest.mark.cuda
def test_rows_12_13_are_gemm_into_and_an_exact_all_gather_on_card(
        cuda_device, gemm_ag_runs):
    """Each case's result is bit for bit this rank's ``gemm_into`` block
    (row 3's kernel into a buffer of its own) and every rank's, gathered
    through the group in rank order: the same bytes on every rank."""
    for run, outs in gemm_ag_runs.items():
        for o in outs:
            exact = [(case, ok) for case, _, ok in o["readings"]
                     if case[0] == "exact"]
            assert exact and all(ok for _, ok in exact), (run, exact)


@pytest.mark.cuda
def test_rows_12_13_back_to_back_calls_on_card(cuda_device, gemm_ag_runs):
    """``GEMM_AG_REUSE_CALLS`` calls back to back on changing inputs, kinds
    and shapes (the slots reused by call parity, no host synchronisation
    between them), every collective of the group and of
    ``torch.distributed`` made to raise: none is called, and each result
    is bit for bit its ``gemm_into`` blocks all-gathered."""
    import torch_mp_ranks as ranks
    for run, outs in gemm_ag_runs.items():
        for o in outs:
            assert o["refused"] is None, (run, o["refused"])
            reuse = [ok for case, _, ok in o["readings"]
                     if case[0] == "reuse"]
            assert reuse == [True] * ranks.GEMM_AG_REUSE_CALLS, (run, reuse)


@pytest.mark.cuda
def test_rows_12_13_wait_for_a_late_peer_on_card(cuda_device, gemm_ag_runs):
    """With the channel's timeout shortened to 1.5 s the last rank sleeps
    three timeouts before a call; the others' gathers wait for its block
    (longer than two timeouts) without giving up, no rank's error record
    is set, and every result is the same bits as the case's first call."""
    import torch_mp_ranks as ranks
    for run, outs in gemm_ag_runs.items():
        n = len(outs)
        assert [o["late"] for o in outs] == [False] * (n - 1) + [True]
        for r, o in enumerate(outs):
            assert o["code"] == 0, (run, r)
            late = [ok for case, _, ok in o["readings"] if case[0] == "late"]
            assert late == [True], (run, r)
            if not o["late"]:
                assert o["waited"] > 2 * ranks.GEMM_AG_LATE_TIMEOUT_S, \
                    (run, r)


@pytest.mark.cuda
def test_row12_gone_peer_leaves_a_filled_record_on_card(cuda_device,
                                                        tmp_path):
    """Row 12 on two ranks sharing the card, called by rank 0 alone while
    its peer's process ends a second after the group barrier: rank 0's
    gather publishes its block, then its wait for the peer's block gives
    up once the peer's heartbeat has stood still for the 2 s timeout,
    fills the error record (code 1, row 12, rank 0, the gather's wait,
    call 1, peer 1) and traps; synchronising raises and the next call
    names it."""
    import torch_mp_ranks as ranks
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import fused_collectives as fc
    fc.build_gemm_ag()           # once, here: the ranks only load it
    outs = env.launch(2, ranks.card_gemm_ag_gone_peer, 2.0, layout="shared",
                      timeout_s=300, init_dir=tmp_path)
    got = outs[0]
    rec = got["record"]
    assert got["raised"], got
    assert rec["code"] == 1 and rec["row"] == 12 and rec["rank"] == 0, rec
    assert rec["at_end"] == 0 and rec["epoch"] == 1 and rec["peer"] == 1, rec
    assert got["seconds"] < 30, got
    assert ("row 12: rank 0's gather's wait for a peer's block at epoch 1"
            in got["next_call"])
    assert "the process is gone" in got["next_call"]
    assert outs[1:] == [{}]


@pytest.mark.cuda
def test_row8_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """A chunk that is not a multiple of the 128-row tile, fp32 operands,
    a width that is not a multiple of 16, a strided operand and groups of
    1 and 9 ranks raise before any channel opens; nothing falls back to
    a ring or to NCCL, and no launch is counted."""
    import types
    from paddle_tpu_torch.ops import ring_gemm as rg
    dev = torch.zeros(1, device=cuda_device).device
    bf = dict(device=cuda_device, dtype=torch.bfloat16)

    def group(n):
        return types.SimpleNamespace(n=n, rank=0, device=dev,
                                     peer_channels={})

    g2 = group(2)
    y, w = torch.zeros(2, 256, 64, **bf), torch.zeros(64, 32, **bf)
    before = (rg.ring_gemm_rs.calls, rg.ring_gemm_rs.launches)
    with pytest.raises(ValueError, match="not a multiple of 128"):
        rg.ring_gemm_rs(torch.zeros(2, 96, 64, **bf), w, g2)
    with pytest.raises(ValueError, match="not bfloat16"):
        rg.ring_gemm_rs(y.float(), w.float(), g2)
    with pytest.raises(ValueError, match="not a multiple of 16"):
        rg.ring_gemm_rs(y[..., :40].contiguous(), w[:40], g2)
    with pytest.raises(ValueError, match="not contiguous"):
        rg.ring_gemm_rs(y, w.t().contiguous().t(), g2)
    for n in (1, 9):
        with pytest.raises(ValueError, match=f"a group of {n} ranks"):
            rg.ring_gemm_rs(torch.zeros(2, 128 * n, 64, **bf), w, group(n))
    assert not g2.peer_channels
    assert (rg.ring_gemm_rs.calls, rg.ring_gemm_rs.launches) == before
