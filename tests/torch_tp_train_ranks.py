"""Per-rank functions of tests/test_torch_tp_train.py, run by
``paddle_tpu_torch.distributed.env.launch`` in spawned ranks on the CPU
(gloo). A spawned child imports the module that holds its function, so
this module imports neither jax nor the reference package: the JAX side
runs in the test process and arrives here as numpy."""
import torch

from paddle_tpu_torch.distributed import tp_overlap as tp
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import GPTConfig, HybridTrainStep
from paddle_tpu_torch.models.gpt_hybrid import flatten_params
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fused_collectives as fc
from paddle_tpu_torch.ops import ring_gemm as rg
from paddle_tpu_torch.optimizer import AdamW

# the reference's own tensor-parallel test config (tests/test_tp_overlap.py
# _mini_cfg), run at B=4, S=32
CFG_KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=64, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=True)
RUNGS = ("rsag", "ring", "fused")
STEPS = 5
LR = 1e-3
CLIP = 1.0


def config():
    return GPTConfig(**CFG_KW)


def optimizer():
    return AdamW(LR, grad_clip=ClipGradByGlobalNorm(CLIP))


def _np(t):
    return t.detach().numpy().copy()


def _rows(t, group, n_dim=1):
    """This rank's 1/n block of ``t`` along ``n_dim``."""
    w = t.shape[n_dim] // group.n
    return t.narrow(n_dim, group.rank * w, w).contiguous()


def _grads(fn, inputs, cot):
    """(out, d inputs) of ``fn(*inputs)`` against the cotangent ``cot``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


def ops(group, case):
    """The three rungs of the all-gather + GEMM and the GEMM +
    reduce-scatter on this rank's shards of ``case`` (x [B, S, A], w
    [A, F], y [B, S, F], w2 [F, A], cotangents gy [B, S, F] and gx
    [B, S, A], all fp32): forward, and dx, dw by autograd; and the ring
    weight-gradient kernel's plain version."""
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    x_r = _rows(t["x"], group)                  # seq shard
    w_r = _rows(t["w"], group)                  # column shard
    y_r = _rows(t["y"], group, 2)               # feature-sharded partial
    w2_r = _rows(t["w2"], group, 0)             # row shard
    gy_r = _rows(t["gy"], group, 2)             # [B, S, F/n]
    gx_r = _rows(t["gx"], group)                # [B, s, A]
    out = {}
    ag = {"fused": lambda x, w: fc.fused_ag_gemm(x, w, group),
          "ring": lambda x, w: tp.ring_ag_gemm(x, w, group),
          "rsag": lambda x, w: tp.seq_all_gather(x, group) @ w}
    rs = {"fused": lambda y, w: fc.fused_gemm_rs(y, w, group),
          "ring": lambda y, w: tp.gemm_ring_rs(y, w, group),
          "rsag": lambda y, w: tp.seq_reduce_scatter(y @ w, group)}
    for rung in RUNGS:
        o, (dx, dw) = _grads(ag[rung], (x_r, w_r), gy_r)
        out[f"ag/{rung}"] = (_np(o), _np(dx), _np(dw))
        o, (dy, dw2) = _grads(rs[rung], (y_r, w2_r), gx_r)
        out[f"rs/{rung}"] = (_np(o), _np(dy), _np(dw2))
    out["ag/plain"] = _np(rg.ring_ag_gemm(x_r, w_r, group))
    out["ag/plain_t"] = _np(rg.ring_ag_gemm(gx_r, w2_r, group,
                                            transpose_w=True))
    out["rs/plain"] = _np(rg.ring_gemm_rs(y_r, w2_r, group))
    out["rs/plain_t"] = _np(rg.ring_gemm_rs(gy_r, w_r, group,
                                            transpose_w=True))
    out["accum"] = _np(rg.ring_ag_accum(x_r, gy_r, group))
    out["accum_t"] = _np(rg.ring_ag_accum(gx_r, y_r, group,
                                          transpose=True))
    return out


def steps(group, params, ids, rung):
    """STEPS steps of the tensor-parallel step on ``rung``: the losses,
    this rank's final shards (numpy, flat names), and the mp counters
    against the step's own record."""
    tp.reset_mp_counters()
    step = HybridTrainStep(config(), optimizer(), device="cpu",
                           params=params, group=group, comm_backend=rung)
    before = float(step.loss_only(ids))
    losses = [float(step(ids)) for _ in range(STEPS)]
    rec = step.step_records(tuple(ids.shape))["mp"]
    return {"losses": losses, "loss_only": before,
            "shards": {k: _np(v) for k, v in
                       flatten_params(step.params).items()},
            "counters": tp.mp_counters(),
            "record": {k: getattr(rec, k) for k in (
                "collectives", "ppermute_hops", "fused_dispatches",
                "rs_bytes", "ag_bytes", "activation_bytes")},
            "num_params": step.num_params()}


def flag_rung(group, params, ids):
    """One step whose rung comes from FLAGS_comm_backend (mp=fused)."""
    set_flags({"FLAGS_comm_backend": "mp=fused"})
    try:
        step = HybridTrainStep(config(), optimizer(), device="cpu",
                               params=params, group=group)
        return step._backend(), float(step(ids))
    finally:
        set_flags({"FLAGS_comm_backend": ""})


def checks(group, payload):
    """Everything a rank computes for the test module."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.models import params_from_numpy
    params = params_from_numpy(payload["params"], config(), device="cpu")
    ids = torch.from_numpy(payload["ids"])
    out = {"rank": group.rank, "ops": ops(group, payload["case"])}
    out["steps"] = {rung: steps(group, params, ids, rung)
                    for rung in RUNGS}
    out["flag_rung"] = flag_rung(group, params, ids)
    return out


# the ring kernels' card check: (B, s, A, F) per rank. Row 7: a chunk of
# 48 rows (under one 128-row tile) with A and F past the tiles' edges,
# then several tiles; row 9 (s a multiple of its 64-row k step): a chunk
# of 192 rows (1.5 tiles) with outputs past the edges, then several tiles
CARD_SHAPES = ((2, 24, 96, 48), (2, 256, 512, 384))
ACCUM_CARD_SHAPES = ((3, 64, 96, 48), (2, 256, 512, 384))
# row 8's (its chunk of s rows is a multiple of the 128-row tile): A and F
# past the 256 x 64 tile's edges in the first, several tiles in the second
RS_CARD_SHAPES = ((2, 128, 272, 80), (2, 256, 512, 384))


def card_kernels(group, seed):
    """On the card: each ring kernel, plain and transposed, against its
    plain version on this rank's inputs; returns [(case, readings, ok)]
    and the launch counts."""
    dev = group.device
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rg.reset_counts()
    out = []
    for (B, s, A, Fd), (aB, a_s, aA, aF), rs_shape in zip(
            CARD_SHAPES, ACCUM_CARD_SHAPES, RS_CARD_SHAPES):
        x, gx = rand(B, s, A), rand(B, s, A)
        w, w2 = rand(A, Fd), rand(Fd, A)
        r, gr = rand(aB, a_s, aA), rand(aB, a_s, aA)
        S = group.n * a_s
        y, gy = rand(aB, S, aF), rand(aB, S, aF)
        rB, rs, rA, rF = rs_shape
        ry, rgy = rand(rB, group.n * rs, rF), rand(rB, group.n * rs, rF)
        rw, rw2 = rand(rA, rF), rand(rF, rA)
        cases = {
            "ag_gemm": (rg.ring_ag_gemm(x, w, group),
                        rg.ag_gemm_plain(x, w, group)),
            "ag_gemm_t": (rg.ring_ag_gemm(gx, w2, group, transpose_w=True),
                          rg.ag_gemm_plain(gx, w2, group, True)),
            "gemm_rs": (rg.ring_gemm_rs(ry, rw2, group),
                        rg.gemm_rs_plain(ry, rw2, group)),
            "gemm_rs_t": (rg.ring_gemm_rs(rgy, rw, group, transpose_w=True),
                          rg.gemm_rs_plain(rgy, rw, group, True)),
            "ag_accum": (rg.ring_ag_accum(r, gy, group),
                         rg.ag_accum_plain(r, gy, group)),
            "ag_accum_t": (rg.ring_ag_accum(gr, y, group, transpose=True),
                           rg.ag_accum_plain(gr, y, group, True)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            r_ = rg.error_vs_plain(got, want)
            ok = bool(torch.isfinite(got).all()) and \
                got.shape == want.shape and got.dtype == want.dtype and \
                rg.within_tolerance(r_, got.dtype)
            out.append(((name, B, s, A, Fd), r_, ok))
    counts = {k.__name__: (k.calls, k.launches) for k in rg.KERNELS}
    return {"readings": out, "counts": counts}


# rows 7 and 9's card checks (``card_ag``): (B, s, A, F) per rank, the
# first two as in CARD_SHAPES / ACCUM_CARD_SHAPES, the third a main-path
# chunk (s = 512, A = 2048)
AG_SHAPES = CARD_SHAPES + ((1, 512, 2048, 512),)
ACCUM_SHAPES = ACCUM_CARD_SHAPES + ((1, 512, 2048, 512),)
AG_REUSE_CALLS = 12
AG_LATE_TIMEOUT_S = 1.5             # the late-peer check's timeout
AG_LATE_BY = 3.0                    # how late its late rank is: timeouts


def card_ag(group, seed):
    """Rows 7 and 9 (``ring_ag_gemm``, ``ring_ag_accum``: the pull over
    the peers' slots, then the wgmma GEMM) on the card, every rank its own
    operands: both modes at every ``AG_SHAPES`` / ``ACCUM_SHAPES`` against
    the plain ring (per element and per 128-row tile) and the same bits on
    a second call; ``AG_REUSE_CALLS`` calls back to back, rows, modes and
    shapes alternating, with no host synchronisation (the slots reused by
    call parity), each the same bits as that case's first call; a late
    peer: the last rank sleeps ``AG_LATE_BY`` timeouts of
    ``AG_LATE_TIMEOUT_S`` before a row-7 and a row-9 call while the others
    wait for its chunk, no rank's error record set, both results the same
    bits. Returns the readings, the (calls, launches) of each row, how
    long the late calls took on this rank and whether it was the late
    one."""
    import time
    from paddle_tpu_torch.distributed import peer
    dev, n = group.device, group.n
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rg.reset_counts()
    cases = []
    for B, s, A, Fd in AG_SHAPES:
        x = rand(B, s, A)
        for t in (False, True):
            w = rand(Fd, A) if t else rand(A, Fd)
            cases.append((("ag", B, s, A, Fd, t), rg.ring_ag_gemm,
                          rg.ag_gemm_plain, x, w))
    for B, s, A, Fd in ACCUM_SHAPES:
        r, stat = rand(B, s, A), rand(B, n * s, Fd)
        for t in (False, True):
            cases.append((("accum", B, s, A, Fd, t), rg.ring_ag_accum,
                          rg.ag_accum_plain, r, stat))
    readings, first = [], {}
    for key, kern, plain, a, b in cases:
        got = kern(a, b, group, key[-1])
        again = kern(a, b, group, key[-1])
        want = plain(a, b, group, key[-1])
        torch.cuda.synchronize(dev)
        ok, r_ = _row8_ok(got, want)
        readings.append((("plain",) + key, r_, ok))
        readings.append((("same bits",) + key, None,
                         bool(torch.equal(got, again))))
        first[key] = got
    outs = [(key, kern(a, b, group, key[-1]))
            for i in range(AG_REUSE_CALLS)
            for key, kern, _, a, b in [cases[(5 * i) % len(cases)]]]
    torch.cuda.synchronize(dev)
    for i, (key, got) in enumerate(outs):
        readings.append((("reuse", i) + key, None,
                         bool(torch.equal(got, first[key]))))
    counts = {k.__name__: (k.calls, k.launches)
              for k in (rg.ring_ag_gemm, rg.ring_ag_accum)}
    # the late peer
    late_cases = [cases[2 * len(AG_SHAPES) - 1], cases[-1]]
    ch = group.peer_channels[rg.AG_CHANNEL]     # rows 7 and 9 share it
    before = ch.timeout_ns
    ch.timeout_ns = int(AG_LATE_TIMEOUT_S * 1e9)
    group.barrier()
    late = group.rank == n - 1
    if late:
        time.sleep(AG_LATE_BY * AG_LATE_TIMEOUT_S)
    t0 = time.perf_counter()
    got = [kern(a, b, group, key[-1]) for key, kern, _, a, b in late_cases]
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    ch.timeout_ns = before
    for (key, *_), o in zip(late_cases, got):
        readings.append((("late",) + key, None, bool(torch.equal(o,
                                                                 first[key]))))
    return {"readings": readings, "counts": counts, "waited": waited,
            "late": late, "code": peer.error_record()["code"]}


def card_ag_gone_peer(group, timeout_s):
    """Row 7 where rank 0 alone calls ``ring_ag_gemm`` and its peers'
    processes end ``ROW8_DEAD_AFTER_S`` after the group barrier, as a
    crash would: rank 0's pull publishes its chunk, then its waits for the
    peers' chunks (the pull's, and the GEMM's for the gathered chunk)
    give up once a peer's heartbeat has stood still for ``timeout_s``.
    Returns, on rank 0, what synchronising raised, the error record, what
    the next call raised and how long the call took to fail. Rank 0's
    CUDA context is lost, so no rank tears its channel or heartbeat
    down."""
    import time
    from paddle_tpu_torch.distributed import env, peer
    dev, n = group.device, group.n
    x = torch.ones((1, 128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones((64, 64), device=dev, dtype=torch.bfloat16)
    rg.ag_gemm_plain(x, w, group)           # every rank: the group works
    peer.channel(group, rg.AG_CHANNEL, (2 + n) * x.numel() * 2)
    torch.cuda.synchronize(dev)
    group.barrier()
    if group.rank != 0:
        time.sleep(ROW8_DEAD_AFTER_S)
        env.exit_rank({})
    group.peer_channels[rg.AG_CHANNEL].timeout_ns = int(timeout_s * 1e9)
    out = {}
    t0 = time.perf_counter()
    rg.ring_ag_gemm(x, w, group)
    try:
        torch.cuda.synchronize(dev)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    out["seconds"] = time.perf_counter() - t0
    out["record"] = peer.error_record()
    try:
        rg.ring_ag_gemm(x, w, group)
        out["next_call"] = None
    except RuntimeError as e:
        out["next_call"] = str(e)
    group.peer_channels.clear()
    group.peer_beat = None
    return out


# row 8's card checks (``card_row8``): (B, s, A, F) per rank, the first
# two as in RS_CARD_SHAPES, the third a main-path chunk (s = 512, A = 2048)
ROW8_SHAPES = RS_CARD_SHAPES + ((1, 512, 2048, 512),)
ROW8_REUSE_CALLS = 12
ROW8_LATE_TIMEOUT_S = 1.5           # the late-peer check's barrier timeout
ROW8_LATE_BY = 3.0                  # how late its late rank is: timeouts


def _row8_ok(got, want):
    r = rg.error_vs_plain(got, want)
    return (bool(torch.isfinite(got).all()) and got.shape == want.shape and
            got.dtype == want.dtype and rg.within_tolerance(r, got.dtype)), r


def card_row8(group, seed):
    """Row 8 (``ring_gemm_rs``: the wgmma GEMM storing into the peers'
    slots, then the ring-order reduce) on the card, every rank its own
    operands: NN and NT at every ``ROW8_SHAPES`` against ``gemm_rs_plain``
    (per element and per 128-row tile) and the same bits on a second
    call; ``ROW8_REUSE_CALLS`` calls back to back, modes and shapes
    alternating, with no host synchronisation (the slots reused by call
    parity), each the same bits as that case's first call; a late peer:
    the last rank sleeps ``ROW8_LATE_BY`` timeouts of
    ``ROW8_LATE_TIMEOUT_S`` between two calls while the others wait in
    their reduce, no rank's error record set, the result the same bits.
    Returns the readings, the launch counts, how long the late call took
    on this rank and whether it was the late one."""
    import time
    from paddle_tpu_torch.distributed import peer
    dev, n = group.device, group.n
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rg.reset_counts()
    cases, readings, first = [], [], {}
    for B, s, A, Fd in ROW8_SHAPES:
        y = rand(B, n * s, Fd)
        for t in (False, True):
            w = rand(A, Fd) if t else rand(Fd, A)
            cases.append(((B, s, A, Fd, t), y, w))
    for key, y, w in cases:
        got = rg.ring_gemm_rs(y, w, group, transpose_w=key[-1])
        again = rg.ring_gemm_rs(y, w, group, transpose_w=key[-1])
        want = rg.gemm_rs_plain(y, w, group, key[-1])
        torch.cuda.synchronize(dev)
        ok, r = _row8_ok(got, want)
        readings.append((("plain",) + key, r, ok))
        readings.append((("same bits",) + key, None,
                         bool(torch.equal(got, again))))
        first[key] = got
    outs = [(key, rg.ring_gemm_rs(y, w, group, transpose_w=key[-1]))
            for i in range(ROW8_REUSE_CALLS)
            for key, y, w in [cases[(5 * i) % len(cases)]]]
    torch.cuda.synchronize(dev)
    for i, (key, got) in enumerate(outs):
        readings.append((("reuse", i) + key, None,
                         bool(torch.equal(got, first[key]))))
    counts = (rg.ring_gemm_rs.calls, rg.ring_gemm_rs.launches)
    # the late peer
    key, y, w = cases[-1]
    ch = group.peer_channels[rg.RS_CHANNEL]
    before = ch.timeout_ns
    ch.timeout_ns = int(ROW8_LATE_TIMEOUT_S * 1e9)
    group.barrier()
    late = group.rank == n - 1
    if late:
        time.sleep(ROW8_LATE_BY * ROW8_LATE_TIMEOUT_S)
    t0 = time.perf_counter()
    got = rg.ring_gemm_rs(y, w, group, transpose_w=key[-1])
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    ch.timeout_ns = before
    readings.append((("late",) + key, None, bool(torch.equal(got,
                                                             first[key]))))
    return {"readings": readings, "counts": counts, "waited": waited,
            "late": late, "code": peer.error_record()["code"]}


# how long the peers of the gone-peer check live on after the group
# barrier: long enough for rank 0's GEMM to have stored its tiles
ROW8_DEAD_AFTER_S = 1.0


def card_row8_gone_peer(group, timeout_s):
    """Row 8 where rank 0 alone calls ``ring_gemm_rs`` and its peers'
    processes end ``ROW8_DEAD_AFTER_S`` after the group barrier, as a
    crash would (their heartbeats stop): rank 0's GEMM stores its tiles,
    then its reduce waits for partials that never come and gives up once
    a peer's heartbeat has stood still for ``timeout_s``. Returns, on rank
    0, what synchronising raised, the error record, what the next call
    raised and how long the call took to fail. Rank 0's CUDA context is
    lost, so no rank tears its channel or heartbeat down."""
    import time
    from paddle_tpu_torch.distributed import env, peer
    dev, n = group.device, group.n
    y = torch.ones((1, n * 128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.ones((64, 64), device=dev, dtype=torch.bfloat16)
    rg.gemm_rs_plain(y, w, group)           # every rank: the group works
    peer.channel(group, rg.RS_CHANNEL, 2 * n * 128 * 64 * 4)
    torch.cuda.synchronize(dev)
    group.barrier()
    if group.rank != 0:
        time.sleep(ROW8_DEAD_AFTER_S)
        env.exit_rank({})
    group.peer_channels[rg.RS_CHANNEL].timeout_ns = int(timeout_s * 1e9)
    out = {}
    t0 = time.perf_counter()
    rg.ring_gemm_rs(y, w, group)
    try:
        torch.cuda.synchronize(dev)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    out["seconds"] = time.perf_counter() - t0
    out["record"] = peer.error_record()
    try:
        rg.ring_gemm_rs(y, w, group)
        out["next_call"] = None
    except RuntimeError as e:
        out["next_call"] = str(e)
    group.peer_channels.clear()
    group.peer_beat = None
    return out
