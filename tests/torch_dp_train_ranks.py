"""Per-rank functions of tests/test_torch_dp_train.py and
tests/test_torch_grad_comm.py (and of the rows 10-11 card tests in
tests/test_torch_cuda_kernels.py), run by
``paddle_tpu_torch.distributed.env.launch`` in spawned ranks, one per
data-parallel replica. A spawned child imports the module that holds its
function, so this module imports neither jax nor the reference package:
the JAX side runs in the test process and arrives here as numpy."""
import numpy as np
import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import grad_comm as gc
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     layer_params_from_numpy)
from paddle_tpu_torch.models.gpt import gpt_loss_fn
from paddle_tpu_torch.ops import fused_collectives as fc
from paddle_tpu_torch.optimizer import AdamW

DEFAULT_FLAGS = {"FLAGS_grad_comm": "auto",
                 "FLAGS_weight_update_sharding": False,
                 "FLAGS_allreduce_dtype": "float32",
                 "FLAGS_grad_bucket_bytes": 16 * 2 ** 20,
                 "FLAGS_comm_backend": ""}
AR = {"FLAGS_grad_comm": "on", "FLAGS_weight_update_sharding": False}
RS = {"FLAGS_grad_comm": "on", "FLAGS_weight_update_sharding": True}
FUSED = {"FLAGS_comm_backend": "dp=fused",
         "FLAGS_weight_update_sharding": True}

# the mini GPT of the dp tests (fp32; remat on, so every block runs under
# the dots_no_batch preset, as the reference's eager GPT does)
GPT_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=32, use_flash=False, compute_dtype="float32")
LR = {"mlp": 0.01, "mlp16": 0.01, "gpt": 1e-3}
STEPS = 3
WIRE_STEPS = 20

# (name, flags, clip, accumulate_steps) of the rungs held against the
# reference's TrainStep; clip: None | ("global", c) | ("norm", c) |
# ("value", c)
RUNGS = (("ar", AR, None, 1), ("rs", RS, None, 1), ("fused", FUSED, None, 1),
         ("off", {}, None, 1),
         ("clip-global", RS, ("global", 0.05), 1),
         ("clip-norm", RS, ("norm", 0.05), 1),
         ("clip-value", RS, ("value", 0.01), 1),
         ("accum2", RS, None, 2), ("accum2-ar", AR, None, 2))
# rungs held inside the port only (bitwise, counters, compressed wires)
EXTRA = (("rs-4096", dict(RS, FLAGS_grad_bucket_bytes=4096), None, 1),
         ("fused-4096", dict(FUSED, FLAGS_grad_bucket_bytes=4096), None, 1),
         ("ar-clip-global", AR, ("global", 0.05), 1),
         ("fused-accum2", FUSED, None, 2))
# (name, model, flags, steps) of the compressed wires: the ring rung's
# all-to-all wires on tests/test_grad_comm.py's MLP over 20 steps, and the
# fused rung's bf16 ring on tests/test_fused_collectives.py's (_dp_model,
# 4 steps: its _dp_train)
WIRES = (("wire-fp32", "mlp", RS, WIRE_STEPS),
         ("wire-bf16", "mlp", dict(RS, FLAGS_allreduce_dtype="bfloat16"),
          WIRE_STEPS),
         ("wire-int8", "mlp", dict(RS, FLAGS_allreduce_dtype="int8"),
          WIRE_STEPS),
         ("wire-fused-fp32", "mlp16", FUSED, 4),
         ("wire-fused-bf16", "mlp16",
          dict(FUSED, FLAGS_allreduce_dtype="bfloat16"), 4))


def clip_of(spec):
    if spec is None:
        return None
    kind, c = spec
    return {"global": nn.ClipGradByGlobalNorm, "norm": nn.ClipGradByNorm,
            "value": nn.ClipGradByValue}[kind](c)


def build_model(kind, init):
    """The MLP of tests/test_grad_comm.py ("mlp") or of
    tests/test_fused_collectives.py ("mlp16"), or the mini GPT, with the
    reference's initial weights ``init`` ({name: array})."""
    if kind == "mlp":
        m = nn.Sequential(nn.Linear(64, 64), nn.ReLU(), nn.Linear(64, 8))
        loss = nn.MSELoss()
    elif kind == "mlp16":
        m = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 8))
        loss = nn.MSELoss()
    else:
        m = GPTForCausalLM(GPTConfig(**GPT_KW))
        loss = gpt_loss_fn
    return layer_params_from_numpy(m, init), loss


def _np(t):
    return t.detach().cpu().numpy().copy()


def train(group, kind, init, batch, flags, clip=None, k=1, steps=STEPS):
    """``steps`` calls of the port's TrainStep on this replica's slice of
    ``batch`` (inputs, labels): (losses, final params, the step)."""
    set_flags(dict(DEFAULT_FLAGS))
    set_flags(flags)
    model, loss_fn = build_model(kind, init)
    opt = AdamW(LR[kind], parameters=model.parameters(),
                grad_clip=clip_of(clip))
    step = TrainStep(model, loss_fn, opt, group=group, accumulate_steps=k,
                     device="cpu" if group is None else None)
    x, y = batch
    n = 1 if group is None else group.n
    r = 0 if group is None else group.rank
    b = x.shape[0] // n
    sl = slice(r * b, (r + 1) * b)
    losses = [float(step(torch.from_numpy(x[sl]), torch.from_numpy(y[sl])))
              for _ in range(steps)]
    set_flags(dict(DEFAULT_FLAGS))
    return losses, {n_: _np(p) for n_, p in step.params.items()}, step


def run_rung(group, kind, init, batch, spec, steps=STEPS):
    name, flags, clip, k = spec
    gc.reset_comm_counters()
    losses, params, step = train(group, kind, init, batch, flags, clip, k,
                                 steps)
    cfg = step._gc_cfg
    out = {"losses": losses, "params": params,
           "counters": gc.comm_counters()}
    if cfg is not None:
        out["plan"] = {"fingerprint": cfg.plan.fingerprint(),
                       "buckets": len(cfg.plan.buckets),
                       "float_buckets": sum(b.dtype.is_floating_point
                                            for b in cfg.plan.buckets)}
        out["records"] = {t: vars(r) for t, r in step._comm_records.items()}
        out["slot_shapes"] = sorted({tuple(v.shape) for sl in
                                     step.opt_state["slots"].values()
                                     for v in sl.values()})
        out["accum_shapes"] = None if step._grad_accum is None else sorted(
            {tuple(v.shape) for v in step._grad_accum.values()})
    return out


def checks(group, inputs):
    """Every rung of the dp tests on this replica: {model: {rung:
    readings}}."""
    torch.set_num_threads(1)
    out = {}
    for kind in ("mlp", "gpt"):
        init, batch = inputs[kind]["init"], inputs[kind]["batch"]
        out[kind] = {spec[0]: run_rung(group, kind, init, batch, spec)
                     for spec in RUNGS + EXTRA}
    return {"rank": group.rank, "models": out}


def wires(group, inputs):
    """Every wire of ``WIRES`` on its model."""
    torch.set_num_threads(1)
    return {name: run_rung(group, kind, inputs[kind]["init"],
                           inputs[kind]["batch"], (name, flags, None, 1),
                           steps) for name, kind, flags, steps in WIRES}


def collectives(group, cases):
    """Rows 10 and 11's plain rings and the compressed reduce on this
    rank's own buckets: for each (cols, seed) case, the rank's x (n, cols)
    (drawn from seed + rank) and what ``rs_bucket_plain`` (fp32 and bf16
    wires), ``fused_rs_bucket`` (its CPU path), the library's
    reduce-scatter and ``_quantized_reduce_row`` (bf16, int8) return, and
    what ``ag_bucket_plain`` and ``fused_ag_bucket`` (its CPU path) gather
    of row ``rank`` of x."""
    n, r = group.n, group.rank
    out = []
    for cols, seed in cases:
        x = np.random.default_rng(seed + r).standard_normal(
            (n, cols)).astype(np.float32)
        t = torch.from_numpy(x)
        row = {"x": x}
        for wire in ("float32", "bfloat16"):
            wd = getattr(torch, wire)
            row[f"plain-{wire}"] = _np(fc.rs_bucket_plain(t, group, wd))
            row[f"fused-{wire}"] = _np(fc.fused_rs_bucket(t, group, wd))
        lib = torch.empty(cols)
        row["library"] = _np(group.reduce_scatter_into(lib, t.reshape(-1)))
        row["quant-bfloat16"] = _np(gc._quantized_reduce_row(
            t, group, torch.bfloat16))
        row["quant-int8"] = _np(gc._quantized_reduce_row(t, group,
                                                         torch.int8))
        row["gather-plain"] = _np(fc.ag_bucket_plain(t[r], group))
        row["gather-fused"] = _np(fc.fused_ag_bucket(t[r].clone(), group))
        out.append(row)
    return out


# ------------------------------------------------------------- on the card
CARD_COLS = (3, 512, 1536, 2560, 4099, 1 << 20)
# rows 10-11's operand dtypes: fp32 and bf16 gradient parts, fp32 and bf16
# wires; fp32 param rows and bf16 serving activations
PART_DTYPES = (torch.float32, torch.bfloat16)
WIRE_DTYPES = (torch.float32, torch.bfloat16)
REUSE_CALLS = 200


def card_ring(group, seed):
    """Row 10 across ranks that share a card over gloo: for each width of
    ``CARD_COLS``, each part dtype and each wire, the one-launch kernel
    against the plain ring bit for bit, this rank's own bucket drawn from
    seed + rank; one launch a call. Returns the readings and the
    counts."""
    dev = group.device
    readings = []
    fc.reset_rs_bucket_counts()
    for cols in CARD_COLS:
        g = torch.Generator(device=dev).manual_seed(seed + group.rank)
        x = torch.randn((group.n, cols), generator=g, device=dev)
        for part in PART_DTYPES:
            for wire in WIRE_DTYPES:
                xp = x.to(part)
                got = fc.fused_rs_bucket(xp, group, wire)
                want = fc.rs_bucket_plain(xp, group, wire)
                torch.cuda.synchronize()
                readings.append(((cols, str(part), str(wire)),
                                 bool(torch.equal(got, want))))
    return {"readings": readings,
            "counts": (fc.fused_rs_bucket.calls,
                       fc.fused_rs_bucket.launches)}


def card_ag_ring(group, seed):
    """Row 11 across ranks that share a card over gloo: for each width of
    ``CARD_COLS``, fp32 and bf16, the one-launch kernel against the plain
    ring bit for bit, this rank's own row drawn from seed + rank; one
    launch a call. Returns the readings and the counts."""
    dev = group.device
    readings = []
    fc.reset_ag_bucket_counts()
    for cols in CARD_COLS:
        g = torch.Generator(device=dev).manual_seed(seed + group.rank)
        row = torch.randn(cols, generator=g, device=dev)
        for dtype in PART_DTYPES:
            got = fc.fused_ag_bucket(row.to(dtype), group)
            want = fc.ag_bucket_plain(row.to(dtype), group)
            torch.cuda.synchronize()
            readings.append(((cols, str(dtype)), bool(torch.equal(got, want))))
    return {"readings": readings,
            "counts": (fc.fused_ag_bucket.calls, fc.fused_ag_bucket.launches)}


def reuse_widths(n):
    """``REUSE_CALLS`` bucket widths in a bucket plan's order (the mini GPT
    at 4096-byte buckets), a 1M-col bucket (a grid of many blocks, and a
    staging that must grow) and odd widths mixed in."""
    model = GPTForCausalLM(GPTConfig(**GPT_KW))
    plan = gc.BucketPlan.build(dict(model.named_parameters()), n, 4096)
    widths = [b.cols for b in plan.buckets] + [1 << 20, 3, 4099]
    return [widths[i % len(widths)] for i in range(REUSE_CALLS)]


def card_reuse(group, seed):
    """``REUSE_CALLS`` back-to-back calls of rows 10 and 11 (alternating)
    with no host synchronisation between them, at ``reuse_widths``; every
    other row-10 bucket packed straight into the staging, the others
    copied in by the wrapper. Each call's inputs are kept; after the last
    call, every result against its plain ring bit for bit. A rank that
    overwrote its staging while a peer still read it, or a barrier that
    let a rank run ahead, shows as a mismatch."""
    dev = group.device
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)
    calls = []
    fc.reset_rs_bucket_counts()
    fc.reset_ag_bucket_counts()
    for i, cols in enumerate(reuse_widths(group.n)):
        wire = WIRE_DTYPES[i // 2 % 2]
        if i % 2:
            row = torch.randn(cols, generator=g, device=dev)
            calls.append(("ag", row, None, fc.fused_ag_bucket(row, group)))
            continue
        x = torch.randn((group.n, cols), generator=g, device=dev)
        if i % 4 == 0:
            stage = fc.rs_bucket_staging(group, x.shape, x.dtype)
            stage.copy_(x)
            got = fc.fused_rs_bucket(stage, group, wire)
        else:
            got = fc.fused_rs_bucket(x, group, wire)
        calls.append(("rs", x, wire, got))
    torch.cuda.synchronize()
    counts = ((fc.fused_rs_bucket.calls, fc.fused_rs_bucket.launches),
              (fc.fused_ag_bucket.calls, fc.fused_ag_bucket.launches))
    readings = []
    for i, (kind, t, wire, got) in enumerate(calls):
        want = fc.rs_bucket_plain(t, group, wire) if kind == "rs" else \
            fc.ag_bucket_plain(t, group)
        readings.append(((i, kind, t.shape[-1]), bool(torch.equal(got, want))))
    return {"readings": readings, "counts": counts}


def card_teardown(group, seed):
    """Open rows 10-11's channels, close them, reopen and close again:
    the peer mappings this process holds (2 (n - 1) while both channels
    are open, 0 after each close), the group's channels and heartbeat gone
    after each close, and each reopened call still equal to its plain
    ring."""
    from paddle_tpu_torch.distributed import peer
    dev = group.device
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)
    mappings, readings = [peer.open_mappings()], []
    for _ in range(2):
        x = torch.randn((group.n, 4099), generator=g, device=dev)
        got = fc.fused_rs_bucket(x, group)
        row = torch.randn(4099, generator=g, device=dev)
        got_ag = fc.fused_ag_bucket(row, group)
        torch.cuda.synchronize()
        readings.append(bool(torch.equal(got, fc.rs_bucket_plain(x, group))))
        readings.append(bool(torch.equal(got_ag,
                                         fc.ag_bucket_plain(row, group))))
        mappings.append(peer.open_mappings())
        peer.close(group)
        mappings.append(peer.open_mappings())
        readings.append(not group.peer_channels)
        readings.append(group.peer_beat is None)
    return {"mappings": mappings, "readings": readings}


# the barrier timeout of the late-peer check (seconds) and how late its
# late rank is: three timeouts
LATE_TIMEOUT_S = 1.5
LATE_BY = 3.0


def card_late(group, seed):
    """A late but live peer: rows 10 and 11 with the channels' timeout
    shortened to ``LATE_TIMEOUT_S``. Every rank makes one row-10 call on
    time; then the last rank sleeps ``LATE_BY`` timeouts (its Python idle,
    its heartbeat beating) before its next row-10 and row-11 calls, while
    the others make theirs at once and wait in the kernels' entry
    barriers. Returns the three results against their plain rings bit for
    bit, how long this rank's two late calls took (host clock, to the
    synchronise), whether it was the late rank, and its error record's
    code (0: no wait gave up)."""
    import time
    from paddle_tpu_torch.distributed import peer
    dev, n = group.device, group.n
    g = torch.Generator(device=dev).manual_seed(seed + group.rank)
    xs = [torch.randn((n, 4099), generator=g, device=dev) for _ in range(2)]
    row = torch.randn(4099, generator=g, device=dev)
    fc.rs_bucket_staging(group, (n, 4099), torch.float32)   # both channels
    fc.ag_bucket_staging(group, 4099, torch.float32)
    chans = [group.peer_channels[c] for c in (fc.RS_CHANNEL, fc.AG_CHANNEL)]
    before = [ch.timeout_ns for ch in chans]
    for ch in chans:
        ch.timeout_ns = int(LATE_TIMEOUT_S * 1e9)
    first = fc.fused_rs_bucket(xs[0], group)
    torch.cuda.synchronize(dev)
    group.barrier()
    late = group.rank == n - 1
    if late:
        time.sleep(LATE_BY * LATE_TIMEOUT_S)
    t0 = time.perf_counter()
    second = fc.fused_rs_bucket(xs[1], group)
    gathered = fc.fused_ag_bucket(row, group)
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    for ch, t in zip(chans, before):
        ch.timeout_ns = t
    readings = [
        ("first", bool(torch.equal(first, fc.rs_bucket_plain(xs[0], group)))),
        ("late rs", bool(torch.equal(second,
                                     fc.rs_bucket_plain(xs[1], group)))),
        ("late ag", bool(torch.equal(gathered,
                                     fc.ag_bucket_plain(row, group))))]
    return {"readings": readings, "waited": waited, "late": late,
            "code": peer.error_record()["code"]}


def card_rows(group, seed):
    """Every peer-buffer card check in one spawn: row 8's
    (``torch_tp_train_ranks.card_row8``), rows 7 and 9's (``card_ag``),
    rows 12-13's (``torch_mp_ranks.card_gemm_ag``), then rows 10-11's
    above: the rings, the back-to-back reuse, a late peer, then the
    teardown (which must find the channels open and close them)."""
    import torch_mp_ranks as mp_ranks
    import torch_tp_train_ranks as tp_ranks
    from paddle_tpu_torch.distributed import peer
    out = {"row8": tp_ranks.card_row8(group, seed + 4),
           "ag": tp_ranks.card_ag(group, seed + 5),
           "gemm_ag": mp_ranks.card_gemm_ag(group, seed + 6)}
    out.update({"ring": card_ring(group, seed),
                "ag_ring": card_ag_ring(group, seed),
                "reuse": card_reuse(group, seed + 1),
                "late": card_late(group, seed + 3)})
    peer.close(group)
    out["teardown"] = card_teardown(group, seed + 2)
    return out


# how long the peers of the dead-peer check live on after the group
# barrier: long enough for rank 0's blocks to have signalled them and to
# be waiting
DEAD_AFTER_S = 1.0


def card_forced_timeout(group, cols, timeout_s, backstop_s=None):
    """Row 10 where rank 0 alone calls ``fused_rs_bucket`` and its peers
    never do: every block of rank 0's kernel (a bucket of ``cols``
    columns: a grid of many blocks) waits at the entry barrier for peers
    that never arrive, and traps. With ``backstop_s`` None the peers'
    processes end (``env.exit_rank``, as a crash would: the heartbeat
    thread and the mappings go with them) ``DEAD_AFTER_S`` after the
    group barrier, so the waits give up once the heartbeats have stood
    still for ``timeout_s``; otherwise the peers stay alive and beating
    and the waits give up at the backstop, shortened to ``backstop_s``.
    Returns, on rank 0, what synchronising raised, the error record, what
    the next call raised, and how long the call took to fail (host clock).
    Rank 0's CUDA context is lost, so no rank tears its channel or
    heartbeat down (process exit releases them)."""
    import time
    from paddle_tpu_torch.distributed import env, peer
    dev = group.device
    stage = fc.rs_bucket_staging(group, (group.n, cols), torch.float32)
    stage.fill_(1.0)
    torch.cuda.synchronize(dev)
    group.barrier()
    if backstop_s is None and group.rank != 0:
        time.sleep(DEAD_AFTER_S)
        env.exit_rank({})
    out = {}
    if group.rank == 0:
        ch = group.peer_channels[fc.RS_CHANNEL]
        ch.timeout_ns = int(timeout_s * 1e9)
        if backstop_s is not None:
            ch.backstop_ns = int(backstop_s * 1e9)
        t0 = time.perf_counter()
        fc.fused_rs_bucket(stage, group)
        try:
            torch.cuda.synchronize(dev)
            out["raised"] = None
        except RuntimeError as e:
            out["raised"] = str(e)
        out["seconds"] = time.perf_counter() - t0
        out["record"] = peer.error_record()
        try:
            fc.fused_rs_bucket(stage, group)
            out["next_call"] = None
        except RuntimeError as e:
            out["next_call"] = str(e)
    if backstop_s is not None:
        group.barrier()
    group.peer_channels.clear()
    group.peer_beat = None
    return out


# ------------------------------------------------------- the pull algebra
def pull_algebra(group, cases):
    """The pull kernels' plain algebra against the plain rings on this
    rank's own buckets, for each (cols, seed) case: row 10's
    (``rs_bucket_pull_plain`` against ``rs_bucket_plain``) at fp32 and
    bf16 parts and wires, and row 11's (``ag_bucket_pull_plain`` against
    ``ag_bucket_plain``) on row ``rank`` at fp32 and bf16. Returns
    [(case, equal bit for bit, the rows)] with the rows of the two wires
    kept for one fp32 part."""
    n, r = group.n, group.rank
    out = []
    for cols, seed in cases:
        x = torch.from_numpy(np.random.default_rng(seed + r).standard_normal(
            (n, cols)).astype(np.float32))
        for part in PART_DTYPES:
            xp = x.to(part)
            for wire in WIRE_DTYPES:
                pull = fc.rs_bucket_pull_plain(xp, group, wire)
                ring = fc.rs_bucket_plain(xp, group, wire)
                keep = _np(pull) if part == torch.float32 else None
                out.append((("rs", cols, str(part), str(wire)),
                            torch.equal(pull, ring) and
                            pull.dtype == torch.float32, keep))
        for dtype in PART_DTYPES:
            row = x[r].to(dtype)
            out.append((("ag", cols, str(dtype)),
                        torch.equal(fc.ag_bucket_pull_plain(row, group),
                                    fc.ag_bucket_plain(row, group)), None))
    return out
