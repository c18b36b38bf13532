"""The port's gradient-communication layer and the eager pieces it trains
(paddle_tpu_torch/distributed/grad_comm.py, row 10's plain ring in
ops/fused_collectives.py, distributed/recompute.py's ``dots_no_batch``,
models/gpt.py's eager GPT, models/params.py's Layer-name map) against the
reference, on the CPU.

Held, fp32:

* ``BucketPlan`` against the reference's on the same parameters (the MLP
  of tests/test_grad_comm.py and a mini GPT's Layer params, whose sizes
  leave padding; n = 2, 4, 8; 4096-byte and 16 MiB buckets): entries,
  buckets, ``fingerprint()``, payload and padded bytes, ``reduce_record``
  (fp32, bf16 and int8 wires, one- and two-sided) and ``gather_record``
  equal;
* the eager ``GPTForCausalLM``'s ``named_parameters`` names, shapes and
  order equal the reference Layer's;
* ``resolve`` against the reference's for every combination of the four
  flags and ``dp=ring`` / ``dp=gspmd`` / none (the reference's
  ``dp=fused`` does not import under this image's jax: the port's is
  checked on its own), and its bails;
* row 10's plain ring (``rs_bucket_plain``, and ``fused_rs_bucket``'s CPU
  path) at n = 2, 4 and 8 over gloo against a torch copy of
  ``rs_bucket_reference``'s algebra (fused_collectives.py:1032) bit for
  bit on fp32 and bf16 wires, and against the reference's
  ``psum_scatter`` within 1e-6; the library reduce-scatter likewise;
* rows 10 and 11's pull kernels' algebra (``rs_bucket_pull_plain``,
  ``ag_bucket_pull_plain``) against their plain rings bit for bit at n = 2
  and 4 (fp32 and bf16 parts, wires and rows; 512 and 1,000,003 cols), and
  ``_pack_bucket`` into a staging view against a fresh tensor, byte for
  byte;
* ``_quantized_reduce_row`` (bf16, int8 with 2,048-element chunk scales)
  against the reference's under its shard_map on n of the 8 virtual
  devices: the same wire values, sums within 1e-6;
* ``dots_no_batch``: the gradients of ``full`` and of no remat within
  1e-6, four saved projection outputs a block;
* the eager GPT's loss against the port's functional ``gpt_forward`` + CE
  on the same weights (the Layer-name map) and against the reference's
  eager loss, within 1e-5.
"""
import itertools
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from torch.utils.checkpoint import CheckpointPolicy

import paddle_tpu as paddle
import torch_dp_train_ranks as ranks
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu_torch import nn, to_tensor
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed import grad_comm as gc
from paddle_tpu_torch.distributed import recompute
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, gpt_forward,
                                     layer_params_from_numpy,
                                     layer_params_from_tree,
                                     tree_from_layer_params)
from paddle_tpu_torch.models.gpt import gpt_loss_fn
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW

# a mini GPT whose sizes do not all divide by 8 (V=127, H=36), so plans
# pad
PLAN_GPT = dict(vocab_size=127, hidden_size=36, num_layers=2, num_heads=4,
                max_seq_len=20, use_flash=False, compute_dtype="float32")
DEGREES = (2, 4, 8)
BUCKET_BYTES = (4096, 16 * 2 ** 20)
# (cols, seed) of the collective checks: a tiny row, a 512-col bucket,
# rows that pad to the int8 chunk (2,048) and span three chunks
COLL_CASES = ((3, 0), (512, 10), (2049, 20), (5000, 30))
COLL_TOL = 1e-6
# (cols, seed) of the pull kernels' algebra: a bucket row, an odd width
PULL_CASES = ((512, 40), (1_000_003, 50))
PULL_DEGREES = (2, 4)


def _ref_mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(64, 64), jnn.ReLU(), jnn.Linear(64, 8))


def _port_mlp():
    return nn.Sequential(nn.Linear(64, 64), nn.ReLU(), nn.Linear(64, 8))


def _models(kind, **kw):
    """(reference Layer, port module) of ``kind`` with the reference's
    weights in both."""
    if kind == "mlp":
        ref, port = _ref_mlp(), _port_mlp()
    else:
        cfg = dict(PLAN_GPT, **kw)
        paddle.seed(7)
        ref, port = JaxGPT(JaxGPTConfig(**cfg)), GPTForCausalLM(
            GPTConfig(**cfg))
    layer_params_from_numpy(port, {n: np.asarray(p.numpy())
                                   for n, p in ref.named_parameters()})
    return ref, port


def _ref_params(ref):
    return {n: p._data for n, p in ref.named_parameters()}


# ---------------------------------------------------------------- the plan
def _plan_view(plan, dt):
    entries = {n: (e.shape, dt(e.dtype), e.size, e.cols, e.bucket, e.offset)
               for n, e in plan.entries.items()}
    buckets = [(b.index, dt(b.dtype), b.names, b.cols) for b in plan.buckets]
    return entries, buckets


@pytest.mark.parametrize("bucket_bytes", BUCKET_BYTES)
@pytest.mark.parametrize("n", DEGREES)
@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_bucket_plan_matches_the_reference(kind, n, bucket_bytes):
    ref, port = _models(kind)
    jp = jgc.BucketPlan.build(_ref_params(ref), n, bucket_bytes)
    tp = gc.BucketPlan.build(dict(port.named_parameters()), n, bucket_bytes)
    assert list(tp.entries) == list(jp.entries)
    assert _plan_view(tp, gc.dtype_name) == _plan_view(
        jp, lambda d: str(jnp.dtype(d)))
    assert tp.fingerprint() == jp.fingerprint()
    assert tp.payload_bytes() == jp.payload_bytes()
    assert tp.padded_bytes() == jp.padded_bytes()
    assert tp.padded_bytes(torch.bfloat16) == jp.padded_bytes(jnp.bfloat16)
    for (tw, jw), two in itertools.product(
            ((None, None), (torch.bfloat16, jnp.bfloat16),
             (torch.int8, jnp.int8)), (False, True)):
        assert tp.reduce_record(tw, two_sided=two) == \
            jp.reduce_record(jw, two_sided=two)
    assert tp.gather_record() == jp.gather_record()
    if bucket_bytes == 4096:
        assert len(tp.buckets) > 1


@pytest.mark.parametrize("tie", [False, True])
def test_eager_gpt_parameter_order_is_the_reference_layers(tie):
    ref, port = _models("gpt", tie_embeddings=tie)
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == want
    assert [tuple(p.shape) for p in port.parameters()] == [s for _, s in
                                                           want]
    assert port.num_params() == sum(int(np.prod(s)) for _, s in want)


def test_composed_mode_raises():
    plan = gc.BucketPlan.build({"w": torch.zeros(4, 4)}, 2, 4096)
    for call in (lambda: plan.reduce_record(None, fixed16=True),
                 lambda: plan.gather_record(emulated=True),
                 lambda: gc.all_gather_shards(plan, {}, None, idx=0),
                 lambda: gc.resolve(types.SimpleNamespace(n=2), AdamW(1e-3),
                                    mp=2)):
        set_flags({"FLAGS_grad_comm": "on"})
        try:
            with pytest.raises(NotImplementedError, match="item 14"):
                call()
        finally:
            set_flags(dict(ranks.DEFAULT_FLAGS))


def test_packing_round_trips():
    t = torch.arange(10.0).view(2, 5)
    packed = gc.pack_array(t, 4)
    assert packed.shape == (4, 3) == gc.packed_shape((2, 5), 4)
    assert torch.equal(gc.unpack_array(packed, (2, 5)), t)
    state = {"step": 3, "slots": {"w": {"m": t.clone()}}}
    row = gc.pack_opt_state(state, {"w": t}, 4, rank=1)
    assert row["slots"]["w"]["m"].shape == (1, 3)
    assert torch.equal(row["slots"]["w"]["m"][0], packed[1])
    full = gc.pack_opt_state(state, {"w": t}, 4)
    assert torch.equal(gc.unpack_opt_state(full, {"w": t})["slots"]["w"][
        "m"], t)
    assert torch.equal(gc.unpack_accum(gc.pack_accum({"w": t}, {"w": t}, 4),
                                       {"w": t})["w"], t)
    plan = gc.BucketPlan.build({"w": t}, 4, 4096)
    for r in range(4):
        assert torch.equal(gc.shard_of(plan, "w", t, r), packed[r])


# ------------------------------------------------------------ the resolver
FLAG_GRID = list(itertools.product(
    ("auto", "on", "off"), (False, True),
    ("float32", "bfloat16", "int8", "float16"), ("", "dp=ring", "dp=gspmd")))


def _resolve_both(mode, wus, dtype, backend, port_opt=None, ref_opt=None):
    flags = {"FLAGS_grad_comm": mode, "FLAGS_weight_update_sharding": wus,
             "FLAGS_allreduce_dtype": dtype}
    paddle.set_flags(dict(flags, FLAGS_comm_backend=backend))
    set_flags(dict(flags, FLAGS_comm_backend=backend))
    try:
        mesh = jenv.create_hybrid_mesh(dp=4)
        ref = jgc.resolve(mesh, ref_opt or paddle.optimizer.AdamW(
            1e-3, parameters=_ref_mlp().parameters()))
        port = gc.resolve(types.SimpleNamespace(n=4),
                          port_opt or AdamW(1e-3))
    finally:
        paddle.set_flags({k: v for k, v in ranks.DEFAULT_FLAGS.items()})
        set_flags(dict(ranks.DEFAULT_FLAGS))
        jenv.set_mesh(None)
    return ref, port


def _same_config(ref, port):
    if ref is None or port is None:
        return ref is None and port is None
    wire = None if ref.wire_dtype is None else str(jnp.dtype(ref.wire_dtype))
    return (ref.n, ref.weight_update_sharding, wire, ref.bucket_bytes,
            ref.backend, ref.fused_kernels) == (
        port.n, port.weight_update_sharding,
        None if port.wire_dtype is None else gc.dtype_name(port.wire_dtype),
        port.bucket_bytes, port.backend, port.backend == "fused")


@pytest.mark.parametrize("mode, wus, dtype, backend", FLAG_GRID,
                         ids=["-".join(map(str, c)) for c in FLAG_GRID])
def test_resolve_matches_the_reference(mode, wus, dtype, backend):
    ref, port = _resolve_both(mode, wus, dtype, backend)
    assert _same_config(ref, port), (ref, port)


def test_resolve_fused_and_its_bails():
    """dp=fused resolves to the fused rung (the reference's cannot be
    resolved here); a non-elementwise optimizer under weight-update
    sharding and an unknown clip fall back, as the reference's do; a
    group of one or none keeps the default step."""
    set_flags({"FLAGS_comm_backend": "dp=fused"})
    try:
        cfg = gc.resolve(types.SimpleNamespace(n=4), AdamW(1e-3))
        assert cfg.backend == "fused"
        assert gc.resolve(types.SimpleNamespace(n=1), AdamW(1e-3)) is None
        assert gc.resolve(None, AdamW(1e-3)) is None
    finally:
        set_flags(dict(ranks.DEFAULT_FLAGS))

    class Lamb(AdamW):
        _elementwise_update = False

    ref, port = _resolve_both("on", True, "float32", "",
                              port_opt=Lamb(1e-3),
                              ref_opt=paddle.optimizer.Lamb(
                                  1e-3, parameters=_ref_mlp().parameters()))
    assert ref is None and port is None
    _, port = _resolve_both("on", False, "float32", "", port_opt=Lamb(1e-3))
    assert port is not None        # the replicated update takes any rule
    _, port = _resolve_both("on", True, "float32", "",
                            port_opt=AdamW(1e-3, grad_clip=object()))
    assert port is None


# ---------------------------------------------------- row 10 and the wires
@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    pool = ThreadPoolExecutor(max_workers=len(DEGREES))
    futures = {n: pool.submit(env.launch, n, ranks.collectives, COLL_CASES,
                              layout="cpu", timeout_s=300,
                              init_dir=tmp_path_factory.mktemp(f"coll{n}"))
               for n in DEGREES}
    yield futures
    pool.shutdown(wait=True)


def _ring_reference(xs, wire):
    """A torch copy of ``rs_bucket_reference``'s algebra over every
    replica at once: xs[r] is replica r's (n, cols) bucket; returns each
    replica's row."""
    n = len(xs)
    t = [torch.from_numpy(x) for x in xs]
    acc = [t[r][(r - 1) % n].float() for r in range(n)]
    for step in range(1, n):
        sent = [a.to(wire) for a in acc]
        acc = [sent[(r - 1) % n].float() + t[r][(r - step - 1) % n]
               for r in range(n)]
    return acc


def _ref_collective(fn, xs):
    """``fn(local (n, cols))`` -> (cols,) under the reference's shard_map
    over n of the 8 virtual devices; returns each replica's row."""
    n = len(xs)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    run = jax.jit(jenv.shard_map_compat(fn, mesh, in_specs=P("dp"),
                                        out_specs=P("dp")))
    return np.asarray(run(jnp.asarray(np.concatenate(xs)))).reshape(n, -1)


@pytest.mark.parametrize("case", range(len(COLL_CASES)))
@pytest.mark.parametrize("n", DEGREES)
def test_rs_bucket_plain_is_the_reference_ring(collective_runs, n, case):
    outs = [o[case] for o in collective_runs[n].result()]
    xs = [o["x"] for o in outs]
    psum = _ref_collective(lambda x: lax.psum_scatter(
        x, "dp", scatter_dimension=0, tiled=True).reshape(-1), xs)
    for wire in ("float32", "bfloat16"):
        want = _ring_reference(xs, getattr(torch, wire))
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[f"plain-{wire}"], want[r])
            np.testing.assert_array_equal(o[f"fused-{wire}"], want[r])
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["plain-float32"], psum[r],
                                   rtol=COLL_TOL, atol=COLL_TOL)
        np.testing.assert_allclose(o["library"], psum[r], rtol=COLL_TOL,
                                   atol=COLL_TOL)
        if n > 2:     # a bf16 accumulator rounds at every hop
            assert not np.array_equal(o["plain-bfloat16"],
                                      o["plain-float32"])


@pytest.mark.parametrize("case", range(len(COLL_CASES)))
@pytest.mark.parametrize("n", DEGREES)
def test_ag_bucket_plain_is_the_reference_gather(collective_runs, n, case):
    """Row 11's plain ring (and the wrapper's CPU path) gathers row
    ``rank`` of every replica's bucket in rank order, bit for bit as the
    reference's ``all_gather`` of the same rows does."""
    outs = [o[case] for o in collective_runs[n].result()]
    xs = [o["x"] for o in outs]
    want = _ref_collective(lambda x: lax.all_gather(
        x[lax.axis_index("dp")], "dp").reshape(-1), xs)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["gather-plain"].reshape(-1), want[r])
        np.testing.assert_array_equal(o["gather-fused"].reshape(-1), want[r])


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", range(len(COLL_CASES)))
@pytest.mark.parametrize("n", DEGREES)
def test_quantized_reduce_row_matches_the_reference(collective_runs, n, case,
                                                    wire):
    outs = [o[case] for o in collective_runs[n].result()]
    xs = [o["x"] for o in outs]
    jwire = getattr(jnp, wire)
    want = _ref_collective(
        lambda x: jgc._quantized_reduce_row(x, "dp", jwire), xs)
    scale = np.abs(want).max()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"quant-{wire}"], want[r], rtol=0,
                                   atol=COLL_TOL * max(scale, 1.0))


# ------------------------------------- rows 10-11's pull kernels' algebra
@pytest.fixture(scope="module")
def pull_runs(tmp_path_factory):
    pool = ThreadPoolExecutor(max_workers=len(PULL_DEGREES))
    futures = {n: pool.submit(env.launch, n, ranks.pull_algebra, PULL_CASES,
                              layout="cpu", timeout_s=300,
                              init_dir=tmp_path_factory.mktemp(f"pull{n}"))
               for n in PULL_DEGREES}
    yield futures
    pool.shutdown(wait=True)


def _pull_readings(pull_runs, n, kind, cols):
    return [[(case, same, keep) for case, same, keep in o
             if case[0] == kind and case[1] == cols]
            for o in pull_runs[n].result()]


@pytest.mark.parametrize("cols", [c for c, _ in PULL_CASES])
@pytest.mark.parametrize("n", PULL_DEGREES)
def test_rs_bucket_pull_algebra_is_the_plain_ring(pull_runs, n, cols):
    """Row 10's pull kernel computes row ``rank`` from every rank's bucket
    in the ring's order and roundings (``rs_bucket_pull_plain``): bit for
    bit ``rs_bucket_plain`` at fp32 and bf16 parts and wires, an odd width
    included; the bf16 wire's rounding shows (it differs from the fp32
    wire's row where n > 2)."""
    for readings in _pull_readings(pull_runs, n, "rs", cols):
        assert len(readings) == 4
        for case, same, _ in readings:
            assert same, case
        rows = {case[3]: keep for case, _, keep in readings
                if keep is not None}
        assert set(rows) == {"torch.float32", "torch.bfloat16"}
        if n > 2:
            assert not np.array_equal(rows["torch.float32"],
                                      rows["torch.bfloat16"])


@pytest.mark.parametrize("cols", [c for c, _ in PULL_CASES])
@pytest.mark.parametrize("n", PULL_DEGREES)
def test_ag_bucket_pull_algebra_is_the_plain_ring(pull_runs, n, cols):
    """Row 11's pull kernel copies every rank's row into its slot
    (``ag_bucket_pull_plain``): bit for bit ``ag_bucket_plain`` at the fp32
    of the dp param rows and the bf16 of serving's activations."""
    for readings in _pull_readings(pull_runs, n, "ag", cols):
        assert [case[2] for case, _, _ in readings] == [
            "torch.float32", "torch.bfloat16"]
        for case, same, _ in readings:
            assert same, case


def test_peer_barrier_timeout_keeps_five_heartbeats():
    """A channel refuses a barrier timeout under five heartbeat periods (a
    wait reads the heartbeat every quarter of its timeout, so a shorter one
    could take a live peer for gone) and takes one of five; stopping the
    heartbeat of a process that never mapped one does nothing (it loads
    no library, so it is safe in a failing CPU rank)."""
    from paddle_tpu_torch.distributed import peer
    assert peer.MIN_TIMEOUT_S == 5 * peer.BEAT_PERIOD_S
    assert min(peer.TIMEOUT_S.values()) >= peer.MIN_TIMEOUT_S
    ch = peer.Channel.__new__(peer.Channel)
    with pytest.raises(ValueError, match="five heartbeats"):
        ch.timeout_ns = int(peer.MIN_TIMEOUT_S * 1e9) - 1
    ch.timeout_ns = int(peer.MIN_TIMEOUT_S * 1e9)
    assert ch.timeout_ns == 500_000_000
    peer.stop_heartbeat()


@pytest.mark.parametrize("n", DEGREES)
@pytest.mark.parametrize("kind", ["mlp", "gpt"])
def test_pack_bucket_into_a_staging_view_gives_the_same_bytes(kind, n):
    """``_pack_bucket`` into a view of a larger byte buffer (as row 10's
    peer staging is one) writes the bytes it returns into a fresh tensor,
    for every bucket of a plan (one- and many-member buckets, padded
    tails), and returns the view itself."""
    _, port = _models(kind)
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(
        i)) for i, (k, p) in enumerate(port.named_parameters())}
    plan = gc.BucketPlan.build(dict(port.named_parameters()), n, 4096)
    assert any(len(b.names) > 1 for b in plan.buckets)
    staging = torch.full((1 << 16,), 0xAB, dtype=torch.uint8)
    for b in plan.buckets:
        fresh = gc._pack_bucket(plan, b, grads)
        nbytes = fresh.numel() * fresh.element_size()
        view = staging[:nbytes].view(b.dtype).view(n, b.cols)
        got = gc._pack_bucket(plan, b, grads, view)
        assert got.data_ptr() == staging.data_ptr()
        assert torch.equal(staging[:nbytes], fresh.reshape(-1).view(
            torch.uint8)), b.names


# ---------------------------------------------------- the eager GPT, remat
@pytest.mark.parametrize("other", ["full", "nothing"])
def test_dots_no_batch_saves_the_projections_and_keeps_the_gradients(
        other, monkeypatch):
    """The eager GPT's blocks under dots_no_batch (config.remat) against
    the same blocks under ``other``: the same loss, gradients within 1e-6;
    a dots_no_batch forward saves the qkv, out, up and down outputs of
    each block and nothing else."""
    cfg = dict(PLAN_GPT, num_layers=3)
    ref, _ = _models("gpt", num_layers=3)
    init = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg["vocab_size"], (2, 16)))
    # remat off in the config: the wrappers below choose each policy
    model = GPTForCausalLM(GPTConfig(**dict(cfg, remat=False)))
    layer_params_from_numpy(model, init)
    blocks = model.gpt.h
    saved = _count_saved(monkeypatch)
    out = {}
    for policy in ("dots_no_batch", other):
        # GPTModel.forward with each block under ``policy``
        model.gpt.h = torch.nn.ModuleList(
            _Remat(b, policy) for b in blocks)
        saved["count"] = 0
        loss = gpt_loss_fn(model(ids), ids)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[policy] = (float(loss), grads, saved["count"])
    model.gpt.h = blocks
    # config.remat runs every block under dots_no_batch itself
    eager = GPTForCausalLM(GPTConfig(**cfg))
    layer_params_from_numpy(eager, init)
    saved["count"] = 0
    assert float(gpt_loss_fn(eager(ids), ids)) == out["dots_no_batch"][0]
    assert saved["count"] == 4 * cfg["num_layers"]
    assert out["dots_no_batch"][0] == out[other][0]
    assert out["dots_no_batch"][2] == 4 * cfg["num_layers"]
    assert out[other][2] == 0
    for a, b in zip(out["dots_no_batch"][1], out[other][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["config", "full"])
def test_dropout_under_remat_gives_the_gradients_without_remat(policy):
    """The eager GPT with dropout 0.1: its blocks under remat (the
    config's dots_no_batch, or "full") give the loss and gradients of the
    same blocks without remat from the same generator state, because the
    recompute draws the forward's masks again; afterwards the generators
    stand where the run without remat left them."""
    cfg = dict(PLAN_GPT, num_layers=2, dropout=0.1)
    ref, _ = _models("gpt", num_layers=2)
    init = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg["vocab_size"], (2, 16)))
    out = {}
    for remat in (False, True):
        model = GPTForCausalLM(GPTConfig(
            **dict(cfg, remat=remat and policy == "config")))
        layer_params_from_numpy(model, init)
        if remat and policy != "config":
            model.gpt.h = torch.nn.ModuleList(
                _Remat(b, policy) for b in model.gpt.h)
        prandom.seed(11)
        loss = gpt_loss_fn(model(ids), ids)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (float(loss.detach()), grads, prandom.philox_key())
    assert out[True][0] == out[False][0]
    assert out[True][2] == out[False][2]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _count_saved(monkeypatch):
    """A count of the outputs dots_no_batch's selective-checkpoint policy
    saves in forward passes (not in the backward's recompute): the policy
    that the checkpoint context calls, wrapped."""
    saved = {"count": 0}
    policy = recompute._no_batch_dots

    def counted(ctx, op, *args, **kwargs):
        choice = policy(ctx, op, *args, **kwargs)
        if choice == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved["count"] += 1
        return choice
    monkeypatch.setattr(recompute, "_no_batch_dots", counted)
    return saved


class _Remat(torch.nn.Module):
    """A block run under a remat policy (its parameters stay the
    block's)."""

    def __init__(self, block, policy):
        super().__init__()
        self.block, self.policy = block, policy

    def forward(self, x):
        return recompute.remat(self.block, self.policy)(x)


def test_eager_gpt_loss_matches_functional_and_reference():
    """The port's eager GPT through the flash kernels' plain versions
    against its functional forward on the same weights (the Layer-name
    map) and against the reference's eager GPT (blockwise attention)."""
    cfg = dict(PLAN_GPT, use_flash=True)
    ref, _ = _models("gpt")
    port = GPTForCausalLM(GPTConfig(**cfg))
    layer_params_from_numpy(port, {n: np.asarray(p.numpy())
                                   for n, p in ref.named_parameters()})
    ids = np.random.default_rng(6).integers(0, cfg["vocab_size"], (2, 20))
    tid = torch.from_numpy(ids)
    eager = port(tid)
    loss = gpt_loss_fn(eager, tid)
    tree = tree_from_layer_params(dict(port.named_parameters()),
                                  GPTConfig(**cfg))
    logits = gpt_forward(tree, tid, GPTConfig(**cfg))
    torch.testing.assert_close(eager, logits.float(), rtol=1e-5, atol=1e-5)
    V = cfg["vocab_size"]
    functional = cross_entropy(logits[:, :-1].reshape(-1, V),
                               tid[:, 1:].reshape(-1))
    want = float(jax_gpt_loss_fn(ref(paddle.to_tensor(ids)),
                                 paddle.to_tensor(ids)).numpy())
    assert float(loss) == pytest.approx(float(functional), rel=1e-5)
    assert float(loss) == pytest.approx(want, rel=1e-5)


def test_layer_name_map_round_trips():
    cfg = GPTConfig(**PLAN_GPT)
    _, port = _models("gpt")
    named = {n: p.detach() for n, p in port.named_parameters()}
    back = layer_params_from_tree(tree_from_layer_params(named, cfg))
    assert set(back) == set(named)
    for n, t in named.items():
        assert torch.equal(back[n], t), n
    with pytest.raises(KeyError, match="missing"):
        layer_params_from_numpy(port, {"lm_head.weight": np.zeros((36, 127))})
    bad = dict(named, **{"gpt.wpe.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        layer_params_from_numpy(port, bad)


def test_eager_layers_follow_the_reference_cast_order():
    """Linear casts its [in, out] weight (and bias) to the input's dtype;
    Dropout is the identity at p=0 and in eval, and above it in training
    zeroes elements and scales the rest by 1 / (1 - p) in x's dtype; the
    cross-entropy skips ignore_index labels."""
    lin = nn.Linear(8, 4)
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    y = lin(x)
    assert y.dtype == torch.bfloat16 and lin.weight.shape == (8, 4)
    assert torch.equal(y, x @ lin.weight.to(torch.bfloat16) +
                       lin.bias.to(torch.bfloat16))
    assert nn.Linear(8, 4, bias_attr=False).bias is None
    assert nn.Dropout(0.0)(x) is x
    drop = nn.Dropout(0.5)
    y = drop(x)
    kept = y != 0
    assert y.dtype == torch.bfloat16 and 0 < int(kept.sum()) < x.numel()
    assert torch.equal(y[kept], (x / 0.5)[kept])
    drop.eval()
    assert drop(x) is x
    logits = torch.randn(4, 5)
    labels = torch.tensor([1, -100, 3, 0])
    keep = labels != -100
    want = torch.nn.functional.cross_entropy(logits[keep], labels[keep])
    torch.testing.assert_close(cross_entropy(logits, labels), want)


def test_to_tensor_places_and_casts():
    t = to_tensor(np.arange(3), dtype="float32", place="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert torch.equal(t, torch.arange(3.0))
    assert to_tensor(t, place="cpu") is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            to_tensor([1.0])


def test_optimizer_takes_parameters_in_the_reference_position():
    m = nn.Linear(2, 2)
    opt = AdamW(1e-3, 0.9, 0.999, 1e-8, m.parameters(), 0.02)
    assert opt._wd == 0.02 and opt.supports_sharded_update()
    p = {"w": torch.ones(3)}
    state = opt.init_state(p)
    opt.apply_gradients(p, {"w": torch.zeros(3)}, state)
    # apply_decay_param_fun=None decays every param (the reference's rule)
    torch.testing.assert_close(p["w"], torch.full((3,), 1 - 1e-3 * 0.02))


def test_uncaught_exceptions_stop_the_heartbeat(monkeypatch):
    """Once a heartbeat is up, an uncaught exception in the main thread
    (sys.excepthook) or in another thread (threading.excepthook) halts it
    and then reaches the hook that was there before."""
    import sys
    import threading
    from paddle_tpu_torch.distributed import peer

    halts, seen = [], []

    class _Lib:
        def peer_beat_halt(self):
            halts.append(1)

    monkeypatch.setattr(peer, "_library", lambda: _Lib())
    monkeypatch.setattr(peer, "_beating", True)
    monkeypatch.setattr(peer, "_hooked", False)
    monkeypatch.setattr(sys, "excepthook",
                        lambda tp, value, tb: seen.append(("main", tp)))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(("thread", args.exc_type)))
    peer._hook_uncaught_exceptions()
    peer._hook_uncaught_exceptions()            # once a process
    sys.excepthook(ValueError, ValueError("x"), None)
    worker = threading.Thread(target=lambda: 1 / 0)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert halts == [1, 1]
    assert seen == [("main", ValueError), ("thread", ZeroDivisionError)]
