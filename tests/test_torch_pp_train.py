"""The port's pipeline-parallel training (paddle_tpu_torch/distributed/
pipeline.py, comm_backend.resolve_pp, ops/pp_boundary.py, models/gpt.py's
prelude and fused boundary, models/gpt_hybrid.py with ``pp_group=``)
against the reference, on the CPU.

The port is SPMD, one process per stage: ``distributed.env.launch``
spawns gloo ranks, each running ``tests/torch_pp_train_ranks.py:checks``
on its stage. One spawn per pp degree (2 and 4) holds everything the
stages compute; the tests read it. The reference runs here, in the test
process, on the 8-virtual-device mesh: its ``run_pipeline(backend="ring")``
on a single-axis pp mesh (and ``jax.grad`` of it), and its
``HybridTrainStep(mesh=create_hybrid_mesh(pp=n), num_microbatches=M)``
under ``FLAGS_comm_backend='pp=ring'``. Its fused module does not import
under this image's jax (fused_collectives.py:63), so the port's fused
rung is held against the reference's ring rung, and its rows 14-15 plain
versions against a jnp copy of ``gemm_ppsend_reference``'s algebra.
The reference's GSPMD pp schedule carries known defects (its 1F1B
backward, tests/test_pp_backend.py:7-9) and is not a yardstick here.

Held, fp32 (differences are summation order only), the reference's
``_mini`` config (tests/test_pp_backend.py:67-73; 8 layers, H=32, 4
heads, V=128), M = 4 microbatches:

* ``run_pipeline`` at pp = 2, 4 (x [8, 16, 32], loss sum(out^2)): GPipe,
  1F1B and the fused rung's outputs at 1e-6 and block and input gradients
  at rtol 1e-5 / atol 1e-6 of the reference's ring run (its own
  tolerances, test_pp_backend.py:157-161 and :191-194); 1F1B against the
  layer-sequential stack at the reference's own case of that check (one
  layer a stage, M = 8; loss rtol 1e-6, gradients rtol 1e-5 / atol
  1e-6); the fused rung's plain path the ring rung's bits;
* the step (B=8, S=32, AdamW 1e-3, clip 1.0, remat full, 5 steps) on
  ring-gpipe, ring-1f1b and fused: losses at 1e-5 of the reference's
  pp=n ring step and of the port's one-device step, gathered params at
  1e-4 (``PARAM_TOL``, as in tests/test_torch_tp_train.py); every stage
  the same loss; the fused step the ring step's bits;
* the bookkeeping: the ledger against the reference's, the bf16 wire,
  ``resolve_pp``'s gates, the stage split, the prelude + tail block,
  rows 14-15's plain algebra.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import torch_pp_train_ranks as ranks
from paddle_tpu.distributed import comm_backend as jcb
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import pipeline as jpl
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_block_fn as jax_block_fn
from paddle_tpu.models.gpt_hybrid import HybridTrainStep as JaxStep
from paddle_tpu.models.gpt_hybrid import gpt_param_specs as jax_specs
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu_torch.distributed import comm_backend as cb
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed import pipeline as pl
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import HybridTrainStep, params_from_numpy
from paddle_tpu_torch.models.gpt import gpt_block_fn, gpt_block_prelude_fn
from paddle_tpu_torch.models.gpt_hybrid import (flatten_params,
                                                unflatten_params)
from paddle_tpu_torch.models.params import (gather_stage_params,
                                            stage_params)
from paddle_tpu_torch.ops import pp_boundary as ppb

JCFG = JaxGPTConfig(**ranks.CFG_KW)
TCFG = ranks.config()
B, S = 8, 32
XB, XS = 8, 16                   # run_pipeline's x [XB, XS, H]
DEGREES = (2, 4)
OUT_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
RUNG_NAMES = [name for name, _, _ in ranks.RUNGS]
PIPE_NAMES = [name for name, _, _ in ranks.PIPES]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    params = _np(jax_init_params(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int64)
    x = np.random.default_rng(1).standard_normal(
        (XB, XS, JCFG.hidden_size)).astype(np.float32)
    return {"params": params, "ids": ids, "x": x}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """One spawn of n gloo stages per degree running
    ``torch_pp_train_ranks.checks``, started in threads so that they run
    while the reference computes."""
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {n: pool.submit(
        env.launch, n, ranks.checks, inputs, layout="cpu", timeout_s=400,
        init_dir=tmp_path_factory.mktemp(f"pp{n}")) for n in DEGREES}
    yield futures
    pool.shutdown(wait=True)


def _ref_pipes(inputs, n):
    """The reference's ring run_pipeline on an n-device pp mesh, GPipe and
    1F1B: (loss, outputs, block grads, x grad) by jax.value_and_grad."""
    mesh = jenv.create_single_axis_mesh("pp", n, devices=jax.devices()[:n])
    specs = {k: P(*(a if (a is None or a in mesh.axis_names) else None
                    for a in tuple(s)))
             for k, s in jax_specs(JCFG, pp=n)["blocks"].items()}
    blocks = jax.tree_util.tree_map(jnp.asarray, inputs["params"]["blocks"])
    x = jnp.asarray(inputs["x"])
    block = jax_block_fn(JCFG)
    out = {}
    try:
        for sched in ("gpipe", "1f1b"):
            def loss(p, xx, sched=sched):
                o = jpl.run_pipeline(block, p, xx, ranks.M, mesh=mesh,
                                     schedule=sched, backend="ring",
                                     pp_param_specs=specs,
                                     x_spec=P(None, None, None))
                return jnp.sum(o ** 2), o
            with mesh:
                (lv, o), (gp, gx) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(blocks, x)
            out[sched] = (float(lv), np.asarray(o), _np(gp), np.asarray(gx))
    finally:
        jenv.set_mesh(None)
    return out


def _ref_steps(inputs, n, sched):
    """The reference's pp=n ring step: losses and final params."""
    paddle.set_flags({"FLAGS_comm_backend": "pp=ring"})
    try:
        mesh = jenv.create_hybrid_mesh(dp=1, pp=n,
                                       devices=jax.devices()[:n])
        opt = paddle.optimizer.AdamW(
            ranks.LR, grad_clip=paddle.nn.ClipGradByGlobalNorm(ranks.CLIP))
        step = JaxStep(dataclasses.replace(JCFG, pp_schedule=sched), opt,
                       mesh=mesh, num_microbatches=ranks.M, seed=0)
        ids = jnp.asarray(inputs["ids"].astype(np.int32))
        losses = [float(step(ids)) for _ in range(ranks.STEPS)]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jax.device_get(a)), step.params)
    finally:
        paddle.set_flags({"FLAGS_comm_backend": ""})
        jenv.set_mesh(None)
        jpl.reset_pp_counters()
    return losses, flatten_params(params)


@pytest.fixture(scope="module")
def ref(inputs, spawned, devices8):
    """Everything the reference computes, once, while the stages run."""
    return {n: {"pipes": _ref_pipes(inputs, n),
                "steps": {s: _ref_steps(inputs, n, s)
                          for s in ("gpipe", "1f1b")}} for n in DEGREES}


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's mesh-less step on the same weights and ids: losses and
    final params."""
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    step = HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                           params=params)
    ids = torch.from_numpy(inputs["ids"])
    losses = [float(step(ids)) for _ in range(ranks.STEPS)]
    return losses, {k: v.detach().numpy()
                    for k, v in flatten_params(step.params).items()}


def _sequential(inputs, layers):
    """The stack of the first ``layers`` blocks on one device:
    sum(out^2), its block gradients and x's."""
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    blocks = {k: v[:layers].clone().requires_grad_(True)
              for k, v in params["blocks"].items()}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    block = gpt_block_fn(TCFG)
    h = x
    for layer in range(layers):
        h = block({k: v[layer] for k, v in blocks.items()}, h)
    loss = (h ** 2).sum()
    names = list(blocks)
    grads = torch.autograd.grad(loss, [blocks[k] for k in names] + [x])
    return float(loss.detach()), \
        {k: g.numpy() for k, g in zip(names, grads)}, grads[-1].numpy()


@pytest.fixture(scope="module", params=DEGREES, ids=lambda n: f"pp{n}")
def run(request, spawned, ref):
    """(n, every stage's results) of the degree's spawn."""
    return request.param, spawned[request.param].result()


def _stage_rows(a, r, n):
    per = a.shape[0] // n
    return a[r * per:(r + 1) * per]


def _gathered(outs, rung, n):
    parts = [unflatten_params({k: torch.from_numpy(v) for k, v in
                               o["steps"][rung]["params"].items()})
             for o in outs]
    return {k: v.numpy() for k, v in
            flatten_params(gather_stage_params(parts, n)).items()}


# ------------------------------------------------------------- pipeline
@pytest.mark.parametrize("pipe", PIPE_NAMES)
def test_pipeline_outputs_match_reference(run, ref, pipe):
    """The last stage's outputs and loss against the reference's ring
    run_pipeline of the same schedule (the fused rung's against GPipe)."""
    n, outs = run
    sched = "1f1b" if pipe == "1f1b" else "gpipe"
    lv, o_ref, _, _ = ref[n]["pipes"][sched]
    last = outs[-1]["pipes"][pipe]
    np.testing.assert_allclose(last["out"], o_ref, rtol=OUT_TOL,
                               atol=OUT_TOL * np.abs(o_ref).max())
    np.testing.assert_allclose(last["loss"], lv, rtol=OUT_TOL)
    for o in outs[:-1]:
        assert o["pipes"][pipe]["out"] is None


@pytest.mark.parametrize("pipe", PIPE_NAMES)
def test_pipeline_grads_match_reference(run, ref, pipe):
    """Every stage's block gradients (its rows of jax.grad of the
    reference's run) and stage 0's x gradient."""
    n, outs = run
    sched = "1f1b" if pipe == "1f1b" else "gpipe"
    _, _, g_ref, gx_ref = ref[n]["pipes"][sched]
    for o in outs:
        res = o["pipes"][pipe]
        for k, g in res["grads"].items():
            np.testing.assert_allclose(
                g, _stage_rows(g_ref[k], o["rank"], n), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"stage {o['rank']} {k}")
        if o["rank"] == 0:
            np.testing.assert_allclose(res["gx"], gx_ref, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
        else:
            assert res["gx"] is None


def test_1f1b_matches_the_layer_sequential_stack(run, inputs):
    """The reference's own case (tests/test_pp_backend.py:163-194: one
    layer a stage, M = 8, x [8, 16, 32], sum(out^2)) and tolerances."""
    n, outs = run
    loss, grads, gx = _sequential(inputs, n)
    np.testing.assert_allclose(outs[-1]["1f1b-seq"]["loss"], loss,
                               rtol=1e-6)
    for o in outs:
        for k, g in o["1f1b-seq"]["grads"].items():
            np.testing.assert_allclose(
                g, _stage_rows(grads[k], o["rank"], n), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"stage {o['rank']} {k}")
    np.testing.assert_allclose(outs[0]["1f1b-seq"]["gx"], gx,
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_fused_plain_path_is_the_ring_rung_bit_for_bit(run):
    """The reference's own claim (tests/test_pp_backend.py:16), inside the
    port: run_pipeline's outputs and gradients, and the step's losses and
    params after 5 steps."""
    n, outs = run
    for o in outs:
        fused, ring = o["pipes"]["fused"], o["pipes"]["gpipe"]
        if fused["out"] is not None:
            np.testing.assert_array_equal(fused["out"], ring["out"])
        for k in ring["grads"]:
            np.testing.assert_array_equal(fused["grads"][k],
                                          ring["grads"][k], err_msg=k)
        sf, sr = o["steps"]["fused"], o["steps"]["ring-gpipe"]
        assert sf["losses"] == sr["losses"]
        for k in sr["params"]:
            np.testing.assert_array_equal(sf["params"][k], sr["params"][k],
                                          err_msg=k)


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("rung", RUNG_NAMES)
def test_step_matches_reference_pp_step(run, ref, rung):
    n, outs = run
    sched = "1f1b" if rung == "ring-1f1b" else "gpipe"
    want_losses, want = ref[n]["steps"][sched]
    np.testing.assert_allclose(outs[0]["steps"][rung]["losses"],
                               want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    for k, v in _gathered(outs, rung, n).items():
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("rung", RUNG_NAMES)
def test_step_matches_one_device_step(run, one_device, rung):
    n, outs = run
    want_losses, want = one_device
    for o in outs:                    # every stage returns the same loss
        assert o["steps"][rung]["losses"] == \
            outs[0]["steps"][rung]["losses"]
    np.testing.assert_allclose(outs[0]["steps"][rung]["losses"],
                               want_losses, rtol=LOSS_TOL, atol=LOSS_TOL)
    for k, v in _gathered(outs, rung, n).items():
        np.testing.assert_allclose(v, want[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("rung", RUNG_NAMES)
def test_loss_only_is_the_first_steps_loss(run, rung):
    """``loss_only`` before any update computes the first step's forward,
    on every stage."""
    _, outs = run
    for o in outs:
        res = o["steps"][rung]
        assert res["loss_only"] == res["losses"][0]


@pytest.mark.parametrize("rung", RUNG_NAMES)
def test_counters_are_steps_times_the_record(run, rung):
    n, outs = run
    _, backend, sched = dict((r[0], r) for r in ranks.RUNGS)[rung]
    for o in outs:
        res = o["steps"][rung]
        c, rec = res["counters"], res["record"]
        assert c["steps"] == ranks.STEPS
        assert c["backend"] == {"pp": backend[3:]}
        assert (c["schedule"], c["stages"], c["stage"]) == \
            (sched, n, o["rank"])
        for k in ("boundary_bytes", "ppermute_hops", "fused_dispatches"):
            assert c[k] == ranks.STEPS * rec[k], k
        assert res["num_params"] == sum(
            int(np.prod(v.shape)) for v in _gathered(outs, rung, n).values())


def test_flags_choose_the_rung(run, one_device):
    """FLAGS_comm_backend='pp=fused' with comm_backend=None runs the fused
    rung (on GPipe: the config asks for 1F1B); with no pp rung named the
    step runs ring with config.pp_schedule. Both first losses are the
    one-device step's."""
    _, outs = run
    for o in outs:
        assert o["flags"]["fused"][:2] == ("fused", "gpipe")
        assert o["flags"]["none"][:2] == ("ring", "1f1b")
        for name in ("fused", "none"):
            np.testing.assert_allclose(o["flags"][name][2],
                                       one_device[0][0], rtol=LOSS_TOL)


def test_bf16_wire_halves_the_boundary_bytes(run):
    """FLAGS_pp_wire_dtype='bfloat16' under fp32 compute: the boundary
    bytes halve (the reference's test_wire_dtype_halves_boundary_bytes,
    tests/test_pp_backend.py:363) and the first loss moves by bf16
    rounding of the hops only."""
    _, outs = run
    for o in outs:
        full = o["steps"]["ring-gpipe"]["counters"]["boundary_bytes"]
        assert full == ranks.STEPS * 2 * o["wire_bf16"]["boundary_bytes"]
        assert full > 0
        np.testing.assert_allclose(o["wire_bf16"]["losses"][0],
                                   o["steps"]["ring-gpipe"]["losses"][0],
                                   rtol=1e-2)


# ------------------------------------------------------------ bookkeeping
@pytest.mark.parametrize("n", DEGREES)
@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_bubble_fraction_equals_reference(sched, M, n):
    assert pl.bubble_fraction(sched, n, M) == \
        jpl.bubble_fraction(sched, n, M)


def _reference_hops(schedule, S, M):
    """The reference's ppermutes per device per step: every forward tick's
    hop and its transpose (GPipe), or the forward stream plus both hops of
    every combined backward tick (1F1B)."""
    T_fwd = M + S - 1
    if schedule == "1f1b":
        return T_fwd + 2 * (M + 2 * S - 2)
    return 2 * T_fwd


@pytest.mark.parametrize("n", DEGREES)
@pytest.mark.parametrize("backend", ["ring", "fused"])
@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_step_record_against_reference(sched, backend, n):
    """Bubble, hop bytes and schedule equal the reference's record where
    they mean the same; the hops differ by formula: the reference counts
    a hop on every device at every tick (idle ticks and the wrap to stage
    0 included), the port the sends a stage posts (``stage_hops``); the
    reference's RDMA kernels replace its fused hops, the port's post NCCL
    sends beside rows 14-15 (two kernel calls a microbatch on a sending
    stage)."""
    run_sched = "gpipe" if backend == "fused" else sched
    ppc = cb.PpConfig(n=n, backend=backend, schedule=run_sched,
                      wire_dtype=None)
    jppc = jcb.PpConfig(axis="pp", n=n, backend="ring", schedule=run_sched,
                        wire_dtype=None, fused_rdma=False)
    want = jpl.gpt_pp_step_record(JCFG, jppc, B, S, ranks.M)
    hop_bytes = want.boundary_bytes // want.ppermute_hops
    assert want.ppermute_hops == _reference_hops(run_sched, n, ranks.M)
    for s in range(n):
        got = pl.gpt_pp_step_record(TCFG, ppc, B, S, ranks.M, s)
        assert got.bubble_fraction == want.bubble_fraction
        assert (got.schedule, got.stages, got.microbatches) == \
            (run_sched, n, ranks.M)
        hops = pl.stage_hops(run_sched, n, s, ranks.M)
        assert got.ppermute_hops == hops
        assert got.boundary_bytes == hops * hop_bytes
        assert got.fused_dispatches == (
            2 * ranks.M if backend == "fused" and s < n - 1 else 0)
    # over the stages, GPipe sends M activations and M cotangents across
    # each of the n - 1 boundaries; the reference 2(M + n - 1) per device
    total = sum(pl.stage_hops(run_sched, n, s, ranks.M) for s in range(n))
    assert total == (3 if run_sched == "1f1b" else 2) * ranks.M * (n - 1)


def test_step_record_bf16_wire_halves_the_bytes():
    f32 = cb.PpConfig(n=4, backend="ring", schedule="gpipe", wire_dtype=None)
    b16 = dataclasses.replace(f32, wire_dtype=torch.bfloat16)
    for s in range(4):
        a = pl.gpt_pp_step_record(TCFG, f32, B, S, ranks.M, s)
        b = pl.gpt_pp_step_record(TCFG, b16, B, S, ranks.M, s)
        assert a.boundary_bytes == 2 * b.boundary_bytes


@pytest.mark.parametrize("change, kw, match", [
    (dict(pp_interleave=2), {}, "does not interleave"),
    ({}, dict(zero3=True), "ZeRO stage-3"),
    ({}, dict(extra_axes=("sp",)), r"axes \['sp'\] must be size 1"),
    ({}, dict(batch=14, num_microbatches=4), "batch 14 not divisible"),
    ({}, dict(comm_backend="pp=gspmd"), "GSPMD pipeline"),
])
def test_resolve_pp_raises_where_the_reference_falls_back(change, kw,
                                                          match):
    """Where the reference falls back to its GSPMD schedule the port
    raises with the reference's fix-naming text."""
    cfg = dataclasses.replace(TCFG, **change)
    kw = {"comm_backend": "pp=ring", **kw}
    with pytest.raises(ValueError, match=match):
        cb.resolve_pp(cfg, 4, **kw)


def test_resolve_pp_rungs_and_gates():
    assert cb.resolve_pp(TCFG, 1, "pp=ring") is None
    ok = cb.resolve_pp(TCFG, 4, "pp=ring", batch=16, num_microbatches=4)
    assert (ok.n, ok.backend, ok.schedule, ok.wire_dtype) == \
        (4, "ring", "gpipe", None)
    assert cb.resolve_pp(TCFG, 4, "fused").backend == "fused"
    # pp x mp: the mp schedule inside each stage on the ring rung; the
    # fused rung raises naming ring (tests/test_torch_hybrid_train.py)
    assert cb.resolve_pp(TCFG, 4, "pp=ring", mp=2).backend == "ring"
    with pytest.raises(ValueError, match="pp=ring"):
        cb.resolve_pp(TCFG, 4, "pp=fused", mp=2)
    cfg = dataclasses.replace(TCFG, pp_schedule="1f1b")
    assert cb.resolve_pp(cfg, 4, "pp=ring").schedule == "1f1b"
    cb._warned.clear()
    fused = cb.resolve_pp(cfg, 4, "pp=fused")
    assert (fused.backend, fused.schedule) == ("fused", "gpipe")
    assert "pp-fused-1f1b" in cb._warned
    # no pp rung named: ring, with config.pp_schedule
    assert cb.resolve_pp(cfg, 4, "mp=fused").backend == "ring"
    assert cb.resolve_pp(cfg, 4).schedule == "1f1b"
    with pytest.raises(ValueError, match="bfloat16 operands"):
        cb.resolve_pp(TCFG, 4, "pp=fused", device="cuda")


def test_resolve_pp_wire_dtype_flag():
    cb._warned.clear()
    try:
        set_flags({"FLAGS_pp_wire_dtype": "bfloat16"})
        assert cb.resolve_pp(TCFG, 2, "pp=ring").wire_dtype == \
            torch.bfloat16
        assert cb.resolve_pp(TCFG, 2, "pp=fused").wire_dtype is None
        assert ("pp-fused-wire", "bfloat16") in cb._warned
        set_flags({"FLAGS_pp_wire_dtype": "int8"})
        assert cb.resolve_pp(TCFG, 2, "pp=ring").wire_dtype is None
        assert ("pp-wire", "int8") in cb._warned
        set_flags({"FLAGS_pp_wire_dtype": "float32"})
        assert cb.resolve_pp(TCFG, 2, "pp=ring").wire_dtype == torch.float32
    finally:
        set_flags({"FLAGS_pp_wire_dtype": "auto"})


@pytest.mark.parametrize("n", DEGREES)
def test_stage_params_round_trip_is_bitwise(inputs, n):
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    parts = [stage_params(params, s, n) for s in range(n)]
    back = flatten_params(gather_stage_params(parts, n))
    for k, v in flatten_params(params).items():
        assert torch.equal(back[k], v), k
    assert set(parts[0]) == {"wte", "wpe", "blocks"}
    assert set(parts[-1]) == {"lnf_g", "lnf_b", "head_w", "blocks"}
    assert tuple(parts[1]["blocks"]["up_w"].shape) == \
        (8 // n, 32, 128)
    with pytest.raises(ValueError, match="do not split into 3"):
        stage_params(params, 0, 3)


def test_prelude_plus_tail_is_the_block_bit_for_bit(inputs):
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    x = torch.from_numpy(inputs["x"])
    layer = {k: v[3] for k, v in params["blocks"].items()}
    resid, gact = gpt_block_prelude_fn(TCFG)(layer, x)
    tail = resid + (gact @ layer["down_w"] + layer["down_b"])
    assert torch.equal(tail, gpt_block_fn(TCFG)(layer, x))
    assert torch.equal(ppb.gemm_ppsend_plain(gact, layer["down_w"],
                                             layer["down_b"], resid), tail)


def test_rows_14_15_plain_match_the_reference_algebra():
    """``gemm_ppsend_plain`` against a jnp copy of
    ``gemm_ppsend_reference``'s tail (fused_collectives.py:1051), and
    ``gemm_pprecv_plain`` against jax.vjp of it with the cotangent
    gy + gwire, over a [B, S] row split; fp32 at 1e-6."""
    rng = np.random.default_rng(5)
    Bb, Ss, K, F = 2, 24, 48, 40
    x, r = rng.standard_normal((Bb, Ss, K)), rng.standard_normal((Bb, Ss, F))
    w, b = rng.standard_normal((K, F)) * K ** -0.5, rng.standard_normal(F)
    gy, gw = rng.standard_normal((Bb, Ss, F)), rng.standard_normal((Bb, Ss, F))
    f32 = [a.astype(np.float32) for a in (x, w, b, r, gy, gw)]
    x, w, b, r, gy, gw = f32

    def tail(x, w, b, r):
        return (r + (x @ w + b)).astype(r.dtype)

    y_ref, vjp = jax.vjp(jax.jit(tail), *map(jnp.asarray, (x, w, b, r)))
    dx_ref, dw_ref, db_ref, dr_ref = map(np.asarray,
                                         vjp(jnp.asarray(gy + gw)))
    t = [torch.from_numpy(a) for a in f32]
    y = ppb.gemm_ppsend(t[0], t[1], t[2], t[3])      # CPU: the plain path
    dx, dw, db, dr = ppb.gemm_pprecv(t[4], t[5], t[0], t[1], rows=(Bb, Ss))
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref), (db, db_ref),
                      (dr, dr_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert ppb.gemm_ppsend.launches == 0 and ppb.gemm_pprecv.launches == 0


@pytest.mark.parametrize("products", [("dx",), ("dw",), ("dx", "dw")])
def test_row_15_products_apart_match_the_reference(products):
    """``pprecv_gemms`` (row 15's GEMM launch alone, for one product or
    both) on the CPU: the products named, against jax.vjp of the
    reference's tail with dr as the cotangent, fp32 at 1e-6; the same
    bits as ``gemm_pprecv``'s; None for a product not named; no launch
    counted."""
    rng = np.random.default_rng(6)
    Bb, Ss, K, F = 2, 16, 48, 32
    x = rng.standard_normal((Bb, Ss, K)).astype(np.float32)
    w = (rng.standard_normal((K, F)) * K ** -0.5).astype(np.float32)
    dr = rng.standard_normal((Bb, Ss, F)).astype(np.float32)

    def tail(x, w):
        return x @ w

    _, vjp = jax.vjp(jax.jit(tail), jnp.asarray(x), jnp.asarray(w))
    want = dict(zip(("dx", "dw"), map(np.asarray, vjp(jnp.asarray(dr)))))
    t = {k: torch.from_numpy(v) for k, v in (("x", x), ("w", w), ("dr", dr))}
    got = dict(zip(("dx", "dw"), ppb.pprecv_gemms(t["dr"], t["x"], t["w"],
                                                 products)))
    whole = ppb.gemm_pprecv(t["dr"], torch.zeros_like(t["dr"]), t["x"],
                            t["w"])
    for i, name in enumerate(("dx", "dw")):
        if name not in products:
            assert got[name] is None
            continue
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[name]).max())
        assert torch.equal(got[name], whole[i])
    assert ppb.gemm_pprecv.launches == 0


def test_boundary_kernels_name_what_they_do_not_take():
    assert ppb.unsupported_reason(2048, 8192, 2048, torch.bfloat16) is None
    why = ppb.unsupported_reason(2048, 8192, 2040, torch.float32)
    assert "columns 2040 not a multiple of 16" in why
    assert "not bfloat16" in why


def test_run_pipeline_and_the_step_refuse_what_they_do_not_run():
    group = env.MPGroup(rank=0, n=2, backend="gloo",
                        device=torch.device("cpu"))
    x = torch.zeros(4, 8, 32)
    blocks = {"w": torch.zeros(2, 1)}
    for kw, match in ((dict(interleave=2), "interleave"),
                      (dict(remat_policy="full"), "requires the 1f1b"),
                      (dict(backend="fused", schedule="1f1b"),
                       "runs the gpipe"),
                      (dict(backend="fused"), "needs its boundary"),
                      (dict(schedule="zb"), "schedule must be")):
        with pytest.raises(ValueError, match=match):
            pl.run_pipeline(None, blocks, x, 2, group, **kw)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        pl.run_pipeline(None, blocks, x, 3, group)
    with pytest.raises(ValueError, match="do not wrap around"):
        group.stage_hops_async(send_prev=x)
    with pytest.raises(ValueError, match="pp=ring"):
        HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                        pp_group=group, group=group, num_microbatches=2,
                        comm_backend="mp=ring,pp=fused")
    with pytest.raises(NotImplementedError, match="pp_group="):
        HybridTrainStep(TCFG, ranks.optimizer(), mesh=object(),
                        device="cpu")
