"""The port's composed parallelisms (paddle_tpu_torch/models/gpt_hybrid.py
with ``group=``, ``pp_group=`` and ``dp_group=`` on the sub-groups of
``distributed.env.init_hybrid_groups``; grad_comm's ZeRO-1 over dp,
nn/clip.py over the three axes) against the reference and the port's
one-device step, on the CPU.

The port is SPMD: ``distributed.env.launch(n, ..., axes=)`` spawns one
hybrid world of gloo ranks per layout (dp2 x mp2, dp2 x pp2 and pp2 x mp2
at 4 ranks; pp2 x dp2 x mp2 at 8, the reference's own multi-chip
composition, __graft_entry__.py:80-96), each rank running
``tests/torch_hybrid_train_ranks.py:checks``. The reference runs here, in
the test process, on the 8-virtual-device mesh: its
``HybridTrainStep(mesh=create_hybrid_mesh(dp=, mp=, pp=))`` with ZeRO-1
(``_shard_opt_states_axis = "dp"``) where its composed step is right:
dp2 x mp2 under ``mp=ring``, dp2 x pp2 under ``pp=ring`` and pp2 x mp2
under ``mp=ring,pp=ring`` with ``pp_schedule="gpipe"``. Its composed
1F1B with the mp schedule inside a stage gives other gradients than one
device (ROADMAP Queue C's facts about the reference), so the port's
pp x mp 1F1B is held to the one-device step. The reference's fused
module does not import under this image's jax, so the port's fused rungs
(whose CPU paths are the kernels' plain versions) are held to its ring
rungs, bit for bit.

Held, fp32 (differences are summation order only), GPT at H=64, 4 heads,
4 layers, V=512, S=32, B=4 (8 for the 3-D world), M=2, AdamW 1e-3,
clip 1.0, remat full, 5 steps (2 on the fused rungs):

* every rank the same loss; the dp replicas the same params, bit for bit;
* losses at 1e-5 of the port's one-device step and gathered params at
  ``PARAM_TOL`` (every run, 1F1B included), and the same of the
  reference's composed step where it is right; exactly-zero gradients
  (wte rows of tokens the batch lacks, wpe rows past S) are held at
  ``PARAM_TOL`` too;
* the fused rungs' plain paths the ring rungs' bits; ZeRO-1 on and off
  within fp32 summation order; ZeRO-1 keeps one (1, cols) row of each
  slot per replica;
* the world's layout against the reference mesh's, and the gates.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_hybrid_train_ranks as ranks
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import pipeline as jpl
from paddle_tpu.distributed import tp_overlap as jtp
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import HybridTrainStep as JaxStep
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu_torch.distributed import comm_backend as cb
from paddle_tpu_torch.distributed import env, tp_overlap
from paddle_tpu_torch.distributed import grad_comm as gc
from paddle_tpu_torch.models import HybridTrainStep, params_from_numpy
from paddle_tpu_torch.models.gpt_hybrid import (flatten_params,
                                                unflatten_params)
from paddle_tpu_torch.models.params import (gather_params,
                                            gather_stage_params)

JCFG = JaxGPTConfig(**ranks.CFG_KW)
TCFG = ranks.config()
S = 32
LOSS_TOL = 1e-5
# Adam turns summation-order noise in near-zero gradients into up-to-lr
# moves (tests/test_torch_tp_train.py)
PARAM_TOL = 1e-4
# ... and an element whose first gradient is nonzero but sits in Adam's
# epsilon (1e-8) region moves by g / (|g| + eps) of lr, so gradient noise
# of 1e-9 there moves it by ~lr / 20 on the first step: such elements are
# held to Adam's largest move, lr a step (the gradients themselves at
# GRAD_RTOL). An exactly-zero gradient is zero on both sides (the same
# decay), so it is held at PARAM_TOL.
ADAM_EPS_REGION = 1e-7
GRAD_RTOL = 1e-5
# ZeRO-1 on and off: the same sums over two replicas; only the clip's
# norm is summed in another order (from the shards)
ZERO_LOSS_TOL, ZERO_PARAM_TOL = 1e-6, 1e-5
LAYOUTS = list(ranks.LAYOUTS)
RUNS = [(lay, name) for lay, (_, _, runs) in ranks.LAYOUTS.items()
        for name, _, _, _ in runs]
# the reference's composed step where it is right: (layout, the port's
# run held to it, FLAGS_comm_backend, pp_schedule)
REF_RUNS = (("dp2xmp2", "ring", "mp=ring", None),
            ("dp2xpp2", "ring", "pp=ring", "gpipe"),
            ("pp2xmp2", "ring", "mp=ring,pp=ring", "gpipe"))
ZERO_PAIRS = (("dp2xmp2", "ring", "no-zero"), ("dp2xpp2", "ring", "no-zero"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    params = _np(jax_init_params(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)
    by_batch = {B: rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int64)
                for B in sorted({B for _, B, _ in ranks.LAYOUTS.values()})}
    ids = {lay: by_batch[B] for lay, (_, B, _) in ranks.LAYOUTS.items()}
    return {"params": params, "ids": ids}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """One hybrid world per layout running ``torch_hybrid_train_ranks.
    checks``, started in threads so that they run while the reference
    computes."""
    pool = ThreadPoolExecutor(max_workers=len(LAYOUTS))
    futures = {}
    for lay, (axes, _, _) in ranks.LAYOUTS.items():
        n = axes["dp"] * axes["mp"] * axes["pp"]
        futures[lay] = pool.submit(
            env.launch, n, ranks.checks, inputs, lay, layout="cpu",
            timeout_s=400, init_dir=tmp_path_factory.mktemp(lay), axes=axes)
    yield futures
    pool.shutdown(wait=True)


def _ref_step(inputs, layout, flags, schedule):
    """The reference's composed step of ``layout`` under ``flags``:
    losses and final params (qkv head-major under mp, as its step stores
    them)."""
    axes, _, _ = ranks.LAYOUTS[layout]
    n = axes["dp"] * axes["mp"] * axes["pp"]
    paddle.set_flags({"FLAGS_comm_backend": flags})
    try:
        mesh = jenv.create_hybrid_mesh(dp=axes["dp"], mp=axes["mp"],
                                       pp=axes["pp"],
                                       devices=jax.devices()[:n])
        opt = paddle.optimizer.AdamW(
            ranks.LR, grad_clip=paddle.nn.ClipGradByGlobalNorm(ranks.CLIP))
        opt._shard_opt_states_axis = "dp"
        cfg = JCFG if schedule is None else \
            dataclasses.replace(JCFG, pp_schedule=schedule)
        step = JaxStep(cfg, opt, mesh=mesh, seed=0,
                       num_microbatches=ranks.M if axes["pp"] > 1 else 1)
        ids = jnp.asarray(inputs["ids"][layout].astype(np.int32))
        losses = [float(step(ids)) for _ in range(ranks.STEPS)]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jax.device_get(a)), step.params)
    finally:
        paddle.set_flags({"FLAGS_comm_backend": ""})
        jenv.set_mesh(None)
        jtp.reset_mp_counters()
        jpl.reset_pp_counters()
    return losses, flatten_params(params)


@pytest.fixture(scope="module")
def ref(inputs, spawned, devices8):
    """The reference's composed steps, once, while the worlds run."""
    return {lay: _ref_step(inputs, lay, flags, sched)
            for lay, _, flags, sched in REF_RUNS}


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's mesh-less step on each batch: losses and final params
    in the logical and the head-major qkv layouts."""
    out = {}
    for B in sorted({B for _, B, _ in ranks.LAYOUTS.values()}):
        ids = next(v for v in inputs["ids"].values() if len(v) == B)
        params = params_from_numpy(inputs["params"], TCFG, device="cpu")
        step = HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                               params=params)
        _, grads = step.loss_and_grads(torch.from_numpy(ids))
        losses, early = [], None
        for i in range(ranks.STEPS):
            losses.append(float(step(torch.from_numpy(ids))))
            if i + 1 == ranks.FUSED_STEPS:
                early = _layouts(flatten_params(step.params))
        out[B] = {"losses": losses, "early": early,
                  "params": _layouts(flatten_params(step.params)),
                  "grads": _layouts(grads)}
    return out


def _layouts(flat):
    """{"logical": numpy leaves, "head_major": the same, qkv head-major}."""
    tree = unflatten_params({k: v.detach().clone() for k, v in flat.items()})
    logical = {k: v.numpy() for k, v in flatten_params(tree).items()}
    tree["blocks"] = tp_overlap.to_qkv_head_major(
        tree["blocks"], TCFG.hidden_size, TCFG.num_heads)
    return {"logical": logical, "head_major": {
        k: v.numpy() for k, v in flatten_params(tree).items()}}


@pytest.fixture(scope="module")
def worlds(spawned, ref, one_device):
    """The worlds' results, awaited once the reference and the one-device
    steps have run beside them."""
    return {lay: f.result() for lay, f in spawned.items()}


def _gathered(outs, layout, run, dp_rank=0, what="params"):
    """The full tree of ``run``'s ``what`` from the ranks of dp replica
    ``dp_rank``: mp shards joined within each stage, then the stages."""
    axes, _, _ = ranks.LAYOUTS[layout]
    mp, pp = axes["mp"], axes["pp"]
    stages = []
    for s in range(pp):
        parts = sorted((o for o in outs if o["coords"]["pp"] == s and
                        o["coords"]["dp"] == dp_rank),
                       key=lambda o: o["coords"]["mp"])
        trees = [unflatten_params({k: torch.from_numpy(v) for k, v in
                                   o["runs"][run][what].items()})
                 for o in parts]
        stages.append(gather_params(trees, mp) if mp > 1 else trees[0])
    full = gather_stage_params(stages, pp) if pp > 1 else stages[0]
    return {k: v.numpy() for k, v in flatten_params(full).items()}


def _batch(layout):
    return ranks.LAYOUTS[layout][1]


def _qkv(layout):
    """The qkv layout the layout's steps store."""
    return "head_major" if ranks.LAYOUTS[layout][0]["mp"] > 1 else "logical"


def noisy_elements(first_grads):
    """{leaf: mask of the elements whose first gradient is nonzero and in
    Adam's epsilon region}."""
    return {k: (g != 0) & (np.abs(g) <= ADAM_EPS_REGION)
            for k, g in first_grads.items()}


def _hold_params(got, want, first_grads):
    """``got`` against ``want`` at ``PARAM_TOL``; the elements whose first
    gradient is nonzero and in Adam's epsilon region within lr a step."""
    assert set(got) == set(want)
    masks = noisy_elements(first_grads)
    for k, v in got.items():
        noisy = masks[k]
        np.testing.assert_allclose(v[~noisy], want[k][~noisy],
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(v[noisy], want[k][noisy], rtol=0,
                                   atol=ranks.STEPS * ranks.LR, err_msg=k)


# ---------------------------------------------------------------- steps
@pytest.mark.parametrize("layout, run", RUNS)
def test_every_rank_returns_the_same_loss(worlds, layout, run):
    outs = worlds[layout]
    want = outs[0]["runs"][run]["losses"]
    assert all(np.isfinite(want))
    for o in outs:
        assert o["runs"][run]["losses"] == want, o["coords"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_first_gradients_match_one_device(worlds, one_device, layout):
    """``loss_and_grads`` at the initial params (the mp-replicated leaves
    summed over mp, every leaf averaged over dp) gathered over the world,
    against the one-device step's, each leaf at GRAD_RTOL of its
    scale."""
    outs = worlds[layout]
    run = ranks.LAYOUTS[layout][2][0][0]
    want = one_device[_batch(layout)]["grads"][_qkv(layout)]
    got = _gathered(outs, layout, run, what="grads")
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("layout, run", RUNS)
def test_step_matches_one_device_step(worlds, one_device, layout, run):
    outs = worlds[layout]
    one = one_device[_batch(layout)]
    losses = outs[0]["runs"][run]["losses"]
    np.testing.assert_allclose(losses, one["losses"][:len(losses)],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    got = _gathered(outs, layout, run)
    at = "params" if len(losses) == ranks.STEPS else "early"
    _hold_params(got, one[at][_qkv(layout)], one["grads"][_qkv(layout)])
    assert outs[0]["runs"][run]["num_params"] == sum(
        int(np.prod(v.shape)) for v in got.values())


@pytest.mark.parametrize("layout, run, flags, sched", REF_RUNS,
                         ids=[r[0] for r in REF_RUNS])
def test_step_matches_reference_composed_step(worlds, ref, one_device,
                                              layout, run, flags, sched):
    want_losses, want = ref[layout]
    outs = worlds[layout]
    np.testing.assert_allclose(outs[0]["runs"][run]["losses"], want_losses,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    _hold_params(_gathered(outs, layout, run),
                 {k: np.asarray(v) for k, v in want.items()},
                 one_device[_batch(layout)]["grads"][_qkv(layout)])


@pytest.mark.parametrize("layout", ["dp2xmp2", "dp2xpp2", "pp2xmp2"])
def test_fused_plain_paths_are_the_ring_rungs_bit_for_bit(worlds, layout):
    """On the CPU the fused rungs run their kernels' plain versions (rows
    7-9's rings, rows 10-11's rings over two replicas, rows 14-15's
    algebra): the same losses and params as the ring rungs over the fused
    run's steps."""
    for o in worlds[layout]:
        fused, ring = o["runs"]["fused"], o["runs"]["ring"]
        assert len(fused["losses"]) == ranks.FUSED_STEPS
        assert fused["losses"] == ring["losses"][:ranks.FUSED_STEPS]
        for k, v in ring["early"].items():
            np.testing.assert_array_equal(fused["params"][k], v, err_msg=k)


@pytest.mark.parametrize("layout, zero, plain", ZERO_PAIRS,
                         ids=[p[0] for p in ZERO_PAIRS])
def test_zero1_on_and_off_agree(worlds, layout, zero, plain):
    """ZeRO-1 (reduce-scatter, clip from the shards, sharded AdamW,
    all-gather) against the all-reduce step: within fp32 summation order
    (the clip's norm); the slots of every leaf one (1, cols) row per
    replica."""
    for o in worlds[layout]:
        a, b = o["runs"][zero], o["runs"][plain]
        np.testing.assert_allclose(a["losses"], b["losses"],
                                   rtol=ZERO_LOSS_TOL, atol=ZERO_LOSS_TOL)
        for k, v in b["params"].items():
            np.testing.assert_allclose(a["params"][k], v,
                                       rtol=ZERO_PARAM_TOL,
                                       atol=ZERO_PARAM_TOL, err_msg=k)
            numel = int(np.prod(v.shape))
            assert a["slots"][k] == (1, -(-numel // 2)), k
            assert b["slots"][k] == v.shape, k
        assert (a["dp_backend"], b["dp_backend"]) == ("ring", "gspmd")


@pytest.mark.parametrize("layout", [lay for lay in LAYOUTS
                                    if ranks.LAYOUTS[lay][0]["dp"] > 1])
def test_dp_replicas_hold_the_same_params(worlds, layout):
    outs = worlds[layout]
    for run in outs[0]["runs"]:
        for o in outs:
            twin = next(t for t in outs if t["coords"] == {
                **o["coords"], "dp": 0})
            for k, v in o["runs"][run]["params"].items():
                np.testing.assert_array_equal(
                    v, twin["runs"][run]["params"][k], err_msg=(run, k))
    # every step with a dp group recorded its gradient traffic
    runs = ranks.LAYOUTS[layout][2]
    assert all(o["comm_steps"] == sum(ranks.steps(r[0]) for r in runs)
               for o in outs)


@pytest.mark.parametrize("layout, run", RUNS)
def test_loss_only_is_the_first_steps_loss(worlds, layout, run):
    for o in worlds[layout]:
        res = o["runs"][run]
        np.testing.assert_allclose(res["loss_only"], res["losses"][0],
                                   rtol=1e-7, atol=1e-7)


# ------------------------------------------------------------- layout
@pytest.mark.parametrize("dp, mp, pp", [(2, 2, 1), (2, 1, 2), (1, 2, 2),
                                        (2, 2, 2), (1, 4, 2), (4, 1, 2)])
def test_world_layout_is_the_reference_meshs(devices8, dp, mp, pp):
    """World rank r sits where the reference's create_hybrid_mesh puts
    device r, and its axis groups are that mesh's lines."""
    n = dp * mp * pp
    devs = jax.devices()[:n]
    try:
        mesh = jenv.create_hybrid_mesh(dp=dp, mp=mp, pp=pp, devices=devs)
    finally:
        jenv.set_mesh(None)
    arr = np.vectorize(lambda d: devs.index(d))(mesh.devices)
    names = list(mesh.axis_names)
    for r in range(n):
        where = dict(zip(names, (int(i[0]) for i in np.nonzero(arr == r))))
        assert env.hybrid_coords(r, dp, mp, pp) == \
            (where["pp"], where["dp"], where["mp"])
    for axis in ("dp", "mp", "pp"):
        lines = set()
        moved = np.moveaxis(arr, names.index(axis), -1)
        for line in moved.reshape(-1, moved.shape[-1]):
            lines.add(tuple(int(x) for x in line))
        assert set(env.hybrid_group_ranks(axis, dp, mp, pp)) == lines


@pytest.mark.parametrize("layout, method", [("cpu", "forkserver"),
                                            ("shared", "spawn"),
                                            ("per_card", "spawn")])
def test_cpu_ranks_fork_from_a_server_and_card_ranks_spawn(layout, method):
    """CPU ranks fork from one server that has imported torch; a rank
    that will use a card starts a fresh interpreter."""
    assert env._context(layout).get_start_method() == method


def test_launch_refuses_axes_that_do_not_fit():
    with pytest.raises(ValueError, match="do not multiply to 4"):
        env.launch(4, print, axes={"dp": 2, "mp": 1, "pp": 1})
    with pytest.raises(ValueError, match="name dp, mp and pp"):
        env.launch(4, print, axes={"dp": 2, "sp": 2})


# -------------------------------------------------------------- gates
def _group(n, rank=0):
    return env.MPGroup(rank=rank, n=n, backend="gloo",
                       device=torch.device("cpu"))


def test_fused_pp_rung_with_mp_raises_naming_ring():
    """The reference steps down to ring with a warning
    (comm_backend.py:229-234); the port raises."""
    with pytest.raises(ValueError, match="pp=ring"):
        cb.resolve_pp(TCFG, 2, "pp=fused", mp=2)
    assert cb.resolve_pp(TCFG, 2, "pp=ring", mp=2).backend == "ring"
    with pytest.raises(ValueError, match="pp=ring"):
        HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                        group=_group(2), pp_group=_group(2),
                        num_microbatches=2,
                        comm_backend="mp=ring,pp=fused")


def test_microbatch_not_divisible_by_dp_raises():
    """The reference's rule (comm_backend.py:219-225): the explicit
    schedule shards each microbatch over dp."""
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        cb.resolve_pp(TCFG, 2, "pp=ring", batch=4, num_microbatches=4,
                      dp=2)
    assert cb.resolve_pp(TCFG, 2, "pp=ring", batch=8, num_microbatches=4,
                         dp=2).n == 2


def test_dp_rungs_without_zero1_raise():
    """Without ZeRO-1 the gradients take one all-reduce a bucket, which
    only ``dp=gspmd`` (or no dp rung) names; ZeRO-1 runs on every rung."""
    for rung in ("ring", "fused"):
        with pytest.raises(ValueError, match="without ZeRO-1"):
            gc.resolve_hybrid(_group(2), ranks.optimizer(), rung)
        assert gc.resolve_hybrid(_group(2), ranks.optimizer(zero=True),
                                 rung).backend == rung
    for zero in (False, True):
        dpc = gc.resolve_hybrid(_group(2), ranks.optimizer(zero), None)
        assert (dpc.backend, dpc.weight_update_sharding) == ("gspmd", zero)
    assert gc.resolve_hybrid(_group(1), ranks.optimizer(), "ring") is None


def test_zero_stage_3_and_meshes_raise():
    with pytest.raises(NotImplementedError, match="zero_stage >= 3"):
        HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                        zero_stage=3)
    with pytest.raises(NotImplementedError, match="init_hybrid_groups"):
        HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                        mesh=object())


def test_comm_backend_names_the_three_axes():
    assert cb.parse("mp=fused,pp=ring,dp=fused") == \
        {"mp": "fused", "pp": "ring", "dp": "fused"}
    assert cb.parse("rsag") == {"mp": "rsag"}
    assert cb.parse("ring") == {"mp": "ring", "pp": "ring", "dp": "ring"}
    cb._warned.clear()
    assert cb.parse("dp=rsag") == {}
    assert ("backend", "dp", "rsag") in cb._warned
