"""The port's tensor-parallel training (sequence parallelism;
paddle_tpu_torch/distributed/tp_overlap.py, ops/ring_gemm.py,
ops/fused_collectives.py, models/gpt_hybrid.py with ``group=``) against
the reference, on the CPU.

The port is SPMD: ``distributed.env.launch`` spawns gloo ranks, each
running ``tests/torch_tp_train_ranks.py:checks`` on its shards. One spawn
per mp degree (2 and 4) holds everything the ranks compute; the tests
read it. The reference runs here, in the test process, on the
8-virtual-device mesh: its ``tp_overlap.ring_ag_gemm``/``gemm_ring_rs``
under ``shard_map`` (and JAX autodiff of them), and its
``HybridTrainStep(mesh=create_hybrid_mesh(dp=1, mp=n))`` under
``FLAGS_comm_backend='mp=ring'``. Its fused module does not import under
this image's jax (fused_collectives.py:63), so the port's fused rung is
held against the reference's ring rung, and ``ring_ag_accum`` against
the dense sum (``ag_accum_reference`` lives in that module).

Held, fp32 (differences are summation order only):

* ops at n = 2, 4: every rung's forward at 1e-5 of the reference's ring
  functions, dx and dw at 1e-5 of JAX autodiff of them; the weight
  gradient kernel's plain version at 1e-5 of the dense sum; the fused
  rung's plain path the ring rung's bits;
* the step at n = 2, 4 on the rungs rsag, ring and fused (GPT, H=64, 4
  heads, 2 layers, V=512, S=32, B=4, remat full, AdamW 1e-3, clip 1.0,
  5 steps): losses at the reference's own gate (rtol 5e-4, atol 1e-5;
  tests/test_tp_overlap.py:153-164) and gathered params at 1e-4 of the
  reference's mp=n ring step; losses at 1e-5 of the port's one-device
  step and gathered params at 1e-4 (``PARAM_TOL``); every rank the same
  loss;
* the bookkeeping: shard/gather round trip, the head-major block bit for
  bit, the counters and the wire record against the reference's, the
  resolver's gates, meshes refused.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import torch_tp_train_ranks as ranks
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import tp_overlap as jtp
from paddle_tpu.distributed.env import shard_map_compat
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import HybridTrainStep as JaxStep
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu_torch.distributed import env, tp_overlap
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.models import HybridTrainStep, params_from_numpy
from paddle_tpu_torch.models.gpt import gpt_block_fn
from paddle_tpu_torch.models.gpt_hybrid import (flatten_params,
                                                unflatten_params)
from paddle_tpu_torch.models.params import gather_params, shard_params

JCFG = JaxGPTConfig(**ranks.CFG_KW)
TCFG = ranks.config()
B, S = 4, 32
DEGREES = (2, 4)
# ops case: x [B, S, A], w [A, F]; S, F divisible by both degrees
OB, OS, OA, OF = 2, 8, 16, 24
OP_TOL = 1e-5
# row 9's peer schedule in plain form against the plain ring: both sum the
# chunks' fp32 partials in ring order, but the transposed form computes
# stat^T @ r where the ring transposes r^T @ stat, so its products may sum
# in another order (fp32 rounding, ~1e-7 of the values)
ACCUM_PEER_TOL = 1e-6
# final params after 5 AdamW steps: the reference's own gate. Adam divides
# each update by sqrt(v), so an element whose gradient is mostly
# summation-order noise moves by up to lr a step in either framework or
# schedule (the one-device step and the mp rungs differ by <= 4.2e-5 here)
PARAM_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    params = _np(jax_init_params(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int64)
    crng = np.random.default_rng(1)
    case = {"x": crng.standard_normal((OB, OS, OA)),
            "w": crng.standard_normal((OA, OF)) * 0.3,
            "y": crng.standard_normal((OB, OS, OF)),
            "w2": crng.standard_normal((OF, OA)) * 0.3,
            "gy": crng.standard_normal((OB, OS, OF)),
            "gx": crng.standard_normal((OB, OS, OA))}
    case = {k: v.astype(np.float32) for k, v in case.items()}
    return {"params": params, "ids": ids, "case": case}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """One spawn of n gloo ranks per degree running
    ``torch_tp_train_ranks.checks``, started in threads so that they run
    while the reference computes."""
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {n: pool.submit(
        env.launch, n, ranks.checks, inputs, layout="cpu", timeout_s=400,
        init_dir=tmp_path_factory.mktemp(f"tp{n}")) for n in DEGREES}
    yield futures
    pool.shutdown(wait=True)


def _ref_ops(case, n):
    """The reference's ring functions on an n-device mesh: forward, and
    (dx, dw) by JAX autodiff against the cotangents."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))
    seq, col, row = P(None, "mp", None), P(None, "mp"), P("mp", None)
    ag = shard_map_compat(lambda x, w: jtp.ring_ag_gemm(x, w, "mp", n),
                          mesh, in_specs=(seq, col),
                          out_specs=P(None, None, "mp"))
    rs = shard_map_compat(lambda y, w: jtp.gemm_ring_rs(y, w, "mp", n),
                          mesh, in_specs=(P(None, None, "mp"), row),
                          out_specs=seq)
    c = {k: jnp.asarray(v) for k, v in case.items()}
    out = {}
    with mesh:
        o, vjp = jax.vjp(jax.jit(ag), c["x"], c["w"])
        out["ag"] = (np.asarray(o),) + tuple(map(np.asarray, vjp(c["gy"])))
        o, vjp = jax.vjp(jax.jit(rs), c["y"], c["w2"])
        out["rs"] = (np.asarray(o),) + tuple(map(np.asarray, vjp(c["gx"])))
    return out


def _ref_steps(inputs, n):
    """The reference's mp=n ring-rung step: losses and final params (qkv
    head-major, as its step stores them)."""
    paddle.set_flags({"FLAGS_comm_backend": "mp=ring"})
    try:
        mesh = jenv.create_hybrid_mesh(dp=1, mp=n,
                                       devices=jax.devices()[:n])
        opt = paddle.optimizer.AdamW(
            ranks.LR, grad_clip=paddle.nn.ClipGradByGlobalNorm(ranks.CLIP))
        step = JaxStep(dataclasses.replace(JCFG), opt, mesh=mesh, seed=0)
        ids = jnp.asarray(inputs["ids"].astype(np.int32))
        losses = [float(step(ids)) for _ in range(ranks.STEPS)]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(jax.device_get(a)), step.params)
    finally:
        paddle.set_flags({"FLAGS_comm_backend": ""})
        jenv.set_mesh(None)
        jtp.reset_mp_counters()
    return losses, params


@pytest.fixture(scope="module")
def ref(inputs, spawned, devices8):
    """Everything the reference computes, once, while the ranks run."""
    return {n: {"ops": _ref_ops(inputs["case"], n),
                "steps": _ref_steps(inputs, n)} for n in DEGREES}


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's mesh-less step on the same weights and ids: losses and
    final params, qkv head-major."""
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    step = HybridTrainStep(TCFG, ranks.optimizer(), device="cpu",
                           params=params)
    ids = torch.from_numpy(inputs["ids"])
    losses = [float(step(ids)) for _ in range(ranks.STEPS)]
    p = dict(step.params)
    p["blocks"] = tp_overlap.to_qkv_head_major(
        p["blocks"], TCFG.hidden_size, TCFG.num_heads)
    return losses, {k: v.detach().numpy()
                    for k, v in flatten_params(p).items()}


@pytest.fixture(scope="module", params=DEGREES, ids=lambda n: f"mp{n}")
def run(request, spawned, ref):
    """(n, every rank's results) of the degree's spawn."""
    return request.param, spawned[request.param].result()


def _gathered(outs, rung, n):
    shards = [unflatten_params({k: torch.from_numpy(v) for k, v in
                                o["steps"][rung]["shards"].items()})
              for o in outs]
    return {k: v.numpy() for k, v in
            flatten_params(gather_params(shards, n)).items()}


def _cols(a, r, n, dim):
    w = a.shape[dim] // n
    return np.take(a, np.arange(r * w, (r + 1) * w), axis=dim)


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_ag_gemm_and_grads_match_reference(run, ref, rung):
    """Forward against the reference's ring_ag_gemm; dx and dw against JAX
    autodiff of it, this rank's shards."""
    n, outs = run
    o_ref, dx_ref, dw_ref = ref[n]["ops"]["ag"]
    for o in outs:
        r = o["rank"]
        got, dx, dw = o["ops"][f"ag/{rung}"]
        for a, b, dim in ((got, o_ref, 2), (dx, dx_ref, 1), (dw, dw_ref, 1)):
            np.testing.assert_allclose(a, _cols(b, r, n, dim), rtol=OP_TOL,
                                       atol=OP_TOL * np.abs(b).max())


@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_gemm_rs_and_grads_match_reference(run, ref, rung):
    n, outs = run
    o_ref, dy_ref, dw_ref = ref[n]["ops"]["rs"]
    for o in outs:
        r = o["rank"]
        got, dy, dw = o["ops"][f"rs/{rung}"]
        for a, b, dim in ((got, o_ref, 1), (dy, dy_ref, 2), (dw, dw_ref, 0)):
            np.testing.assert_allclose(a, _cols(b, r, n, dim), rtol=OP_TOL,
                                       atol=OP_TOL * np.abs(b).max())


def test_fused_plain_path_is_the_ring_rung_bit_for_bit(run):
    n, outs = run
    for o in outs:
        np.testing.assert_array_equal(o["ops"]["ag/plain"],
                                      o["ops"]["ag/ring"][0])
        np.testing.assert_array_equal(o["ops"]["rs/plain"],
                                      o["ops"]["rs/ring"][0])
        np.testing.assert_array_equal(o["ops"]["ag/fused"][0],
                                      o["ops"]["ag/ring"][0])
        np.testing.assert_array_equal(o["ops"]["rs/fused"][0],
                                      o["ops"]["rs/ring"][0])


@pytest.mark.parametrize("transpose", [False, True], ids=["NN", "NT"])
def test_row8_peer_schedule_is_the_plain_ring(run, ref, inputs, transpose):
    """Row 8's peer schedule in plain form (``gemm_rs_peer_plain``: every
    rank's fp32 partial of chunk c into slot [c][src], each destination
    summing its slots in the ring's order) over all n ranks' shards: the
    same bits as each rank's ``gemm_rs_plain`` (the ring of hops, fp32),
    and within OP_TOL of the reference's ring (its ``gemm_ring_rs``; NT:
    dx of its ``ring_ag_gemm`` by JAX autodiff, which is the GEMM +
    reduce-scatter of gy by w^T). The reference's ``_gemm_rs_kernel``
    lives in a module that does not import under this image's jax
    (fused_collectives.py:63), so its ring algebra stands in for it, as
    in the tests above."""
    from paddle_tpu_torch.ops import ring_gemm as rg
    n, outs = run
    c = {k: torch.from_numpy(v) for k, v in inputs["case"].items()}
    if transpose:
        ys = [c["gy"].chunk(n, dim=2)[r].contiguous() for r in range(n)]
        ws = [c["w"].chunk(n, dim=1)[r].contiguous() for r in range(n)]
        key, want = "rs/plain_t", ref[n]["ops"]["ag"][1]
    else:
        ys = [c["y"].chunk(n, dim=2)[r].contiguous() for r in range(n)]
        ws = [c["w2"].chunk(n, dim=0)[r].contiguous() for r in range(n)]
        key, want = "rs/plain", ref[n]["ops"]["rs"][0]
    got = rg.gemm_rs_peer_plain(ys, ws, transpose_w=transpose)
    for o in outs:
        r = o["rank"]
        np.testing.assert_array_equal(got[r].numpy(), o["ops"][key])
        np.testing.assert_allclose(got[r].numpy(), _cols(want, r, n, 1),
                                   rtol=OP_TOL,
                                   atol=OP_TOL * np.abs(want).max())


@pytest.mark.parametrize("transpose", [False, True], ids=["NN", "NT"])
def test_row7_peer_schedule_is_the_plain_ring(run, ref, inputs, transpose):
    """Row 7's peer schedule in plain form (``ag_gemm_peer_plain``: every
    rank's chunk gathered, each GEMMed into its block-row) over all n
    ranks' shards: the same bits as each rank's ``ag_gemm_plain`` (the
    ring of hops, fp32), and within OP_TOL of the reference's ring (NN:
    its ``ring_ag_gemm``; NT: dy of its ``gemm_ring_rs`` by JAX autodiff,
    which is the all-gather + GEMM of gx by w2^T). The reference's
    ``_ag_gemm_kernel`` lives in a module that does not import under this
    image's jax (fused_collectives.py:63), so its ring algebra stands in
    for it, as in the tests above."""
    from paddle_tpu_torch.ops import ring_gemm as rg
    n, outs = run
    c = {k: torch.from_numpy(v) for k, v in inputs["case"].items()}
    if transpose:
        xs = [t.contiguous() for t in c["gx"].chunk(n, dim=1)]
        ws = [t.contiguous() for t in c["w2"].chunk(n, dim=0)]
        key, want = "ag/plain_t", ref[n]["ops"]["rs"][1]
    else:
        xs = [t.contiguous() for t in c["x"].chunk(n, dim=1)]
        ws = [t.contiguous() for t in c["w"].chunk(n, dim=1)]
        key, want = "ag/plain", ref[n]["ops"]["ag"][0]
    for o in outs:
        r = o["rank"]
        got = rg.ag_gemm_peer_plain(xs, ws[r], transpose_w=transpose)
        np.testing.assert_array_equal(got.numpy(), o["ops"][key])
        np.testing.assert_allclose(got.numpy(), _cols(want, r, n, 2),
                                   rtol=OP_TOL,
                                   atol=OP_TOL * np.abs(want).max())


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["plain", "transposed"])
def test_row9_peer_schedule_matches_the_plain_ring(run, ref, inputs,
                                                   transpose):
    """Row 9's peer schedule in plain form (``ag_accum_peer_plain``: each
    gathered chunk's fp32 partial, summed in ring-step order as the
    kernel's last block of a tile sums them) over all n ranks' ring
    operands: within ACCUM_PEER_TOL of each rank's ``ag_accum_plain`` (the
    ring of hops), and within OP_TOL of the reference's weight gradients
    by JAX autodiff (plain: dw of its ``ring_ag_gemm``; transposed: dw of
    its ``gemm_ring_rs``)."""
    from paddle_tpu_torch.ops import ring_gemm as rg
    n, outs = run
    c = {k: torch.from_numpy(v) for k, v in inputs["case"].items()}
    if transpose:
        rs = [t.contiguous() for t in c["gx"].chunk(n, dim=1)]
        stats = [t.contiguous() for t in c["y"].chunk(n, dim=2)]
        key, want, dim = "accum_t", ref[n]["ops"]["rs"][2], 0
    else:
        rs = [t.contiguous() for t in c["x"].chunk(n, dim=1)]
        stats = [t.contiguous() for t in c["gy"].chunk(n, dim=2)]
        key, want, dim = "accum", ref[n]["ops"]["ag"][2], 1
    for o in outs:
        r = o["rank"]
        got = rg.ag_accum_peer_plain(rs, stats[r], r, transpose).numpy()
        ring = o["ops"][key]
        np.testing.assert_allclose(got, ring, rtol=ACCUM_PEER_TOL,
                                   atol=ACCUM_PEER_TOL * np.abs(ring).max())
        np.testing.assert_allclose(got, _cols(want, r, n, dim), rtol=OP_TOL,
                                   atol=OP_TOL * np.abs(want).max())


def test_ag_accum_matches_the_dense_sum(run, inputs):
    """sum_c r_c^T stat_c over the ring equals the dense contraction over
    the whole sequence; the transposed variant its transpose."""
    n, outs = run
    c = inputs["case"]
    for o in outs:
        r = o["rank"]
        want = c["x"].reshape(-1, OA).T @ \
            _cols(c["gy"], r, n, 2).reshape(-1, OF // n)
        np.testing.assert_allclose(o["ops"]["accum"], want, rtol=OP_TOL,
                                   atol=OP_TOL * np.abs(want).max())
        want_t = _cols(c["y"], r, n, 2).reshape(-1, OF // n).T @ \
            c["gx"].reshape(-1, OA)
        np.testing.assert_allclose(o["ops"]["accum_t"], want_t,
                                   rtol=OP_TOL,
                                   atol=OP_TOL * np.abs(want_t).max())


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_step_matches_reference_mp_step(run, ref, rung):
    n, outs = run
    want_losses, want_params = ref[n]["steps"]
    losses = outs[0]["steps"][rung]["losses"]
    np.testing.assert_allclose(losses, want_losses, rtol=5e-4, atol=1e-5)
    got = _gathered(outs, rung, n)
    want = {k: np.asarray(v) for k, v in flatten_params(
        {**{k: v for k, v in want_params.items() if k != "blocks"},
         "blocks": want_params["blocks"]}).items()}
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_step_matches_one_device_step(run, one_device, rung):
    n, outs = run
    want_losses, want = one_device
    for o in outs:                    # every rank returns the same loss
        assert o["steps"][rung]["losses"] == outs[0]["steps"][rung]["losses"]
    np.testing.assert_allclose(outs[0]["steps"][rung]["losses"],
                               want_losses, rtol=1e-5, atol=1e-5)
    for k, v in _gathered(outs, rung, n).items():
        np.testing.assert_allclose(v, want[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


def test_flags_choose_the_rung(run, one_device):
    """FLAGS_comm_backend='mp=fused' with comm_backend=None runs the fused
    rung, and its first loss is the one-device step's."""
    _, outs = run
    for o in outs:
        rung, loss = o["flag_rung"]
        assert rung == "fused"
        np.testing.assert_allclose(loss, one_device[0][0], rtol=1e-5)


@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_loss_only_is_the_first_steps_loss(run, rung):
    """``loss_only`` before any update computes the first step's forward."""
    _, outs = run
    for o in outs:
        res = o["steps"][rung]
        assert res["loss_only"] == res["losses"][0]


@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_counters_are_steps_times_the_step_record(run, rung):
    n, outs = run
    for o in outs:
        res = o["steps"][rung]
        c, rec = res["counters"], res["record"]
        assert c["steps"] == ranks.STEPS
        assert c["backend"] == {"mp": rung}
        for k in ("collectives", "ppermute_hops", "fused_dispatches",
                  "rs_bytes", "ag_bytes"):
            assert c[k] == ranks.STEPS * rec[k], k
        assert c["wire_bytes"] == ranks.STEPS * (rec["rs_bytes"]
                                                 + rec["ag_bytes"])
        assert res["num_params"] == sum(
            int(np.prod(s)) for s in flatten_params(
                _shapes(TCFG)).values())


def _shapes(cfg):
    from paddle_tpu_torch.models.params import param_shapes
    return param_shapes(cfg)


@pytest.mark.parametrize("n", DEGREES)
@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_step_record_equals_reference(n, rung):
    sp = tp_overlap.SPConfig(n=n, backend=rung)
    got = tp_overlap.gpt_step_record(TCFG, sp, B, S)
    want = jtp.gpt_step_record(JCFG, jtp.SPConfig(axis="mp", n=n,
                                                  backend=rung), B, S)
    for k in ("collectives", "ppermute_hops", "fused_dispatches",
              "rs_bytes", "ag_bytes", "activation_bytes", "bytes_by_kind",
              "backend"):
        assert getattr(got, k) == getattr(want, k), k


# ------------------------------------------------------------ bookkeeping
@pytest.mark.parametrize("n", DEGREES)
def test_shard_gather_round_trip_is_bitwise(inputs, n):
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    shards = [shard_params(params, r, n) for r in range(n)]
    back = flatten_params(gather_params(shards, n))
    for k, v in flatten_params(params).items():
        assert torch.equal(back[k], v), k
    qkv = shards[1]["blocks"]["qkv_w"]
    assert tuple(qkv.shape) == (2, 64, 3 * 64 // n)
    assert tuple(shards[1]["wte"].shape) == (512 // n, 64)
    assert tuple(shards[1]["head_w"].shape) == (64, 512 // n)
    assert shards[1]["wpe"] is params["wpe"]


def test_head_major_block_is_a_bitwise_relabeling(inputs):
    """The reference's test_qkv_head_major_is_bitwise_relabeling on the
    port's block."""
    params = params_from_numpy(inputs["params"], TCFG, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 16, TCFG.hidden_size).astype(np.float32))
    layer = {k: v[0] for k, v in params["blocks"].items()}
    ref = gpt_block_fn(TCFG)(layer, x)
    hm = tp_overlap.to_qkv_head_major(params["blocks"], TCFG.hidden_size,
                                      TCFG.num_heads)
    cfg_hm = dataclasses.replace(TCFG, qkv_head_major=True)
    out = gpt_block_fn(cfg_hm)({k: v[0] for k, v in hm.items()}, x)
    assert torch.equal(ref, out)


@pytest.mark.parametrize("change, match", [
    (dict(hidden_size=66, num_heads=6), "hidden 66"),
    (dict(num_heads=2), "heads 2"),
    (dict(vocab_size=510), "vocab 510"),
    (dict(qkv_head_major=False), "head-major"),
])
def test_resolve_gpt_gates(change, match):
    cfg = dataclasses.replace(TCFG, **{"qkv_head_major": True, **change})
    with pytest.raises(ValueError, match=match):
        tp_overlap.resolve_gpt(cfg, 4, "ring")


def test_resolve_gpt_gates_seq_and_flags():
    cfg = dataclasses.replace(TCFG, qkv_head_major=True)
    with pytest.raises(ValueError, match="sequence 30"):
        tp_overlap.resolve_gpt(cfg, 4, "fused", seq=30)
    with pytest.raises(ValueError, match="one of"):
        tp_overlap.resolve_gpt(cfg, 4, "gspmd")
    with pytest.raises(NotImplementedError, match="not ported"):
        tp_overlap.resolve_gpt(cfg, 4)       # no flag names a schedule
    set_flags({"FLAGS_sequence_parallel": True})
    try:
        assert tp_overlap.resolve_gpt(cfg, 4).backend == "rsag"
        set_flags({"FLAGS_mp_overlap": True})
        assert tp_overlap.resolve_gpt(cfg, 4).backend == "ring"
    finally:
        set_flags({"FLAGS_sequence_parallel": False,
                   "FLAGS_mp_overlap": False})
    assert tp_overlap.resolve_gpt(cfg, 1) is None


def test_fused_rung_on_cuda_names_what_its_kernels_do_not_take():
    """The fused rung's CUDA gate raises (never steps down to ring) for an
    fp32 model; checked without a card: the gate reads the device type."""
    cfg = dataclasses.replace(TCFG, qkv_head_major=True)
    with pytest.raises(ValueError, match="not bfloat16.*choose"):
        tp_overlap.resolve_gpt(cfg, 4, "fused", device="cuda", seq=64)


def test_mesh_raises_pointing_to_group():
    with pytest.raises(NotImplementedError, match="group="):
        HybridTrainStep(TCFG, ranks.optimizer(), mesh=object(),
                        device="cpu")
