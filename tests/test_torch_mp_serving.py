"""The port's tensor-parallel serving (paddle_tpu_torch/serving/mp_forward.py,
ops/fused_collectives.py, distributed/) against the reference, on the CPU.

The port is SPMD: ``distributed.env.launch`` spawns gloo ranks (a
``file://`` rendezvous under ``tmp_path``), each running
``tests/torch_mp_ranks.py:checks`` on its shards. One spawn per mp degree
(2 and 4) holds everything the ranks compute; the tests read it. The
reference runs here, in the test process, on the 8-virtual-device mesh,
through its ``ring`` and ``gspmd`` rungs: its fused module does not
import under this image's jax (fused_collectives.py:63), so its Pallas
kernels cannot run even in interpret mode. The serving schedule only
gathers, so every rung computes the same function.

Held, at the reference's test config (V=96, H=64, 4 heads, L=2, fp32):

* the port's plain all-gather exactly, and its plain column-parallel GEMM
  + all-gather (fp32, int8, fp8) within fp32 summation order of the
  reference's ``mp_forward.gemm_ag`` on the ring rung;
* ``quantize_params(qkv_perm=)`` bytes and scales bit for bit;
* greedy tokens of the port's mp engine, on every rung and rank, at fp32
  and int8/fp8, equal to the reference's ring-rung mp engine (and at fp32
  to ``generate_from_params``);
* inside the port, bit for bit: step logits across rungs, ranks and the
  one-device engine; sampled streams across ranks and against the
  one-device engine; admission order; V=97's replicated head;
* KV bytes per rank 1/n; deadlines decided on rank 0, callbacks on rank
  0; the mp counters against the reference's wire record; the resolver's
  and the engine's errors; the flags; the LM head's stored dtype.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_mp_ranks as ranks
from paddle_tpu import serving as jserving
from paddle_tpu.distributed import comm_backend as jcb
from paddle_tpu.distributed import tp_overlap as jtp
from paddle_tpu.distributed.env import shard_map_compat
from paddle_tpu.models.generation import generate_from_params
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu.serving import mp_forward as jmp
from paddle_tpu.serving import quant as jquant
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import comm_backend, env, tp_overlap
from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.serving import quant as tquant

JCFG = JaxGPTConfig(**ranks.CFG_KW)
TCFG = ranks.config()
SHAPES = ((3, 4), (9, 5), (13, 4), (21, 5))    # (prompt, new tokens)
# the reference's quantized mp engines: (dtype, mp, rung); its one-chip
# quantized engines run at both dtypes
JAX_QUANT = (("int8", 2, "ring"), ("fp8", 4, "ring"))
# cross-framework sums (GEMM outputs) agree to fp32 summation order,
# relative to the output's scale
SUM_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


@pytest.fixture(scope="module")
def inputs(devices8):
    """The weights (the reference's, as numpy), the requests and the
    collectives' case: rows and last-axis blocks per rank, one x and full
    weights (fp32; int8/fp8 with their scales) of [H, 96]."""
    params = _np(jax_init_params(JCFG, jax.random.key(0)))
    rng = np.random.default_rng(0)
    # V=97: the V=96 weights with one more embedding row and head column
    odd = dict(params)
    odd["wte"] = np.concatenate([odd["wte"], odd["wte"][:1] * 0.5])
    odd["head_w"] = np.concatenate([odd["head_w"], odd["head_w"][:, :1]],
                                   axis=1)
    crng = np.random.default_rng(1)
    w = (crng.standard_normal((64, 96)) * 0.3).astype(np.float32)
    gemms = {"fp32/w": (w, None)}
    for dtype in ("int8", "fp8"):
        q, s = jquant._quantize_leaf(jnp.asarray(w), dtype)
        gemms[f"{dtype}/w"] = (np.asarray(q).view(np.uint8), np.asarray(s))
    return {"params": params, "params_odd": odd,
            "prompts": [rng.integers(0, 96, p).tolist() for p, _ in SHAPES],
            "max_new": [m for _, m in SHAPES],
            "x": crng.standard_normal((5, 64)).astype(np.float32),
            "gemms": gemms,
            "full": {n: crng.standard_normal((3, 2, 8 * n)).astype(
                np.float32) for n in (2, 4)}}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """One spawn of n gloo ranks per degree running
    ``torch_mp_ranks.checks``, started in threads so that they run while
    the reference computes (``ref``)."""
    pool = ThreadPoolExecutor(max_workers=2)
    futures = {}
    for n in (2, 4):
        case = {"rows": [np.arange(7, dtype=np.float32) + 10 * r
                         for r in range(n)],
                "blocks": np.split(inputs["full"][n], n, axis=-1),
                "x": inputs["x"], "gemms": inputs["gemms"]}
        payload = {k: inputs[k] for k in ("params", "params_odd", "prompts",
                                          "max_new")}
        payload["case"] = case
        futures[n] = pool.submit(
            env.launch, n, ranks.checks, payload, layout="cpu",
            timeout_s=240, init_dir=tmp_path_factory.mktemp(f"mp{n}"))
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ref(inputs, spawned):
    """Everything the reference computes, once: greedy tokens of
    ``generate_from_params`` and of its mp engines, and its ring rung's
    gathers on the collectives' case."""
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    prompts, max_new = inputs["prompts"], inputs["max_new"]
    out = {"generate": [np.asarray(generate_from_params(
        params, np.asarray(p)[None], JCFG, max_new_tokens=m)._data)[
            0, len(p):].tolist() for p, m in zip(prompts, max_new)]}

    def engine_tokens(mp, rung, quant=None):
        eng = jserving.Engine(params=params, config=JCFG, mp=mp,
                              comm_backend=rung, quant=quant,
                              **{k: v for k, v in ranks.ENGINE_KW.items()
                                 if k != "device"})
        reqs = [jserving.Request(np.asarray(p), max_new_tokens=m)
                for p, m in zip(prompts, max_new)]
        res = eng.run(reqs)
        return [res[r.request_id].tokens for r in reqs]

    out["engine"] = {(n, None): engine_tokens(n, "ring") for n in (2, 4)}
    for dtype, n, rung in JAX_QUANT:
        out["engine"][(1, dtype)] = engine_tokens(None, None, dtype)
        out["engine"][(n, dtype)] = engine_tokens(n, rung, dtype)

    gemms = inputs["gemms"]
    ws = [jnp.asarray(w if s is None else
                      w.view(jquant.STORE_DTYPES[k.split("/")[0]]))
          for k, (w, s) in gemms.items()]
    ss = [jnp.asarray(s) for _, s in gemms.values() if s is not None]
    out["ring"] = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))

        def device_fn(x, blk, w32, w8, wf8, s8, sf8, n=n):
            return (jmp.ag_last(blk, "mp", n, "ring", None),
                    jmp.gemm_ag(x, w32, "mp", n, "ring", None),
                    jmp.gemm_ag(x, w8, "mp", n, "ring", None, scale=s8),
                    jmp.gemm_ag(x, wf8, "mp", n, "ring", None, scale=sf8))

        col = P(None, "mp")
        fn = jax.jit(shard_map_compat(
            device_fn, mesh,
            in_specs=(P(None, None), P(None, None, "mp"), col, col, col,
                      P("mp"), P("mp")),
            out_specs=(P(None, None, None),) + (P(None, None),) * 3))
        ag, *ys = fn(jnp.asarray(inputs["x"]),
                     jnp.asarray(inputs["full"][n]), *ws, *ss)
        out["ring"][(n, "ag_last")] = np.asarray(ag)
        for name, y in zip(gemms, ys):
            out["ring"][(n, name)] = np.asarray(y)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"mp{n}")
def run(request, spawned, ref):
    """(n, every rank's results) of the degree's spawn."""
    return request.param, spawned[request.param].result()


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(o[key], first)
        else:
            assert o[key] == first, f"{key}: rank {o['rank']} differs"
    return first


# ---------------------------------------------------------- collectives
def test_all_gathers_are_exact_on_every_rank_and_rung(run, ref, inputs):
    n, outs = run
    rows = np.stack([np.arange(7, dtype=np.float32) + 10 * r
                     for r in range(n)])
    full, jax_out = inputs["full"][n], ref["ring"][(n, "ag_last")]
    np.testing.assert_array_equal(jax_out, full)
    for o in outs:
        np.testing.assert_array_equal(o["ag_bucket_plain"], rows)
        np.testing.assert_array_equal(o["fused_ag_bucket"], rows)
        for rung in ranks.RUNGS:
            np.testing.assert_array_equal(o[f"ag_last/{rung}"], full)


@pytest.mark.parametrize("name", ["fp32/w", "int8/w", "fp8/w"])
def test_gemm_ag_matches_reference_ring_rung(run, ref, name):
    """The plain GEMM + all-gather against the reference's ring rung
    (summation order only), and every rung and rank bitwise equal to it."""
    n, outs = run
    want = ref["ring"][(n, name)]
    got = _same_on_every_rank(outs, f"gemm_ag_plain/{name}")
    assert got.shape == want.shape == (5, 96)
    np.testing.assert_allclose(got, want, rtol=SUM_TOL,
                               atol=SUM_TOL * np.abs(want).max())
    for rung in ranks.RUNGS:
        np.testing.assert_array_equal(
            _same_on_every_rank(outs, f"gemm_ag/{rung}/{name}"), got)


@pytest.mark.parametrize("name", ["fp32/w", "int8/w", "fp8/w"])
def test_gemm_ag_peer_plain_is_gemm_ag_plain_bit_for_bit(run, ref, name):
    """Rows 12-13's peer schedule in plain form (every rank's block stored
    into its slot of the call's parity, the output copied out of the
    slots as the gather kernel copies them) on every rank and at both
    parities: bit for bit the plain GEMM + all-gather, and so within
    summation order of the reference's ring rung."""
    n, outs = run
    want = ref["ring"][(n, name)]
    for o in outs:
        for got in o[f"gemm_ag_peer_plain/{name}"]:
            np.testing.assert_array_equal(got, o[f"gemm_ag_plain/{name}"])
            np.testing.assert_allclose(got, want, rtol=SUM_TOL,
                                       atol=SUM_TOL * np.abs(want).max())


def test_gemm_ag_staging_holds_the_largest_block_twice():
    """The ``"gemm_ag"`` channel's size: two slots of the largest block,
    each rounded up to the slot alignment; at GPT-3 1.3B mp=4 (8 slots,
    chunk 256) the fp32 head's [8, 12576] block is the largest."""
    from paddle_tpu_torch.models import GPT_CONFIGS
    from paddle_tpu_torch.ops import fused_collectives as fc
    from paddle_tpu_torch.serving import mp_forward
    a = fc.GEMM_AG_ALIGN
    assert fc.gemm_ag_staging_bytes([(1, a, 1)]) == 2 * a
    assert fc.gemm_ag_staging_bytes([(1, a + 1, 1)]) == 4 * a
    assert fc.gemm_ag_staging_bytes([(8, 512, 2), (3, 100, 4)]) == 16384
    cfg = GPT_CONFIGS["gpt3-1.3B"]
    blocks = mp_forward.gemm_ag_blocks(cfg, 4, 256, 8, True)
    assert blocks == [(256, 512, 2), (8, 12576, 4)]
    assert fc.gemm_ag_staging_bytes(blocks) == 2 * 8 * 12576 * 4
    # a vocab that does not divide keeps the head out of the channel
    assert mp_forward.gemm_ag_blocks(cfg, 4, 256, 8, False) == [
        (256, 512, 2)]
    assert mp_forward.gemm_ag_blocks(TCFG, 2, 8, 4, True) == [
        (8, 32, 4), (4, 48, 4)]


@pytest.mark.parametrize("call", [1, 2, 3, 4])
def test_gemm_ag_slot_follows_the_call_parity(call):
    """Call number e reads and writes slot e & 1, half the staging
    (aligned down) past slot 0, the same offset in every rank's
    staging."""
    from paddle_tpu_torch.ops import fused_collectives as fc
    a = fc.GEMM_AG_ALIGN
    for capacity, half in ((4 * a, 2 * a), (5 * a + 7, 2 * a),
                           (4 * 2 ** 20, 2 * 2 ** 20)):
        par, off = fc.gemm_ag_slot(capacity, call)
        assert par == call % 2
        assert off == par * half
        assert off % a == 0 and off + half <= capacity


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_gemm_ag_peer_plain_puts_rank_p_block_at_columns_p(rank):
    """Block p of the peer schedule's output is rank p's own GEMM block,
    bit for bit, on every rank, at both parities, with the slots of a
    staging just large enough and of one with room to spare; int8 shards
    with their scales."""
    from paddle_tpu_torch.ops import fused_collectives as fc
    from paddle_tpu_torch.serving.quant import _quantize_leaf
    n, K, Fl = 4, 32, 16
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32))
    full = [torch.from_numpy(rng.standard_normal((K, Fl)).astype(
        np.float32)) for _ in range(n)]
    for ws, ss in ((full, None),
                   tuple(map(list, zip(*(_quantize_leaf(w, "int8")
                                         for w in full))))):
        want = [fc._gemm_block(x, w, None if ss is None else ss[p])
                for p, w in enumerate(ws)]
        for calls in (0, 1):
            for capacity in (None, 3 * 2 ** 12 + 40):
                got = fc.gemm_ag_peer_plain(x, ws, rank, ss, calls,
                                            capacity)
                assert got.shape == (2, 3, n * Fl)
                for p in range(n):
                    assert torch.equal(got[..., p * Fl:(p + 1) * Fl],
                                       want[p]), (p, calls, capacity)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_params_head_major_bitwise(inputs, dtype, pinned):
    """Quantizing the head-major tree with ``qkv_perm``: the bytes and the
    scales (pinned ones relabeled with their columns) bit for bit."""
    H, nh = JCFG.hidden_size, JCFG.num_heads
    scales = None
    if pinned:
        b = inputs["params"]["blocks"]
        scales = {"blocks": {k: (np.abs(b[k]).max(axis=-2) / 100.0
                                 ).astype(np.float32)
                             for k in tquant.BLOCK_WEIGHTS},
                  "head_w": (np.abs(inputs["params"]["head_w"]).max(axis=0)
                             / 100.0).astype(np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    jtree = {**jtree, "blocks": jtp.to_qkv_head_major(jtree["blocks"], H, nh)}
    jq = jquant.quantize_params(
        jtree, JCFG, jquant.QuantSpec(dtype, "bf16", weight_scales=scales),
        qkv_perm=jtp.qkv_head_major_perm(H, nh))
    ttree = params_from_numpy(inputs["params"], TCFG, device="cpu")
    ttree = {**ttree,
             "blocks": tp_overlap.to_qkv_head_major(ttree["blocks"], H, nh)}
    tq = tquant.quantize_params(
        ttree, TCFG, tquant.QuantSpec(dtype, "bf16", weight_scales=scales),
        qkv_perm=tp_overlap.qkv_head_major_perm(H, nh))
    np.testing.assert_array_equal(tp_overlap.qkv_head_major_perm(H, nh),
                                  jtp.qkv_head_major_perm(H, nh))
    for name in tquant.BLOCK_WEIGHTS:
        np.testing.assert_array_equal(_bytes(tq["blocks"][name]),
                                      _bytes(jq["blocks"][name]))
        np.testing.assert_array_equal(tq["blocks"][name + "_s"].numpy(),
                                      np.asarray(jq["blocks"][name + "_s"]))
    np.testing.assert_array_equal(_bytes(tq["head_w"]), _bytes(jq["head_w"]))


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
def test_greedy_tokens_equal_reference_on_every_rung_and_rank(run, ref,
                                                              quant):
    """At int8/fp8 the reference's one-chip quantized engine is the want
    at both degrees; its mp engine equals it where it ran (JAX_QUANT)."""
    n, outs = run
    if quant == "fp32":
        want = ref["engine"][(n, None)]
        assert want == ref["generate"]      # the reference's own contract
    else:
        want = ref["engine"][(1, quant)]
        assert ref["engine"].get((n, quant), want) == want
    for rung in ("single",) + ranks.RUNGS:
        assert _same_on_every_rank(outs, f"tokens/{rung}/{quant}") == want, \
            f"{rung} rung at {quant}"


@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
def test_logits_bitwise_across_rungs_ranks_and_one_device(run, quant):
    n, outs = run
    single = _same_on_every_rank(outs, f"logits/single/{quant}")
    assert np.isfinite(single).all() and single.shape == (2, 4, 96)
    for rung in ranks.RUNGS:
        np.testing.assert_array_equal(
            _same_on_every_rank(outs, f"logits/{rung}/{quant}"), single)


def test_sampled_streams_equal_across_ranks_and_one_device(run):
    n, outs = run
    got = _same_on_every_rank(outs, "sampled/fused")
    assert got == _same_on_every_rank(outs, "sampled/single")
    assert all(len(t) == 6 for t in got)


def test_admission_order_invariance(run, ref):
    n, outs = run
    assert _same_on_every_rank(outs, "reversed/fused") == \
        ref["engine"][(n, None)]


def test_indivisible_vocab_keeps_a_replicated_head(run, ref):
    """V=97 over mp 2 or 4: the embedding shards by feature, the head and
    the logits stay replicated; tokens as the port's one-device engine."""
    n, outs = run
    assert _same_on_every_rank(outs, "odd/shard_vocab") is False
    assert _same_on_every_rank(outs, "odd/head_shape") == (64, 97)
    assert _same_on_every_rank(outs, "odd/tokens") == \
        _same_on_every_rank(outs, "odd/single")


@pytest.mark.parametrize("quant", ["fp32", "int8", "fp8"])
def test_kv_bytes_per_rank_are_one_nth(run, quant):
    n, outs = run
    pool, per_tok = _same_on_every_rank(outs, f"kv/single/{quant}")
    scale_bytes = 0 if quant == "fp32" else -(-2 * 2 * 4 // 8)
    for rung in ranks.RUNGS:
        p_r, t_r = _same_on_every_rank(outs, f"kv/{rung}/{quant}")
        assert p_r * n == pool
        # the page scales are replicated: only K/V bytes divide
        assert (t_r - scale_bytes) * n == per_tok - scale_bytes


def test_deadlines_on_rank0_and_callbacks_on_rank0_only(run):
    n, outs = run
    assert _same_on_every_rank(outs, "deadline") == serving.EXPIRED
    assert len(outs[0]["callbacks"]) == 3
    assert all(o["callbacks"] == [] for o in outs[1:])


@pytest.mark.parametrize("rung", ranks.RUNGS)
def test_mp_counters_follow_the_reference_wire_record(run, rung):
    """Per dispatch the static record of the reference's schedule: 1 + 4L
    (+1 vocab-sharded) all-gathers, fused launches on the fused rung."""
    n, outs = run
    c = _same_on_every_rank(outs, f"counters/{rung}/fp32")
    assert c["mp_steps"] == c["paged_steps"] > 0
    assert c["mp_collectives"] == c["paged_steps"] * (1 + 4 * 2 + 1)
    assert c["mp_fused_dispatches"] == (c["mp_collectives"]
                                        if rung == "fused" else 0)
    assert c["mp_wire_bytes"] > 0


@pytest.mark.parametrize("shape", [(4, 1), (1, 8), (1, 32)])
@pytest.mark.parametrize("vocab", [96, 97])
def test_serving_step_record_equals_reference(shape, vocab):
    for n in (2, 4):
        for rung in ranks.RUNGS:
            jcfg = JaxGPTConfig(**{**ranks.CFG_KW, "vocab_size": vocab})
            want = jtp.serving_step_record(
                jcfg, jtp.ServingMPConfig("mp", n, rung, vocab % n == 0),
                *shape)
            got = tp_overlap.serving_step_record(
                ranks.config(vocab),
                tp_overlap.ServingMPConfig(n, rung, vocab % n == 0), *shape)
            for k in ("collectives", "ppermute_hops", "fused_dispatches",
                      "ag_bytes", "activation_bytes", "bytes_by_kind"):
                assert getattr(got, k) == getattr(want, k), (n, rung, k)


# ------------------------------------------------------ errors and flags
def test_indivisible_heads_raise():
    with pytest.raises(ValueError, match="must divide hidden 64, heads 4"):
        tp_overlap.resolve_serving(TCFG, 8)
    with pytest.raises(ValueError, match="must divide"):
        tp_overlap.resolve_serving(TCFG, 3)
    assert tp_overlap.resolve_serving(TCFG, 1) is None


def test_fused_resolver_raises_where_the_reference_steps_down():
    """On CUDA tensors the fused rung raises, naming the GEMM and why; the
    reference quietly steps 'fused' down to 'ring' there. The CPU takes
    the plain versions, so nothing is refused there."""
    assert tp_overlap.resolve_serving(TCFG, 2, "fused",
                                      device="cpu").backend == "fused"
    with pytest.raises(ValueError, match="fused serving rung cannot run"
                       ".*out_w.*float16"):
        tp_overlap.resolve_serving(TCFG, 2, "fused", device="cuda",
                                   weight_dtypes={"out_w": torch.float16})
    bf16 = ranks.GPTConfig(**{**ranks.CFG_KW, "compute_dtype": "bfloat16",
                              "hidden_size": 40, "num_heads": 4})
    with pytest.raises(ValueError, match="not a multiple of 16"):
        tp_overlap.resolve_serving(bf16, 2, "fused", device="cuda",
                                   weight_dtypes={"head_w": torch.bfloat16})
    ok = ranks.GPTConfig(**{**ranks.CFG_KW, "compute_dtype": "bfloat16"})
    with pytest.raises(ValueError, match="down_w.*float32 weights need "
                       "float32 x"):
        tp_overlap.resolve_serving(ok, 2, "fused", device="cuda",
                                   weight_dtypes={"down_w": torch.float32})
    # the LM head at bf16, or as the caller passed it at fp32 (the fp32
    # weight instance); fp32 blocks against fp32 x
    for head in (torch.bfloat16, torch.float32):
        assert tp_overlap.resolve_serving(
            ok, 2, "fused", device="cuda",
            weight_dtypes={"head_w": head}).shard_vocab
    assert tp_overlap.resolve_serving(TCFG, 2, "fused",
                                      device="cuda").backend == "fused"
    with pytest.raises(ValueError, match="comm_backend must be one of"):
        tp_overlap.resolve_serving(TCFG, 2, "nccl")


def test_flags_pick_the_rung_and_the_degree():
    """FLAGS_comm_backend picks the rung; the degree is the group's size
    (an SPMD engine has no degree without a group), so there is no
    FLAGS_serving_mp to set."""
    before = get_flags(["FLAGS_comm_backend"])
    assert before == {"FLAGS_comm_backend": ""}
    try:
        for spec in ("mp=ring", "mp=fused,dp=ring", "gspmd"):
            set_flags({"FLAGS_comm_backend": spec})
            assert comm_backend.serving_requested() == \
                jcb.parse(spec).get("mp")
            assert tp_overlap.resolve_serving(TCFG, 2).backend == \
                jcb.parse(spec)["mp"]
        set_flags({"FLAGS_comm_backend": "mp=bogus"})
        assert comm_backend.parse("mp=bogus") == {}
        assert tp_overlap.resolve_serving(TCFG, 2).backend == "gspmd"
        with pytest.raises(KeyError, match="FLAGS_serving_mp"):
            set_flags({"FLAGS_serving_mp": 2})
        params = params_from_numpy(_np(jax_init_params(
            JCFG, jax.random.key(0))), TCFG, device="cpu")
        eng = serving.Engine(params=params, config=TCFG, device="cpu")
        assert eng.mp == 1 and eng.group is None
        with pytest.raises(ValueError, match="needs group="):
            serving.Engine(params=params, config=TCFG, device="cpu", mp=2)
    finally:
        set_flags(before)


@pytest.mark.parametrize("head_dtype", [torch.float32, torch.bfloat16])
def test_head_keeps_the_dtype_the_caller_passed(head_dtype):
    """At a bf16 compute dtype a full-precision LM head is stored in the
    dtype it was passed in, whatever its values: an fp32 head whose values
    all happen to be bf16 values stays fp32, so whether the fused rung
    can take it never depends on the weights."""
    from paddle_tpu_torch.serving.mp_forward import shard_serving_params
    cfg = ranks.GPTConfig(**{**ranks.CFG_KW, "compute_dtype": "bfloat16"})
    params = params_from_numpy(_np(jax_init_params(JCFG, jax.random.key(0))),
                               cfg, device="cpu")
    # bf16 values in the caller's dtype
    params["head_w"] = params["head_w"].to(torch.bfloat16).to(head_dtype)
    for rank in range(2):
        sh = shard_serving_params(params, cfg, 2, rank, True)
        assert sh["head_w"].dtype == head_dtype
        np.testing.assert_array_equal(
            sh["head_w"].float().numpy(),
            params["head_w"][:, rank * 48:(rank + 1) * 48].float().numpy())
    assert tp_overlap.resolve_serving(
        cfg, 2, "fused", device="cuda",
        weight_dtypes={"head_w": head_dtype}).backend == "fused"


def test_engine_mesh_raises_pointing_to_group():
    params = params_from_numpy(_np(jax_init_params(JCFG, jax.random.key(0))),
                               TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match="group="):
        serving.Engine(params=params, config=TCFG, device="cpu",
                       mesh=object())
    with pytest.raises(ValueError, match="needs group="):
        serving.Engine(params=params, config=TCFG, device="cpu", mp=2)


def test_launch_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1.*ZeroDivisionError"):
        env.launch(2, ranks.fail_on_rank1, layout="cpu", timeout_s=60,
                   init_dir=tmp_path)
