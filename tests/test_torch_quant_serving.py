"""The port's quantized serving (paddle_tpu_torch/serving/quant.py,
ops/quant_gemm.py, the quantized paged pool and decode) against the
reference on the same weights and inputs, on the CPU:

* weight quantization bit for bit (int8 and fp8 bytes, fp32 scales);
* calibration (page scales, KV clip ranges with absmax and percentile
  observers, weight scales) within 1e-6 relative: the K/V the clips are
  read from differ by fp32 summation order;
* the plain quantized GEMM against the reference's jnp algebra (1e-5) and
  its Pallas kernel in interpret mode (its own rtol 1e-3, atol 1e-4);
* the plain quantized paged decode against the reference's Pallas kernel
  in interpret mode (2e-5), and the quantized KV scatter byte for byte;
* the fused paged forward and the logit drift at four dtype configs;
* the quantized Engine: admission-order invariance, greedy tokens equal
  to the reference's quantized engine, prefix sharing and copy-on-write
  with page scales, the memory-equal capacity gain, flags and errors.

The reference's test config (V=96, H=64, L=2, 4 heads, fp32) keeps the
JAX engine runs short; they run once per dtype through a module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu.ops.pallas_kernels import quant_gemm as jqg
from paddle_tpu.quantization import PercentileObserver as JaxPercentile
from paddle_tpu.serving import paged_attention as jpa
from paddle_tpu.serving import quant as jquant
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.models import GPTConfig, cast_for_compute, \
    params_from_numpy
from paddle_tpu_torch.ops.quant_gemm import (quant_gemm, quant_gemm_plain,
                                             unsupported_reason)
from paddle_tpu_torch.quantization import PercentileObserver
from paddle_tpu_torch.serving import quant as tquant
from paddle_tpu_torch.serving.paged_attention import (new_pool,
                                                      paged_forward,
                                                      paged_kv_scatter)
from paddle_tpu_torch.serving.paged_decode import (
    paged_decode_attention_q, paged_decode_q_plain)

CFG_KW = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=False)
JCFG = JaxGPTConfig(**CFG_KW)
TCFG = GPTConfig(**CFG_KW)
V = TCFG.vocab_size
STORE = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
SAMPLE = list(range(1, 33))


@pytest.fixture(scope="module")
def np_params():
    tree = jax_init_params(JCFG, jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return params_from_numpy(tree, TCFG, device="cpu")


def _bytes(t):
    """Raw bytes of a torch or jax array as uint8 numpy."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _engine(params, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("config", TCFG)
    return serving.Engine(params=params, device="cpu", **kw)


# ---------------------------------------------------------- quantization
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_leaf_bitwise_equals_reference(dtype, pinned):
    """Bytes and scales bit for bit; the weights carry outliers that
    clip at pinned scales and values on rounding ties."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 64, 96)) * 0.02).astype(np.float32)
    w[0, 3, 5] = 0.9
    w[1, :, 7] = np.float32(0.25)            # exact multiples of a scale
    scale = (np.abs(w).max(axis=-2) / 200.0).astype(np.float32) \
        if pinned else None
    jq, js = jquant._quantize_leaf(jnp.asarray(w), dtype, scale)
    tq, ts = tquant._quantize_leaf(torch.from_numpy(w), dtype, scale)
    assert tq.dtype == STORE[dtype][1]
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantize_params_bitwise_and_cast_keeps_them(np_params, dtype):
    spec = tquant.QuantSpec(dtype, "bf16")
    jtree = jquant.quantize_params(_jax(np_params), JCFG,
                                   jquant.QuantSpec(dtype, "bf16"))
    ttree = cast_for_compute(tquant.quantize_params(
        _torch(np_params), TCFG, spec), TCFG)
    for name in tquant.BLOCK_WEIGHTS:
        np.testing.assert_array_equal(_bytes(ttree["blocks"][name]),
                                      _bytes(jtree["blocks"][name]))
        assert ttree["blocks"][name + "_s"].dtype == torch.float32
        np.testing.assert_array_equal(ttree["blocks"][name + "_s"].numpy(),
                                      np.asarray(jtree["blocks"][name + "_s"]))
    np.testing.assert_array_equal(_bytes(ttree["head_w"]),
                                  _bytes(jtree["head_w"]))
    assert ttree["head_w"].dtype == STORE[dtype][1]
    assert tquant.scale_bytes(ttree) == jquant.scale_bytes(jtree)


def test_cast_keeps_fp32_only_the_scales_of_quantized_weights(np_params):
    """At bf16 compute, a quantized weight's ``<name>_s`` stays float32;
    a leaf that merely ends in ``_s`` is cast like any other."""
    bf16 = GPTConfig(**{**CFG_KW, "compute_dtype": "bfloat16"})
    tree = tquant.quantize_params(_torch(np_params), TCFG,
                                  tquant.QuantSpec("int8", "bf16"))
    tree["blocks"]["extra_s"] = torch.ones(2, 3)
    out = cast_for_compute(tree, bf16)
    for name in tquant.BLOCK_WEIGHTS:
        assert out["blocks"][name].dtype == torch.int8
        assert out["blocks"][name + "_s"].dtype == torch.float32
    assert out["head_w_s"].dtype == torch.float32
    assert out["blocks"]["extra_s"].dtype == torch.bfloat16


# ------------------------------------------------------------ calibration
def test_page_scales_equal_reference():
    clip = np.array([0.5, 3.0, 0.0])
    for qmax in (127.0, 448.0):
        np.testing.assert_array_equal(tquant.page_scales(clip, 5, qmax),
                                      jquant.page_scales(clip, 5, qmax))


@pytest.mark.parametrize("observer", ["absmax", "percentile"])
def test_kv_ranges_match_reference(np_params, observer):
    jf = (lambda: JaxPercentile(99.9)) if observer == "percentile" else None
    tf = (lambda: PercentileObserver(99.9)) if observer == "percentile" \
        else None
    jk, jv = jquant.kv_ranges(_jax(np_params), JCFG, SAMPLE,
                              observer_factory=jf)
    tk, tv = tquant.kv_ranges(_torch(np_params), TCFG, SAMPLE,
                              observer_factory=tf)
    np.testing.assert_allclose(tk, jk, rtol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_calibrate_matches_reference(np_params):
    jspec = jquant.calibrate(_jax(np_params), JCFG, sample_ids=SAMPLE)
    tspec = tquant.calibrate(_torch(np_params), TCFG, sample_ids=SAMPLE)
    for name in tquant.BLOCK_WEIGHTS:
        np.testing.assert_array_equal(tspec.weight_scales["blocks"][name],
                                      jspec.weight_scales["blocks"][name])
    np.testing.assert_array_equal(tspec.weight_scales["head_w"],
                                  jspec.weight_scales["head_w"])
    np.testing.assert_allclose(tspec.kv_k_clip, jspec.kv_k_clip, rtol=1e-6)
    np.testing.assert_allclose(tspec.kv_v_clip, jspec.kv_v_clip, rtol=1e-6)
    # a calibrated spec drives the engine
    res = _engine(_torch(np_params), quant=tspec).run(
        [serving.Request([1, 2, 3, 4], max_new_tokens=3)])
    assert len(list(res.values())[0].tokens) == 3


# --------------------------------------------------------- quant GEMM
@pytest.mark.parametrize("R", [1, 8, 24])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quant_gemm_plain_matches_reference(dtype, R):
    """fp32 x: the plain version against the reference's jnp algebra
    (1e-5 of the output's scale: the 256-term sums of values up to ~30
    differ in summation order only) and its Pallas kernel in interpret
    mode (the reference's own tolerance for the kernel's k-tiled order)."""
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    jw, js = jquant._quantize_leaf(jnp.asarray(w), dtype)
    tw, ts = tquant._quantize_leaf(torch.from_numpy(w), dtype)
    got = quant_gemm_plain(torch.from_numpy(x), tw, ts).numpy()
    ref = np.asarray(jqg.quant_gemm(jnp.asarray(x), jw, js))
    kern = np.asarray(jqg.quant_gemm_kernel(jnp.asarray(x), jw, js,
                                            interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(got, kern, rtol=1e-3, atol=1e-4)


def test_quant_gemm_routes_plain_on_cpu_and_names_limits():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    wq, s = tquant._quantize_leaf(torch.randn(32, 48), "int8")
    before = quant_gemm.launches
    got = quant_gemm(x, wq, s, use_kernel=True)
    assert quant_gemm.launches == before
    assert got.shape == (2, 3, 48)
    assert torch.equal(got, quant_gemm_plain(x, wq, s))
    assert unsupported_reason(2048, 50304, torch.int8, torch.float32) is None
    why = unsupported_reason(40, 100, torch.float16, torch.float16)
    assert "contraction dim 40" in why and "out dim 100" in why
    assert "weight dtype" in why and "x dtype" in why


# ------------------------------------------------- quantized paged decode
def _qpool(rng, dtype, P, ps, nh, d):
    if dtype == "int8":
        vals = rng.integers(-127, 128, (P, ps, nh, d))
        return np.asarray(vals, np.int8), torch.from_numpy(
            np.asarray(vals, np.int8))
    vals = np.clip(rng.standard_normal((P, ps, nh, d)) * 60, -448,
                   448).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.float8_e4m3fn)
    return np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)), t


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_paged_decode_q_plain_matches_reference_kernel(dtype, ps):
    """Positions at 0 and at page boundaries; unmapped pages are page 0."""
    rng = np.random.default_rng(7)
    B, nh, d, P = 4, 4, 64, 11
    pos = np.array([0, ps - 1, ps, 3 * ps - 1], np.int32)
    MP = 4
    table = rng.integers(1, P, (B, MP)).astype(np.int32)
    for b, p in enumerate(pos):
        table[b, p // ps + 1:] = 0
    q = rng.standard_normal((B, nh, d)).astype(np.float32)
    jk, tk = _qpool(rng, dtype, P, ps, nh, d)
    jv, tv = _qpool(rng, dtype, P, ps, nh, d)
    ksc = rng.uniform(0.01, 0.1, P).astype(np.float32)
    vsc = rng.uniform(0.01, 0.1, P).astype(np.float32)
    want = jpa.paged_decode_attention_q(
        jnp.asarray(q), jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(ksc), jnp.asarray(vsc), page_size=ps,
        interpret=True)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(ksc),
            torch.from_numpy(vsc), ps)
    got = paged_decode_q_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    before = paged_decode_attention_q.launches
    assert torch.equal(paged_decode_attention_q(*args), got)
    assert paged_decode_attention_q.launches == before


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_paged_kv_scatter_quantizes_like_reference(dtype):
    """A chunk window with padding lanes and a decode window: the pool
    bytes equal the reference's (the trash page aside, whose bytes depend
    on which duplicate write lands last)."""
    rng = np.random.default_rng(9)
    ps, P, nh, d = 8, 9, 4, 16
    jdt, tdt = STORE[dtype]
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    ksc = rng.uniform(0.01, 0.05, P).astype(np.float32)
    vsc = rng.uniform(0.01, 0.05, P).astype(np.float32)
    ksc[0] = vsc[0] = 1.0
    jk = jnp.zeros((P, ps, nh, d), jdt)
    jv = jnp.zeros((P, ps, nh, d), jdt)
    tk = new_pool((P, ps, nh, d), tdt, "cpu")
    tv = new_pool((P, ps, nh, d), tdt, "cpu")
    for start, T, valid in ((np.array([3, 0]), 12, np.array([12, 5])),
                            (np.array([15, 5]), 1, np.array([1, 1]))):
        k = (rng.standard_normal((2, T, nh, d)) * 2).astype(np.float32)
        v = (rng.standard_normal((2, T, nh, d)) * 2).astype(np.float32)
        pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
        jk, jv = jpa.paged_kv_scatter(
            jk, jv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
            jnp.asarray(pos), jnp.asarray(valid.astype(np.int32)), ps,
            jnp.asarray(ksc), jnp.asarray(vsc))
        paged_kv_scatter(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(table), torch.from_numpy(pos),
                         torch.from_numpy(valid.astype(np.int32)), ps,
                         torch.from_numpy(ksc), torch.from_numpy(vsc))
    np.testing.assert_array_equal(_bytes(tk)[1:], _bytes(jk)[1:])
    np.testing.assert_array_equal(_bytes(tv)[1:], _bytes(jv)[1:])
    assert _bytes(tk)[1:].any()


# ----------------------------------------------- fused forward and drift
CONFIGS = [("int8", "bf16"), ("bf16", "int8"), ("int8", "int8"),
           ("fp8", "fp8")]


@pytest.mark.parametrize("wd,kd", CONFIGS)
def test_paged_forward_quantized_matches_reference(np_params, wd, kd):
    """A prefill chunk and a decode step through the quantized forward on
    both sides, same weights, scales and table: logits within 1e-5."""
    ps, MP = 8, 4
    P = 2 * MP + 1
    L, nh, d = TCFG.num_layers, TCFG.num_heads, TCFG.hidden_size // 4
    jspec = jquant.ensure_kv_clips(jquant.QuantSpec(wd, kd),
                                   _jax(np_params), JCFG)
    tspec = tquant.QuantSpec(wd, kd, kv_k_clip=jspec.kv_k_clip,
                             kv_v_clip=jspec.kv_v_clip)
    jp = jquant.quantize_params(_jax(np_params), JCFG, jspec)
    tp = cast_for_compute(tquant.quantize_params(_torch(np_params), TCFG,
                                                 tspec), TCFG)
    jstore = jnp.float32 if kd == "bf16" else STORE[kd][0]
    tstore = torch.float32 if kd == "bf16" else STORE[kd][1]
    jk = jnp.zeros((L, P, ps, nh, d), jstore)
    jv = jnp.zeros((L, P, ps, nh, d), jstore)
    tk = new_pool((L, P, ps, nh, d), tstore, "cpu")
    tv = new_pool((L, P, ps, nh, d), tstore, "cpu")
    jsc = tsc = None
    if kd != "bf16":
        sc = tquant.kv_scales_for(tspec, L, P)
        jsc = tuple(jnp.asarray(s) for s in sc)
        tsc = tuple(torch.from_numpy(s) for s in sc)
    table = np.arange(1, 2 * MP + 1, dtype=np.int32).reshape(2, MP)
    rng = np.random.default_rng(4)
    steps = [(rng.integers(0, V, (2, 16)), np.array([0, 0]),
              np.array([16, 11])),
             (rng.integers(0, V, (2, 1)), np.array([16, 11]),
              np.array([1, 1]))]
    for ids, start, valid in steps:
        a = [ids.astype(np.int32), start.astype(np.int32),
             valid.astype(np.int32)]
        want, jk, jv = jpa.paged_forward(
            jp, JCFG, jnp.asarray(a[0]), jk, jv, jnp.asarray(a[1]),
            jnp.asarray(a[2]), jnp.asarray(table), ps, False, kv_scales=jsc)
        got = paged_forward(tp, TCFG, torch.from_numpy(a[0]).long(), tk, tv,
                            torch.from_numpy(a[1]), torch.from_numpy(a[2]),
                            torch.from_numpy(table), ps, kv_scales=tsc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wd,kd", CONFIGS)
def test_max_logit_drift_matches_reference(np_params, wd, kd):
    prompt = list(range(1, 14))
    jd, jm = jquant.max_logit_drift(_jax(np_params), JCFG,
                                    jquant.QuantSpec(wd, kd), prompt)
    td, tm = tquant.max_logit_drift(_torch(np_params), TCFG,
                                    tquant.QuantSpec(wd, kd), prompt)
    # the drift is a difference of two logit vectors, each within fp32
    # summation order of the reference's: 1e-5 of the logit scale
    assert td > 0.0
    assert abs(td - jd) <= 1e-5 * max(jm, 1.0)
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    assert td < 0.15 * max(tm, 1.0)


# ------------------------------------------------------------------ engine
_PROMPTS = ((3, 4), (5, 6), (9, 4), (13, 6), (21, 5), (30, 3))


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [serving.Request(rng.integers(0, V, plen), max_new_tokens=mnt)
            for plen, mnt in _PROMPTS]


@pytest.fixture(scope="module")
def reference_engine_tokens(np_params):
    """Greedy tokens of the reference's quantized engine, one run per
    dtype, on the shared weights."""
    out = {}
    for dtype in ("int8", "fp8"):
        eng = jserving.Engine(params=_jax(np_params), config=JCFG,
                              num_slots=3, max_seq_len=96, page_size=8,
                              prefill_chunk=16, quant=dtype)
        reqs = [jserving.Request(r.prompt.copy(),
                                 max_new_tokens=r.max_new_tokens)
                for r in _requests(1)]
        res = eng.run(reqs)
        out[dtype] = [res[r.request_id].tokens for r in reqs]
    return out


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quant_engine_order_invariant_and_matches_reference(
        np_params, reference_engine_tokens, dtype):
    """Two admission orders give the same tokens, bit for bit, and those
    are the reference's quantized engine's greedy tokens."""
    runs = []
    for order in (1, -1):
        reqs = _requests(1)
        eng = _engine(_torch(np_params), quant=dtype)
        for r in reqs[::order]:
            eng.submit(r)
        res = eng.run()
        runs.append([res[r.request_id].tokens for r in reqs])
        bal = eng.pool.balance()
        assert bal["conserved"] and bal["refcounts_accounted"]
    assert runs[0] == runs[1]
    assert runs[0] == reference_engine_tokens[dtype]


def _prefix_wave(eng):
    """A cached prompt, then an exact repeat (copy-on-write of its partial
    last page) and a sibling sharing its two full pages."""
    base = list(range(1, 22))                   # 2 full pages + 5 tokens
    eng.run([serving.Request(list(base), max_new_tokens=3)])
    wave = [serving.Request(list(base), max_new_tokens=4),
            serving.Request(base[:16] + [50, 51], max_new_tokens=4)]
    res = eng.run(wave)
    return [res[r.request_id].tokens for r in wave]


def test_quant_prefix_sharing_and_cow_keep_pages_and_scales(np_params):
    """Shared quantized prefix pages give the tokens of an engine without
    the prefix cache; a copy-on-write copies a page's scales with its
    bytes, on the host and on the device."""
    serving.reset_serving_counters()
    shared = _engine(_torch(np_params), quant="int8")
    got = _prefix_wave(shared)
    c = serving.serving_counters()
    assert c["prefix_hits"] >= 2 and c["cow_copies"] >= 1
    solo = _engine(_torch(np_params), quant="int8", prefix_cache=False)
    assert got == _prefix_wave(solo)
    bal = shared.pool.balance()
    assert bal["conserved"] and bal["refcounts_accounted"]

    # distinct scales per page, so a copy that left them behind shows
    eng = _engine(_torch(np_params), quant="int8")
    bump = np.linspace(1.0, 1.5, eng.pool.num_pages, dtype=np.float32)
    bump[0] = 1.0
    for host, dev in zip((eng.pool.k_scale, eng.pool.v_scale),
                         eng._kv_scales):
        host *= bump
        dev.copy_(torch.from_numpy(host))
    copies = []
    make_writable = eng.pool.make_writable

    def recording(b, start, end):
        out = make_writable(b, start, end)
        copies.extend(out)
        return out

    eng.pool.make_writable = recording
    _prefix_wave(eng)
    assert copies
    for src, dst in copies:
        assert bump[src] != bump[dst]
        np.testing.assert_array_equal(eng.pool.k_scale[:, dst],
                                      eng.pool.k_scale[:, src])
        np.testing.assert_array_equal(eng.pool.v_scale[:, dst],
                                      eng.pool.v_scale[:, src])
    for host, dev in zip((eng.pool.k_scale, eng.pool.v_scale),
                         eng._kv_scales):
        np.testing.assert_array_equal(dev.numpy(), host)


def test_memory_equal_capacity(np_params):
    """The same KV bytes hold twice the bf16 pages in int8, and admit a
    request the bf16 pool can never hold."""
    bcfg = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    params = _torch(np_params)
    fp = _engine(params, config=bcfg, num_slots=2, num_pages=12)
    q = _engine(params, config=bcfg, num_slots=2, num_pages=23,
                quant="int8")
    assert fp._kc.dtype == torch.bfloat16 and q._kc.dtype == torch.int8
    assert q.kv_shard_bytes() < fp.kv_shard_bytes()
    assert q.pool.num_pages - 1 == 2 * (fp.pool.num_pages - 1)
    assert 2 * q.kv_bytes_per_token() < fp.kv_bytes_per_token() + 64
    # 11 usable bf16 pages = 88 positions; 60 + 36 = 96 needs 12 pages
    big = serving.Request(np.random.default_rng(3).integers(0, V, 60),
                          max_new_tokens=36)
    with pytest.raises(ValueError, match="KV pages"):
        fp.submit(serving.Request(big.prompt.copy(), max_new_tokens=36))
    res = q.run([big])
    assert len(res[big.request_id].tokens) == 36
    c = serving.serving_counters()
    assert c["quant_kv_bytes_per_token"] == q.kv_bytes_per_token()
    assert c["quant_scale_bytes"] > 0
    assert "quant: w=int8 kv=int8" in serving.serving_summary()


def test_flags_drive_the_quant_default(np_params):
    params = _torch(np_params)
    flags = get_flags()
    assert flags["FLAGS_serving_weight_dtype"] == "bf16"
    assert flags["FLAGS_serving_kv_dtype"] == "bf16"
    assert flags["FLAGS_serving_quant_kernel"] is True
    plain = _engine(params)
    assert plain._quant is None and plain._kc.dtype == torch.float32
    assert "qkv_w_s" not in plain.params["blocks"]
    try:
        set_flags({"FLAGS_serving_weight_dtype": "fp8",
                   "FLAGS_serving_kv_dtype": "int8"})
        eng = _engine(params)
        assert (eng._quant.weight_dtype, eng._quant.kv_dtype) == \
            ("fp8", "int8")
        assert eng._kc.dtype == torch.int8
        assert eng.params["head_w"].dtype == torch.float8_e4m3fn
        assert _engine(params, quant="bf16")._quant is None
    finally:
        set_flags(flags)


def test_quant_spec_errors_name_the_leaf(np_params):
    params = _torch(np_params)
    spec = tquant.calibrate(params, TCFG, sample_ids=SAMPLE[:16])
    bad = dataclasses.replace(spec, weight_scales={
        "blocks": dict(spec.weight_scales["blocks"],
                       up_w=np.ones((2, 3), np.float32)),
        "head_w": spec.weight_scales["head_w"]})
    with pytest.raises(tquant.QuantSpecError, match="blocks.up_w"):
        _engine(params, quant=bad)
    with pytest.raises(tquant.QuantSpecError, match="kv_k_clip"):
        _engine(params, quant=dataclasses.replace(
            spec, kv_k_clip=np.ones(5)))
    with pytest.raises(tquant.QuantSpecError, match="int4"):
        tquant.QuantSpec("int4", "bf16")
    with pytest.raises(tquant.QuantSpecError, match="QuantSpec"):
        _engine(params, quant=8)
