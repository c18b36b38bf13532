"""The port's speculative decoding (paddle_tpu_torch/serving: the draft,
verify and rewind of paged_attention.py, the accept scan of
models/generation.py, the engine's spec path) on the CPU:

* op level against the reference's JAX functions on the same weights and
  pool bytes: ``paged_verify_forward`` (logits within 1e-5, the saved
  pre-write bytes equal), ``paged_kv_rewind`` (pool bytes equal),
  ``paged_draft_forward`` (proposals equal, fp and int8 draft trees,
  shallow, fp32 / int8 / fp8 pools) and ``_verify_accept`` (greedy
  tokens and run lengths equal);
* engine level, inside the port: greedy speculative streams equal the
  plain engine's bit for bit for two admission orders and every draft
  source; sampled and mixed streams replay ``generate_from_params``;
  ``speculate="off"``; a stop token inside an accepted run; the pool
  after rewinds byte for byte the plain engine's (page 0 aside), with and
  without prefix sharing; the degenerate self-draft of an int8 engine
  accepts every proposal; a speculative engine never dispatches the plain
  [B, 1] decode; the refusals;
* one greedy run whose tokens equal the reference's speculative engine.

The reference's spec-test config (V=97, H=64, L=2, 4 heads, fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_hybrid import init_gpt_params as jax_init_params
from paddle_tpu.serving import paged_attention as jpa
from paddle_tpu.serving import quant as jquant
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.models import (GPTConfig, cast_for_compute,
                                     generate_from_params, params_from_numpy)
from paddle_tpu_torch.models.generation import _verify_accept
from paddle_tpu_torch.serving import quant as tquant
from paddle_tpu_torch.serving.paged_attention import (new_pool,
                                                      paged_draft_forward,
                                                      paged_kv_rewind,
                                                      paged_verify_forward)

CFG_KW = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=False)
JCFG = JaxGPTConfig(**CFG_KW)
TCFG = GPTConfig(**CFG_KW)
V = TCFG.vocab_size
L, NH, D = TCFG.num_layers, TCFG.num_heads, TCFG.hidden_size // 4
STORE = {"bf16": (jnp.float32, torch.float32),
         "int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


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


def _trees(np_params, wd, kd="bf16"):
    """The reference's and the port's serving trees at weight dtype ``wd``
    (KV clips calibrated by the reference, shared)."""
    if wd == "bf16":
        return _jax(np_params), cast_for_compute(_torch(np_params), TCFG)
    jspec = jquant.ensure_kv_clips(jquant.QuantSpec(wd, kd),
                                   _jax(np_params), JCFG)
    tspec = tquant.QuantSpec(wd, kd, kv_k_clip=jspec.kv_k_clip,
                             kv_v_clip=jspec.kv_v_clip)
    return (jquant.quantize_params(_jax(np_params), JCFG, jspec),
            cast_for_compute(tquant.quantize_params(_torch(np_params), TCFG,
                                                    tspec), TCFG))


def _pools(rng, kd, P, ps=8):
    """The same random pool contents for both frameworks ([L, P, ps, nh, d]
    K and V in the storage dtype) and, for a one-byte pool, page scales
    [L, P] in [0.01, 0.05] (the trash page 1.0)."""
    jdt, tdt = STORE[kd]
    shape = (L, P, ps, NH, D)
    out = []
    for _ in range(2):
        a = rng.standard_normal(shape).astype(np.float32)
        if kd == "int8":
            a = np.clip(np.round(a * 40), -127, 127).astype(np.int8)
        elif kd == "fp8":
            a = np.asarray(jnp.asarray(np.clip(a * 100, -448, 448)).astype(
                jdt))
        j = jnp.asarray(a)
        t = new_pool(shape, tdt, "cpu")
        t.view(torch.uint8).copy_(torch.from_numpy(_bytes(j).copy()))
        out.append((j, t))
    scales = (None, None)
    if kd != "bf16":
        sc = [rng.uniform(0.01, 0.05, (L, P)).astype(np.float32)
              for _ in range(2)]
        for s in sc:
            s[:, 0] = 1.0
        scales = (tuple(jnp.asarray(s) for s in sc),
                  tuple(torch.from_numpy(s) for s in sc))
    return out[0], out[1], scales


# three slots of 4 pages of 8 tokens; windows cross a page, slot 2 idle
TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
START = np.array([5, 14, 0], np.int32)
VALID = np.array([5, 3, 0], np.int32)
P = 13


# ------------------------------------------------------------- op level
@pytest.mark.parametrize("wd,kd", [("bf16", "bf16"), ("int8", "int8"),
                                   ("fp8", "fp8")])
def test_paged_verify_forward_matches_reference(np_params, wd, kd):
    """Every lane's logits within 1e-5 of the reference's, the saved
    pre-write bytes equal, and the window's lanes read at the [B, 1]
    shape (the pool's other bytes untouched)."""
    rng = np.random.default_rng(1)
    jp, tp = _trees(np_params, wd, kd)
    (jk, tk), (jv, tv), (jsc, tsc) = _pools(rng, kd, P)
    ids = rng.integers(0, V, (3, 5)).astype(np.int32)
    want, jk2, _, jsk, jsv = jpa.paged_verify_forward(
        jp, JCFG, jnp.asarray(ids), jk, jv, jnp.asarray(START),
        jnp.asarray(VALID), jnp.asarray(TABLE), 8, False, kv_scales=jsc)
    got, tsk, tsv = paged_verify_forward(
        tp, TCFG, torch.from_numpy(ids).long(), tk, tv,
        torch.from_numpy(START), torch.from_numpy(VALID),
        torch.from_numpy(TABLE), 8, kv_scales=tsc)
    assert got.shape == (3, 5, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(_bytes(tsk), _bytes(jsk))
    np.testing.assert_array_equal(_bytes(tsv), _bytes(jsv))
    # positions the window did not write keep their bytes on both sides
    written = np.zeros((P, 8), bool)
    for b in range(3):
        for t in range(VALID[b]):
            p = START[b] + t
            written[TABLE[b, p // 8], p % 8] = True
    written[0] = True
    np.testing.assert_array_equal(_bytes(tk)[:, ~written],
                                  _bytes(jk2)[:, ~written])


@pytest.mark.parametrize("kd", ["bf16", "int8", "fp8"])
def test_paged_kv_rewind_matches_reference(kd):
    """The same pool, saved bytes and run lengths (every lane count of a
    window, an idle slot): the pools after rewind are the same bytes, page
    0 aside, and the rewound positions hold the saved bytes."""
    rng = np.random.default_rng(2)
    (jk, tk), (jv, tv), _ = _pools(rng, kd, P)
    (sjk, stk), (sjv, stv), _ = _pools(rng, kd, P)
    # saved bytes: any storage-dtype values [L, B, T, nh, d]
    sk_j, sv_j = sjk[:, 1:4, :5], sjv[:, 1:4, :5]
    sk_t = stk.view(torch.uint8)[:, 1:4, :5] if kd != "bf16" \
        else stk[:, 1:4, :5]
    sv_t = stv.view(torch.uint8)[:, 1:4, :5] if kd != "bf16" \
        else stv[:, 1:4, :5]
    n_emit = np.array([2, 1, 0], np.int32)
    jk, jv = jpa.paged_kv_rewind(jk, jv, sk_j, sv_j, jnp.asarray(TABLE),
                                 jnp.asarray(START), jnp.asarray(VALID),
                                 jnp.asarray(n_emit), 8)
    before = _bytes(tk).copy()
    paged_kv_rewind(tk, tv, sk_t, sv_t, torch.from_numpy(TABLE),
                    torch.from_numpy(START), torch.from_numpy(VALID),
                    torch.from_numpy(n_emit), 8)
    np.testing.assert_array_equal(_bytes(tk)[:, 1:], _bytes(jk)[:, 1:])
    np.testing.assert_array_equal(_bytes(tv)[:, 1:], _bytes(jv)[:, 1:])
    changed = (_bytes(tk)[:, 1:] != before[:, 1:]).any(axis=(0, 3, 4))
    assert changed.sum() == (5 - 2) + (3 - 1)        # slots 0 and 1 only


DRAFT_CASES = [("fp", "bf16"), ("int8", "bf16"), ("fp", "int8"),
               ("int8", "fp8"), ("shallow", "bf16")]


@pytest.mark.parametrize("tree,kd", DRAFT_CASES)
def test_paged_draft_forward_matches_reference(np_params, tree, kd):
    """k=4 greedy proposals of three slots, one at position 0 (no pool
    key), the others mid-page over a pool they must not write: the same
    tokens as the reference's draft."""
    rng = np.random.default_rng(3)
    jp, tp = _trees(np_params, "bf16")
    if tree == "int8":
        jp = jquant.quantize_params(jp, JCFG, jquant.QuantSpec("int8"))
        tp = tquant.quantize_params(tp, TCFG, tquant.QuantSpec("int8"))
    elif tree == "shallow":
        jp = jquant.shallow_draft_params(jp, 1)
        tp = tquant.shallow_draft_params(tp, 1)
    (jk, tk), (jv, tv), (jsc, tsc) = _pools(rng, kd, P)
    pool_before = _bytes(tk).copy()
    tok = rng.integers(0, V, 3).astype(np.int32)
    pos = np.array([6, 17, 0], np.int32)
    want = jpa.paged_draft_forward(jp, JCFG, jnp.asarray(tok), jk, jv,
                                   jnp.asarray(pos), jnp.asarray(TABLE), 8,
                                   4, kv_scales=jsc)
    got = paged_draft_forward(tp, TCFG, torch.from_numpy(tok).long(), tk, tv,
                              torch.from_numpy(pos), torch.from_numpy(TABLE),
                              8, 4, kv_scales=tsc)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_bytes(tk), pool_before)
    # the table's columns below max(pos) are enough
    part = paged_draft_forward(tp, TCFG, torch.from_numpy(tok).long(), tk,
                               tv, torch.from_numpy(pos),
                               torch.from_numpy(TABLE)[:, :3], 8, 4,
                               kv_scales=tsc)
    assert torch.equal(part, got)


def test_verify_accept_greedy_matches_reference():
    """Greedy windows whose proposals agree for 0..4 lanes, capped by
    nprop, and a slot that does not emit: tokens and run lengths equal."""
    rng = np.random.default_rng(4)
    B, T = 5, 5
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    best = logits.argmax(-1)
    ids_next = (best + 1) % V                   # every proposal wrong...
    for b, m in enumerate([0, 1, 2, 4, 3]):
        ids_next[b, :m] = best[b, :m]           # ...but the first m
    nprop = np.array([4, 4, 1, 4, 4], np.int32)
    emit = np.array([True, True, True, True, False])
    jt, jn, _ = jgen._verify_accept(
        jnp.asarray(logits), jnp.asarray(ids_next.astype(np.int32)),
        jnp.asarray(nprop), jnp.asarray(emit), jnp.zeros(B, bool),
        jnp.ones(B), jnp.ones(B), jnp.zeros((B, 2), jnp.uint32), None)
    tt, tn = _verify_accept(
        torch.from_numpy(logits), torch.from_numpy(ids_next),
        torch.from_numpy(nprop), torch.from_numpy(emit), None,
        torch.ones(B), None, torch.zeros(B, T), None)
    assert tn.tolist() == np.asarray(jn).tolist() == [1, 2, 2, 5, 0]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_verify_accept_samples_each_lane_as_the_plain_step():
    """A sampled row's lane t draws with u[b, t] exactly what the plain
    step's sampler draws from that lane's logits alone."""
    from paddle_tpu_torch.models.generation import _mask_logits, _sample
    rng = np.random.default_rng(5)
    B, T = 3, 5
    logits = torch.from_numpy(rng.standard_normal((B, T, V)).astype(
        np.float32))
    u = torch.from_numpy(rng.uniform(size=(B, T)).astype(np.float32))
    temp = torch.tensor([0.7, 1.0, 1.3])
    top_p = torch.tensor([0.85, 1.0, 0.9])
    sample = torch.tensor([True, False, True])
    toks, _ = _verify_accept(logits, torch.zeros(B, T, dtype=torch.long),
                             torch.zeros(B, dtype=torch.int32),
                             torch.ones(B, dtype=torch.bool), sample, temp,
                             top_p, u, 8)
    for b in range(B):
        for t in range(T):
            lg = logits[b, t][None]
            want = (_sample(_mask_logits(lg, temp[b:b + 1], 8,
                                         top_p[b:b + 1]), u[b, t:t + 1])
                    if sample[b] else lg.argmax(-1))
            assert int(toks[b, t]) == int(want[0]), (b, t)


# ---------------------------------------------------------- engine level
_SHAPES = ((3, 5), (5, 7), (9, 4), (13, 8), (21, 6), (37, 5))


@pytest.fixture(scope="module")
def tparams(np_params):
    return _torch(np_params)


def _engine(params, **kw):
    kw.setdefault("num_slots", 7)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return serving.Engine(params=params, config=TCFG, device="cpu", **kw)


def _requests(n, seed, sample_every=3, **kw):
    """n requests over the shape palette; every ``sample_every``-th one
    sampled with its own temperature, nucleus and seed (sampled slots
    reject far more proposals: the rewind's workout)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen, mnt = _SHAPES[i % len(_SHAPES)]
        rkw = dict(kw)
        if sample_every and i % sample_every == 1:
            rkw.update(do_sample=True, temperature=0.7 + 0.1 * (i % 4),
                       top_p=0.85 if i % 2 else None, seed=11 + i)
        reqs.append(serving.Request(rng.integers(0, V, plen),
                                    max_new_tokens=mnt, **rkw))
    return reqs


def _oracle(params, req):
    out = generate_from_params(
        params, req.prompt[None], TCFG, max_new_tokens=req.max_new_tokens,
        do_sample=req.do_sample, temperature=req.temperature,
        top_p=req.top_p, seed=req.seed,
        stop_token_ids=req.stop_token_ids or None, device="cpu")
    toks = out[0, req.prompt_len:].tolist()
    stops = req.stop_token_ids or ()
    for i, t in enumerate(toks):
        if t in stops:
            return toks[:i + 1]
    return toks


def _tokens(eng, reqs, order=1):
    for r in reqs[::order]:
        eng.submit(r)
    res = eng.run()
    return [res[r.request_id].tokens for r in reqs]


SOURCES = [("quant", None, None), ("shallow", None, None),
           ("shallow", 1, None), ("quant", None, "int8")]


@pytest.mark.parametrize("source,layers,quant", SOURCES)
def test_greedy_spec_streams_equal_the_plain_engine(tparams, source, layers,
                                                    quant):
    """Greedy streams of every draft source, in two admission orders, are
    the plain engine's tokens bit for bit (an int8 engine against the plain
    int8 engine): the draft only proposes."""
    plain = _tokens(_engine(tparams, quant=quant),
                    _requests(8, 0, sample_every=0))
    for order in (1, -1):
        serving.reset_serving_counters()
        eng = _engine(tparams, quant=quant, speculate_k=4,
                      draft_source=source, draft_layers=layers)
        assert eng.speculate_k == 4
        got = _tokens(eng, _requests(8, 0, sample_every=0), order)
        assert got == plain, (source, layers, quant, order)
        c = serving.serving_counters()
        assert c["spec_proposed"] > 0 and c["verify_dispatches"] > 0
        bal = eng.pool.balance()
        assert bal["conserved"] and bal["refcounts_accounted"]


def test_sampled_and_mixed_streams_replay_generate(tparams):
    """Greedy and sampled slots (with and without a nucleus cut) share the
    verify dispatch; every stream is ``generate_from_params``'s, bit for
    bit: a window's uniforms are the request's next draws and its
    generator moves by the tokens emitted only."""
    reqs = _requests(9, 1)
    eng = _engine(tparams, speculate_k=4)
    got = _tokens(eng, reqs)
    for r, toks in zip(reqs, got):
        assert toks == _oracle(tparams, r), r.request_id
    sampled = [r for r in reqs if r.do_sample]
    assert len(sampled) == 3 and any(r.top_p is None for r in sampled)


def test_speculate_off_opts_out(tparams):
    """An all-"off" batch dispatches no draft and proposes nothing, yet
    every decode dispatch is a verify dispatch; a mixed on/off batch stays
    bit for bit too."""
    eng = _engine(tparams, speculate_k=4)
    serving.reset_serving_counters()
    reqs = _requests(6, 3, speculate="off")
    got = _tokens(eng, reqs)
    c = serving.serving_counters()
    assert got == [_oracle(tparams, r) for r in reqs]
    assert c["draft_dispatches"] == 0 and c["spec_proposed"] == 0
    assert c["verify_dispatches"] == c["decode_dispatches"] > 0
    mixed = _requests(6, 4)
    for i, r in enumerate(mixed):
        if i % 2:
            r.speculate = "off"
    assert _tokens(eng, mixed) == [_oracle(tparams, r) for r in mixed]


def test_stop_token_cuts_a_window_mid_run(tparams):
    """A stop token inside an accepted run ends the stream there, the
    run's later tokens dropped: the plain engine's tokens, finish reason
    STOP (the int8 self-draft accepts every proposal, so its stop lands
    inside the first window)."""
    prompt = np.arange(2, 9)
    for quant in (None, "int8"):
        free = _tokens(_engine(tparams, quant=quant),
                       [serving.Request(prompt, max_new_tokens=8)])[0]
        stop = free[3]
        want = free[:free.index(stop) + 1]
        runs = []
        for k in (0, 4):
            serving.reset_serving_counters()
            req = serving.Request(prompt, max_new_tokens=8,
                                  eos_token_id=stop)
            res = _engine(tparams, quant=quant, speculate_k=k).run([req])
            runs.append(res[req.request_id])
        assert runs[0].tokens == runs[1].tokens == want, quant
        assert runs[0].finish_reason == runs[1].finish_reason == serving.STOP
        if quant == "int8":
            c = serving.serving_counters()
            assert c["spec_tokens_out"] == len(want) - 1
            assert c["spec_accepted"] == len(want) - 2 >= 1
            assert c["spec_proposed"] == 4 > c["spec_accepted"]


@pytest.mark.parametrize("prefix", [False, True])
def test_pool_after_rewind_equals_the_plain_engine(tparams, prefix):
    """After mixed traffic with real rejections the spec engine's pool
    (page 0, the trash page, aside), page table and allocator balance are
    the plain engine's; with prefix sharing, siblings decode over shared
    pages copied on write."""
    def waves():
        if not prefix:
            return [_requests(8, 6)]
        rng = np.random.default_rng(7)
        base = rng.integers(0, V, 17)
        return [[serving.Request(base.copy(), max_new_tokens=6)],
                [serving.Request(base.copy(), max_new_tokens=7,
                                 do_sample=True, temperature=0.9, top_p=0.85,
                                 seed=23),
                 serving.Request(np.concatenate(
                     [base[:16], rng.integers(0, V, 4)]), max_new_tokens=5),
                 serving.Request(base.copy(), max_new_tokens=5)]]

    serving.reset_serving_counters()
    spec, plain = _engine(tparams, speculate_k=4), _engine(tparams)
    for ws, wp in zip(waves(), waves()):
        assert _tokens(spec, ws) == _tokens(plain, wp)
    c = serving.serving_counters()
    assert 0 < c["spec_accepted"] < c["spec_proposed"]
    if prefix:
        assert c["prefix_hits"] > 0 and c["cow_copies"] > 0
    assert torch.equal(spec._kc[:, 1:], plain._kc[:, 1:])
    assert torch.equal(spec._vc[:, 1:], plain._vc[:, 1:])
    assert (spec.pool.table == plain.pool.table).all()
    assert spec.pool.balance() == plain.pool.balance()


def test_degenerate_self_draft_accepts_every_proposal(tparams):
    """On an int8 engine the "quant" draft is the served tree itself: every
    greedy proposal is accepted, each window emits nprop + 1 tokens."""
    serving.reset_serving_counters()
    eng = _engine(tparams, quant="int8", speculate_k=4)
    assert eng._draft_params is eng.params
    _tokens(eng, _requests(6, 2, sample_every=0))
    c = serving.serving_counters()
    assert c["spec_proposed"] > 0
    assert c["accept_rate"] == 1.0
    assert c["spec_accepted"] == c["spec_proposed"]
    assert c["tokens_per_dispatch"] > 1.5


def test_dispatch_counters_reconcile(tparams):
    """A speculative engine's decode dispatches are all verify dispatches
    (never the plain [B, 1] step); accept rate and tokens per dispatch
    derive from the raw counters; the summary shows them only when on."""
    serving.reset_serving_counters()
    reqs = _requests(7, 8)
    _tokens(_engine(tparams, speculate_k=3), reqs)
    c = serving.serving_counters()
    assert c["decode_dispatches"] == c["verify_dispatches"] > 0
    assert c["draft_dispatches"] <= c["verify_dispatches"]
    assert c["accept_rate"] == c["spec_accepted"] / c["spec_proposed"]
    disp = c["draft_dispatches"] + c["verify_dispatches"]
    assert c["tokens_per_dispatch"] == c["spec_tokens_out"] / disp
    # every token after each request's first comes from a verify
    assert c["spec_tokens_out"] == c["tokens_out"] - len(reqs)
    assert "spec:" in serving.serving_summary()
    serving.reset_serving_counters()
    _tokens(_engine(tparams), _requests(3, 9))
    c = serving.serving_counters()
    assert c["verify_dispatches"] == c["draft_dispatches"] == 0
    assert "spec:" not in serving.serving_summary()


@pytest.mark.parametrize("kw,error,match", [
    ({"mp": 2}, ValueError, "single-chip"),
    ({"adapter_slots": 2}, ValueError, "mutually exclusive"),
    ({"kv_layout": "pooled"}, ValueError, "paged layout"),
    ({"draft_source": "oracle"}, tquant.QuantSpecError, "source"),
    ({"draft_layers": -1, "draft_source": "shallow"}, tquant.QuantSpecError,
     "layers"),
])
def test_refusals(tparams, kw, error, match):
    with pytest.raises(error, match=match):
        _engine(tparams, speculate_k=4, **kw)


def test_request_speculate_validation():
    with pytest.raises(ValueError, match="speculate"):
        serving.Request(np.arange(4), max_new_tokens=2, speculate="on")
    assert serving.Request(np.arange(4), speculate="off").speculate == "off"
    assert serving.Request(np.arange(4)).speculate == "auto"


def test_draft_plumbing_matches_reference(np_params):
    """DraftSpec / resolve_draft resolve as the reference's; the shallow
    tree shares everything but the sliced blocks."""
    for args in ((4, "quant", 0), (2, "shallow", 0), (3, "shallow", 5),
                 (0, None, None), (None, None, None)):
        flags = {"FLAGS_serving_speculate_k": 3,
                 "FLAGS_serving_draft_source": "shallow",
                 "FLAGS_serving_draft_layers": 1}
        j = jquant.resolve_draft(*args, flags)
        t = tquant.resolve_draft(*args, flags)
        assert (j is None) == (t is None)
        if t is not None:
            assert (t.k, t.source, t.layers) == (j.k, j.source, j.layers)
            assert t.num_layers(2) == j.num_layers(2)
    tp = _torch(np_params)
    sh = tquant.shallow_draft_params(tp, 1)
    assert sh["wte"] is tp["wte"] and sh["head_w"] is tp["head_w"]
    assert sh["blocks"]["qkv_w"].shape[0] == 1
    assert sh["blocks"]["qkv_w"].data_ptr() == tp["blocks"][
        "qkv_w"].data_ptr()


def test_flags_drive_speculation(tparams):
    old = get_flags()
    try:
        set_flags({"FLAGS_serving_speculate_k": 2,
                   "FLAGS_serving_draft_source": "shallow",
                   "FLAGS_serving_draft_layers": 1})
        eng = _engine(tparams)
        assert eng.speculate_k == 2 and eng._spec.source == "shallow"
        assert eng._draft_params["blocks"]["qkv_w"].shape[0] == 1
        assert _engine(tparams, speculate_k=0)._spec is None
    finally:
        set_flags(old)
    assert _engine(tparams)._spec is None


def test_greedy_tokens_equal_the_reference_spec_engine(np_params, tparams):
    """One greedy run on shared weights: the port's speculative engine's
    tokens are the reference's speculative engine's."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, V, n) for n in (4, 11, 23)]
    jeng = jserving.Engine(params=_jax(np_params), config=JCFG, num_slots=3,
                           max_seq_len=96, page_size=8, prefill_chunk=16,
                           kv_layout="paged", speculate_k=4)
    jreqs = [jserving.Request(p.copy(), max_new_tokens=6) for p in prompts]
    jres = jeng.run(jreqs)
    eng = _engine(tparams, num_slots=3, prefill_chunk=16, speculate_k=4)
    got = _tokens(eng, [serving.Request(p, max_new_tokens=6)
                        for p in prompts])
    assert got == [jres[r.request_id].tokens for r in jreqs]
