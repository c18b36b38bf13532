"""The port's paged serving engine (paddle_tpu_torch/serving/engine.py):

* every request's tokens equal the port's ``generate_from_params``, bit
  for bit, greedy and sampled, for two admission orders, with chunked
  prefill over several ladder rungs, prefix reuse and copy-on-write;
* greedy tokens also equal the reference's ``generate_from_params`` on
  the same weights;
* the page allocator balances after drain, admission waits on pages;
* options of later slices raise instead of being ignored.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.generation import generate_from_params as \
    jax_generate
from paddle_tpu_torch import serving
from paddle_tpu_torch.flags import get_flags, set_flags
from paddle_tpu_torch.models import generate_from_params
from torch_parity import JCFG, TCFG, jax_params, torch_params

V = TCFG.vocab_size


def _engine(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 32)          # ladder 8, 16, 32
    return serving.Engine(params=torch_params(), config=TCFG, device="cpu",
                          **kw)


def _oracle(req):
    out = generate_from_params(
        torch_params(), req.prompt[None], TCFG,
        max_new_tokens=req.max_new_tokens, do_sample=req.do_sample,
        temperature=req.temperature, top_p=req.top_p, seed=req.seed,
        stop_token_ids=req.stop_token_ids or None, device="cpu")
    toks = out[0, req.prompt_len:].tolist()
    stops = req.stop_token_ids or ()
    for i, t in enumerate(toks):
        if t in stops:
            return toks[:i + 1]
    return toks


def _workload(rng):
    """Mixed lengths (1 token to several chunk rungs), greedy and sampled
    (with and without a nucleus cut), and a shared-prefix family."""
    base = rng.integers(0, V, 29)
    spec = [(1, 4), (2, 5), (7, 6), (13, 4), (40, 5), (29, 6), (70, 3)]
    prompts = [rng.integers(0, V, n) for n, _ in spec]
    news = [m for _, m in spec]
    prompts += [base, np.concatenate([base[:24], rng.integers(0, V, 9)])]
    news += [5, 6]
    reqs = []
    for i, (p, m) in enumerate(zip(prompts, news)):
        sampled = i % 3 == 1
        reqs.append(dict(prompt=p, max_new_tokens=m, do_sample=sampled,
                         temperature=0.8 if sampled else 1.0,
                         top_p=0.9 if i % 2 else None, seed=100 + i))
    return reqs


def test_engine_bitwise_equals_oracle_for_two_admission_orders():
    specs = _workload(np.random.default_rng(0))
    outs = []
    for order in (range(len(specs)), reversed(range(len(specs)))):
        serving.reset_serving_counters()
        eng = _engine()
        reqs = [serving.Request(**specs[i]) for i in order]
        results = eng.run(reqs)
        got = {tuple(r.prompt.tolist()): results[r.request_id].tokens
               for r in reqs}
        for r in reqs:
            assert got[tuple(r.prompt.tolist())] == _oracle(r), \
                f"prompt of {r.prompt_len} tokens diverged from the oracle"
        bal = eng.pool.balance()
        assert bal["conserved"] and bal["refcounts_accounted"]
        assert eng.active_slots == 0 and eng.queue_depth == 0
        c = serving.serving_counters()
        assert c["completed"] == len(specs)
        assert c["prefill_chunks"] > len(specs)       # long prompts chunk
        outs.append(got)
    assert outs[0] == outs[1]


def test_prefix_reuse_and_copy_on_write_stay_bitwise():
    """A second wave re-serves cached prompts: an exact duplicate (CoW of
    the shared partial last page) and a page-aligned sibling."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, V, 21)
    eng = _engine()
    first = serving.Request(base, max_new_tokens=5, seed=1)
    eng.run([first])
    serving.reset_serving_counters()
    wave = [serving.Request(base, max_new_tokens=6, do_sample=True,
                            temperature=0.7, seed=2),
            serving.Request(np.concatenate([base[:16],
                                            rng.integers(0, V, 5)]),
                            max_new_tokens=5, seed=3),
            serving.Request(base, max_new_tokens=5, seed=1)]
    results = eng.run(wave)
    for r in wave:
        assert results[r.request_id].tokens == _oracle(r)
    c = serving.serving_counters()
    assert c["prefix_hits"] == 3 and c["cow_copies"] >= 1
    assert c["prefix_tokens_reused"] > 0
    bal = eng.pool.balance()
    assert bal["conserved"] and bal["refcounts_accounted"]


def test_greedy_engine_tokens_equal_reference_generate():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, V, n) for n in (3, 11, 26)]
    eng = _engine(num_slots=2)
    results = eng.generate(prompts, max_new_tokens=6)
    for p, res in zip(prompts, results):
        want = np.asarray(jax_generate(jax_params(), jnp.asarray(p[None]),
                                       JCFG, max_new_tokens=6)._data)
        assert res.tokens == want[0, len(p):].tolist()
        assert res.finish_reason == serving.LENGTH


def test_admission_waits_on_pages_and_stays_bitwise():
    """A pool too small for every request at once: admission blocks on
    pages (strict FCFS), output is unchanged."""
    rng = np.random.default_rng(3)
    reqs = [serving.Request(rng.integers(0, V, n), max_new_tokens=4)
            for n in (30, 22, 9, 17)]
    serving.reset_serving_counters()
    eng = _engine(num_slots=4, num_pages=9)            # 8 usable pages
    results = eng.run(reqs)
    for r in reqs:
        assert results[r.request_id].tokens == _oracle(r)
    c = serving.serving_counters()
    assert c["pages_inuse_max"] <= 8
    assert eng.pool.balance()["refcounts_accounted"]


def test_stop_tokens_and_streaming_callback():
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, V, 6)
    free = _oracle(serving.Request(prompt, max_new_tokens=8))
    streamed = []
    req = serving.Request(prompt, max_new_tokens=8, eos_token_id=free[3],
                          on_token=lambda r, t: streamed.append(t))
    res = _engine().run([req])[req.request_id]
    assert res.tokens == free[:free.index(free[3]) + 1]
    assert res.finish_reason == serving.STOP
    assert streamed == res.tokens and res.ttft is not None


def test_submit_validation_and_expiry():
    eng = _engine(max_queue=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(serving.Request(np.arange(120), max_new_tokens=20))
    eng.submit(serving.Request([1, 2, 3], max_new_tokens=2,
                               deadline_s=0.0))
    with pytest.raises(serving.QueueFullError):
        eng.submit(serving.Request([1, 2, 3], max_new_tokens=2))
    results = eng.run()
    assert [r.finish_reason for r in results.values()] == [serving.EXPIRED]
    req = serving.Request([4, 5], max_new_tokens=0)
    assert eng.submit(req).state == serving.FINISHED
    with pytest.raises(ValueError, match="single-use"):
        eng.submit(req)


@pytest.mark.parametrize("kwarg,item", [
    ("mesh", "item 11"), ("tenant_adapters", "item 9"),
    ("adapter_slots", "item 9"), ("priority", "item 10"),
    ("shed", "item 10"), ("role", "item 10"), ("prefill_buckets", "item 7"),
])
def test_later_slice_options_raise_naming_roadmap_item(kwarg, item):
    with pytest.raises(NotImplementedError, match=item):
        _engine(**{kwarg: 1})


def test_unknown_options_and_layouts_are_refused():
    with pytest.raises(TypeError, match="bogus"):
        _engine(bogus=1)
    with pytest.raises(NotImplementedError, match="item 7"):
        _engine(kv_layout="pooled")
    with pytest.raises(KeyError, match="FLAGS_serving_mp"):
        set_flags({"FLAGS_serving_mp": 2})


def test_flags_drive_defaults():
    old = get_flags()
    try:
        set_flags({"FLAGS_serving_slots": 3, "FLAGS_serving_page_size": 8,
                   "FLAGS_serving_prefill_chunk": 16,
                   "FLAGS_serving_prefix_cache": False})
        eng = serving.Engine(params=torch_params(), config=TCFG,
                             device="cpu")
        assert eng.num_slots == 3 and eng.page_size == 8
        assert eng.pool.num_pages == 3 * (TCFG.max_seq_len // 8) + 1
        assert not eng.pool.prefix_cache_enabled
    finally:
        set_flags(old)


def test_engine_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.Engine(params=torch_params(), config=TCFG)
