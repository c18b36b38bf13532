"""Per-rank functions of tests/test_torch_mp_serving.py, run by
``paddle_tpu_torch.distributed.env.launch`` in spawned ranks on the CPU
(gloo). A spawned child imports the module that holds its function, so
this module imports neither jax nor the reference package: the JAX side
runs in the test process and arrives here as numpy."""
import numpy as np
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.models import GPTConfig, params_from_numpy
from paddle_tpu_torch.models.params import layer_params
from paddle_tpu_torch.ops import fused_collectives as fc
from paddle_tpu_torch.serving import metrics, mp_forward
from paddle_tpu_torch.serving import quant as squant
from paddle_tpu_torch.serving.paged_attention import new_pool, paged_forward

CFG_KW = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0, use_flash=False,
              compute_dtype="float32", remat=False)
ENGINE_KW = dict(num_slots=4, max_seq_len=96, page_size=8, prefill_chunk=8,
                 device="cpu")
RUNGS = ("gspmd", "ring", "fused")
QUANTS = (None, "int8", "fp8")


def config(vocab=96):
    return GPTConfig(**{**CFG_KW, "vocab_size": vocab})


def _cut(t, group):
    w = t.shape[-1] // group.n
    return t[..., group.rank * w:(group.rank + 1) * w].contiguous()


def collectives(group, case):
    """The plain collectives and the three rungs' gathers on this rank:
    ``case`` holds x, the full weights (and scales), rows per rank."""
    out = {}
    row = torch.from_numpy(case["rows"][group.rank])
    out["ag_bucket_plain"] = fc.ag_bucket_plain(row, group).numpy()
    out["fused_ag_bucket"] = fc.fused_ag_bucket(row, group).numpy()
    blk = torch.from_numpy(case["blocks"][group.rank])
    for rung in RUNGS:
        out[f"ag_last/{rung}"] = mp_forward.ag_last(blk, group, rung).numpy()
    x = torch.from_numpy(case["x"])
    for name, (w, s) in case["gemms"].items():
        w = torch.from_numpy(w)
        if w.dtype == torch.uint8:          # int8/fp8 bytes
            w = w.view(squant.STORE_DTYPES[name.split("/")[0]])
        w_r = _cut(w, group)
        s_r = None if s is None else _cut(torch.from_numpy(s), group)
        out[f"gemm_ag_plain/{name}"] = fc.gemm_ag_plain(
            x, w_r, group, s_r).numpy()
        # the peer schedule over every rank's shard, at both slot parities
        Fl = w_r.shape[-1]
        ws = [w[..., p * Fl:(p + 1) * Fl].contiguous()
              for p in range(group.n)]
        ss = None if s is None else [
            torch.from_numpy(s[p * Fl:(p + 1) * Fl].copy())
            for p in range(group.n)]
        out[f"gemm_ag_peer_plain/{name}"] = [
            fc.gemm_ag_peer_plain(x, ws, group.rank, ss, calls).numpy()
            for calls in (0, 1)]
        for rung in RUNGS:
            out[f"gemm_ag/{rung}/{name}"] = mp_forward.gemm_ag(
                x, w_r, group, rung, s_r).numpy()
    return out


def _step_logits(eng, prompts):
    """The logits of one scripted prefill (each prompt a row at offset 0)
    and one decode dispatch through the engine's forward, on fresh pools
    of the engine's shapes: [2, B, V] float32."""
    cfg = eng.config
    dev = eng.device
    B = len(prompts)
    ps = eng.page_size
    mp_pages = eng.max_seq_len // ps
    P = B * mp_pages + 1
    shape = (cfg.num_layers, P) + tuple(eng._kc.shape[2:])
    kc, vc = new_pool(shape, eng._kc.dtype, dev), \
        new_pool(shape, eng._kc.dtype, dev)
    kv = None
    if eng._kv_quant:
        kv = tuple(torch.from_numpy(s).to(dev) for s in
                   squant.kv_scales_for(eng._quant, cfg.num_layers, P))
    table = torch.arange(1, P, dtype=torch.int32, device=dev).view(
        B, mp_pages)
    T = max(len(p) for p in prompts)
    ids = torch.zeros(B, T, dtype=torch.int64, device=dev)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = torch.as_tensor(p)
    i32 = dict(dtype=torch.int32, device=dev)
    valid = torch.tensor([len(p) for p in prompts], **i32)
    mp = None if eng.mp <= 1 else (eng.group, eng._mp_cfg)
    layers = layer_params(eng.params)

    def fwd(window, start, v):
        return paged_forward(eng.params, cfg, window, kc, vc, start, v,
                             table, ps, use_kernel=False, layers=layers,
                             kv_scales=kv, wq_kernel=False, mp=mp)

    first = fwd(ids, torch.zeros(B, **i32), valid)
    nxt = first.argmax(-1)[:, None]
    second = fwd(nxt, valid, torch.ones(B, **i32))
    return torch.stack([first, second]).cpu().numpy()


def _greedy(eng, prompts, max_new, order=None):
    reqs = [serving.Request(np.asarray(p), max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    order = range(len(reqs)) if order is None else order
    res = eng.run([reqs[i] for i in order])
    return [res[r.request_id].tokens for r in reqs]


def _sampled(eng, prompts):
    reqs = [serving.Request(np.asarray(p), max_new_tokens=6, do_sample=True,
                            temperature=0.8, top_p=0.9 if i % 2 else None,
                            seed=100 + i)
            for i, p in enumerate(prompts)]
    res = eng.run(reqs)
    return [res[r.request_id].tokens for r in reqs]


def checks(group, payload):
    """Everything one rank checks: ``collectives`` and ``engines``."""
    out = engines(group, payload)
    out.update(collectives(group, payload["case"]))
    return out


def engines(group, payload):
    """Every rung at every dtype config against the one-device engine of
    the port, on this rank: greedy tokens, step logits, sampled streams,
    admission order, the replicated head of V=97, KV bytes, deadlines,
    callbacks and the mp counters."""
    torch.set_num_threads(1)
    prompts, max_new = payload["prompts"], payload["max_new"]
    cfg = config()
    params = params_from_numpy(payload["params"], cfg, device="cpu")
    out = {"rank": group.rank}
    for quant in QUANTS:
        qtag = quant or "fp32"
        single = serving.Engine(params=params, config=cfg, quant=quant,
                                **ENGINE_KW)
        out[f"tokens/single/{qtag}"] = _greedy(single, prompts, max_new)
        out[f"logits/single/{qtag}"] = _step_logits(single, prompts)
        out[f"kv/single/{qtag}"] = (single.kv_shard_bytes(),
                                    single.kv_bytes_per_token())
        if quant is None:
            out["sampled/single"] = _sampled(single, prompts)
        for rung in RUNGS:
            eng = serving.Engine(params=params, config=cfg, quant=quant,
                                 mp=group.n, comm_backend=rung, group=group,
                                 **ENGINE_KW)
            metrics.reset_serving_counters()
            out[f"tokens/{rung}/{qtag}"] = _greedy(eng, prompts, max_new)
            c = metrics.serving_counters()
            out[f"counters/{rung}/{qtag}"] = {
                k: c[k] for k in ("paged_steps", "mp_steps",
                                  "mp_collectives", "mp_wire_bytes",
                                  "mp_fused_dispatches")}
            out[f"logits/{rung}/{qtag}"] = _step_logits(eng, prompts)
            out[f"kv/{rung}/{qtag}"] = (eng.kv_shard_bytes(),
                                        eng.kv_bytes_per_token())
            if rung == "fused" and quant is None:
                out["sampled/fused"] = _sampled(eng, prompts)
                out["reversed/fused"] = _greedy(
                    eng, prompts, max_new,
                    order=list(reversed(range(len(prompts)))))
                seen = []
                cb = serving.Request(np.asarray(prompts[0]),
                                     max_new_tokens=3,
                                     on_token=lambda r, t: seen.append(t))
                late = serving.Request(np.asarray(prompts[1]),
                                       max_new_tokens=3, deadline_s=0.0)
                res = eng.run([cb, late])
                out["callbacks"] = seen
                out["deadline"] = res[late.request_id].finish_reason
    odd = config(97)
    p_odd = params_from_numpy(payload["params_odd"], odd, device="cpu")
    eng = serving.Engine(params=p_odd, config=odd, mp=group.n,
                         comm_backend="fused", group=group, **ENGINE_KW)
    out["odd/shard_vocab"] = eng._mp_cfg.shard_vocab
    out["odd/head_shape"] = tuple(eng.params["head_w"].shape)
    out["odd/tokens"] = _greedy(eng, prompts, max_new)
    single = serving.Engine(params=p_odd, config=odd, **ENGINE_KW)
    out["odd/single"] = _greedy(single, prompts, max_new)
    return out


# the card test's engine: bf16 compute over fp32 weights, widths the
# kernels take at mp = 2
CARD_CFG_KW = dict(vocab_size=512, hidden_size=256, num_layers=2,
                   num_heads=2, max_seq_len=256)
CARD_ENGINE_KW = dict(num_slots=4, prefill_chunk=64, page_size=16)


def card_params(device):
    """fp32 weights from a seed (an LM head that is not bf16-exact)."""
    from paddle_tpu_torch.models import init_gpt_params
    return init_gpt_params(GPTConfig(**CARD_CFG_KW), seed=3, device=device,
                           dtype=torch.float32)


def fp32_head_engine(group, prompts, max_new):
    """``Engine(mp=n, comm_backend="fused")`` on this rank's card from fp32
    params: the head's stored dtype, the fused GEMM launches by shape,
    greedy tokens and one step's logits."""
    cfg = GPTConfig(**CARD_CFG_KW)
    eng = serving.Engine(params=card_params(group.device), config=cfg,
                         mp=group.n, comm_backend="fused", group=group,
                         **CARD_ENGINE_KW)
    fc.fused_gemm_ag.shapes.clear()
    tokens = _greedy(eng, prompts, max_new)
    return {"rank": group.rank, "head_dtype": str(eng.params["head_w"].dtype),
            "shapes": dict(fc.fused_gemm_ag.shapes), "tokens": tokens,
            "logits": _step_logits(eng, prompts)}


def fail_on_rank1(group):
    """A rank that fails: ``launch`` must raise with its traceback."""
    if group.rank == 1:
        return 1 // 0
    return group.rank


# ------------------------------------------- rows 12-13 on the card
# (label, K, F/n, rows, x dtype) of the card checks: the 1.3B mp=4 out and
# down shards at decode, ragged row counts (1, 5, 130) and a full chunk,
# and the fp32 head shard at decode
GEMM_AG_CARD_CASES = (
    [("out", 2048, 512, R, "bfloat16") for R in (1, 5, 8, 130, 256)] +
    [("down", 8192, 512, 8, "bfloat16"),
     ("head", 2048, 12576, 8, "float32")])
GEMM_AG_KINDS = ("bf16", "int8", "fp8")
GEMM_AG_REUSE_CALLS = 8             # back to back, on changing inputs
GEMM_AG_LATE_TIMEOUT_S = 1.5        # the late-peer check's timeout
GEMM_AG_LATE_BY = 3.0               # how late its late rank is: timeouts
GEMM_AG_DEAD_AFTER_S = 1.0          # the gone peer's life after the barrier


def _card_weight(gen, dev, K, F, kind):
    w = torch.randn(K, F, generator=gen, device=dev) * 0.02
    if kind == "bf16":
        return w.to(torch.bfloat16), None
    if kind == "fp32":
        return w, None
    return squant._quantize_leaf(w, kind)


class _NoCollective(RuntimeError):
    pass


def _forbid_collectives(group):
    """Make every collective of ``group`` and of ``torch.distributed`` raise
    until the returned function restores them."""
    import torch.distributed as dist

    def refuse(*_, **__):
        raise _NoCollective("a collective was called")

    names = ("all_gather_into", "all_gather_list", "barrier", "broadcast",
             "ring_shift", "ring_shift_async", "all_reduce_")
    saved = {n: getattr(group, n) for n in names if hasattr(group, n)}
    for n in saved:
        setattr(group, n, refuse)
    dnames = ("all_gather_into_tensor", "all_gather", "all_gather_object",
              "barrier", "broadcast", "all_reduce", "reduce_scatter_tensor",
              "send", "recv", "isend", "irecv", "batch_isend_irecv")
    dsaved = {n: getattr(dist, n) for n in dnames}
    for n in dsaved:
        setattr(dist, n, refuse)

    def restore():
        for n in saved:
            delattr(group, n)
        for n, f in dsaved.items():
            setattr(dist, n, f)
    return restore


def card_gemm_ag(group, seed):
    """Rows 12-13 (``fused_gemm_ag``: the GEMM into this rank's slot of the
    ``"gemm_ag"`` channel, then ``csrc/gemm_ag.cu``'s gather) on the card,
    x the same on every rank and each rank's shard its own, for every
    kind at every ``GEMM_AG_CARD_CASES`` (and an fp32 head shard): against
    ``gemm_ag_plain`` (``error_vs_plain``'s gates) and bit for bit against
    ``gemm_ag_exact`` (``gemm_into`` + an exact all-gather);
    ``GEMM_AG_REUSE_CALLS`` calls back to back on changing inputs with no
    host synchronisation, with every
    collective of the group and of ``torch.distributed`` made to raise;
    a late peer: the last rank sleeps ``GEMM_AG_LATE_BY`` timeouts of
    ``GEMM_AG_LATE_TIMEOUT_S`` before a call while the others wait for its
    block. Returns the readings, (calls, launches) against the launches
    the GEMM's plan implies, how long the late call took here and whether
    this rank was the late one, and the error record's code."""
    import time
    from paddle_tpu_torch.distributed import peer
    from paddle_tpu_torch.ops import quant_gemm as qg
    dev, n = group.device, group.n
    xgen = torch.Generator(device=dev).manual_seed(seed)
    wgen = torch.Generator(device=dev).manual_seed(seed + 100 + group.rank)
    fc.reserve_gemm_ag(group, [(R, F, 4) for _, _, F, R, _ in
                               GEMM_AG_CARD_CASES])
    fc.reset_gemm_ag_counts()
    cases = [(kind,) + c for kind in GEMM_AG_KINDS
             for c in GEMM_AG_CARD_CASES]
    cases.append(("fp32",) + GEMM_AG_CARD_CASES[-1])
    readings, inputs, first, want_launches = [], [], {}, 0
    for kind, label, K, F, R, xdt in cases:
        key = (kind, label, R)
        w, s = _card_weight(wgen, dev, K, F, kind)
        x = torch.randn(R, K, generator=xgen, device=dev).to(
            getattr(torch, xdt))
        got = fc.fused_gemm_ag(x, w, group, s)
        torch.cuda.synchronize(dev)
        r = fc.error_vs_plain(got, fc.gemm_ag_plain(x, w, group, s))
        readings.append((("plain",) + key, r,
                         fc.within_tolerance(r, x.dtype) and
                         bool(torch.isfinite(got).all())))
        exact = fc.gemm_ag_exact(x, w, group, s)
        readings.append((("exact",) + key, None, bool(torch.equal(got,
                                                                  exact))))
        first[key] = got
        inputs.append((key, x, w, s))
        splits = qg.plan(R, K, F, w.dtype, x.dtype, dev.index)[2]
        want_launches += 2 + (splits > 1)
    # back to back on changing inputs, no collective allowed
    order = [inputs[(3 * i) % len(inputs)]
             for i in range(GEMM_AG_REUSE_CALLS)]
    xs = [torch.randn(x.shape, generator=xgen, device=dev).to(x.dtype)
          for _, x, _, _ in order]
    torch.cuda.synchronize(dev)
    restore = _forbid_collectives(group)
    try:
        outs = [fc.fused_gemm_ag(x, w, group, s)
                for (_, _, w, s), x in zip(order, xs)]
        torch.cuda.synchronize(dev)
        refused = None
    except _NoCollective as e:
        outs, refused = [], str(e)
    finally:
        restore()
    for i, ((key, _, w, s), x, got) in enumerate(zip(order, xs, outs)):
        K = w.shape[0]
        splits = qg.plan(x.shape[0], K, w.shape[1], w.dtype, x.dtype,
                         dev.index)[2]
        want_launches += 2 + (splits > 1)
        exact = fc.gemm_ag_exact(x, w, group, s)
        readings.append((("reuse", i) + key, None, bool(torch.equal(got,
                                                                    exact))))
    # a late peer
    key, x, w, s = inputs[2]
    ch = group.peer_channels[fc.GEMM_AG_CHANNEL]
    before = ch.timeout_ns
    ch.timeout_ns = int(GEMM_AG_LATE_TIMEOUT_S * 1e9)
    group.barrier()
    late = group.rank == n - 1
    if late:
        time.sleep(GEMM_AG_LATE_BY * GEMM_AG_LATE_TIMEOUT_S)
    t0 = time.perf_counter()
    got = fc.fused_gemm_ag(x, w, group, s)
    torch.cuda.synchronize(dev)
    waited = time.perf_counter() - t0
    ch.timeout_ns = before
    splits = qg.plan(x.shape[0], w.shape[0], w.shape[1], w.dtype, x.dtype,
                     dev.index)[2]
    want_launches += 2 + (splits > 1)
    readings.append((("late",) + key, None, bool(torch.equal(got,
                                                             first[key]))))
    return {"readings": readings, "refused": refused,
            "counts": (fc.fused_gemm_ag.calls, fc.fused_gemm_ag.launches),
            "want_counts": (len(cases) + len(outs) + 1, want_launches),
            "waited": waited, "late": late,
            "code": peer.error_record()["code"]}


def card_gemm_ag_gone_peer(group, timeout_s):
    """Row 12 where rank 0 alone calls ``fused_gemm_ag`` and its peers'
    processes end ``GEMM_AG_DEAD_AFTER_S`` after the group barrier, as a
    crash would: rank 0's gather publishes its block, then its wait for a
    peer's block gives up once the peer's heartbeat has stood still for
    ``timeout_s``. Returns, on rank 0, what synchronising raised, the
    error record, what the next call raised and how long the call took to
    fail. Rank 0's CUDA context is lost, so no rank tears its channel or
    heartbeat down."""
    import time
    from paddle_tpu_torch.distributed import env, peer
    dev = group.device
    x = torch.ones((8, 256), device=dev, dtype=torch.bfloat16)
    w = torch.ones((256, 128), device=dev, dtype=torch.bfloat16)
    fc.reserve_gemm_ag(group, [(8, 128, 2)])
    fc.build_gemm_ag()
    torch.cuda.synchronize(dev)
    group.barrier()
    if group.rank != 0:
        time.sleep(GEMM_AG_DEAD_AFTER_S)
        env.exit_rank({})
    group.peer_channels[fc.GEMM_AG_CHANNEL].timeout_ns = int(timeout_s * 1e9)
    out = {}
    t0 = time.perf_counter()
    fc.fused_gemm_ag(x, w, group)
    try:
        torch.cuda.synchronize(dev)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    out["seconds"] = time.perf_counter() - t0
    out["record"] = peer.error_record()
    try:
        fc.fused_gemm_ag(x, w, group)
        out["next_call"] = None
    except RuntimeError as e:
        out["next_call"] = str(e)
    group.peer_channels.clear()
    group.peer_beat = None
    return out
