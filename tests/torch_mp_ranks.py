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
