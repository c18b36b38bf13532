#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (nonzero exit, no result line):

1. build the hand-written CUDA kernels from ``paddle_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version at the serving
   slice's shapes (8 slots, 16 heads of 128, page 16, 128 slot pages,
   bf16 pool, positions at 0 and page boundaries);
3. serve GPT-3 1.3B (full width and depth, bf16, random weights from the
   seed) through ``serving.Engine``: 16 requests, prompts of 32-1024
   tokens, greedy and sampled, two sharing a cached prefix. Every request
   must finish, the page pool must balance, and the paged-decode kernel
   must have launched once per layer per decode dispatch;
4. one decode step of the fused forward with the kernel against the same
   step through the plain gather path (bf16 tolerance), and greedy
   agreement with ``generate_from_params`` (printed, not gated: random
   weights make near-ties);
5. timings: each kernel against its bound, its plain version and one
   PyTorch library call; engine decode tokens/s and TTFT.

The lines before the last carry a ``{"kernels": [...]}`` JSON object and
the card's name and power limit (nvidia-smi); the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without printing a
result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import cuda_build
from paddle_tpu_torch.models import (GPT_CONFIGS, cast_for_compute,
                                     generate_from_params, init_gpt_params)
from paddle_tpu_torch.models.params import layer_params
from paddle_tpu_torch.serving import (Engine, Request, reset_serving_counters,
                                      serving_counters, serving_summary)
from paddle_tpu_torch.serving import paged_decode
from paddle_tpu_torch.serving.paged_attention import paged_forward
from paddle_tpu_torch.serving.paged_decode import (gather_window,
                                                   paged_decode_attention,
                                                   paged_decode_plain)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# rate outside the tensor cores (the kernel's math is fp32 FMA)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

MODEL = "gpt3-1.3B"
SLOTS, PAGE, CHUNK = 8, 16, 256
KERNEL_TOL = 1e-3           # atol = rtol: fp32 accumulation, bf16 inputs
LOGIT_TOL = 0.05            # max |kernel - plain| / max |plain| logits


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=100, warmup=10):
    """Mean milliseconds per call over ``iters`` eager calls, CUDA events:
    includes any gap the host leaves between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters, replays=5):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    launch gap is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def decode_inputs(gen, dev, pos, layers=1, nh=16, d=128, mp=128):
    """q, pools [layers, P, PAGE, nh, d] (bf16), table [B, mp] and pos [B]
    int32: each slot's live pages are distinct random pages, the rest of
    its row the trash page 0."""
    B = len(pos)
    P = B * mp + 1
    q = torch.randn(B, nh, d, generator=gen, device=dev)
    shape = (layers, P, PAGE, nh, d)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
    table = torch.zeros(B, mp, dtype=torch.int32)
    for b, p in enumerate(pos):
        live = p // PAGE + 1
        table[b, :live] = perm[b * mp:b * mp + live] + 1
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, kc, vc, table.to(dev), pos_t


def decode_bound(pos, nh=16, d=128, pool_bytes=2):
    """Least time (ms) and its limiter for one paged decode call: every
    live key and value read once, q read and ctx written once, the live
    table entries and pos read; the fp32 q.k and p.v flops."""
    live_pages = [p // PAGE + 1 for p in pos]
    tokens = [p + 1 for p in pos]
    B = len(pos)
    nbytes = (sum(live_pages) * PAGE * nh * d * 2 * pool_bytes
              + 2 * B * nh * d * 4 + sum(live_pages) * 4 + B * 4)
    flops = sum(tokens) * nh * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def phase_build():
    t0 = time.perf_counter()
    paged_decode.build()
    info = cuda_build.BUILD_INFO["paged_decode"]
    print(f"[build] paged_decode.cu: {time.perf_counter() - t0:.2f}s "
          f"-> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_kernel_vs_plain(gen, dev):
    pos = [0, 15, 16, 31, 511, 1023, 1500, 2047]
    q, kc, vc, table, pos_t = decode_inputs(gen, dev, pos)
    got = paged_decode_attention(q, kc[0], vc[0], table, pos_t, PAGE)
    torch.cuda.synchronize()
    want = paged_decode_plain(q, kc[0], vc[0], table, pos_t, PAGE)
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    print(f"[kernel] paged_decode vs plain at B=8 nh=16 d=128 page=16 "
          f"MP=128 bf16, pos={pos}: max abs {max_abs:.3e}, max rel "
          f"{max_rel:.3e} (tolerance atol=rtol={KERNEL_TOL})")
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    check(torch.allclose(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL),
          f"paged_decode kernel disagrees with its plain version "
          f"(max abs {max_abs:.3e})")
    return max_abs


def make_requests(cfg, rng):
    """Wave 1: 14 requests, prompts spread over 32-1024 tokens; wave 2:
    an exact repeat of the first wave-1 prompt (prefix hit, CoW of its
    partial last page) and a sibling sharing the full pages of the
    second. Both are among the first admitted and released, so their
    pages are cached while the pool is far from the registration
    pressure limit."""
    lengths = rng.permutation(np.linspace(32, 1000, 14).astype(int))
    lengths[lengths % PAGE == 0] += 3              # partial last pages
    wave1 = []
    for i, n in enumerate(lengths):
        sampled = i % 3 == 1
        wave1.append(Request(
            rng.integers(0, cfg.vocab_size, int(n)),
            max_new_tokens=int(rng.integers(32, 65)), do_sample=sampled,
            temperature=0.8 if sampled else 1.0,
            top_p=0.9 if sampled and i % 2 else None, seed=1000 + i))
    shared = wave1[1].prompt[:wave1[1].prompt_len // PAGE * PAGE]
    wave2 = [
        Request(wave1[0].prompt.copy(), max_new_tokens=48, seed=7),
        Request(np.concatenate([shared,
                                rng.integers(0, cfg.vocab_size, 40)]),
                max_new_tokens=40, do_sample=True, temperature=0.7,
                seed=8),
    ]
    return wave1, wave2


def phase_serve(cfg, params, rng):
    eng = Engine(params=params, config=cfg, num_slots=SLOTS,
                 prefill_chunk=CHUNK, page_size=PAGE)
    check(eng.use_kernel, "FLAGS_serving_paged_kernel is off")
    wave1, wave2 = make_requests(cfg, rng)
    # the main path: counts start at 0 here and are read right after;
    # later calls (the logits check, the timings) are not counted
    reset_serving_counters()
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    results = eng.run(wave1)
    results.update(eng.run(wave2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    c = serving_counters()
    print(f"[serve] {serving_summary()}")
    reqs = wave1 + wave2
    check(len(results) == len(reqs) and all(
        results[r.request_id].finish_reason in ("length", "stop")
        for r in reqs), "not every request finished")
    for r in reqs:
        toks = results[r.request_id].tokens
        check(0 < len(toks) <= r.max_new_tokens and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"request {r.request_id} returned invalid tokens")
    bal = eng.pool.balance()
    check(bal["conserved"] and bal["refcounts_accounted"],
          f"page pool does not balance: {bal}")
    check(c["prefix_hits"] >= 2 and c["cow_copies"] >= 1,
          f"prefix cache / CoW not exercised: hits {c['prefix_hits']}, "
          f"cow {c['cow_copies']}")
    want = c["decode_dispatches"] * cfg.num_layers
    print(f"[serve] paged_decode launches {launches} == decode dispatches "
          f"{c['decode_dispatches']} x {cfg.num_layers} layers = {want}")
    check(launches == want and launches > 0,
          "the decode path did not run through the paged-decode kernel")
    decode_tokens = c["tokens_out"] - len(reqs)
    stats = {
        "requests": len(reqs), "tokens_out": c["tokens_out"],
        "wall_s": wall, "tokens_per_s_wall": c["tokens_out"] / wall,
        "decode_dispatches": c["decode_dispatches"],
        "decode_tokens_per_s": decode_tokens / c["decode_time_s"],
        "ttft_p50_ms": c["ttft_p50"] * 1e3, "ttft_p99_ms": c["ttft_p99"] * 1e3,
        "token_latency_p50_ms": c["token_latency_p50"] * 1e3,
        "prefix_hits": c["prefix_hits"], "cow_copies": c["cow_copies"],
    }
    print(f"[serve] {json.dumps(stats)}")
    return eng, results, wave1, launches


def phase_logits(cfg, eng, gen, dev):
    """One [8, 1] decode step of the fused forward at full width: the
    kernel path against the plain gather path on the same pool state."""
    params = eng.params
    layers = layer_params(params)
    mp = 8
    L, nh = cfg.num_layers, cfg.num_heads
    d = cfg.hidden_size // nh
    kc = torch.zeros(L, SLOTS * mp + 1, PAGE, nh, d, dtype=torch.bfloat16,
                     device=dev)
    vc = torch.zeros_like(kc)
    table = (torch.arange(SLOTS * mp, dtype=torch.int32, device=dev)
             .view(SLOTS, mp) + 1)
    plen = 100
    ids = torch.randint(0, cfg.vocab_size, (SLOTS, plen + 1), generator=gen,
                        device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    for b in range(SLOTS):          # prefill each slot (gather path)
        window = torch.zeros(1, 128, dtype=torch.int64, device=dev)
        window[0, :plen] = ids[b, :plen]
        paged_forward(params, cfg, window, kc, vc, torch.zeros(1, **i32),
                      torch.full((1,), plen, **i32), table[b:b + 1], PAGE,
                      use_kernel=False, layers=layers)
    start = torch.full((SLOTS,), plen, **i32)
    ones = torch.ones(SLOTS, **i32)
    tok = ids[:, plen:]
    plain = paged_forward(params, cfg, tok, kc, vc, start, ones, table, PAGE,
                          use_kernel=False, layers=layers)
    kern = paged_forward(params, cfg, tok, kc, vc, start, ones, table, PAGE,
                         use_kernel=True, layers=layers)
    torch.cuda.synchronize()
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[logits] fused decode step, kernel vs plain: max abs diff "
          f"{diff:.4e} of max |logit| {scale:.4e} (tolerance "
          f"{LOGIT_TOL} x max), argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(kern).all()), "kernel-path logits not finite")
    check(diff <= LOGIT_TOL * scale,
          "kernel-path logits disagree with the plain path")


def phase_profile(cfg, eng, rng, steps=10):
    """Where a decode step's time goes: 8 decoding slots, ``steps``
    boundaries timed on the host, then the same number traced with
    torch.profiler (device kernels only) for kernel time by name and the
    device's busy share of the traced window."""
    chunks = serving_counters()["prefill_chunks"] + SLOTS
    for _ in range(SLOTS):   # one 64-token chunk each, then decode only
        eng.submit(Request(rng.integers(0, cfg.vocab_size, 64),
                           max_new_tokens=8 + 2 * steps))
    while serving_counters()["prefill_chunks"] < chunks:
        eng.step()
    check(eng.active_slots == SLOTS, "profile window lost a slot")
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall = (time.perf_counter() - t0) / steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / steps
    eng.run()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3 / steps        # ms/step
    print(f"[profile] [8, 1] decode boundary: {wall * 1e3:.2f} ms host "
          f"wall untraced, {traced * 1e3:.2f} ms traced; device busy "
          f"{busy:.3f} ms/step = {busy / (traced * 1e3):.1%} of the traced "
          f"wall")
    ours = [e for e in events if "paged_decode_kernel" in e.key]
    for e in events[:8] + [e for e in ours if e not in events[:8]]:
        print(f"[profile]   {dev_us(e) / 1e3 / steps:8.4f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}")


def phase_oracle(cfg, params, eng_results, wave1):
    greedy = sorted((r for r in wave1 if not r.do_sample),
                    key=lambda r: r.prompt_len)[:2]
    for r in greedy:
        got = eng_results[r.request_id].tokens
        ref = generate_from_params(params, r.prompt[None], cfg,
                                   max_new_tokens=r.max_new_tokens)
        ref = ref[0, r.prompt_len:].tolist()
        same = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                    min(len(got), len(ref)))
        print(f"[oracle] greedy request of {r.prompt_len} prompt tokens: "
              f"engine and generate_from_params agree on the first "
              f"{same}/{len(ref)} tokens (not gated)")


def phase_timing(gen, dev, max_abs, launches, layers):
    """Kernel, plain and library times at 8 slots x 512 live tokens, cycling
    over the model's layer slices of the pool (cold L2, as the decode step
    sees it)."""
    pos = [511] * SLOTS
    q, kc, vc, table, pos_t = decode_inputs(gen, dev, pos, layers=layers)
    layer = itertools.cycle(range(layers))

    def kernel():
        i = next(layer)
        paged_decode_attention(q, kc[i], vc[i], table, pos_t, PAGE)

    def plain():
        i = next(layer)
        paged_decode_plain(q, kc[i], vc[i], table, pos_t, PAGE)

    # library yardstick: one SDPA call over K/V pre-gathered contiguously
    live = pos[0] + 1
    kg = [gather_window(kc[i], table)[:, :live].permute(0, 2, 1, 3)
          .contiguous() for i in range(layers)]
    vg = [gather_window(vc[i], table)[:, :live].permute(0, 2, 1, 3)
          .contiguous() for i in range(layers)]
    qb = q.to(torch.bfloat16)[:, :, None]

    def library():
        i = next(layer)
        F.scaled_dot_product_attention(qb, kg[i], vg[i])

    # device time, in turns: plain, kernel, kernel, plain (then library)
    p1 = graph_ms(plain, iters=layers)
    k1 = graph_ms(kernel, iters=10 * layers)
    k2 = graph_ms(kernel, iters=10 * layers)
    p2 = graph_ms(plain, iters=layers)
    lib = graph_ms(library, iters=10 * layers)
    # the same calls eagerly, one launch after another from Python
    k_eager = cuda_ms(kernel, iters=10 * layers)
    lib_eager = cuda_ms(library, iters=10 * layers)
    bound, bound_by, nbytes = decode_bound(pos)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    print(f"[timing] paged_decode B=8 x 512 live tokens, nh=16 d=128 bf16, "
          f"device time (CUDA graph replay): kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms, SDPA on pre-gathered K/V "
          f"{lib:.4f} ms, bound {bound:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB) -> {bound / ms:.1%} of bound")
    print(f"[timing] eager back-to-back calls (host launch rate included): "
          f"kernel wrapper {k_eager:.4f} ms, SDPA {lib_eager:.4f} ms")
    del q, kc, vc, kg, vg
    # the varied positions of phase 2, for the record
    vpos = [0, 15, 16, 31, 511, 1023, 1500, 2047]
    vq, vkc, vvc, vtable, vpos_t = decode_inputs(gen, dev, vpos,
                                                 layers=layers)

    def varied():
        i = next(layer)
        paged_decode_attention(vq, vkc[i], vvc[i], vtable, vpos_t, PAGE)

    vms = graph_ms(varied, iters=10 * layers)
    vbound, _, _ = decode_bound(vpos)
    print(f"[timing] paged_decode at pos={vpos}, device time: kernel "
          f"{vms:.4f} ms, "
          f"bound {vbound:.4f} ms -> {vbound / vms:.1%} of bound")
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/serving/paged_attention.py:94",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase_build()
    max_abs = phase_kernel_vs_plain(gen, dev)

    cfg = GPT_CONFIGS[MODEL]
    t0 = time.perf_counter()
    params = cast_for_compute(
        init_gpt_params(cfg, seed=args.seed, device=dev,
                        dtype=torch.bfloat16), cfg)
    torch.cuda.synchronize()
    print(f"[model] {MODEL}: H={cfg.hidden_size} L={cfg.num_layers} "
          f"nh={cfg.num_heads} V={cfg.vocab_size} {cfg.compute_dtype}, "
          f"random weights (seed {args.seed}) in "
          f"{time.perf_counter() - t0:.1f}s")
    eng, results, wave1, launches = phase_serve(cfg, params, rng)
    phase_logits(cfg, eng, gen, dev)
    phase_profile(cfg, eng, rng)
    phase_oracle(cfg, params, results, wave1)
    del eng
    torch.cuda.empty_cache()
    row = phase_timing(gen, dev, max_abs, launches, cfg.num_layers)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
