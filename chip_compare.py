#!/usr/bin/env python3
"""Two trees timed in turns on one NVIDIA GPU:

    python3 chip_compare.py train-turns PARENT_DIR
    python3 chip_compare.py decode-turns PARENT_DIR
    python3 chip_compare.py serve-turns PARENT_DIR
    python3 chip_compare.py tp-turns PARENT_DIR
    python3 chip_compare.py pp-turns PARENT_DIR
    python3 chip_compare.py mp-serve-turns PARENT_DIR
    python3 chip_compare.py flash-turns PARENT_DIR

``train-turns`` runs chip_smoke's one-card GPT-3 1.3B train step
(``phase_train``, then ``phase_train_profile``); ``decode-turns`` the
paged-decode kernels (bf16, int8 and fp8 pools; 16 heads of 128, page
16, a 128-page table, 24 layer slices cycled) at 8 slots x 512 live
tokens, 1 x 2048 and 8 x 2048, by CUDA-graph replay; ``serve-turns``
chip_smoke's one-card serving of GPT-3 1.3B (``phase_serve``: the 16
requests, then ``phase_profile``: one [8, 1] decode boundary traced) at
bf16 and int8 (after one row-1 call's eager host cost at 8 x 512), once
both trees' kernels are built; ``tp-turns`` chip_smoke's tensor-parallel
GPT-3 1.3B step on the fused rung (``phase_tp_train``: 2 + 5 steps at
full depth, then ``phase_tp_profile``) and each ring kernel's whole call
and GEMMs alone (``phase_tp_timing``) in MP ranks, a card each where
there are MP cards; ``pp-turns`` rows 14-15 alone (``gemm_ppsend``,
``gemm_pprecv``, and row 15's two products apart where the tree has
``pprecv_gemms``) at the pp=4 shape by CUDA-graph replay and, where
there are PP cards, chip_smoke's pp=4 GPT-3 1.3B step on the fused
rung (``phase_pp_train``: 2 + 5 steps at full depth, a card a stage);
``mp-serve-turns`` chip_smoke's tensor-parallel serving of GPT-3 1.3B
(``phase_mp_serve`` at bf16 in MP ranks, a card each where there are MP
cards: the 16 requests, decode tokens/s and TTFT p50 / p99, then, with a
card per rank, ``phase_profile``'s host ms of one [8, 1] decode boundary
by function on rank 0), once both trees' serving kernels are built;
``flash-turns`` chip_smoke's ``phase_flash_timing`` (rows 4-6 without a
bias or dropout at every training path's GPT shape, by CUDA-graph
replay) and ``phase_bert_flash`` (BERT's bias + dropout instances at 32 x
128 and 8 x 512), once both trees' flash libraries are built.
Each runs from the tree at PARENT_DIR (a ``git archive`` of another
commit) and from
this one, in turns (parent, this, this, parent), each in a process of
its own, and prints their lines. Needs a CUDA device and exits with
another code than 0 without one.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_RUN = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops import flash_attention as fa
fa.build()
step, ids, _, _ = cs.phase_train(0, torch.device("cuda"))
cs.phase_train_profile(step, ids)
"""


DECODE_RUN = """
import itertools, torch
import chip_smoke as cs
from paddle_tpu_torch.serving import paged_decode as pd
pd.build()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
L = 24
for B, live in ((8, 512), (1, 2048), (8, 2048)):
    pos = [live - 1] * B
    for kind in ("bf16", "int8", "fp8"):
        if kind == "bf16":
            q, kc, vc, table, pos_t = cs.decode_inputs(gen, dev, pos, layers=L)
            ksc = vsc = None
        else:
            q, kc, vc, ksc, vsc, table, pos_t = cs.decode_inputs_q(
                gen, dev, pos, kind, layers=L)
        layer = itertools.cycle(range(L))

        def call():
            i = next(layer)
            if ksc is None:
                pd.paged_decode_attention(q, kc[i], vc[i], table, pos_t,
                                          cs.PAGE)
            else:
                pd.paged_decode_attention_q(q, kc[i], vc[i], table, pos_t,
                                            ksc[i], vsc[i], cs.PAGE)

        ms = min(cs.graph_ms(call, iters=10 * L) for _ in range(2))
        bound = cs.decode_bound(pos, pool_bytes=2 if ksc is None else 1,
                                page_scales=ksc is not None)[0]
        print(f"[decode-turns] {kind} B={B} x {live}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms", flush=True)
        del q, kc, vc
        torch.cuda.empty_cache()
"""


SERVE_RUN = """
import time
import numpy as np, torch
import chip_smoke as cs
from paddle_tpu_torch.serving import paged_decode as pd
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
q, kc, vc, table, pos = cs.decode_inputs(gen, dev, [511] * 8, layers=1)
for n in (20, 500):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        pd.paged_decode_attention(q, kc[0], vc[0], table, pos, cs.PAGE)
    torch.cuda.synchronize()
print(f"[serve-wrapper] paged decode, eager back to back: "
      f"{(time.perf_counter() - t0) / n * 1e3:.4f} ms a call", flush=True)
del q, kc, vc
cfg = cs.GPT_CONFIGS[cs.MODEL]
params = cs.cast_for_compute(cs.init_gpt_params(
    cfg, seed=0, device=dev, dtype=torch.bfloat16), cfg)
for quant in (None, "int8"):
    run = cs.phase_serve(cfg, params, np.random.default_rng(0), quant=quant)
    cs.phase_profile(cfg, run["eng"], np.random.default_rng(0))
    del run
    torch.cuda.empty_cache()
"""
BUILD_RUN = "import chip_smoke as cs; cs.phase_build()"
FLASH_BUILD = ("from paddle_tpu_torch.ops import flash_attention as fa; "
               "fa.build()")
FLASH_RUN = """
import collections, torch
import chip_smoke as cs
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
zero = collections.defaultdict(int)
cs.phase_flash_timing(gen, dev, zero, zero)
cs.phase_bert_flash(gen, dev, zero)
"""
# a module of its own (spawned ranks import the module of their function)
TP_RANK = """
import torch
import chip_smoke as cs


def rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \\
        (lambda *a: None)
    step, ids, _, failed = cs.phase_tp_train(group, seed, say)
    cs.phase_tp_profile(group, step, ids, say)
    del step, ids
    torch.cuda.empty_cache()
    gen = torch.Generator(device=group.device).manual_seed(seed + 5)
    cs.phase_tp_timing(group, gen, cs.GPT_CONFIGS[cs.MODEL], say)
    return failed
"""
# a module of its own (spawned ranks import the module of their function)
MP_SERVE_RANK = """
import torch
import chip_smoke as cs


def rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \\
        (lambda *a: None)
    cfg = cs.GPT_CONFIGS[cs.MODEL]
    gen = torch.Generator(device=group.device).manual_seed(seed + 1)
    params = cs.init_gpt_params(cfg, seed=seed, device=group.device,
                                dtype=torch.bfloat16)
    return cs.phase_mp_serve(group, cfg, params, seed, None, gen, say)[1]
"""
MP_SERVE_RUN = """
import chip_smoke as cs
import mp_serve_turns_rank
from paddle_tpu_torch.distributed import env
outs = env.launch(cs.MP, mp_serve_turns_rank.rank, 0, layout=cs.mp_layout(),
                  timeout_s=900)
print(f"[mp-serve-turns] failures: {sum(outs, [])}", flush=True)
"""
# the serving kernels of a tree: rows 1-3 and 11, and rows 12-13's gather
# where the tree has it
MP_SERVE_BUILD = """
from paddle_tpu_torch.ops import fused_collectives as fc, quant_gemm as qg
from paddle_tpu_torch.serving import paged_decode as pd
qg.build()
pd.build()
fc.build_ag_bucket()
getattr(fc, "build_gemm_ag", lambda: None)()
"""
PP_RUN = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops import pp_boundary as ppb
ppb.build()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
R, K, F = 2048, 8192, 2048


def rand(*shape, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


x, w, b, r = rand(R, K), rand(K, F, scale=K ** -0.5), rand(F), rand(R, F)
gy, gw = rand(R, F), rand(R, F)
for _ in range(2):
    s = cs.graph_ms(lambda: ppb.gemm_ppsend(x, w, b, r), iters=8)
    v = cs.graph_ms(lambda: ppb.gemm_pprecv(gy, gw, x, w), iters=8)
    print(f"[pp-alone] R={R} K={K} F={F}: gemm_ppsend {s:.4f} ms, "
          f"gemm_pprecv {v:.4f} ms", flush=True)
if hasattr(ppb, "pprecv_gemms"):      # row 15's products apart
    dr = gy + gw
    for p in ("dx", "dw"):
        ms = min(cs.graph_ms(lambda: ppb.pprecv_gemms(dr, x, w, (p,)),
                             iters=8) for _ in range(2))
        print(f"[pp-alone] gemm_pprecv's {p} alone: {ms:.4f} ms = "
              f"{2 * R * K * F / ms / 1e9:.1f} TFLOP/s", flush=True)
if torch.cuda.device_count() >= cs.PP:    # the pp=4 step, a card a stage
    import pp_turns_rank
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.build()
    outs = env.launch(cs.PP, pp_turns_rank.rank, 0, layout="per_card",
                      timeout_s=900)
    print(f"[pp-turns] failures: {sum(outs, [])}", flush=True)
"""
PP_RANK = """
import torch
import chip_smoke as cs


def rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \\
        (lambda *a: None)
    return cs.phase_pp_train(group, seed, say, "fused", "pp=fused",
                             "gpipe")[3]
"""
TP_RUN = """
import chip_smoke as cs
import tp_turns_rank
from paddle_tpu_torch.distributed import env, peer
from paddle_tpu_torch.ops import flash_attention as fa, ring_gemm as rg
fa.build()
rg.build()
peer.build()
outs = env.launch(cs.MP, tp_turns_rank.rank, 0, layout=cs.mp_layout(),
                  timeout_s=900)
print(f"[tp-turns] failures: {sum(outs, [])}", flush=True)
"""


def _say(msg):
    print(msg, flush=True)


def turns(parent, run, prefixes, path=()):
    """``run`` (Python source) from the tree at ``parent`` and from this
    one, in turns, each in a process of its own with ``path`` on
    PYTHONPATH; prints the lines that start with one of ``prefixes``."""
    parent = Path(parent).resolve()
    if not (parent / "chip_smoke.py").exists():
        raise SystemExit(f"{parent} holds no chip_smoke.py")
    failed = False
    for name, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(tree), *map(str, path)]))
        proc = subprocess.run([sys.executable, "-c", run], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(prefixes):
                _say(f"<{name}> {line}")
        if proc.returncode:
            _say(f"<{name}> exit {proc.returncode}: {proc.stderr[-3000:]}")
            failed = True
    if failed:
        raise SystemExit("a run failed")


def build_both(parent, run):
    """``run`` (Python source that builds kernels) in the tree at
    ``parent`` and in this one, both at once."""
    builds = [subprocess.Popen(
        [sys.executable, "-c", run], cwd=tree,
        env=dict(os.environ, PYTHONPATH=str(tree)),
        stdout=subprocess.DEVNULL) for tree in (parent, ROOT)]
    if any(b.wait(timeout=900) for b in builds):
        raise SystemExit("a build failed")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py needs a CUDA device")
    _say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip())
    if argv[:1] == ["train-turns"] and len(argv) == 2:
        turns(argv[1], TRAIN_RUN, ("[train]", "[train-profile]"))
    elif argv[:1] == ["decode-turns"] and len(argv) == 2:
        turns(argv[1], DECODE_RUN, ("[decode-turns]",))
    elif argv[:1] == ["serve-turns"] and len(argv) == 2:
        build_both(argv[1], BUILD_RUN)
        turns(argv[1], SERVE_RUN, ("[serve] {", "[serve-int8] {",
                                   "[profile]", "[serve-wrapper]"))
    elif argv[:1] == ["mp-serve-turns"] and len(argv) == 2:
        build_both(argv[1], MP_SERVE_BUILD)
        with tempfile.TemporaryDirectory() as tmp:
            Path(tmp, "mp_serve_turns_rank.py").write_text(MP_SERVE_RANK)
            turns(argv[1], MP_SERVE_RUN, ("[mp-serve-bf16]",
                                          "[mp-profile-bf16]",
                                          "[mp-serve-turns]"), path=(tmp,))
    elif argv[:1] == ["flash-turns"] and len(argv) == 2:
        build_both(argv[1], FLASH_BUILD)
        turns(argv[1], FLASH_RUN, ("[timing]", "[bert-timing]"))
    elif argv[:1] == ["pp-turns"] and len(argv) == 2:
        with tempfile.TemporaryDirectory() as tmp:
            Path(tmp, "pp_turns_rank.py").write_text(PP_RANK)
            turns(argv[1], PP_RUN, ("[pp-alone]", "[pp-train fused]",
                                    "[pp-turns]"), path=(tmp,))
    elif argv[:1] == ["tp-turns"] and len(argv) == 2:
        with tempfile.TemporaryDirectory() as tmp:
            Path(tmp, "tp_turns_rank.py").write_text(TP_RANK)
            turns(argv[1], TP_RUN, ("[tp-train]", "[tp-profile]",
                                    "[tp-timing]", "[tp-turns]"),
                  path=(tmp,))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:])
