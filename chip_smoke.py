#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (nonzero exit, no result line):

1. build the hand-written CUDA kernels from ``paddle_tpu_torch/csrc``, one
   nvcc per source, all started together (with the card tests'
   forced-timeout build of the flash kernels), printing ptxas's register,
   shared-memory and spill report and, where the toolkit has cuobjdump,
   the HGMMA and UTMALDG (TMA load) count of each instance of the
   flash forward, dQ and dK/dV kernels, of the quant GEMM's tensor-core
   kernel and of row 8's GEMM, which must have both (and the latter two
   no spill), and the TMA loads of the paged decode's 24 instances;
2. hold each kernel against its plain PyTorch version: paged decode at the
   serving slice's shapes (8 slots, 16 heads of 128, page 16, 128 slot
   pages, bf16 pool, positions at 0 and page boundaries); the flash
   forward (O, LSE), dQ and dK/dV kernels at the train step's B=8,
   S=2048, 16 heads of 128, bf16, causal, and at B=2: causal and not,
   S=2048 and the ragged S=200, 129 and 65, and d=64 cases, each output
   held per element and per 128-row tile; then the card-only tests of
   ``tests/test_torch_cuda_kernels.py`` in a pytest process;
3. serve GPT-3 1.3B (full width and depth, bf16, random weights from the
   seed) through ``serving.Engine``: 16 requests, prompts of 32-1024
   tokens, greedy and sampled, two sharing a cached prefix. Every request
   must finish, the page pool must balance, and the paged-decode kernel
   must have launched once per layer per decode dispatch;
4. one decode step of the fused forward with the kernel against the same
   step through the plain gather path (bf16 tolerance), and greedy
   agreement with ``generate_from_params`` (printed, not gated: random
   weights make near-ties);
5. train GPT-3 1.3B at full width and depth through ``HybridTrainStep``
   (bench.py's recipe: bf16 params and compute, AdamW(2e-4) with global
   norm clip 1.0 and bf16 moments, remat "full") on ids [8, 2048] from the
   seed: 2 warm-up and 5 timed steps. Every loss must be finite, the last
   below the first (same batch), and each step must launch the flash
   forward kernel 48 times (24 layers, each rerun in the backward) and
   the dQ and dK/dV kernels 24 times each;
6. one step of a 2-layer copy at full width (B=2, S=2048) through the
   kernels and through ``use_flash=False`` on the same weights: loss and
   every gradient leaf within a bf16 tolerance;
7. timings: each kernel against its bound, its plain version and one
   PyTorch library call (the flash kernels at the shape of every training
   path; the paged decode also at 1 and 8 slots x 2048 live tokens);
   engine decode tokens/s and TTFT; train step
   time, tokens/s and MFU; torch.profiler over a decode step and over a
   train step;
8. quantized serving (phase 2 also holds its two kernels against their
   plain versions: the quant GEMM at every GPT-3 1.3B shape at 8 and 256
   rows and the LM head at 8 fp32 rows, and the quantized paged decode
   over int8 and fp8 pools): GPT-3 1.3B served at ``quant="int8"`` and
   ``quant="fp8"`` with the 16 requests of phase 3. Every request must
   finish, the pool must balance, and each decode dispatch must launch
   the quantized paged-decode kernel 24 times (the bf16 one never) and
   every dispatch the quant GEMM kernel 97 times (4 per layer + the
   head); one decode step through the kernels against the plain path
   (bf16 tolerance). Printed, not gated: the logit drift against the
   bf16 model at full width, greedy agreement with the bf16 engine,
   decode tokens/s and TTFT against the bf16 engine's, the KV bytes per
   token and pages at equal pool bytes, a profile of one int8 decode
   step, and each kernel's times at every timed shape;
9. tensor-parallel serving, in MP = 4 ranks spawned by
   ``distributed.env.launch`` (one per card over NCCL when the machine
   has four cards, else all four on cuda:0 over gloo; the kernels are
   built above, once): the fused GEMM + all-gather (rows 12-13,
   ``fused_gemm_ag``: row 3's GEMM into this rank's slot of the
   ``"gemm_ag"`` peer channel, then the gather kernel of
   ``csrc/gemm_ag.cu``; bf16, int8 and fp8 weight shards; the out and
   down shards at 8 and 256 rows, the vocab-sharded head at 8 fp32 rows,
   also as an fp32 shard) against its plain version and bit for bit
   against ``gemm_into`` + the group's all-gather, and the data
   all-gathers (row 11, ``fused_ag_bucket``: one launch of the pull
   kernel of ``csrc/ag_bucket.cu`` over the ranks' peer staging) against
   their plain versions, each rank with its own
   weight shard and row, the outputs the same bytes on every rank; the
   16 requests through ``Engine(mp=4, comm_backend="fused")`` at bf16,
   int8 and fp8 with four cards; on one card bf16 on four of them (two
   of wave 1, wave 2) and int8 on wave 2 (every request finished with the
   same tokens on every rank; per dispatch 49 fused GEMM + all-gathers
   and 49 data all-gathers of one row-11 launch each, per decode
   dispatch 24 paged-decode launches, 48 local
   quant GEMMs per quantized dispatch; one decode step's logits against
   the one-card forward within LOGIT_TOL); with four cards a profile of
   a decode step; rows 11-13's whole calls, slowest rank (rows 12-13
   eagerly and by CUDA-graph replay, their GEMM alone by replay on rank
   0), beside the plain versions, rows 12-13's former route (the GEMM,
   the group's all-gather, a relayout copy) and the library's (NCCL's
   with four cards; on one card a path check, not a speed).

10. tensor-parallel training, in MP = 4 ranks laid out as in phase 9: the
   ring all-gather + GEMM and ring weight-gradient kernels and the GEMM +
   reduce-scatter over the peer buffers (row 8: ``csrc/gemm_rs.cu``'s
   wgmma GEMM storing into the peers' slots, then its reduce;
   ``ops/ring_gemm.py``) against their plain versions at every shape of
   the main path (B=8, S=2048, each rank its own shards; row 7's output
   the same bytes on every rank); GPT-3 1.3B
   trained through ``HybridTrainStep(group=, comm_backend="fused")`` with
   phase 5's recipe, at full depth (2 warm-up and 5 timed steps) with a
   card per rank, at 2 layers (1 + 2 steps) on one card: finite losses,
   the last below the first, the same on every rank, and per step 6L /
   6L / 4L calls of the three kernels (MP launches a call for rows 7 and
   9, two for row 8); one fused step
   of the 2-layer copy (B=2) against the one-card step on the same
   weights within phase 6's tolerances (loss and every gradient leaf over
   all shards); with a card per rank a profile of one step, the step
   time, tokens/s and MFU over the four cards; each kernel's times
   (whole calls with a card per rank; the GEMMs alone, and row 8's whole
   call as a path check, on one card); and
   with a card per rank the rsag rung at full depth from the same
   weights and ids (its losses printed beside the fused rung's, gated as
   above but for the ring kernels: none launched).
11. pipeline-parallel training, in PP = 4 ranks (stages) laid out as in
   phase 9: the boundary kernels (``ops/pp_boundary.py``: row 14, y = r +
   (x @ w + b), and row 15, dr = gy + gwire, dx and dw) against their
   plain versions at the main path's shapes (R=2048, K=8192, F=2048,
   bf16, each rank its own operands: per element and per 128-row tile,
   dr and db bit for bit, y arriving on the next rank byte for byte);
   GPT-3 1.3B trained through ``HybridTrainStep(pp_group=,
   num_microbatches=8)`` with phase 5's recipe on ``comm_backend=
   "pp=fused"`` (the main path) and then on ``"pp=ring"`` GPipe and
   1F1B, at full depth (6 layers a stage; 2 warm-up and 5 timed steps)
   with a card per rank, at 4 layers (1 + 2 steps) on one card: finite
   losses, the last below the first, the same on every rank, rows 14 and
   15 called once per microbatch on every stage but the last on the fused
   rung and never on the ring rungs; step time, tokens/s, MFU over the
   cards, the schedule's bubble, peak memory and boundary bytes per rank;
   one fused step of a 4-layer copy (B=2, one layer a stage) against the
   one-card step on the same weights within phase 6's tolerances; rows
   14-15's times alone (row 15's two products also apart, in TFLOP/s),
   and with a card per rank with their hops.

12. data-parallel training, in DP = 4 replicas laid out as in phase 9:
   row 10, the bucketed reduce-scatter (``ops/fused_collectives.py:
   fused_rs_bucket``, one launch of the pull kernel of
   ``csrc/rs_bucket.cu`` over the ranks' peer staging), against its
   plain ring bit for bit on fp32 and bf16 wires at 512-25,755,648 cols
   (GPT-3 1.3B's bucket widths at n=4, each rank its own bucket) and
   against NCCL's reduce-scatter of the same fp32 bucket, and row 11's
   all-gather of a bucket row against its plain ring and NCCL's
   all-gather, bit for bit; GPT-3 1.3B
   (the eager ``GPTForCausalLM``, fp32 params, bf16 compute, remat
   dots_no_batch) trained through ``jit.TrainStep(group=)`` with phase
   5's weights, ids, lr, clip and moment dtype on the rungs
   ``dp=fused`` with weight-update sharding at an fp32 wire (the main
   path) and a bf16 wire, ``dp=ring``, the int8 wire and the flags off,
   at full depth (2 warm-up and 5 timed steps) with a card per rank, at
   2 layers (1 + 2 steps) on one card: finite losses, the last below the
   first, the same on every rank, the step resolved to the rung's
   schedule, row 10 called once per float bucket per step (196 at full
   depth, counted from a bucket plan built apart from the step) on the
   fused fp32 and bf16 rungs and never on the others, row 11 once per
   bucket per step on the three fused rungs (int8 included) and never on
   the others, each call one launch; step time, tokens/s, MFU over the
   cards, peak
   memory and the comm ledger per step; one fused step of a 2-layer copy
   (B=4) against the one-device step on the same weights and ids within
   phase 6's tolerances; with a card per rank a profile of one fused
   step, which must show rows 10 and 11's kernels at work and no NCCL
   send/recv kernel; rows 10 and 11's whole calls at every width beside
   their plain rings and the library's reduce-scatter or all-gather
   (NCCL's with a card per rank; on one card a path check, not a
   speed).

13. BERT-base pretraining (``BERT_CONFIGS["bert-base"]``: 12 x 768, 12
   heads of 64, FFN 3072, vocab 30522; random weights from the seed
   through ``framework.random``) through ``jit.TrainStep`` over
   ``BertForPretraining.pretraining_loss`` under ``amp.decorate(level=
   "O2", dtype="bfloat16")`` with AdamW(1e-4, global-norm clip 1.0) and
   fp32 masters: one [32, 128] batch, 64-128 real tokens a row and the
   rest padded (an additive [B, 1, 1, S] bias of -1e4), 15 % MLM targets,
   NSP labels, dropout 0.1 (in the flash kernels for attention): 2
   warm-up and 5 timed steps, every loss finite and the last below the
   first, the flash forward, dQ and dK/dV kernels launched 12 times a
   step each (their bias + dropout instances) and no SDPA call falling
   back to the composed path; step time, sequences/s, tokens/s, MFU, peak
   memory, a traced step's device ms by kind; one step of a 2-layer copy
   through the kernels against ``FLAGS_use_flash_attention=False`` from
   the same weights and generator state (the same masks): loss and every
   gradient leaf within phase 6's gates, then 3 ``jit.TrainStep`` steps
   of each route, every step's loss within phase 6's loss gate and every
   fp32 master moved and written back to its bf16 param; rows 4-6 with the key-padding
   bias and dropout against their plain versions at (32, 128, 12, 64) and
   (8, 512, 12, 64), and their times beside the bound, the plain versions
   and SDPA with the same float mask and dropout_p (rows of their own in
   the kernels line, ``*_bias_dropout``).

   Flash features (rows 4-6's segment ids, varlen packing, fp16 operands
   and q and key lengths apart): the three kernels against their plain
   versions (``FEATURE_CASES``: the Transformer's cross-attention and its
   decoder's -inf square mask, causal with Sq < Sk and Sq > Sk, fp16 at
   the GPT step's and BERT's shapes); ``F.flash_attn_unpadded`` at GPT-3
   1.3B's attention width (16 heads of 128) over a 16,384-token pack of
   documents of 128-2048 tokens, causal in bf16 and fp16, then
   non-causal with other key documents, forward and backward, one launch
   of each kernel a call, its outputs and gradients per document within
   the gates against the plain versions of that document alone; rows 4-6
   on the pack timed against the bound over the pairs inside documents,
   the plain versions per document and SDPA over nested jagged tensors;
   ``F.flash_attention`` and SDPA on fp16 at BERT's shape with dropout
   (and SDPA's padding bias), launches counted, the fp16 instances timed
   (the kernels line's ``*_varlen`` and ``*_fp16`` rows).

14. Transformer-base (Paddle's ``nn.Transformer`` defaults: d_model 512,
   8 heads of 64, 6 + 6 post-LN layers, FFN 2048, relu, dropout 0.1; a
   37,000-token shared embedding scaled by sqrt(512), sinusoidal
   positions, the vocabulary projection fused into the cross-entropy;
   random weights from the seed) through ``jit.TrainStep`` under
   ``amp.decorate(level="O2", dtype="bfloat16")`` with AdamW(1e-4,
   global-norm clip 1.0): 32 pairs of 256 source and 128 target slots,
   64-256 and 32-128 real tokens a row, the source padding as a [B, 1, 1,
   256] bias in the encoder and the cross-attention (queries of 128
   against keys of 256) and the decoder's -inf square mask: 2 warm-up
   and 5 timed steps, every loss finite and the last below the first,
   rows 4-6 launched 18 times a step each and no fallback; step time,
   tokens/s, MFU, peak memory, a traced step's device ms by kind; a 2 +
   2-layer copy through the kernels against the composed path
   (``parity_routes``, the gradient gate set from its CPU copy,
   ``tests/torch_transformer_gate.py``); rows 4-6 at the encoder,
   decoder and cross-attention shapes against their plain versions and
   timed beside SDPA (the kernels line's ``*_cross`` rows).

15. hybrid training: the parallelisms composed on the sub-groups of a
   world of HYBRID = 4 ranks (``env.launch(..., axes=)``, one rank per
   card over NCCL where the machine has four, else gloo ranks sharing
   cuda:0), one world per layout: dp2 x mp2 (``mp=fused,dp=fused``, ZeRO-1
   over dp: rows 7-9 on each mp pair, rows 10-11 on each dp pair, each
   replica 4 of the 8 rows), dp2 x pp2 (``pp=fused,dp=fused``, GPipe,
   M=4, ZeRO-1: rows 14-15 on each pp pair) and pp2 x mp2
   (``mp=fused,pp=ring``, 1F1B and GPipe, M=4: the sequence-parallel
   block inside each stage, activations crossing seq-sharded). Each path:
   one step of a 2-layer (2 a stage) copy at full width (B=4, M=2)
   against the one-card step on the same weights within phase 6's
   tolerances; GPT-3 1.3B with phase 5's recipe, weights and ids, at
   full depth (2 warm-up and 5 timed steps) with a card per rank, at one
   layer a stage (1 + 2 steps) on one card: finite losses, the last
   below the first, the same on every rank; every row's calls and
   launches on every rank as ``hybrid_step_calls`` counts them (rows 4-6
   everywhere, 7-9 on the mp paths, 10-11 under ZeRO-1, 14-15 on dp2 x
   pp2's sending stage), no SDPA fallback; the slowest rank's step time,
   tokens/s, MFU over the four cards and peak memory per rank.

16. speculative serving (run after phase 8, on the same weights): the 16
   requests of phase 3 through ``Engine(speculate_k=4)`` at bf16 with the
   int8 self-draft (``draft_source="quant"``) and with the 12-block
   shallow draft, and at ``quant="int8"`` with the degenerate self-draft
   (the served tree). Every request must finish, the pool must balance,
   every decode dispatch must be a verify dispatch (no plain [8, 1]
   step), each verify dispatch must launch rows 1-2 once per layer per
   lane (24 x 5) and, on the int8 engine, row 3 at its 40 rows 97 times;
   each draft dispatch of a quantized draft row 3 at 8 rows 4 x 97
   times. Each engine's greedy tokens are held to the served model's
   argmax after the same prefix (teacher forced): no more disagreements
   past a bf16 near-tie (LOGIT_TOL) than the plain engine of its dtype in
   this call; one verify dispatch at full width: lane 0 within LOGIT_TOL
   of the plain [8, 1] step, and after a rewind to 1-5 accepted lanes
   every pool byte but the accepted positions' its pre-dispatch byte.
   Printed: accept rate, tokens per dispatch, decode and wall tokens/s,
   TTFT p50 / p99 beside the plain engines'; row 3 at 40 rows (int8, the
   four block GEMMs and the fp32 head) timed beside its plain version,
   ``torch.mm`` on the dequantized weight and its bound (the kernels
   line's ``quant_gemm[int8 * R=40]`` rows).

The lines before the last carry a ``{"kernels": [...]}`` JSON object and
the card's name and power limit (nvidia-smi); the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without printing a
result when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import dataclasses
import itertools
import json
import pathlib
import pstats
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import amp, cuda_build
from paddle_tpu_torch.distributed import env, peer, tp_overlap
from paddle_tpu_torch.distributed import grad_comm as gcomm
from paddle_tpu_torch.distributed.comm_backend import parse as parse_rungs
from paddle_tpu_torch.distributed import pipeline as pl
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import (BERT_CONFIGS, GPT_CONFIGS,
                                     TRANSFORMER_CONFIGS, BertForPretraining,
                                     GPTForCausalLM, HybridTrainStep,
                                     TransformerForTranslation,
                                     cast_for_compute, generate_from_params,
                                     gpt_loss_fn, init_gpt_params,
                                     layer_params_from_numpy,
                                     layer_params_from_tree,
                                     translation_batch)
from paddle_tpu_torch.models.transformer import PAD_BIAS
from paddle_tpu_torch.models.generation import _proj
from paddle_tpu_torch.models.gpt_hybrid import (flatten_params, gpt_loss,
                                                unflatten_params)
from paddle_tpu_torch.models.params import (layer_params, shard_params,
                                            stage_params)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.observability import flops
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_collectives as fc
from paddle_tpu_torch.ops import philox
from paddle_tpu_torch.ops import pp_boundary as ppb
from paddle_tpu_torch.ops import quant_gemm as qg
from paddle_tpu_torch.ops import ring_gemm as rg
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (Engine, Request, reset_serving_counters,
                                      serving_counters, serving_summary)
from paddle_tpu_torch.serving import metrics as serving_metrics
from paddle_tpu_torch.serving import paged_decode
from paddle_tpu_torch.serving import quant as squant
from paddle_tpu_torch.serving.paged_attention import (_head_logits,
                                                      _paged_blocks,
                                                      new_pool,
                                                      paged_draft_forward,
                                                      paged_forward,
                                                      paged_kv_rewind,
                                                      paged_verify_forward)
from paddle_tpu_torch.serving.paged_kv import pages_for
from paddle_tpu_torch.serving.paged_decode import (gather_window,
                                                   paged_decode_attention,
                                                   paged_decode_attention_q,
                                                   paged_decode_plain,
                                                   paged_decode_q_plain)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, fp32
# rate outside the tensor cores (the paged-decode kernel's math is fp32
# FMA) and the bf16 dense tensor-core rate (the flash kernels' products)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

MODEL = "gpt3-1.3B"
SLOTS, PAGE, CHUNK = 8, 16, 256
KERNEL_TOL = 1e-3           # atol = rtol: fp32 accumulation, bf16 inputs
LOGIT_TOL = 0.05            # max |kernel - plain| / max |plain| logits
# flash kernels against their plain versions: per element and per 128-row
# tile of each (b, h), with the tolerance and its reason stated beside
# ops/flash_attention.py:error_vs_plain; the LSE with atol = rtol =
# fa.LSE_TOL. The B=8 case is the train step's own attention.
FLASH_CASES = [  # (B, S, nh, d, causal)
    (8, 2048, 16, 128, True),
    (2, 2048, 16, 128, True), (2, 2048, 16, 128, False),
    (2, 200, 16, 128, True), (2, 200, 16, 128, False),
    (2, 2048, 16, 64, True),
    # one row past a 128-row tile; one past a 64-row tile
    (2, 129, 16, 128, True), (2, 65, 16, 64, False),
]
TRAIN_B, TRAIN_S = 8, 2048  # bench.py's headline rung
# the shapes each training path hands the flash kernels, timed in
# phase_flash_timing: (path, B, S, heads, d); the first gives the kernels
# line's rows. pp=4 runs microbatches of 1 sequence (M=8), an mp=4 rank
# a quarter of the heads, a dp=4 replica 2 sequences.
FLASH_TIMED_SHAPES = (
    ("one card", TRAIN_B, TRAIN_S, 16, 128),
    ("pp=4 microbatch", 1, TRAIN_S, 16, 128),
    ("mp=4 rank", TRAIN_B, TRAIN_S, 4, 128),
    ("dp=4 replica", 2, TRAIN_S, 16, 128),
)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# train-path parity, kernels vs use_flash=False, bf16 everywhere else the
# same ops: |loss_k - loss_p| <= PARITY_LOSS_REL * |loss_p| and, per
# gradient leaf, ||g_k - g_p|| <= PARITY_GRAD_REL * ||g_p|| (P rounded to
# bf16 in the kernels, fp32 in the blockwise path)
PARITY_LOSS_REL = 1e-3
PARITY_GRAD_REL = 5e-2
QUANT_DTYPES = ("int8", "fp8")
MP = 4                      # tensor-parallel ranks of phase 9
MP_WEIGHTS = ("bf16",) + QUANT_DTYPES
QUANT_TORCH = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
DECODE_POS = [0, 15, 16, 31, 511, 1023, 1500, 2047]
# the paged decode's timed shapes beside the main path's 8 slots x 512
# live tokens: one slot and eight at a long context (2048 tokens, the
# table's 128 pages: 16 splits of 8 pages)
DECODE_EXTRA_SHAPES = ((1, 2048), (8, 2048))
FLASH_KERNELS = (  # (name, wrapper, TPU kernel it replaces)
    ("flash_fwd", fa.flash_forward,
     "paddle_tpu/ops/pallas_kernels/flash_attention.py:83"),
    ("flash_dq", fa.flash_dq,
     "paddle_tpu/ops/pallas_kernels/flash_attention_bwd.py:106"),
    ("flash_dkv", fa.flash_dkv,
     "paddle_tpu/ops/pallas_kernels/flash_attention_bwd.py:142"),
)
FLASH_SOURCES = {"flash_fwd": "paddle_tpu_torch/csrc/flash_sm90.cu",
                 "flash_dq": "paddle_tpu_torch/csrc/flash_sm90.cu",
                 "flash_dkv": "paddle_tpu_torch/csrc/flash_sm90.cu"}


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


def slowest_rank_ms(group, calls, order, iters, graph=False):
    """Each of ``calls`` (name -> a whole collective call) timed on every
    rank of ``group`` by CUDA events over ``iters`` eager calls (``graph``:
    ``iters`` calls captured in one CUDA graph, ``graph_ms``), the ranks
    starting together after a barrier, in ``order`` (a name may come
    twice: its faster run counts); {name: the slowest rank's ms}."""
    mine = {}
    for what in order:
        group.barrier()
        v = (graph_ms(calls[what], iters=iters) if graph else
             cuda_ms(calls[what], iters=iters, warmup=2))
        mine[what] = min(v, mine.get(what, v))
    names = sorted(mine)
    every = group.all_gather_list(torch.tensor(
        [mine[k] for k in names], device=group.device, dtype=torch.float64))
    return {k: max(float(e[i]) for e in every) for i, k in enumerate(names)}


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


def decode_bound(pos, nh=16, d=128, pool_bytes=2, page_scales=False):
    """Least time (ms) and its limiter for one paged decode call: every
    live key and value read once, q read and ctx written once, the live
    table entries and pos read (and a quantized pool's two fp32 scales of
    each live page); the fp32 q.k and p.v flops."""
    live_pages = [p // PAGE + 1 for p in pos]
    tokens = [p + 1 for p in pos]
    B = len(pos)
    nbytes = (sum(live_pages) * PAGE * nh * d * 2 * pool_bytes
              + 2 * B * nh * d * 4 + sum(live_pages) * 4 + B * 4
              + (sum(live_pages) * 8 if page_scales else 0))
    flops = sum(tokens) * nh * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def decode_inputs_q(gen, dev, pos, dtype, layers=1, nh=16, d=128, mp=128):
    """``decode_inputs`` over an int8/fp8 pool: quantized values spread
    over the dtype's range, page scales [layers, P] drawn in [0.01, 0.1]
    (the trash page 1.0)."""
    q, kc, vc, table, pos_t = decode_inputs(gen, dev, pos, layers, nh, d, mp)

    def quantize(pool):
        if dtype == "int8":
            return (pool.float() * 40).round().clamp(-127, 127).to(
                torch.int8)
        return (pool.float() * 100).clamp(-448, 448).to(QUANT_TORCH[dtype])

    kq, vq = quantize(kc), quantize(vc)
    del kc, vc
    P = kq.shape[1]
    scales = [torch.rand(layers, P, generator=gen, device=dev) * 0.09 + 0.01
              for _ in range(2)]
    for sc in scales:
        sc[:, 0] = 1.0
    return q, kq, vq, scales[0], scales[1], table, pos_t


def gemm_bound(R, K, N, x_dtype):
    """Least time (ms) and its limiter for one quant GEMM call: x, the
    one-byte weight and the fp32 scale read once, out written once; 2RKF
    operations at the peak of x's type (bf16 tensor cores, fp32 FMA)."""
    xb = x_dtype.itemsize
    nbytes = R * K * xb + K * N + N * 4 + R * N * xb
    nflops = 2 * R * K * N
    rate = BF16_FLOPS if x_dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, nflops)


def mp_gemm_bound(R, K, F, x_dtype, kind):
    """Least time (ms) and its limiter for a rank's fused GEMM block: x,
    the weight shard (two bytes a weight for bf16, one and an fp32 scale
    per column for int8/fp8) read once, the block written once; 2RKF
    operations at the peak of x's type."""
    xb = x_dtype.itemsize
    w_bytes = K * F * 2 if kind == "bf16" else K * F + F * 4
    nbytes = R * K * xb + w_bytes + R * F * xb
    rate = BF16_FLOPS if x_dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * R * K * F / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def quant_gemm_cases(cfg, rows=(SLOTS, CHUNK), head_rows=SLOTS):
    """(label, weight leaf, K, N, rows, x dtype) of the quant GEMMs on the
    serving path: the four block GEMMs at a decode dispatch (SLOTS rows)
    and a full prefill chunk (CHUNK rows), bf16 x; the LM head at a decode
    dispatch, fp32 x (the final LayerNorm's output). ``rows`` and
    ``head_rows`` give other dispatches' rows (the speculative verify's)."""
    H, V = cfg.hidden_size, cfg.vocab_size
    inner = cfg.ffn_mult * H
    blocks = (("qkv", "qkv_w", H, 3 * H), ("out", "out_w", H, H),
              ("up", "up_w", H, inner), ("down", "down_w", inner, H))
    cases = [(label, leaf, K, N, R, torch.bfloat16)
             for R in rows for label, leaf, K, N in blocks]
    cases.append(("head", "head_w", H, V, head_rows, torch.float32))
    return cases


def phase_build():
    t0 = time.perf_counter()
    sources = {"paged_decode": "paged_decode.cu",
               "flash_sm90": "flash_sm90.cu",
               "quant_gemm": "quant_gemm.cu",
               "pp_gemm": "pp_gemm.cu",
               "gemm_rs": "gemm_rs.cu",
               "ag_gemm": "ag_gemm.cu",
               "rs_bucket": "rs_bucket.cu",
               "ag_bucket": "ag_bucket.cu",
               "gemm_ag": "gemm_ag.cu",
               "peer_mem": "peer_mem.cu"}
    # the card tests' forced-timeout build of the flash kernels, beside
    # the others (its nvcc would otherwise run inside the card tests)
    stuck = {}
    side = threading.Thread(target=lambda: stuck.update(err=_build_or_error(
        {"flash_sm90_stuck": "flash_sm90.cu"}, ("FLASH_SM90_STUCK",))))
    side.start()
    try:
        cuda_build.build_all(sources)
    finally:
        side.join()
    check(stuck.get("err", "no result") is None,
          f"the forced-timeout build: {stuck.get('err')}")
    paged_decode.build()
    fa.build()
    qg.build()
    rg.build()
    ppb.build()
    fc.build_rs_bucket()
    fc.build_ag_bucket()
    fc.build_gemm_ag()
    print(f"[build] {len(sources)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f}s")
    for name, source in sources.items():
        info = cuda_build.BUILD_INFO[name]
        print(f"[build] {source}: {info['seconds']:.2f}s -> {info['path']}")
        for line in info["log"].splitlines():
            entry = re.search(r"(\w+_kernel)I(\w+?)EEEv", line)
            pull = re.search(r"_Z\d+(\w+_(?:pull|gather)_kernel)(\w*?)N4peer",
                             line)
            if entry and "Compiling entry" in line:
                print(f"[build]   {entry.group(1)}<{entry.group(2)}>")
            elif pull and "Compiling entry" in line:
                print(f"[build]   {pull.group(1)} {pull.group(2)}")
            elif ("registers" in line or "spill" in line
                  or "wgmma" in line):
                print(f"[build]     {line.strip()}")
    flash = sass_counts(cuda_build.BUILD_INFO["flash_sm90"]["path"],
                        r"flash_\w+_kernel")
    for name in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        n = sum(f"{name}<" in fn for fn in flash or ())
        check(flash is None or n == 24,
              f"{name} has {n} instances in the SASS, not 24 (bf16 and "
              f"fp16 x head dims 64 and 128 x causal and not x three "
              f"feature levels: none; bias + dropout; and segment ids, "
              f"Sq != Sk)")
    tc = sass_counts(cuda_build.BUILD_INFO["quant_gemm"]["path"],
                     r"quant_gemm_tc_kernel")
    check(tc is None or len(tc) == 15,
          f"the quant GEMM's tensor-core kernel has {len(tc or ())} "
          f"instances in the SASS, not 15 (3 weight types x 5 row widths)")
    spills = {fn: s for fn, s in ptxas_spills(
        cuda_build.BUILD_INFO["quant_gemm"]["log"]).items()
        if "quant_gemm_tc_kernel" in fn}
    check(len(spills) == 15 and not any(any(s) for s in spills.values()),
          f"the quant GEMM's tensor-core kernel spills (or ptxas reported "
          f"no instance): {spills}")
    rs = sass_counts(cuda_build.BUILD_INFO["gemm_rs"]["path"],
                     r"gemm_rs_kernel")
    check(rs is None or len(rs) == 4,
          f"row 8's GEMM has {len(rs or ())} instances in the SASS, not 4 "
          f"(NN, NT x peers, local)")
    spills = {fn: s for fn, s in ptxas_spills(
        cuda_build.BUILD_INFO["gemm_rs"]["log"]).items()
        if "gemm_rs" in fn}
    print(f"[build] row 8 (gemm_rs.cu) ptxas spills (store, load bytes): "
          f"{spills}")
    check(len(spills) == 11 and not any(any(s) for s in spills.values()),
          f"row 8's kernels spill (or ptxas reported no instance): {spills}")
    ag = sass_counts(cuda_build.BUILD_INFO["ag_gemm"]["path"],
                     r"ag_gemm_kernel")
    check(ag is None or len(ag) == 3,
          f"rows 7 and 9's GEMM has {len(ag or ())} instances in the SASS, "
          f"not 3 (NN, NT, TN)")
    spills = {fn: s for fn, s in ptxas_spills(
        cuda_build.BUILD_INFO["ag_gemm"]["log"]).items()
        if "ag_gemm" in fn}
    print(f"[build] rows 7 and 9 (ag_gemm.cu) ptxas spills (store, load "
          f"bytes): {spills}")
    check(len(spills) == 3 and not any(any(s) for s in spills.values()),
          f"rows 7 and 9's GEMM spills (or ptxas reported no instance): "
          f"{spills}")
    pp = sass_counts(cuda_build.BUILD_INFO["pp_gemm"]["path"],
                     r"pp_gemm_kernel", absent=("HMMA",))
    check(pp is None or len(pp) == 2,
          f"rows 14-15's GEMM has {len(pp or ())} instances in the SASS, "
          f"not 2 (row 14; row 15's dx and dw)")
    spills = {fn: s for fn, s in ptxas_spills(
        cuda_build.BUILD_INFO["pp_gemm"]["log"]).items()
        if "pp_gemm" in fn}
    print(f"[build] rows 14-15 (pp_gemm.cu) ptxas spills (store, load "
          f"bytes): {spills}")
    check(len(spills) == 2 and not any(any(s) for s in spills.values()),
          f"rows 14-15's GEMM spills (or ptxas reported no instance): "
          f"{spills}")
    spills = [v for k, v in re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+ bytes spill stores, \d+ "
        r"bytes spill loads)", cuda_build.BUILD_INFO["gemm_ag"]["log"],
        re.S)]
    print(f"[build] rows 12-13's gather (gemm_ag.cu) ptxas spills: {spills}")
    check(len(spills) == 1 and spills[0].startswith("0 bytes spill stores, "
                                                    "0 bytes spill loads"),
          f"rows 12-13's gather kernel spills (or ptxas reported no "
          f"instance): {spills}")
    pd = sass_counts(cuda_build.BUILD_INFO["paged_decode"]["path"],
                     r"paged_decode_kernel", ops=("UTMALDG",))
    check(pd is None or len(pd) == 24,
          f"the paged decode has {len(pd or ())} instances in the SASS, not "
          f"24 (4 pool types x 2 head dims x 3 page sizes)")


def _build_or_error(sources, defines):
    """``cuda_build.build_all``; None, or the error it raised."""
    try:
        cuda_build.build_all(sources, defines)
    except Exception as e:      # noqa: BLE001 - reported by the caller
        return e
    return None


def ptxas_spills(log):
    """{kernel<template args>: (spill store bytes, spill load bytes)} from
    ptxas's -v report."""
    out, fn = {}, None
    for line in log.splitlines():
        entry = re.search(r"\d([a-z][a-z_]*_kernel)I(\w+?)EEEv", line)
        if entry and "Compiling entry" in line:
            fn = f"{entry.group(1)}<{entry.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


def sass_counts(lib, pattern, ops=("HGMMA", "UTMALDG"), absent=()):
    """The SASS of a library's kernels named by ``pattern`` (cuobjdump,
    where the toolkit has it): the count of each of ``ops`` in each
    instance (by default the warpgroup products, HGMMA, and TMA tile
    loads, UTMALDG), which must have all, and of each of ``absent``
    (HMMA: mma.sync's products), which must have none. Returns
    {kernel<template args>: counts}, or None without cuobjdump."""
    tool = pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        print(f"[build] no {tool}: SASS not counted")
        return None
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(rf"({pattern})I(\w+?)EEEv", line)
            fn = f"{m.group(1)}<{m.group(2)}>" if m else None
            if fn:
                counts[fn] = dict.fromkeys(ops + tuple(absent), 0)
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += op in line
    for fn, c in counts.items():
        print(f"[build] SASS {fn}: " + ", ".join(f"{v} {k}"
                                                 for k, v in c.items()))
    check(counts and all(all(c[op] for op in ops) for c in counts.values()),
          f"a {pattern} instance lacks one of {ops}: {counts}")
    check(not any(c[op] for c in counts.values() for op in absent),
          f"a {pattern} instance has one of {absent}: {counts}")
    return counts


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


def phase_quant_vs_plain(gen, dev, cfg):
    """The quant GEMM kernel at every case of ``quant_gemm_cases`` and the
    quantized paged decode at the serving shapes, int8 and fp8, against
    their plain versions on the same inputs. Returns {(kernel, dtype,
    label, R): max abs error}."""
    errs = {}
    failed = []
    for dtype in QUANT_DTYPES:
        for label, _, K, N, R, x_dtype in quant_gemm_cases(cfg):
            w = torch.randn(K, N, generator=gen, device=dev) * 0.02
            wq, s = squant._quantize_leaf(w, dtype)
            x = torch.randn(R, K, generator=gen, device=dev).to(x_dtype)
            try:
                got = qg.quant_gemm(x, wq, s)
                torch.cuda.synchronize()
            except RuntimeError:
                print(f"[quant] quant_gemm {dtype} {label} R={R} failed; "
                      f"mbarrier wait record: {qg.wait_timeout_record()}")
                raise
            r = qg.error_vs_plain(got, qg.quant_gemm_plain(x, wq, s))
            errs[("quant_gemm", dtype, label, R)] = r["max_abs"]
            ok = bool(torch.isfinite(got).all()) and \
                qg.within_tolerance(r, x_dtype)
            print(f"[quant] quant_gemm {dtype} {label} R={R} K={K} N={N} "
                  f"x={str(x_dtype)[6:]}: max abs {r['max_abs']:.2e}, worst "
                  f"element {r['element']:.2e} of (|plain| + row rms) "
                  f"(gate {qg.ELEMENT_TOL[x_dtype]}), worst row / 64x64 "
                  f"tile rel L2 {r['row']:.2e} / {r['tile']:.2e} (gates "
                  f"{qg.ROW_TOL[x_dtype]} / {qg.TILE_TOL[x_dtype]}), kernel "
                  f"{qg.MODES[qg.plan(R, K, N, wq.dtype, x_dtype, 0)[0]]}")
            if not ok:
                failed.append(f"quant_gemm {dtype} {label} R={R}")
            del w, wq, s, x, got
        q, kq, vq, ksc, vsc, table, pos_t = decode_inputs_q(
            gen, dev, DECODE_POS, dtype)
        args = (q, kq[0], vq[0], table, pos_t, ksc[0], vsc[0], PAGE)
        got = paged_decode_attention_q(*args)
        torch.cuda.synchronize()
        want = paged_decode_q_plain(*args)
        max_abs = float((got - want).abs().max())
        errs[("paged_decode_q", dtype)] = max_abs
        print(f"[quant] paged_decode_q {dtype} pool, B=8 nh=16 d=128 page=16 "
              f"MP=128, scales in [0.01, 0.1], pos={DECODE_POS}: max abs "
              f"{max_abs:.3e} (max |plain| {float(want.abs().max()):.2e}; "
              f"tolerance atol=rtol={KERNEL_TOL})")
        if not (bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)):
            failed.append(f"paged_decode_q {dtype}")
    check(not failed, f"quantized kernels disagree with their plain "
          f"versions: {failed}")
    return errs


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


SERVE_KERNELS = {"paged_decode": paged_decode_attention,
                 "paged_decode_q": paged_decode_attention_q,
                 "quant_gemm": qg.quant_gemm}


def phase_serve(cfg, params, rng, quant=None):
    """The 16 requests through an Engine at ``quant`` (None: bf16). Gates
    completion, the pool's balance, prefix reuse and every kernel's
    launches; returns the engine, the requests, their results, the
    launches by kernel (and the quant GEMM's by shape) and the stats."""
    tag = "serve" if quant is None else f"serve-{quant}"
    t0 = time.perf_counter()
    eng = Engine(params=params, config=cfg, num_slots=SLOTS,
                 prefill_chunk=CHUNK, page_size=PAGE, quant=quant)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.use_kernel, "FLAGS_serving_paged_kernel is off")
    check(quant is None or eng.quant_kernel,
          "FLAGS_serving_quant_kernel is off")
    wave1, wave2 = make_requests(cfg, rng)
    # the main path: counts start at 0 here and are read right after;
    # later calls (the logits check, the timings) are not counted
    reset_serving_counters()
    for wrapper in SERVE_KERNELS.values():
        wrapper.launches = 0
    qg.quant_gemm.shapes.clear()
    t0 = time.perf_counter()
    results = eng.run(wave1)
    results.update(eng.run(wave2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in SERVE_KERNELS.items()}
    shapes = dict(qg.quant_gemm.shapes)
    c = serving_counters()
    print(f"[{tag}] engine built in {build_s:.1f}s (weights quantized and "
          f"KV clips calibrated at build when quantized)")
    print(f"[{tag}] {serving_summary()}")
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
    L = cfg.num_layers
    decode = c["decode_dispatches"] * L
    want = ({"paged_decode": decode, "paged_decode_q": 0, "quant_gemm": 0}
            if quant is None else
            {"paged_decode": 0, "paged_decode_q": decode,
             "quant_gemm": c["paged_steps"] * (4 * L + 1)})
    print(f"[{tag}] launches {counts} (want {want}: decode dispatches "
          f"{c['decode_dispatches']} x {L} layers of paged decode; "
          f"{c['paged_steps']} dispatches x (4 x {L} + 1) quant GEMMs)")
    check(counts == want and decode > 0,
          "the serving path did not launch its kernels as expected")
    decode_tokens = c["tokens_out"] - len(reqs)
    stats = {
        "quant": quant, "kv_bytes_per_token": eng.kv_bytes_per_token(),
        "kv_pool_bytes": 2 * eng.kv_shard_bytes(),
        "pages": eng.pool.num_pages,
        "requests": len(reqs), "tokens_out": c["tokens_out"],
        "wall_s": wall, "tokens_per_s_wall": c["tokens_out"] / wall,
        "decode_dispatches": c["decode_dispatches"],
        "decode_tokens_per_s": decode_tokens / c["decode_time_s"],
        "ttft_p50_ms": c["ttft_p50"] * 1e3, "ttft_p99_ms": c["ttft_p99"] * 1e3,
        "token_latency_p50_ms": c["token_latency_p50"] * 1e3,
        "prefix_hits": c["prefix_hits"], "cow_copies": c["cow_copies"],
    }
    print(f"[{tag}] {json.dumps(stats)}")
    return {"eng": eng, "reqs": reqs, "results": results, "wave1": wave1,
            "counts": counts, "shapes": shapes, "stats": stats}


def phase_logits(cfg, eng, gen, dev):
    """One [8, 1] decode step of the fused forward at full width: the
    kernel path against the plain gather path on the same pool state, at
    the engine's dtype config (its quantized weights, pool dtype and page
    scales)."""
    params = eng.params
    layers = layer_params(params)
    mp = 8
    L, nh = cfg.num_layers, cfg.num_heads
    d = cfg.hidden_size // nh
    P = SLOTS * mp + 1
    kc = new_pool((L, P, PAGE, nh, d), eng._kc.dtype, dev)
    vc = new_pool((L, P, PAGE, nh, d), eng._kc.dtype, dev)
    kv = {}
    if eng._kv_quant:
        kv["kv_scales"] = tuple(torch.from_numpy(sc).to(dev) for sc in
                                squant.kv_scales_for(eng._quant, L, P))
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
                      use_kernel=False, layers=layers, **kv)
    start = torch.full((SLOTS,), plen, **i32)
    ones = torch.ones(SLOTS, **i32)
    tok = ids[:, plen:]
    plain = paged_forward(params, cfg, tok, kc, vc, start, ones, table, PAGE,
                          use_kernel=False, layers=layers, **kv)
    kern = paged_forward(params, cfg, tok, kc, vc, start, ones, table, PAGE,
                         use_kernel=True, layers=layers, **kv,
                         wq_kernel=eng.quant_kernel)
    torch.cuda.synchronize()
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    config = ("bf16" if eng._quant is None else
              f"w={eng._quant.weight_dtype} kv={eng._quant.kv_dtype}")
    print(f"[logits] {config}: fused decode step, kernel vs plain: "
          f"max abs diff "
          f"{diff:.4e} of max |logit| {scale:.4e} (tolerance "
          f"{LOGIT_TOL} x max), argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(kern).all()), "kernel-path logits not finite")
    check(diff <= LOGIT_TOL * scale,
          "kernel-path logits disagree with the plain path")


def phase_profile(cfg, eng, rng, steps=10, group=None, tag="profile"):
    """Where a decode step's time goes: 8 decoding slots, ``steps``
    boundaries timed on the host, then the same number traced with
    torch.profiler (device kernels only) for kernel time by name and the
    device's busy share of the traced window, then the same number under
    cProfile for the host's time by Python function (cProfile slows the
    Python it counts, so read its shares, not its milliseconds). A
    tensor-parallel rank of ``group`` other than 0 steps along,
    unmeasured, and does not wait for rank 0's profiler to start or to
    collect its trace: it waits in row 11's barriers meanwhile, which
    give up only on a rank whose heartbeat has stopped
    (``distributed/peer.py``)."""
    chunks = serving_counters()["prefill_chunks"] + SLOTS
    # enough tokens that no slot finishes inside the three windows, a
    # speculative boundary emitting up to k + 1 a slot
    for _ in range(SLOTS):   # one 64-token chunk each, then decode only
        eng.submit(Request(rng.integers(0, cfg.vocab_size, 64),
                           max_new_tokens=8 + 3 * steps *
                           (eng.speculate_k + 1)))
    while serving_counters()["prefill_chunks"] < chunks:
        eng.step()
    check(eng.active_slots == SLOTS, "profile window lost a slot")
    if group is not None and group.rank != 0:
        for _ in range(3 * steps):   # rank 0's untraced, traced, cProfiled
            eng.step()
        eng.run()
        return
    before = serving_counters()
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
    host = cProfile.Profile()
    host.enable()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    host.disable()
    after = serving_counters()
    eng.run()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    events = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3 / steps        # ms/step
    config = ("bf16" if eng._quant is None else
              f"w={eng._quant.weight_dtype} kv={eng._quant.kv_dtype}")
    kind = "[8, 1] decode"
    if eng.speculate_k:
        d = {k: after[k] - before[k] for k in
             ("spec_accepted", "spec_proposed", "spec_tokens_out")}
        kind = (f"speculative (k={eng.speculate_k}, greedy slots: accept "
                f"{d['spec_accepted']}/{d['spec_proposed']}, "
                f"{d['spec_tokens_out'] / (3 * steps):.2f} tokens a "
                f"boundary)")
    print(f"[{tag}] {config} {kind} boundary: {wall * 1e3:.2f} ms "
          f"host wall untraced, {traced * 1e3:.2f} ms traced; device busy "
          f"{busy:.3f} ms/step = {busy / (traced * 1e3):.1%} of the traced "
          f"wall", flush=True)
    ours = [e for e in events if "paged_decode" in e.key
            or "quant_gemm" in e.key or "nccl" in e.key.lower()]
    for e in events[:8] + [e for e in ours if e not in events[:8]]:
        print(f"[{tag}]   {dev_us(e) / 1e3 / steps:8.4f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    rows = pstats.Stats(host).stats
    total = sum(tt for _, _, tt, _, _ in rows.values())
    print(f"[{tag}] host under cProfile: {total * 1e3 / steps:.2f} ms/step "
          f"in Python functions and the C calls they make; largest own "
          f"times:")
    for (path, line, name), (_, calls, tt, _, _) in sorted(
            rows.items(), key=lambda kv: kv[1][2], reverse=True)[:12]:
        where = f"{pathlib.Path(path).name}:{line}" if line else path
        print(f"[{tag}]   {tt / total:6.1%} {calls // steps:5d} calls/step "
              f" {name} ({where})"[:120], flush=True)


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


def phase_quant_report(cfg, params, fp, qs, rng):
    """Printed, not gated: the logit drift of the quantized model against
    the bf16 one on one 128-token prefill at full width (through the
    kernels), greedy agreement with the bf16 engine on the same requests,
    decode tokens/s and TTFT against the bf16 engine's in this call, and
    the KV bytes per token and pages at equal pool bytes."""
    eng = qs["eng"]
    prompt = rng.integers(0, cfg.vocab_size, 128)
    drift, top = squant.max_logit_drift(params, cfg, eng._quant, prompt,
                                        page_size=PAGE)
    serving_metrics.observe_logit_drift(drift)
    match = same = total = 0
    for a, b in zip(fp["reqs"], qs["reqs"]):
        if a.do_sample:
            continue
        ta = fp["results"][a.request_id].tokens
        tb = qs["results"][b.request_id].tokens
        n = min(len(ta), len(tb))
        match += next((i for i in range(n) if ta[i] != tb[i]), n)
        same += sum(x == y for x, y in zip(ta, tb))
        total += n
    f, q = fp["stats"], qs["stats"]
    # quantized pages that the bf16 pool's bytes hold
    pages = f["kv_pool_bytes"] * q["pages"] // q["kv_pool_bytes"]
    report = {
        "quant": q["quant"], "max_logit_drift": drift, "max_abs_logit": top,
        "drift_over_bound": drift / (0.15 * max(top, 1.0)),
        "greedy_prefix_agreement": match / total,
        "greedy_token_agreement": same / total,
        "decode_tokens_per_s": [q["decode_tokens_per_s"],
                                f["decode_tokens_per_s"]],
        "ttft_p50_ms": [q["ttft_p50_ms"], f["ttft_p50_ms"]],
        "ttft_p99_ms": [q["ttft_p99_ms"], f["ttft_p99_ms"]],
        "kv_bytes_per_token": [q["kv_bytes_per_token"],
                               f["kv_bytes_per_token"]],
        "pages_in_the_bf16_pool_bytes": [pages, f["pages"]],
    }
    print(f"[quant-{q['quant']}] (quantized, bf16) {json.dumps(report)}")
    print(f"[quant-{q['quant']}] {serving_summary()}")


def phase_quant_timing(cfg, qs, dtype, gen, dev, errs):
    """The quant GEMM at every case of ``quant_gemm_cases`` and the
    quantized paged decode at 8 slots x 512 live tokens, on the served
    engine's own quantized weights (each call on the next layer's, so the
    weights come from device memory as in a decode step): kernel, plain
    version, the nearest library call (cuBLAS ``torch.mm`` on the weight
    dequantized beforehand with its scale folded in: twice the bytes of
    bf16, four of fp32), and for int8 ``torch._weight_int8pack_mm`` where
    this torch has it on CUDA; the kernel by CUDA-graph replay and by
    eager back-to-back calls (the wrapper's host cost per call shows in
    the latter). Returns the ``kernels`` rows."""
    eng = qs["eng"]
    L = cfg.num_layers
    rows = quant_gemm_timing(eng, dtype, quant_gemm_cases(cfg), gen, dev,
                             qs["shapes"], errs)
    pos = [511] * SLOTS
    q, kq, vq, ksc, vsc, table, pos_t = decode_inputs_q(gen, dev, pos, dtype,
                                                        layers=L)
    layer = itertools.cycle(range(L))

    def kernel():
        i = next(layer)
        paged_decode_attention_q(q, kq[i], vq[i], table, pos_t, ksc[i],
                                 vsc[i], PAGE)

    def plain():
        i = next(layer)
        paged_decode_q_plain(q, kq[i], vq[i], table, pos_t, ksc[i], vsc[i],
                             PAGE)

    live = pos[0] + 1
    kg, vg = [], []
    for i in range(L):
        k_sc = ksc[i][table].repeat_interleave(PAGE, 1)[:, :live]
        v_sc = vsc[i][table].repeat_interleave(PAGE, 1)[:, :live]
        kg.append((gather_window(kq[i], table)[:, :live].float() *
                   k_sc[:, :, None, None]).to(torch.bfloat16)
                  .permute(0, 2, 1, 3).contiguous())
        vg.append((gather_window(vq[i], table)[:, :live].float() *
                   v_sc[:, :, None, None]).to(torch.bfloat16)
                  .permute(0, 2, 1, 3).contiguous())
    qb = q.to(torch.bfloat16)[:, :, None]

    def library():
        i = next(layer)
        F.scaled_dot_product_attention(qb, kg[i], vg[i])

    p1 = graph_ms(plain, iters=L)
    k1 = graph_ms(kernel, iters=10 * L)
    k2 = graph_ms(kernel, iters=10 * L)
    p2 = graph_ms(plain, iters=L)
    lib = graph_ms(library, iters=10 * L)
    bound, bound_by, nbytes = decode_bound(pos, pool_bytes=1,
                                           page_scales=True)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    print(f"[timing] paged_decode_q {dtype} B=8 x 512 live tokens, nh=16 "
          f"d=128, device time (CUDA graph replay): kernel {k1:.4f}/"
          f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA on K/V gathered "
          f"and dequantized to bf16 beforehand {lib:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB) -> "
          f"{bound / ms:.1%} of bound")
    del q, kq, vq, kg, vg
    torch.cuda.empty_cache()
    rows.append({
        "name": f"paged_decode_q[{dtype}]", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_decode.cu",
        "replaces": "paddle_tpu/serving/paged_attention.py:140",
        "launches": qs["counts"]["paged_decode_q"],
        "max_abs_err": errs[("paged_decode_q", dtype)], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": lib,
        "other_shapes": decode_shape_times(gen, dev, dtype)})
    return rows


def quant_gemm_timing(eng, dtype, cases, gen, dev, shapes, errs):
    """The quant GEMM at each of ``cases`` (``quant_gemm_cases``) on the
    engine's own ``dtype`` weights, each call on the next layer's: kernel
    and plain version by CUDA-graph replay in turns, the kernel by eager
    back-to-back calls, ``torch.mm`` on the weight dequantized beforehand
    and, for int8 bf16 x, ``torch._weight_int8pack_mm`` where this torch
    has it on CUDA; the bound. ``shapes`` are the launches by (R, K, N) of
    the run the rows report, ``errs`` the kernel's max abs errors by
    ("quant_gemm", dtype, label, R). Returns the ``kernels`` rows."""
    rows = []
    int8pack = None
    for label, leaf, K, N, R, x_dtype in cases:
        if leaf == "head_w":
            ws, ss = [eng.params["head_w"]], [eng.params["head_w_s"]]
        else:
            ws = list(eng.params["blocks"][leaf].unbind(0))
            ss = list(eng.params["blocks"][leaf + "_s"].unbind(0))
        n = len(ws)
        x = torch.randn(R, K, generator=gen, device=dev).to(x_dtype)
        layer = itertools.cycle(range(n))

        def kernel():
            i = next(layer)
            qg.quant_gemm(x, ws[i], ss[i])

        def plain():
            i = next(layer)
            qg.quant_gemm_plain(x, ws[i], ss[i])

        p1 = graph_ms(plain, iters=n, replays=3)
        k1 = graph_ms(kernel, iters=4 * n)
        k2 = graph_ms(kernel, iters=4 * n)
        p2 = graph_ms(plain, iters=n, replays=3)
        eager = cuda_ms(kernel, iters=4 * n)
        deq = [(w.float() * sc).to(x_dtype) for w, sc in zip(ws, ss)]

        def library():
            i = next(layer)
            torch.mm(x, deq[i])

        lib = graph_ms(library, iters=4 * n)
        del deq
        extra = ""
        if dtype == "int8" and x_dtype == torch.bfloat16:
            packed = [w.t().contiguous() for w in ws]
            scl = [sc.to(x_dtype) for sc in ss]

            def pack():
                i = next(layer)
                torch._weight_int8pack_mm(x, packed[i], scl[i])

            try:
                pms = graph_ms(pack, iters=4 * n)
                extra = f", torch._weight_int8pack_mm {pms:.4f} ms"
                int8pack = int8pack or "runs on CUDA"
            except (RuntimeError, NotImplementedError) as e:
                torch.cuda.synchronize()
                int8pack = f"not on CUDA here: {str(e).splitlines()[0][:120]}"
            del packed, scl
        ms, plain_ms = min(k1, k2), min(p1, p2)
        bound, bound_by, nbytes, nflops = gemm_bound(R, K, N, x_dtype)
        qplan = qg.plan(R, K, N, ws[0].dtype, x_dtype, dev.index or 0)
        kern = (f"{qg.MODES[qplan[0]]} kernel, rows {qplan[1]}, {qplan[2]} "
                f"split(s)")
        print(f"[timing] quant_gemm {dtype} {label} R={R} K={K} N={N} "
              f"x={str(x_dtype)[6:]} over {n} weight(s) ({kern}), device "
              f"time (CUDA graph replay): kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, torch.mm on the dequantized weight "
              f"{lib:.4f} ms{extra}; bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {nflops:.3e} flops) -> "
              f"{bound / ms:.1%} of bound; eager back-to-back calls "
              f"{eager:.4f} ms a call")
        rows.append({
            "name": f"quant_gemm[{dtype} {label} R={R}]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/quant_gemm.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels/quant_gemm.py:76",
            "launches": shapes.get((R, K, N), 0),
            "max_abs_err": errs[("quant_gemm", dtype, label, R)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib,
            "library": "torch.mm on the weight dequantized beforehand",
            "kernel": kern, "eager_ms": eager})
        del ws, ss, x
    if int8pack is not None:
        print(f"[timing] torch._weight_int8pack_mm: {int8pack}")
    return rows


def decode_shape_times(gen, dev, dtype=None, layers=8):
    """The paged decode (bf16 pool, or ``dtype`` int8 / fp8 with page
    scales) at each of ``DECODE_EXTRA_SHAPES``, cycling over ``layers``
    layer slices of the pool (134 MB and more, past the 50 MB L2): kernel
    and SDPA on K/V gathered (and dequantized) beforehand by CUDA-graph
    replay, and the bound. Returns {"B x tokens": {ms, library_ms,
    bound_ms}}."""
    out = {}
    for B, live in DECODE_EXTRA_SHAPES:
        pos = [live - 1] * B
        if dtype is None:
            q, kc, vc, table, pos_t = decode_inputs(gen, dev, pos,
                                                    layers=layers)
            ksc = vsc = None
        else:
            q, kc, vc, ksc, vsc, table, pos_t = decode_inputs_q(
                gen, dev, pos, dtype, layers=layers)
        layer = itertools.cycle(range(layers))

        def kernel():
            i = next(layer)
            if dtype is None:
                paged_decode_attention(q, kc[i], vc[i], table, pos_t, PAGE)
            else:
                paged_decode_attention_q(q, kc[i], vc[i], table, pos_t,
                                         ksc[i], vsc[i], PAGE)

        def gathered(pool, sc, i):
            win = gather_window(pool[i], table)[:, :live]
            if sc is not None:
                win = (win.float() * sc[i][table].repeat_interleave(
                    PAGE, 1)[:, :live, None, None]).to(torch.bfloat16)
            return win.permute(0, 2, 1, 3).contiguous()

        kg = [gathered(kc, ksc, i) for i in range(layers)]
        vg = [gathered(vc, vsc, i) for i in range(layers)]
        qb = q.to(torch.bfloat16)[:, :, None]

        def library():
            i = next(layer)
            F.scaled_dot_product_attention(qb, kg[i], vg[i])

        k1 = graph_ms(kernel, iters=10 * layers)
        lib = graph_ms(library, iters=10 * layers)
        k2 = graph_ms(kernel, iters=10 * layers)
        bound, bound_by, nbytes = decode_bound(
            pos, pool_bytes=2 if dtype is None else 1,
            page_scales=dtype is not None)
        ms = min(k1, k2)
        print(f"[timing] paged_decode{'' if dtype is None else '_q ' + dtype}"
              f" B={B} x {live} live tokens, nh=16 d=128, device time (CUDA "
              f"graph replay): kernel {k1:.4f}/{k2:.4f} ms, SDPA "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{nbytes / 1e6:.1f} MB) -> {bound / ms:.1%} of bound")
        out[f"{B}x{live}"] = {"ms": ms, "library_ms": lib, "bound_ms": bound}
        del q, kc, vc, kg, vg
        torch.cuda.empty_cache()
    return out


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
    del vq, vkc, vvc
    torch.cuda.empty_cache()
    return {"name": "paged_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/serving/paged_attention.py:94",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib, "eager_ms": k_eager,
            "other_shapes": decode_shape_times(gen, dev)}


# ---------------------------------------------------- speculative serving
SPEC_K = 4
SHALLOW_LAYERS = 12
# phase 16's speculative engines: (tag, quant, draft source)
SPEC_ENGINES = (("bf16-quant", None, "quant"),
                ("bf16-shallow", None, "shallow"),
                ("int8-self", "int8", "quant"))
# the verify's rows: SLOTS windows of SPEC_K + 1 lanes
VERIFY_ROWS = SLOTS * (SPEC_K + 1)


def phase_spec_serve(cfg, params, seed, tag, quant, source):
    """The 16 requests of phase_serve through a speculative Engine
    (k = SPEC_K; ``source`` "quant" or "shallow" of SHALLOW_LAYERS blocks;
    ``quant`` None or "int8"). Gates completion, the pool's balance, that
    every decode dispatch was a verify dispatch (never the plain [8, 1]
    step), rows 1-2 launched once per layer per lane of every verify
    dispatch and row 3 at the verify's 40 rows (4 per layer + the head a
    verify dispatch, a quantized engine) and the draft's 8 (k times that a
    draft dispatch, a quantized draft)."""
    t0 = time.perf_counter()
    eng = Engine(params=params, config=cfg, num_slots=SLOTS,
                 prefill_chunk=CHUNK, page_size=PAGE, quant=quant,
                 speculate_k=SPEC_K, draft_source=source,
                 draft_layers=SHALLOW_LAYERS if source == "shallow" else None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.use_kernel, "FLAGS_serving_paged_kernel is off")
    wave1, wave2 = make_requests(cfg, np.random.default_rng(seed))
    reset_serving_counters()
    for wrapper in SERVE_KERNELS.values():
        wrapper.launches = 0
    qg.quant_gemm.shapes.clear()
    t0 = time.perf_counter()
    results = eng.run(wave1)
    results.update(eng.run(wave2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in SERVE_KERNELS.items()}
    rows = {}                              # quant GEMM launches by rows
    for (R, _, _), n in qg.quant_gemm.shapes.items():
        rows[R] = rows.get(R, 0) + n
    c = serving_counters()
    print(f"[{tag}] engine built in {build_s:.1f}s; draft "
          f"{len(eng._draft_layers)} blocks, "
          f"{'quantized' if eng._draft_kernel else 'bf16'}")
    print(f"[{tag}] {serving_summary()}")
    reqs = wave1 + wave2
    check(len(results) == len(reqs) and all(
        results[r.request_id].finish_reason in ("length", "stop")
        for r in reqs), f"{tag}: not every request finished")
    for r in reqs:
        toks = results[r.request_id].tokens
        check(0 < len(toks) <= r.max_new_tokens and
              all(0 <= t < cfg.vocab_size for t in toks),
              f"{tag}: request {r.request_id} returned invalid tokens")
    bal = eng.pool.balance()
    check(bal["conserved"] and bal["refcounts_accounted"],
          f"{tag}: page pool does not balance: {bal}")
    L, T = cfg.num_layers, SPEC_K + 1
    nv, nd = c["verify_dispatches"], c["draft_dispatches"]
    check(c["decode_dispatches"] == nv > 0 and 0 < nd <= nv,
          f"{tag}: decode dispatches {c['decode_dispatches']}, verify "
          f"{nv}, draft {nd}: a plain [8, 1] decode ran or no draft did")
    reads = nv * L * T
    want = {"paged_decode": 0 if quant else reads,
            "paged_decode_q": reads if quant else 0}
    want_rows = {VERIFY_ROWS: nv * (4 * L + 1) if quant else 0,
                 SLOTS: nd * SPEC_K * (4 * L + 1) if eng._draft_kernel
                 else 0}
    got_rows = {R: rows.get(R, 0) for R in want_rows}
    per_verify = {k: v / nv for k, v in counts.items()}
    print(f"[{tag}] launches {counts}, quant GEMMs by rows {rows}; per "
          f"verify dispatch: rows 1-2 {per_verify} (want {L} x {T} = "
          f"{L * T}), row 3 at {VERIFY_ROWS} rows "
          f"{got_rows[VERIFY_ROWS] / nv:.1f} (want "
          f"{4 * L + 1 if quant else 0}); row 3 at {SLOTS} rows "
          f"{got_rows[SLOTS] / nd:.1f} a draft dispatch (want "
          f"{SPEC_K * (4 * L + 1) if eng._draft_kernel else 0})")
    check({k: counts[k] for k in want} == want and got_rows == want_rows,
          f"{tag}: the speculative path did not launch its kernels as "
          f"expected (rows 1-2 {counts}, want {want}; row 3 {got_rows}, "
          f"want {want_rows})")
    decode_tokens = c["tokens_out"] - len(reqs)
    stats = {
        "engine": tag, "k": SPEC_K, "accept_rate": c["accept_rate"],
        "tokens_per_dispatch": c["tokens_per_dispatch"],
        "spec_proposed": c["spec_proposed"],
        "spec_accepted": c["spec_accepted"],
        "verify_dispatches": nv, "draft_dispatches": nd,
        "tokens_out": c["tokens_out"], "wall_s": wall,
        "tokens_per_s_wall": c["tokens_out"] / wall,
        "decode_tokens_per_s": decode_tokens / c["decode_time_s"],
        "ttft_p50_ms": c["ttft_p50"] * 1e3, "ttft_p99_ms": c["ttft_p99"] * 1e3,
        "rows_1_2_per_verify": reads / nv,
        "row_3_per_verify": got_rows[VERIFY_ROWS] / nv,
    }
    print(f"[{tag}] {json.dumps(stats)}")
    return {"eng": eng, "reqs": reqs, "results": results, "stats": stats,
            "shapes": dict(qg.quant_gemm.shapes)}


@torch.no_grad()
def served_logits(eng, cfg, seq):
    """The served model's logits after each position of ``seq`` [S]
    (one [1, S] window through the plain paths: gather reads, the plain
    quantized GEMM), fp32 [S, V]."""
    dev = eng.device
    S = len(seq)
    MP = pages_for(S, PAGE)
    P = MP + 1
    nh = cfg.num_heads
    shape = (cfg.num_layers, P, PAGE, nh, cfg.hidden_size // nh)
    kc = new_pool(shape, eng._kc.dtype, dev)
    vc = new_pool(shape, eng._kc.dtype, dev)
    kv = None
    if eng._kv_quant:
        kv = tuple(torch.from_numpy(sc).to(dev) for sc in
                   squant.kv_scales_for(eng._quant, cfg.num_layers, P))
    i32 = dict(dtype=torch.int32, device=dev)
    ids = torch.as_tensor(np.asarray(seq), dtype=torch.int64,
                          device=dev)[None]
    pos = torch.arange(S, **i32)[None]
    x = _paged_blocks(eng.params, cfg, ids, pos, kc, vc,
                      torch.tensor([S], **i32),
                      torch.arange(1, P, **i32)[None], PAGE, False,
                      eng._layers, kv, False)
    return _head_logits(eng.params, cfg, x[0])


def greedy_agreement(eng, cfg, reqs, token_lists):
    """Each greedy request's tokens held to the served model's argmax
    after the same prefix (teacher forced): tokens, tokens equal to the
    argmax, and real disagreements (a token more than LOGIT_TOL x max
    |logit| below the argmax: past a bf16 near-tie)."""
    n = same = real = 0
    for r, toks in zip(reqs, token_lists):
        if r.do_sample or not toks:
            continue
        seq = np.concatenate([r.prompt, np.asarray(toks[:-1], np.int64)])
        lg = served_logits(eng, cfg, seq)[r.prompt_len - 1:]
        t = torch.as_tensor(toks, device=lg.device)
        top = lg.argmax(-1)
        gap = lg.gather(1, top[:, None])[:, 0] - lg.gather(1, t[:, None])[:, 0]
        n += len(toks)
        same += int((top == t).sum())
        real += int((gap > LOGIT_TOL * lg.abs().amax(-1)).sum())
    return {"tokens": n, "argmax_share": same / max(n, 1),
            "real_disagreements": real}


def phase_spec_oracle(cfg, spec, plain_tokens, tag):
    """Printed: each engine's greedy agreement with the served model's
    argmax and how many greedy streams equal the plain engine's. Gated:
    the speculative engine's real disagreements are no more than the
    plain engine's (``greedy_agreement``)."""
    eng, reqs = spec["eng"], spec["reqs"]
    toks = [spec["results"][r.request_id].tokens for r in reqs]
    mine = greedy_agreement(eng, cfg, reqs, toks)
    base = greedy_agreement(eng, cfg, reqs, plain_tokens)
    greedy = [i for i, r in enumerate(reqs) if not r.do_sample]
    equal = sum(toks[i] == plain_tokens[i] for i in greedy)
    print(f"[{tag}] greedy streams equal to the plain engine's: {equal}/"
          f"{len(greedy)} (not gated: the verify's GEMMs take 40 rows, the "
          f"plain step's 8); against the served model's argmax, teacher "
          f"forced: speculative {json.dumps(mine)}, plain "
          f"{json.dumps(base)}")
    check(mine["real_disagreements"] <= base["real_disagreements"],
          f"{tag}: greedy streams disagree with the served model more than "
          f"the plain engine's")
    spec["stats"]["greedy_vs_served_argmax"] = mine
    spec["stats"]["plain_greedy_vs_served_argmax"] = base
    spec["stats"]["greedy_streams_equal_plain"] = [equal, len(greedy)]


@torch.no_grad()
def phase_spec_verify(cfg, eng, gen, dev, tag):
    """One verify dispatch at full width on a fresh pool (8 slots, 100
    prompt tokens each, prefilled through the plain path): its lane-0
    logits against the plain [8, 1] step's within phase_logits' gate, then
    a rewind to 1..5 accepted lanes, after which every pool byte (page 0
    aside) must be its pre-dispatch byte but for the accepted positions,
    which must have been written."""
    params, layers = eng.params, eng._layers
    mp = 8
    L, nh = cfg.num_layers, cfg.num_heads
    P = SLOTS * mp + 1
    shape = (L, P, PAGE, nh, cfg.hidden_size // nh)
    kc = new_pool(shape, eng._kc.dtype, dev)
    vc = new_pool(shape, eng._kc.dtype, dev)
    kv = None
    if eng._kv_quant:
        kv = tuple(torch.from_numpy(sc).to(dev) for sc in
                   squant.kv_scales_for(eng._quant, L, P))
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.arange(SLOTS * mp, **i32).view(SLOTS, mp) + 1
    plen = 100
    ids = torch.randint(0, cfg.vocab_size, (SLOTS, plen + 1), generator=gen,
                        device=dev)
    for b in range(SLOTS):
        window = torch.zeros(1, 128, dtype=torch.int64, device=dev)
        window[0, :plen] = ids[b, :plen]
        paged_forward(params, cfg, window, kc, vc, torch.zeros(1, **i32),
                      torch.full((1,), plen, **i32), table[b:b + 1], PAGE,
                      layers=layers, kv_scales=kv)
    start = torch.full((SLOTS,), plen, **i32)
    tok = ids[:, plen]
    kcp, vcp = kc.clone(), vc.clone()
    plain = paged_forward(params, cfg, tok[:, None], kcp, vcp, start,
                          torch.ones(SLOTS, **i32), table, PAGE,
                          layers=layers, kv_scales=kv)
    del kcp, vcp
    props = paged_draft_forward(eng._draft_params, cfg, tok, kc, vc, start,
                                table, PAGE, SPEC_K,
                                layers=eng._draft_layers, kv_scales=kv,
                                wq_kernel=eng._draft_kernel)
    window = torch.cat([tok[:, None], props], dim=1)
    before = [p.view(torch.uint8).clone() for p in (kc, vc)]
    T = SPEC_K + 1
    valid = torch.full((SLOTS,), T, **i32)
    logits, sk, sv = paged_verify_forward(
        params, cfg, window, kc, vc, start, valid, table, PAGE,
        use_kernel=True, layers=layers, kv_scales=kv,
        wq_kernel=eng.quant_kernel)
    n_emit = torch.arange(SLOTS, **i32) % T + 1
    paged_kv_rewind(kc, vc, sk, sv, table, start, valid, n_emit, PAGE)
    torch.cuda.synchronize()
    diff = float((logits[:, 0] - plain).abs().max())
    scale = float(plain.abs().max())
    print(f"[{tag}] verify lane 0 vs the plain [8, 1] step: max abs diff "
          f"{diff:.4e} of max |logit| {scale:.4e} (tolerance {LOGIT_TOL} x "
          f"max); proposals {props[:2].tolist()}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: verify logits not "
          f"finite")
    check(diff <= LOGIT_TOL * scale, f"{tag}: verify lane-0 logits disagree "
          f"with the plain step")
    accepted = torch.zeros((P, PAGE), dtype=torch.bool, device=dev)
    for b in range(SLOTS):
        for t in range(int(n_emit[b])):
            p = plen + t
            accepted[int(table[b, p // PAGE]), p % PAGE] = True
    bad = written = 0
    for pool, old in zip((kc, vc), before):
        same = (pool.view(torch.uint8) == old).flatten(3).all(dim=(0, 3))
        bad += int((~same[1:] & ~accepted[1:]).sum())
        written += int((~same & accepted).sum())
    print(f"[{tag}] rewind to {n_emit.tolist()} accepted lanes: positions "
          f"changed outside the accepted ones {bad} (want 0), accepted "
          f"positions written {written} of {2 * int(accepted.sum())}")
    check(bad == 0 and written == 2 * int(accepted.sum()),
          f"{tag}: the rewind left bytes other than the accepted lanes' "
          f"changed")
    return diff / scale


def phase_spec_gemm_timing(cfg, eng, shapes, gen, dev):
    """Row 3 at the verify's 40 rows on the int8 engine's own weights: the
    four block GEMMs (bf16 x) and the head (fp32 x) held to the plain
    version, then timed by ``quant_gemm_timing``. Returns the ``kernels``
    rows."""
    cases = quant_gemm_cases(cfg, rows=(VERIFY_ROWS,), head_rows=VERIFY_ROWS)
    errs = {}
    for label, leaf, K, N, R, x_dtype in cases:
        p = eng.params if leaf == "head_w" else \
            {k: v[0] for k, v in eng.params["blocks"].items()}
        x = torch.randn(R, K, generator=gen, device=dev).to(x_dtype)
        got = qg.quant_gemm(x, p[leaf], p[leaf + "_s"])
        r = qg.error_vs_plain(got, qg.quant_gemm_plain(x, p[leaf],
                                                       p[leaf + "_s"]))
        print(f"[spec] quant_gemm int8 {label} R={R} vs plain: max abs "
              f"{r['max_abs']:.2e}, element {r['element']:.2e}, row "
              f"{r['row']:.2e}, tile {r['tile']:.2e}")
        check(bool(torch.isfinite(got).all()) and
              qg.within_tolerance(r, x_dtype),
              f"quant_gemm int8 {label} R={R} disagrees with its plain "
              f"version: {r}")
        errs[("quant_gemm", "int8", label, R)] = r["max_abs"]
    return quant_gemm_timing(eng, "int8", cases, gen, dev, shapes, errs)


def phase_spec(cfg, params, seed, single, gen, dev, rng):
    """Phase 16: the speculative engines of SPEC_ENGINES on the 16
    requests, each beside the plain engine of its dtype that phases 3 and 8
    ran in this call (``single``): the serving gates and rates of
    phase_spec_serve, the greedy gate of phase_spec_oracle, the verify and
    rewind checks of phase_spec_verify; a profile of the first engine's
    boundary (8 greedy slots); row 3 at 40 rows timed on the int8 engine.
    Returns the kernels rows."""
    rows = []
    report = {}
    for i, (tag, quant, source) in enumerate(SPEC_ENGINES):
        spec = phase_spec_serve(cfg, params, seed, f"spec-{tag}", quant,
                                source)
        plain = single[quant or "bf16"]
        phase_spec_oracle(cfg, spec, plain["tokens"], f"spec-{tag}")
        spec["stats"]["lane0_rel_diff"] = phase_spec_verify(
            cfg, spec["eng"], gen, dev, f"spec-{tag}")
        if i == 0:
            phase_profile(cfg, spec["eng"], rng, steps=5,
                          tag=f"spec-{tag}-profile")
        if quant == "int8":
            rows += phase_spec_gemm_timing(cfg, spec["eng"], spec["shapes"],
                                           gen, dev)
        report[tag] = spec["stats"]
        del spec
        torch.cuda.empty_cache()
    plain = {k: single[k]["stats"] for k in ("bf16", "int8")}
    keys = ("decode_tokens_per_s", "tokens_per_s_wall", "ttft_p50_ms",
            "ttft_p99_ms")
    print("[spec] engines (accept rate, tokens per dispatch, decode and "
          "wall tokens/s, TTFT p50 / p99 ms), plain engines of this call "
          "beside them:")
    for tag, st in report.items():
        print(f"[spec]   {tag}: accept {st['accept_rate']:.3f}, "
              f"{st['tokens_per_dispatch']:.3f} tokens/dispatch, " +
              ", ".join(f"{k} {st[k]:.1f}" for k in keys))
    for k, st in plain.items():
        print(f"[spec]   plain {k}: " +
              ", ".join(f"{kk} {st[kk]:.1f}" for kk in keys))
    print(f"[spec] {json.dumps({'spec': report, 'plain': plain})}")
    return rows


# ------------------------------------------------------------ flash / train
def flash_inputs(gen, dev, B, S, nh, d, dtype=torch.bfloat16):
    """q, k, v as strided views of one [B, S, 3, nh, d] qkv tensor (the
    model's split, read in place by the kernels) and a contiguous dO."""
    qkv = torch.randn(B, S, 3, nh, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(B, S, nh, d, generator=gen, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    return q, k, v, do


def flash_bound(kernel, B, S, nh, d, causal, itemsize=2):
    """Least time (ms) and its limiter for one call of a flash kernel:
    each [B, S, nh, d] input read once and each output written once (LSE
    and delta fp32 [B*nh, S]); the tensor-core flops of its products over
    the (query, key) pairs the mask keeps, S(S+1)/2 when causal."""
    pairs = S * (S + 1) // 2 if causal else S * S
    t = B * S * nh * d * itemsize
    stat = B * nh * S * 4
    gemms, nbytes = {"flash_fwd": (2, 4 * t + stat),
                     "flash_dq": (3, 5 * t + 2 * stat),
                     "flash_dkv": (4, 6 * t + 2 * stat)}[kernel]
    nflops = gemms * 2 * d * pairs * B * nh
    t_ops = nflops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", nflops, nbytes)


def phase_flash_vs_plain(gen, dev):
    """The three flash kernels against their plain versions on the same
    inputs. Returns {kernel name: max abs error over the cases}."""
    worst = {name: 0.0 for name, _, _ in FLASH_KERNELS}
    for B, S, nh, d, causal in FLASH_CASES:
        q, k, v, do = flash_inputs(gen, dev, B, S, nh, d)
        try:
            o, lse, delta, dq, dk, dv = run_three(q, k, v, do, causal)
        except RuntimeError:
            print(f"[flash] a kernel failed at B={B} S={S} nh={nh} d={d}; "
                  f"mbarrier wait record: {fa.wait_timeout_record()}")
            raise
        check_vs_plain("flash", f"B={B} S={S} nh={nh} d={d} bf16 "
                       f"{'causal' if causal else 'full'}", (
                           ("o", o, "flash_fwd"), ("lse", lse, "flash_fwd"),
                           ("dq", dq, "flash_dq"), ("dk", dk, "flash_dkv"),
                           ("dv", dv, "flash_dkv")),
                       plain_three(q, k, v, do, delta, causal), worst)
    return worst


def phase_card_tests():
    """The card-only tests of tests/test_torch_cuda_kernels.py (the same
    flash cases, the paged-decode kernel, the small engine) in a pytest
    process of their own, which loads the kernels built above; prints the
    slowest tests' seconds (fixtures counted in their first test)."""
    root = pathlib.Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-p", "no:warnings", "--durations=12",
         "tests/test_torch_cuda_kernels.py"],
        cwd=root, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        if re.match(r"\d+\.\d+s (setup|call|teardown) ", line):
            print(f"[card-tests]   {line}")
    print(f"[card-tests] {lines[-1] if lines else proc.stderr[-500:]}")
    check(proc.returncode == 0, "card tests failed:\n" + proc.stdout[-4000:])


def train_config(num_layers=None):
    """bench.py's recipe on GPT_CONFIGS[MODEL]: flash attention, bf16
    compute, remat "full"."""
    cfg = dataclasses.replace(GPT_CONFIGS[MODEL], use_flash=True,
                              compute_dtype="bfloat16", remat=True,
                              remat_policy="full")
    return cfg if num_layers is None else dataclasses.replace(
        cfg, num_layers=num_layers)


def reset_flash_counts():
    for _, wrapper, _ in FLASH_KERNELS:
        wrapper.launches = 0


def flash_counts():
    return {name: wrapper.launches for name, wrapper, _ in FLASH_KERNELS}


def train_ids(cfg, seed, dev):
    """The one batch of the training phases (5, 10 and 11): the same ids
    on every rank and in every phase, so their trajectories from the same
    weights compare."""
    return torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 3), device=dev)


def phase_train(seed, dev):
    """GPT-3 1.3B through HybridTrainStep with bench.py's recipe: 2
    warm-up and 5 timed steps on one batch. Returns (step, ids, launch
    counts of the run, losses)."""
    cfg = train_config()
    t0 = time.perf_counter()
    opt = AdamW(2e-4, grad_clip=ClipGradByGlobalNorm(1.0),
                moment_dtype="bfloat16")
    step = HybridTrainStep(cfg, opt, param_dtype=torch.bfloat16, seed=seed,
                           device=dev)
    ids = train_ids(cfg, seed, dev)
    torch.cuda.synchronize()
    print(f"[train] {MODEL}: H={cfg.hidden_size} L={cfg.num_layers} "
          f"nh={cfg.num_heads} V={cfg.vocab_size}, {step.num_params():,} "
          f"params bf16, AdamW(2e-4, clip 1.0, bf16 moments), remat full, "
          f"ids [{TRAIN_B}, {TRAIN_S}]; set up in "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts start at 0 here and are read right after
    reset_flash_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        losses.append(step(ids))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        losses.append(step(ids))
    stop.record()
    last = float(losses[-1])                   # scalar read-back
    step_s = start.elapsed_time(stop) / 1e3 / TIMED_STEPS
    counts = flash_counts()
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L * steps, "flash_dq": L * steps,
            "flash_dkv": L * steps}
    print(f"[train] losses {[round(x, 4) for x in losses]}")
    print(f"[train] launches over {steps} steps: {counts} (want {want}: "
          f"forward 2 x {L} layers per step, its rerun under remat "
          f"included; dQ and dK/dV {L} each)")
    check(all(np.isfinite(losses)), f"a train loss is not finite: {losses}")
    check(last < losses[0], f"loss did not fall on the same batch: "
          f"{losses[0]:.4f} -> {last:.4f}")
    check(counts == want, "the train step did not run the flash kernels "
          "the expected number of times")
    fpt, n_params = flops.model_flops_per_token(cfg, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(0))
    mfu = flops.mfu(fpt * tokens, step_s, peak)
    stats = {"step_s": step_s, "tokens_per_s": tokens / step_s,
             "mfu": mfu, "peak_flops_bf16": peak,
             "flops_per_token": fpt, "n_params_formula": n_params,
             "warmup_s": warm, "first_loss": losses[0], "last_loss": last,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[train] {json.dumps(stats)}")
    return step, ids, counts, losses


def trace_by_kind(run, tag):
    """torch.profiler (device kernels) over one ``run()`` (a train step,
    which reads its loss back): prints the host wall, the device's busy
    share of it, kernel rows grouped by kind and the largest rows by
    name. Returns the device-busy ms."""
    run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        traced = time.perf_counter() - t0

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    events = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    kinds = {"flash kernels": ("flash_",), "GEMMs": (
        "gemm", "nvjet", "cutlass", "sm90_xmma", "Kernel2"),
        "reductions": ("reduce",), "elementwise": ("elementwise",
                                                   "vectorized", "unrolled"),
        "index/embedding": ("index", "embedding", "gather", "scatter")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for e in events:
        kind = next((k for k, pats in kinds.items()
                     if any(p in e.key for p in pats)), "other")
        by_kind[kind] += dev_us(e) / 1e3
    print(f"[{tag}] one step: {traced * 1e3:.1f} ms host wall "
          f"traced; device busy {busy:.1f} ms = {busy / (traced * 1e3):.1%}")
    print(f"[{tag}] device ms by kind: "
          f"{json.dumps({k: round(v, 3) for k, v in by_kind.items()})}")
    for e in events[:14]:
        print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} "
              f"calls  {e.key[:90]}")
    return busy


def phase_train_profile(step, ids):
    """Where a train step's time goes: ``trace_by_kind`` over one step,
    then the device time under each range of the step."""
    busy = trace_by_kind(lambda: float(step(ids)), "train-profile")
    # device time under each record_function range of the step: a second
    # trace that also records host ops, so kernels nest under the ranges.
    # The backward (autograd's own thread) is what the ranges leave over.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        float(step(ids))
    ranges = ("train_step/forward", "fused_ce/forward", "fused_ce/backward",
              "train_step/clip", "train_step/optimizer")
    cpu = torch.autograd.DeviceType.CPU
    spans = {r: sum(getattr(e, "device_time_total", 0) for e in prof.events()
                    if e.name == r and e.device_type == cpu) / 1e3
             for r in ranges}
    spans["backward (the rest)"] = busy - sum(
        spans[r] for r in ("train_step/forward", "train_step/clip",
                           "train_step/optimizer"))
    print(f"[train-profile] device ms by part of the step (forward and "
          f"backward contain fused_ce's): "
          f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}")


def phase_train_parity(seed, gen, dev):
    """One step of a 2-layer copy at full width, through the kernels and
    through use_flash=False, on the same weights and ids."""
    cfg = train_config(num_layers=2)
    params = init_gpt_params(cfg, seed=seed + 1, device=dev,
                             dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (2, TRAIN_S), generator=gen,
                        device=dev)
    runs = {}
    for use_flash in (True, False):
        flat = {n: t.detach().clone().requires_grad_(True)
                for n, t in flatten_params(params).items()}
        loss = gpt_loss(unflatten_params(flat), ids,
                        dataclasses.replace(cfg, use_flash=use_flash))
        grads = torch.autograd.grad(loss, list(flat.values()))
        runs[use_flash] = (float(loss.detach()), dict(zip(flat, grads)))
    (lk, gk), (lp, gp) = runs[True], runs[False]
    rel = {n: float((gk[n].float() - gp[n].float()).norm() /
                    gp[n].float().norm().clamp(min=1e-30)) for n in gk}
    worst = max(rel, key=rel.get)
    print(f"[parity] 2-layer {MODEL} width, B=2 S={TRAIN_S} bf16: loss "
          f"kernels {lk:.6f} vs use_flash=False {lp:.6f} (|diff| "
          f"{abs(lk - lp):.2e}); gradient leaves: max ||dg||/||g|| "
          f"{rel[worst]:.3e} ({worst}), median "
          f"{sorted(rel.values())[len(rel) // 2]:.3e} (gates: loss "
          f"{PARITY_LOSS_REL} rel, leaves {PARITY_GRAD_REL})")
    check(np.isfinite(lk) and abs(lk - lp) <= PARITY_LOSS_REL * abs(lp),
          "train loss through the kernels disagrees with the plain path")
    check(all(np.isfinite(v) and v <= PARITY_GRAD_REL
              for v in rel.values()),
          f"a gradient leaf disagrees with the plain path: {rel}")


def flash_shape_times(gen, dev, B, S, nh, d):
    """The three flash kernels and their plain versions at one causal
    shape, device time by CUDA graph replay in turns (plain, kernel,
    kernel, plain), and SDPA's forward and backward (forward + backward
    less forward) on the same values: ({kernel: (k1, k2, p1, p2)},
    sdpa_fwd_ms, sdpa_bwd_ms)."""
    q, k, v, do = flash_inputs(gen, dev, B, S, nh, d)
    o, lse = fa.flash_forward(q, k, v, True)
    delta = fa.attention_delta(o, do)
    calls = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v, True),
                      lambda: fa.flash_forward_plain(q, k, v, True)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, True),
                     lambda: fa.flash_dq_plain(q, k, v, do, lse, delta,
                                               True)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, True),
                      lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta,
                                                 True)),
    }
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).contiguous()
                       for t in (q, k, v, do))
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]

    def sdpa_fwd():
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(out, leaves, doh)

    lib_fwd = graph_ms(sdpa_fwd, iters=10)
    lib_bwd = graph_ms(sdpa_fwd_bwd, iters=10) - lib_fwd
    times = {}
    for name, (kernel, plain) in calls.items():
        p1 = graph_ms(plain, iters=2, replays=3)
        k1 = graph_ms(kernel, iters=10)
        k2 = graph_ms(kernel, iters=10)
        p2 = graph_ms(plain, iters=2, replays=3)
        times[name] = (k1, k2, p1, p2)
    return times, lib_fwd, lib_bwd


def phase_flash_timing(gen, dev, errs, counts):
    """Each flash kernel, causal bf16, at every shape of
    FLASH_TIMED_SHAPES (the one-card step's B=8, S=2048, 16 heads of 128
    first, then what the pp, mp and dp paths hand it) against its bound,
    its plain version and SDPA. SDPA's forward is the forward kernel's
    library time. Its backward computes dQ, dK and dV in one call, so it
    stands once, on flash_dkv's row, marked as covering dQ + dK/dV, and
    flash_dq's row has none. Returns the three kernel rows of the first
    shape."""
    rows = []
    for path, B, S, nh, d in FLASH_TIMED_SHAPES:
        times, lib_fwd, lib_bwd = flash_shape_times(gen, dev, B, S, nh, d)
        library = {"flash_fwd": lib_fwd, "flash_dq": None,
                   "flash_dkv": lib_bwd}
        ms, main_shape = {}, not rows
        for name, _, replaces in FLASH_KERNELS:
            k1, k2, p1, p2 = times[name]
            ms[name], plain_ms = min(k1, k2), min(p1, p2)
            bound, bound_by, nflops, nbytes = flash_bound(name, B, S, nh,
                                                          d, True)
            lib = library[name]
            vs_lib = f", SDPA {lib:.4f} ms" if lib is not None else ""
            print(f"[timing] {name} ({path}) B={B} S={S} nh={nh} d={d} "
                  f"bf16 causal, device time (CUDA graph replay): kernel "
                  f"{k1:.4f}/{k2:.4f} ms = "
                  f"{nflops / ms[name] / 1e9:.1f} TFLOP/s, plain "
                  f"{p1:.4f}/{p2:.4f} ms{vs_lib}, bound {bound:.4f} ms "
                  f"({bound_by}: {nflops:.3e} flops, {nbytes / 1e6:.1f} "
                  f"MB) -> {bound / ms[name]:.1%} of bound")
            if main_shape:
                rows.append({"name": name, "route": "cuda",
                             "source": FLASH_SOURCES[name],
                             "replaces": replaces,
                             "launches": counts[name],
                             "max_abs_err": errs[name], "ms": ms[name],
                             "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": bound_by, "library_ms": lib})
        kernels_bwd = ms["flash_dq"] + ms["flash_dkv"]
        print(f"[timing] SDPA ({path}; library yardstick, not used by the "
              f"port): forward {lib_fwd:.4f} ms against the forward "
              f"kernel's {ms['flash_fwd']:.4f} ms "
              f"({ms['flash_fwd'] / lib_fwd:.2f}x); backward (dQ, dK and "
              f"dV in one call) {lib_bwd:.4f} ms against dQ + dK/dV "
              f"{kernels_bwd:.4f} ms ({kernels_bwd / lib_bwd:.2f}x)")
    rows[2]["library_covers"] = "flash_dq+flash_dkv"
    return rows


# -------------------------------------------------------- BERT pretraining
BERT_MODEL = "bert-base"
BERT_B, BERT_S = 32, 128    # README's BERT-base row (bs32, seq128)
BERT_MIN_LEN = 64           # real tokens a row: 64-128, the rest padded
BERT_MLM_RATE = 0.15
BERT_LR = 1e-4
BERT_PARITY_STEPS = 3       # TrainStep steps of the 2-layer parity copy
# rows 4-6 with a key-padding bias and dropout against their plain
# versions: BERT-base's attention (the main path's shape, first) and a
# long-sequence batch of the same heads; non-causal
BERT_FLASH_CASES = ((BERT_B, BERT_S, 12, 64), (8, 512, 12, 64))


class BertPretrainingLoss(torch.nn.Module):
    """The pretraining-loss adapter of tools_mfu_sweep.py's BERT case, for
    ``jit.TrainStep``: the model's output is its fused MLM + NSP loss."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, labels, types, mask, nsp):
        return self.bert.pretraining_loss(ids, labels, types, mask, nsp)


def bert_batch(cfg, seed, dev, B=BERT_B, S=BERT_S):
    """One pretraining batch from the seed: ids with each row's last
    S - length positions padded (0), lengths BERT_MIN_LEN..S; 15 % of the
    real tokens as MLM targets (-100 elsewhere); token types 0 then 1 at
    half the length; NSP labels."""
    g = torch.Generator().manual_seed(seed + 11)
    lengths = torch.randint(BERT_MIN_LEN, S + 1, (B,), generator=g)
    real = torch.arange(S)[None, :] < lengths[:, None]
    ids = torch.randint(1, cfg.vocab_size, (B, S), generator=g) * real
    target = (torch.rand(B, S, generator=g) < BERT_MLM_RATE) & real
    labels = torch.where(target, ids, -100)
    types = (torch.arange(S)[None, :] >= lengths[:, None] // 2).long()
    nsp = torch.randint(0, 2, (B,), generator=g)
    return tuple(t.to(dev) for t in (ids, labels, types, real.long(), nsp))


def bert_model(cfg, seed, dev):
    """BertForPretraining with the port's init seeded through
    framework.random, under amp.decorate O2 (bf16 params, fp32 masters)
    with the tentpole's AdamW."""
    prandom.seed(seed)
    model = BertForPretraining(cfg)
    opt = AdamW(BERT_LR, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model.to(dev), opt


def phase_bert_train(seed, dev):
    """BERT-base pretraining through jit.TrainStep (amp O2, AdamW with
    global-norm clip and fp32 masters, dropout 0.1 in the flash kernels
    and the hidden layers): 2 warm-up and 5 timed steps on one padded
    batch. Returns (step, batch, launch counts, losses)."""
    cfg = BERT_CONFIGS[BERT_MODEL]
    t0 = time.perf_counter()
    model, opt = bert_model(cfg, seed, dev)
    step = TrainStep(BertPretrainingLoss(model), lambda out: out, opt,
                     device=dev)
    batch = bert_batch(cfg, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"[bert] {BERT_MODEL}: H={cfg.hidden_size} "
          f"L={cfg.num_hidden_layers} heads={cfg.num_attention_heads} "
          f"FFN={cfg.intermediate_size} V={cfg.vocab_size}, {n_params:,} "
          f"params (amp O2: bf16, fp32 masters), AdamW({BERT_LR}, clip "
          f"1.0), dropout {cfg.hidden_dropout_prob} / "
          f"{cfg.attention_probs_dropout_prob}, batch [{BERT_B}, "
          f"{BERT_S}] with {int(batch[3].sum())} real tokens, "
          f"{int((batch[1] != -100).sum())} MLM targets; set up in "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts start at 0 here and are read right after
    reset_flash_counts()
    pF.scaled_dot_product_attention.fallbacks = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        losses.append(step(batch, ()))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        losses.append(step(batch, ()))
    stop.record()
    last = float(losses[-1])                   # scalar read-back
    step_s = start.elapsed_time(stop) / 1e3 / TIMED_STEPS
    counts = flash_counts()
    fallbacks = pF.scaled_dot_product_attention.fallbacks
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    L = cfg.num_hidden_layers
    want = {name: L * steps for name, _, _ in FLASH_KERNELS}
    print(f"[bert] losses {[round(x, 4) for x in losses]}")
    print(f"[bert] flash launches over {steps} steps: {counts} (want "
          f"{want}: {L} / {L} / {L} a step, no remat); SDPA fallbacks "
          f"{fallbacks} (want 0)")
    check(all(np.isfinite(losses)), f"a BERT loss is not finite: {losses}")
    check(last < losses[0], f"BERT loss did not fall on the same batch: "
          f"{losses[0]:.4f} -> {last:.4f}")
    check(counts == want and fallbacks == 0, "the BERT step did not run "
          "the flash kernels the expected number of times")
    tokens = BERT_B * BERT_S
    fpt = flops.dense_flops_per_token(n_params) + \
        flops.attention_flops_per_token(L, cfg.hidden_size, BERT_S)
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(0))
    stats = {"step_s": step_s, "sequences_per_s": BERT_B / step_s,
             "tokens_per_s": tokens / step_s,
             "mfu": flops.mfu(fpt * tokens, step_s, peak),
             "flops_per_token": fpt, "n_params": n_params,
             "warmup_s": warm, "first_loss": losses[0], "last_loss": last,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[bert] {json.dumps(stats)} (tokens count every position, "
          f"padding included)")
    return step, batch, counts, losses


def phase_bert_parity(seed, dev):
    """A 2-layer BERT-base copy through the flash kernels and through
    FLAGS_use_flash_attention=False (``parity_routes``): bf16 everywhere,
    P rounded to bf16 on both routes after the same dropout, phase 6's
    gates."""
    cfg = dataclasses.replace(BERT_CONFIGS[BERT_MODEL], num_hidden_layers=2)
    print(f"[bert-parity] 2-layer {BERT_MODEL} width, [{BERT_B}, {BERT_S}] "
          f"bf16, dropout 0.1, AdamW({BERT_LR}, clip 1.0)")
    parity_routes("bert-parity", lambda: bert_model(cfg, seed + 1, dev),
                  BertPretrainingLoss, bert_batch(cfg, seed + 1, dev), seed,
                  BERT_PARITY_STEPS)


def bert_flash_inputs(gen, dev, B, S, nh, d):
    """q, k, v, dO as flash_inputs gives them, and BERT's [B, 1, 1, S]
    key-padding bias (-1e4 past each row's length, BERT_MIN_LEN..S)."""
    q, k, v, do = flash_inputs(gen, dev, B, S, nh, d)
    lengths = torch.randint(min(BERT_MIN_LEN, S), S + 1, (B,),
                            generator=gen, device=dev)
    real = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    bias = torch.where(real, 0.0, -1e4)[:, None, None, :]
    return q, k, v, do, bias


def library_ms(fwd, fwd_bwd):
    """SDPA's forward and backward (forward + backward less forward) ms
    by CUDA-graph replay, or by eager CUDA events (said so) where a graph
    cannot capture its dropout."""
    try:
        lib_fwd = graph_ms(fwd, iters=10)
        return lib_fwd, graph_ms(fwd_bwd, iters=10) - lib_fwd
    except RuntimeError as e:
        print(f"[bert-timing] SDPA with dropout did not capture in a CUDA "
              f"graph ({str(e)[:200]}); timed eagerly instead")
        torch.cuda.synchronize()
        lib_fwd = cuda_ms(fwd, iters=20)
        return lib_fwd, cuda_ms(fwd_bwd, iters=20) - lib_fwd


def three_calls(q, k, v, do, lse, delta, causal, **feats):
    """{short name: (kernel call, plain call)} of rows 4-6 on one input,
    for ``time_three``."""
    return {
        "fwd": (lambda: fa.flash_forward(q, k, v, causal, **feats),
                lambda: fa.flash_forward_plain(q, k, v, causal, **feats)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal,
                                   **feats),
               lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, causal,
                                         **feats)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                     **feats),
                lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, causal,
                                           **feats)),
    }


def phase_bert_flash(gen, dev, counts):
    """Rows 4-6 with the key-padding bias and dropout 0.1 against their
    plain versions (error_vs_plain's gates, the same key) at each of
    BERT_FLASH_CASES, then their device times by CUDA-graph replay in
    turns (plain, kernel, kernel, plain) beside SDPA's with the same
    float mask and dropout_p, and the bound. Returns the kernels line's
    rows (the first case's)."""
    p, key = BERT_CONFIGS[BERT_MODEL].attention_probs_dropout_prob, 0xB5E7
    rows, worst = [], {}
    for B, S, nh, d in BERT_FLASH_CASES:
        q, k, v, do, bias = bert_flash_inputs(gen, dev, B, S, nh, d)
        feats = dict(bias=bias, dropout_p=p, key=key)
        o, lse, delta, dq, dk, dv = run_three(q, k, v, do, False, **feats)
        case = f"B={B} S={S} nh={nh} d={d} bf16 full, pad bias, p={p}"
        check_vs_plain("bert-flash", case, (
            ("o", o, "flash_fwd"), ("lse", lse, "flash_fwd"),
            ("dq", dq, "flash_dq"), ("dk", dk, "flash_dkv"),
            ("dv", dv, "flash_dkv")),
            plain_three(q, k, v, do, delta, False, **feats), worst)
        bounds = feature_bound(B, S, S, nh, d, S * S, 2,
                               extra_bytes=B * S * 4)
        library = sdpa_library(q, k, v, do, bias, p)
        times = time_three("bert-timing", case, three_calls(
            q, k, v, do, lse, delta, False, **feats), bounds, library)
        if (B, S, nh, d) == BERT_FLASH_CASES[0]:
            rows = kernel_rows("bias_dropout", times, bounds, library,
                               counts, worst)
        bwd = times["dq"][0] + times["dkv"][0]
        print(f"[bert-timing] SDPA (B={B} S={S}; library yardstick with the "
              f"same bf16 attn_mask and dropout_p, not used by the port): "
              f"forward {library['fwd']:.4f} ms against the forward "
              f"kernel's {times['fwd'][0]:.4f} ms "
              f"({times['fwd'][0] / library['fwd']:.2f}x); backward "
              f"{library['dkv']:.4f} ms against dQ + dK/dV {bwd:.4f} ms "
              f"({bwd / library['dkv']:.2f}x)")
        del q, k, v, do, bias, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    for row in rows:                       # the worst over both cases
        row["max_abs_err"] = worst[row["name"].removesuffix("_bias_dropout")]
    return rows


def phase_bert(seed, gen, dev):
    """The BERT phase: training steps (and a traced step), the 2-layer
    parity step, rows 4-6 with the bias and dropout. Returns the kernels
    line's rows."""
    step, batch, counts, _ = phase_bert_train(seed, dev)
    trace_by_kind(lambda: float(step(batch, ())), "bert-profile")
    del step, batch
    torch.cuda.empty_cache()
    phase_bert_parity(seed, dev)
    torch.cuda.empty_cache()
    return phase_bert_flash(gen, dev, counts)


# ------------------------- flash features: segment ids, varlen, fp16, Sq != Sk
VARLEN_TOKENS = 16384       # the pack of flash_attn_unpadded's run
VARLEN_DOCS = (128, 2048)   # document lengths drawn uniformly
VARLEN_HEADS, VARLEN_D = 16, 128                 # GPT-3 1.3B's attention
FP16_CASE = (BERT_B, BERT_S, 12, 64)             # BERT's shape, fp16
# rows 4-6 against their plain versions at the features this slice adds:
# (label, B, Sq, Sk, heads, d, causal, dtype, bias kind, dropout p)
FEATURE_CASES = (
    ("transformer cross", 32, 128, 256, 8, 64, False, torch.bfloat16,
     "pad", 0.1),
    ("transformer decoder self, -inf mask", 32, 128, 128, 8, 64, False,
     torch.bfloat16, "square-inf", 0.1),
    ("causal Sq < Sk", 2, 1024, 2048, 16, 128, True, torch.bfloat16, None,
     0.0),
    ("causal Sq > Sk", 2, 2048, 1024, 16, 128, True, torch.float16, None,
     0.0),
    ("fp16 GPT step", 8, 2048, 2048, 16, 128, True, torch.float16, None,
     0.0),
    ("fp16 BERT", *FP16_CASE[:2], FP16_CASE[1], *FP16_CASE[2:], False,
     torch.float16, "pad", 0.1),
)


def feature_inputs(gen, dev, B, Sq, Sk, nh, d, dtype, kind):
    """q, dO [B, Sq, nh, d], k and v strided views of one [B, Sk, 2, nh, d]
    tensor (the cross-attention's separate projections read in place),
    and the bias of ``kind``: "pad", a [B, 1, 1, Sk] key-padding bias of
    PAD_BIAS past each row's length (half to all of Sk); "square-inf",
    the decoder's [1, 1, Sq, Sk] generate_square_subsequent_mask; None."""
    q = torch.randn(B, Sq, nh, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(B, Sq, nh, d, generator=gen, device=dev).to(dtype)
    k, v = torch.randn(B, Sk, 2, nh, d, generator=gen,
                       device=dev).to(dtype).unbind(2)
    bias = None
    if kind == "pad":
        lengths = torch.randint(Sk // 2, Sk + 1, (B,), generator=gen,
                                device=dev)
        real = torch.arange(Sk, device=dev)[None, :] < lengths[:, None]
        bias = torch.where(real, 0.0, PAD_BIAS)[:, None, None, :]
    elif kind == "square-inf":
        bias = pnn.Transformer.generate_square_subsequent_mask(Sq).to(dev)[
            None, None]
    return q, k, v, do, bias


def check_vs_plain(tag, case, outs, plains, worst):
    """error_vs_plain of each (name, got) against its plain version, the
    LSE at fa.LSE_TOL; prints the readings and fails on a miss. ``worst``
    keeps the largest max abs error per kernel."""
    failed = []
    for (key, got, kernel), want in zip(outs, plains):
        if key == "lse":
            err = float((got - want).abs().max())
            print(f"[{tag}] {case} lse: max abs {err:.2e}")
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            if not torch.allclose(got, want, atol=fa.LSE_TOL,
                                  rtol=fa.LSE_TOL):
                failed.append(key)
            continue
        r = fa.error_vs_plain(got, want)
        worst[kernel] = max(worst.get(kernel, 0.0), r["max_abs"])
        print(f"[{tag}] {case} {key}: max abs {r['max_abs']:.2e} (max "
              f"|plain| {float(want.abs().max()):.2e}), worst tile rel L2 "
              f"{r['tile_rel_l2']:.2e} (gate {fa.TILE_REL}), worst element "
              f"{r['element']:.3f} of its allowance")
        if not (bool(torch.isfinite(got).all()) and fa.within_tolerance(r)):
            failed.append(key)
    check(not failed, f"flash {', '.join(failed)} disagree with the plain "
          f"versions at {case}")


def run_three(q, k, v, do, causal, **feats):
    """The three kernels on one input: (o, lse, delta, dq, dk, dv)."""
    o, lse = fa.flash_forward(q, k, v, causal, **feats)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal, **feats)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, **feats)
    torch.cuda.synchronize()
    return o, lse, delta, dq, dk, dv


def plain_three(q, k, v, do, delta, causal, **feats):
    o, lse = fa.flash_forward_plain(q, k, v, causal, **feats)
    return (o, lse, fa.flash_dq_plain(q, k, v, do, lse, delta, causal,
                                      **feats),
            *fa.flash_dkv_plain(q, k, v, do, lse, delta, causal, **feats))


def feature_bound(B, Sq, Sk, nh, d, pairs, itemsize, extra_bytes=0):
    """(ms, by, flops, bytes) of each of the three kernels over ``pairs``
    (query, key) pairs a (b, head): q and dO [B, Sq], k and v [B, Sk]
    read once, outputs written once, LSE and delta fp32; plus
    ``extra_bytes`` (a bias, segment ids)."""
    tq, tk = B * Sq * nh * d * itemsize, B * Sk * nh * d * itemsize
    stat = B * nh * Sq * 4
    out = {}
    for kernel, gemms, nbytes in (("fwd", 2, tq + 2 * tk + tq + stat),
                                  ("dq", 3, 2 * tq + 2 * tk + 2 * stat + tq),
                                  ("dkv", 4, 2 * tq + 2 * tk + 2 * stat +
                                   2 * tk)):
        nflops = gemms * 2 * d * pairs * B * nh
        nbytes += extra_bytes
        t_ops = nflops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[kernel] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
                       else "bytes", nflops, nbytes)
    return out


def time_three(tag, label, calls, bounds, library, iters=10):
    """Kernel and plain device ms of the three kernels by CUDA-graph replay
    in turns (plain, kernel, kernel, plain; ``calls``: short name ->
    (kernel call, plain call)), printed beside the bound and the library
    time. Returns {short: (ms, plain ms)}."""
    out = {}
    for short, (kernel, plain) in calls.items():
        p1 = graph_ms(plain, iters=1, replays=2)
        k1 = graph_ms(kernel, iters=iters)
        k2 = graph_ms(kernel, iters=iters)
        p2 = graph_ms(plain, iters=1, replays=2)
        ms = min(k1, k2)
        bound, by, nflops, nbytes = bounds[short]
        lib = library.get(short)
        vs_lib = f", library {lib:.4f} ms" if lib is not None else ""
        print(f"[{tag}] {short} {label}: kernel {k1:.4f}/{k2:.4f} ms = "
              f"{nflops / ms / 1e9:.1f} TFLOP/s, plain {p1:.4f}/{p2:.4f} "
              f"ms{vs_lib}, bound {bound:.4f} ms ({by}: {nflops:.3e} flops, "
              f"{nbytes / 1e6:.1f} MB) -> {bound / ms:.1%} of bound")
        out[short] = (ms, min(p1, p2))
    return out


def kernel_rows(suffix, times, bounds, library, counts, errs):
    """The kernels line's three rows of one shape (``_<suffix>``)."""
    rows = []
    for (name, _, replaces), short in zip(FLASH_KERNELS,
                                          ("fwd", "dq", "dkv")):
        ms, plain_ms = times[short]
        rows.append({"name": f"{name}_{suffix}", "route": "cuda",
                     "source": FLASH_SOURCES[name], "replaces": replaces,
                     "launches": counts[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bounds[short][0],
                     "bound_by": bounds[short][1],
                     "library_ms": library.get(short)})
    rows[2]["library_covers"] = f"flash_dq_{suffix}+flash_dkv_{suffix}"
    return rows


def sdpa_library(q, k, v, do, bias, p, causal=False):
    """SDPA's forward and backward ms on the same [B, S, H, D] inputs
    (the library yardstick, not used by the port)."""
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    mask = None if bias is None else bias.to(q.dtype)

    def fwd():
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                       dropout_p=p, is_causal=causal)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             dropout_p=p, is_causal=causal)
        torch.autograd.grad(out, leaves, doh)

    lib_fwd, lib_bwd = library_ms(fwd, fwd_bwd)
    return {"fwd": lib_fwd, "dkv": lib_bwd}


def phase_feature_cases(gen, dev):
    """Rows 4-6 at FEATURE_CASES against their plain versions (the same
    key): Sq != Sk, fp16, the -inf square mask. Returns {case label:
    the worst max abs error per kernel}."""
    errs = {}
    for label, B, Sq, Sk, nh, d, causal, dtype, kind, p in FEATURE_CASES:
        worst = errs[label] = {}
        q, k, v, do, bias = feature_inputs(gen, dev, B, Sq, Sk, nh, d,
                                           dtype, kind)
        feats = dict(bias=bias, dropout_p=p, key=0xF17)
        o, lse, delta, dq, dk, dv = run_three(q, k, v, do, causal, **feats)
        case = (f"{label}: B={B} Sq={Sq} Sk={Sk} nh={nh} d={d} "
                f"{str(dtype)[6:]} {'causal' if causal else 'full'}, bias "
                f"{kind}, p={p}")
        check_vs_plain("features", case, (
            ("o", o, "flash_fwd"), ("lse", lse, "flash_fwd"),
            ("dq", dq, "flash_dq"), ("dk", dk, "flash_dkv"),
            ("dv", dv, "flash_dkv")),
            plain_three(q, k, v, do, delta, causal, **feats), worst)
        del q, k, v, do, bias, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return errs


def varlen_lengths(rng, total, lo, hi):
    """Document lengths drawn uniformly from [lo, hi] until they fill
    ``total`` tokens, the last cut to fit."""
    out = []
    while sum(out) < total:
        out.append(int(rng.integers(lo, hi + 1)))
    out[-1] -= sum(out) - total
    return out


def varlen_pairs(lq, lk, causal):
    """(query, key) pairs a head that the documents keep."""
    return sum(a * (a + 1) // 2 if causal else a * b
               for a, b in zip(lq, lk))


def phase_varlen(rng, gen, dev, dtype, causal, lq, lk):
    """flash_attn_unpadded at GPT-3 1.3B's attention width over a pack of
    documents (lengths lq against lk), forward and backward, with launches
    counted over that call: its output and gradients per document against
    the plain versions of that document alone; then rows 4-6 on the padded
    pack (segment ids) timed against their bound over the pairs inside
    documents, the plain versions per document, and SDPA over nested
    jagged tensors. Returns (times, bounds, library, counts, errs)."""
    H, d = VARLEN_HEADS, VARLEN_D
    cu_q = torch.tensor(np.cumsum([0] + lq), dtype=torch.int32, device=dev)
    cu_k = torch.tensor(np.cumsum([0] + lk), dtype=torch.int32, device=dev)
    Tq, Tk = sum(lq), sum(lk)
    q = torch.randn(Tq, H, d, generator=gen, device=dev).to(dtype)
    do = torch.randn(Tq, H, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(Tk, H, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    label = (f"{len(lq)} documents, {Tq} x {Tk} tokens, {H} x {d}, "
             f"{str(dtype)[6:]}, {'causal' if causal else 'full'}")
    # the entry point's path: counts from 0 before, read after
    reset_flash_counts()
    pF.scaled_dot_product_attention.fallbacks = 0
    out, _ = pF.flash_attn_unpadded(*leaves, cu_q, cu_k, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = flash_counts()
    print(f"[varlen] {label}: launches {counts}, fallbacks "
          f"{pF.scaled_dot_product_attention.fallbacks}")
    check(counts == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1} and
          pF.scaled_dot_product_attention.fallbacks == 0,
          f"flash_attn_unpadded did not run rows 4-6 once each: {counts}")
    worst, bad = {}, []
    for i, (a, b) in enumerate(zip(lq, lk)):
        sq, sk = slice(int(cu_q[i]), int(cu_q[i + 1])), slice(
            int(cu_k[i]), int(cu_k[i + 1]))
        qd, kd, vd, dod = (t[None] for t in (q[sq], k[sk], v[sk], do[sq]))
        od = out[sq].detach()[None]
        delta = fa.attention_delta(od, dod)
        want = plain_three(qd, kd, vd, dod, delta, causal)
        got = (od, None, grads[0][sq][None], grads[1][sk][None],
               grads[2][sk][None])
        for key, kernel, g, w in zip(("o", "lse", "dq", "dk", "dv"),
                                     ("flash_fwd", "flash_fwd", "flash_dq",
                                      "flash_dkv", "flash_dkv"), got, want):
            if g is None:
                continue
            r = fa.error_vs_plain(g, w)
            worst[kernel] = max(worst.get(kernel, 0.0), r["max_abs"])
            if not (bool(torch.isfinite(g).all()) and fa.within_tolerance(r)):
                bad.append((i, key, r))
    print(f"[varlen] {label}: per-document max abs errors {worst}; "
          f"misses {bad[:3]}")
    check(not bad, f"flash_attn_unpadded disagrees with the plain versions "
          f"per document ({label}): {bad[:3]}")
    del out, grads, leaves
    # rows 4-6 alone on the pack, padded to the tile with segment ids
    pad = fa.FWD_ROWS
    Tq_p, Tk_p = -(-Tq // pad) * pad, -(-Tk // pad) * pad
    qs = fa.varlen_segment_ids(cu_q, Tq, Tq_p)[None]
    ks = fa.varlen_segment_ids(cu_k, Tk, Tk_p)[None]
    ks = torch.where(ks < 0, fa.PAD_K_ID, ks)
    seg = (qs, ks)
    qp, dop = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Tq_p - Tq))[None]
               for t in (q, do))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Tk_p - Tk))[None]
              for t in (k, v))
    o, lse = fa.flash_forward(qp, kp, vp, causal, segment_ids=seg)
    delta = fa.attention_delta(o, dop)
    docs = list(zip(lq, lk, cu_q.tolist(), cu_k.tolist()))

    def per_doc(fn):
        def run():
            for a, b, s0, t0 in docs:
                fn(qp[:, s0:s0 + a], kp[:, t0:t0 + b], vp[:, t0:t0 + b],
                   dop[:, s0:s0 + a], lse.view(H, -1)[:, s0:s0 + a],
                   delta.view(H, -1)[:, s0:s0 + a])
        return run

    calls = {
        "fwd": (lambda: fa.flash_forward(qp, kp, vp, causal,
                                         segment_ids=seg),
                per_doc(lambda q_, k_, v_, do_, l_, d_:
                        fa.flash_forward_plain(q_, k_, v_, causal))),
        "dq": (lambda: fa.flash_dq(qp, kp, vp, dop, lse, delta, causal,
                                   segment_ids=seg),
               per_doc(lambda q_, k_, v_, do_, l_, d_: fa.flash_dq_plain(
                   q_, k_, v_, do_, l_.contiguous(), d_.contiguous(),
                   causal))),
        "dkv": (lambda: fa.flash_dkv(qp, kp, vp, dop, lse, delta, causal,
                                     segment_ids=seg),
                per_doc(lambda q_, k_, v_, do_, l_, d_: fa.flash_dkv_plain(
                    q_, k_, v_, do_, l_.contiguous(), d_.contiguous(),
                    causal))),
    }
    pairs = varlen_pairs(lq, lk, causal)
    bounds = feature_bound(1, Tq, Tk, H, d, pairs, 2,
                           extra_bytes=4 * (Tq_p + Tk_p))
    library = varlen_library(q, k, v, do, cu_q, cu_k, causal)
    times = time_three("varlen-timing", label + " (plain: per document)",
                       calls, bounds, library, iters=5)
    dense = feature_bound(1, Tq, Tk, H, d, varlen_pairs([Tq], [Tk], causal),
                          2)["fwd"][2]
    print(f"[varlen-timing] {label}: {pairs * 2 * 2 * d * H:.3e} forward "
          f"flops inside documents against {dense:.3e} over the whole pack "
          f"({dense / (pairs * 4 * d * H):.1f}x)")
    del q, k, v, do, qp, kp, vp, dop, o, lse, delta
    torch.cuda.empty_cache()
    return times, bounds, library, counts, worst


def varlen_library(q, k, v, do, cu_q, cu_k, causal):
    """SDPA over nested jagged tensors ([docs, jagged, H, D], transposed
    to heads first) on the pack, forward and backward (eager CUDA events:
    the nested layout is not captured in a graph); where torch refuses
    that call, the padded SDPA with a block-diagonal mask (said so)."""
    def nest(t, offsets):
        return torch.nested.nested_tensor_from_jagged(
            t, offsets=offsets).transpose(1, 2)

    # one offsets tensor per ragged length: the jagged dimension of two
    # nested tensors is the same only when their offsets are one tensor
    oq = cu_q.long()
    ok = oq if torch.equal(cu_q, cu_k) else cu_k.long()
    try:
        qn, kn, vn, don = nest(q, oq), nest(k, ok), nest(v, ok), nest(do, oq)
        leaves = [t.detach().requires_grad_(True) for t in (qn, kn, vn)]

        def fwd():
            F.scaled_dot_product_attention(qn, kn, vn, is_causal=causal)

        def fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            torch.autograd.grad(out, leaves, don)

        lib_fwd = cuda_ms(fwd, iters=10, warmup=3)
        lib_bwd = cuda_ms(fwd_bwd, iters=10, warmup=3) - lib_fwd
        print("[varlen-timing] library: SDPA over nested jagged tensors")
    except Exception as e:      # noqa: BLE001 - the yardstick's fallback
        print(f"[varlen-timing] SDPA over nested jagged tensors refused "
              f"({type(e).__name__}: {str(e)[:200]}); library: the padded "
              f"SDPA with a block-diagonal mask")
        qs = fa.varlen_segment_ids(cu_q, q.shape[0], q.shape[0])
        ks = fa.varlen_segment_ids(cu_k, k.shape[0], k.shape[0])
        keep = qs[:, None] == ks[None, :]
        if causal:
            keep &= torch.ones_like(keep).tril()
        mask = torch.where(keep, 0.0, float("-inf")).to(q.dtype)[None, None]
        lib = sdpa_library(q[None], k[None], v[None], do[None], mask, 0.0)
        lib_fwd, lib_bwd = lib["fwd"], lib["dkv"]
    return {"fwd": lib_fwd, "dkv": lib_bwd}


def phase_fp16_entry_points(gen, dev):
    """F.flash_attention (dropout 0.1) and SDPA (key-padding bias and
    dropout 0.1) on fp16 at BERT's shape, forward and backward, launches
    counted over those calls; then rows 4-6's fp16 bias + dropout
    instances timed there against the plain versions and SDPA. Returns
    (times, bounds, library, counts)."""
    B, S, nh, d = FP16_CASE
    p = 0.1
    q, k, v, do, bias = feature_inputs(gen, dev, B, S, S, nh, d,
                                       torch.float16, "pad")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    reset_flash_counts()
    pF.scaled_dot_product_attention.fallbacks = 0
    out, none = pF.flash_attention(*leaves, dropout=p)
    torch.autograd.grad(out, leaves, do)
    out = pF.scaled_dot_product_attention(*leaves, attn_mask=bias,
                                          dropout_p=p)
    torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    counts = flash_counts()
    print(f"[fp16] F.flash_attention and SDPA, B={B} S={S} nh={nh} d={d} "
          f"fp16, p={p}: launches {counts}, fallbacks "
          f"{pF.scaled_dot_product_attention.fallbacks}, outputs "
          f"{out.dtype}")
    check(none is None and counts == {"flash_fwd": 2, "flash_dq": 2,
                                      "flash_dkv": 2}
          and pF.scaled_dot_product_attention.fallbacks == 0
          and out.dtype == torch.float16,
          f"the fp16 entry points did not run rows 4-6: {counts}")
    feats = dict(bias=bias, dropout_p=p, key=0xF16)
    o, lse = fa.flash_forward(q, k, v, False, **feats)
    delta = fa.attention_delta(o, do)
    calls = {
        "fwd": (lambda: fa.flash_forward(q, k, v, False, **feats),
                lambda: fa.flash_forward_plain(q, k, v, False, **feats)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, False, **feats),
               lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, False,
                                         **feats)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, False,
                                     **feats),
                lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, False,
                                           **feats)),
    }
    bounds = feature_bound(B, S, S, nh, d, S * S, 2, extra_bytes=B * S * 4)
    library = sdpa_library(q, k, v, do, bias, p)
    times = time_three("fp16-timing", f"B={B} S={S} nh={nh} d={d} fp16 "
                       f"full, pad bias, p={p}", calls, bounds, library)
    return times, bounds, library, counts


def phase_flash_features(seed, gen, dev):
    """The features this slice adds to rows 4-6: each against its plain
    version (FEATURE_CASES), flash_attn_unpadded over a 16,384-token pack
    (causal, bf16 and fp16; then non-causal with cu_seqlens_q !=
    cu_seqlens_k), and the fp16 entry points. Returns the kernels line's
    rows (the causal bf16 pack's and fp16 BERT's)."""
    errs = phase_feature_cases(gen, dev)
    rng = np.random.default_rng(seed + 17)
    lq = varlen_lengths(rng, VARLEN_TOKENS, *VARLEN_DOCS)
    rows = []
    for dtype in (torch.bfloat16, torch.float16):
        got = phase_varlen(rng, gen, dev, dtype, True, lq, lq)
        if dtype == torch.bfloat16:
            rows += kernel_rows("varlen", *got[:4], got[4])
    lk = [int(rng.integers(*VARLEN_DOCS)) for _ in lq]
    phase_varlen(rng, gen, dev, torch.bfloat16, False, lq, lk)
    times, bounds, library, counts = phase_fp16_entry_points(gen, dev)
    return rows + kernel_rows("fp16", times, bounds, library, counts,
                              errs["fp16 BERT"])


# ------------------------------------------------- Transformer-base training
TRANSFORMER_MODEL = "transformer-base"
TF_B, TF_SRC, TF_TGT = 32, 256, 128   # pairs, source and target slots
TF_SRC_LEN, TF_TGT_LEN = (64, 256), (32, 128)   # real tokens a row
TF_LR = 1e-4
TF_PARITY_STEPS = 3
# the 2 + 2-layer copy's gradient-leaf gate, set from its CPU copy
# (tests/torch_transformer_gate.py: worst leaf 6.06e-2, median 3.13e-2,
# the kernels' plain versions keeping P in fp32 where the composed path
# rounds it to bf16) before any reading on the card; its loss and steps
# keep PARITY_LOSS_REL (the CPU copy: at most 7.8e-6)
TF_PARITY_GRAD_REL = 1e-1


class TranslationLoss(torch.nn.Module):
    """The loss adapter for ``jit.TrainStep``: the model's output is its
    fused cross-entropy."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, src, tgt, labels):
        return self.model.loss(src, tgt, labels)


def transformer_model(cfg, seed, dev):
    """TransformerForTranslation with the port's init seeded through
    framework.random, under amp.decorate O2 with AdamW(TF_LR, global-norm
    clip 1.0) and fp32 masters."""
    prandom.seed(seed)
    model = TransformerForTranslation(cfg)
    opt = AdamW(TF_LR, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model.to(dev), opt


def transformer_batch(cfg, seed, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in translation_batch(
        cfg, TF_B, TF_SRC, TF_TGT, seed, TF_SRC_LEN, TF_TGT_LEN))


def transformer_step_flops(cfg):
    """Model FLOPs of one training step (forward x 3), every position of
    the batch counted: the encoder's and decoder's projections, FFNs and
    attention products, the cross-attention's keys and values over the
    source, the vocabulary projection."""
    d, ff, V = cfg.d_model, cfg.dim_feedforward, cfg.vocab_size
    ns, nt = TF_B * TF_SRC, TF_B * TF_TGT
    enc = ns * (2 * (4 * d * d + 2 * d * ff) + 4 * TF_SRC * d)
    dec = nt * (2 * (6 * d * d + 2 * d * ff) + 4 * (TF_TGT + TF_SRC) * d) + \
        ns * 2 * 2 * d * d
    fwd = cfg.num_encoder_layers * enc + cfg.num_decoder_layers * dec + \
        nt * 2 * d * V
    return 3 * fwd


def phase_transformer_train(seed, dev):
    """Transformer-base through jit.TrainStep: 2 warm-up and 5 timed steps
    on one batch; every loss finite, the last below the first, rows 4-6
    launched 18 times a step each (6 encoder, 6 decoder self, 6 cross,
    their level-1 and level-2 bias + dropout instances), no fallback.
    Returns (step, batch, counts)."""
    cfg = TRANSFORMER_CONFIGS[TRANSFORMER_MODEL]
    t0 = time.perf_counter()
    model, opt = transformer_model(cfg, seed, dev)
    step = TrainStep(TranslationLoss(model), lambda out: out, opt,
                     device=dev)
    batch = transformer_batch(cfg, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    real_src = int((batch[0] != cfg.pad_id).sum())
    real_tgt = int((batch[2] != -100).sum())
    torch.cuda.synchronize()
    print(f"[transformer] {TRANSFORMER_MODEL}: d={cfg.d_model} "
          f"heads={cfg.nhead} L={cfg.num_encoder_layers}+"
          f"{cfg.num_decoder_layers} FFN={cfg.dim_feedforward} "
          f"V={cfg.vocab_size}, {n_params:,} params (amp O2: bf16, fp32 "
          f"masters), AdamW({TF_LR}, clip 1.0), dropout {cfg.dropout}, "
          f"batch {TF_B} pairs of [{TF_SRC}] -> [{TF_TGT}] slots with "
          f"{real_src} source and {real_tgt} target tokens; set up in "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts start at 0 here and are read right after
    reset_flash_counts()
    pF.scaled_dot_product_attention.fallbacks = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        losses.append(step(batch, ()))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        losses.append(step(batch, ()))
    stop.record()
    last = float(losses[-1])                   # scalar read-back
    step_s = start.elapsed_time(stop) / 1e3 / TIMED_STEPS
    counts = flash_counts()
    fallbacks = pF.scaled_dot_product_attention.fallbacks
    losses = [float(x) for x in losses]
    steps = WARMUP_STEPS + TIMED_STEPS
    per_step = cfg.num_encoder_layers + 2 * cfg.num_decoder_layers
    want = {name: per_step * steps for name, _, _ in FLASH_KERNELS}
    print(f"[transformer] losses {[round(x, 4) for x in losses]}")
    print(f"[transformer] flash launches over {steps} steps: {counts} "
          f"(want {want}: {per_step} a step each); SDPA fallbacks "
          f"{fallbacks} (want 0)")
    check(all(np.isfinite(losses)), f"a Transformer loss is not finite: "
          f"{losses}")
    check(last < losses[0], f"the Transformer loss did not fall on the "
          f"same batch: {losses[0]:.4f} -> {last:.4f}")
    check(counts == want and fallbacks == 0, "the Transformer step did not "
          "run the flash kernels the expected number of times")
    nflops = transformer_step_flops(cfg)
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(0))
    stats = {"step_s": step_s,
             "target_tokens_per_s": real_tgt / step_s,
             "tokens_per_s": (real_src + real_tgt) / step_s,
             "positions_per_s": TF_B * (TF_SRC + TF_TGT) / step_s,
             "mfu": flops.mfu(nflops, step_s, peak),
             "step_flops": nflops, "n_params": n_params, "warmup_s": warm,
             "first_loss": losses[0], "last_loss": last,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[transformer] {json.dumps(stats)} (tokens: real source + "
          f"target; MFU over every position)")
    return step, batch, counts


def parity_routes(tag, make, wrap, batch, seed, steps,
                  grad_gate=PARITY_GRAD_REL):
    """A model from ``make()`` (model, opt) through the flash kernels and
    through FLAGS_use_flash_attention=False (the composed path), from the
    same weights and generator state (the same Philox keys, so the
    composed path drops the same attention probabilities): one step's loss
    and every gradient leaf within phase 6's gates, then ``steps``
    jit.TrainStep steps of each route (``wrap(model)`` the loss module),
    each step's loss within PARITY_LOSS_REL of the composed route's, and
    on both routes every fp32 master moved off its start and every bf16
    param its master rounded."""
    runs = {}
    try:
        for use_flash in (True, False):
            set_flags({"FLAGS_use_flash_attention": use_flash})
            model, opt = make()
            names = [n for n, _ in model.named_parameters()]
            prandom.seed(seed + 2)
            loss = wrap(model)(*batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            step = TrainStep(wrap(model), lambda out: out, opt,
                             device=batch[0].device)
            start = {n: p.detach().float().clone()
                     for n, p in step.params.items()}
            prandom.seed(seed + 3)
            losses = [float(step(batch, ())) for _ in range(steps)]
            slots = step.opt_state["slots"]
            still = [n for n in start
                     if torch.equal(slots[n]["master"], start[n])]
            unwritten = [n for n, p in step.params.items()
                         if not torch.equal(p, slots[n]["master"].to(
                             p.dtype))]
            check(not still and not unwritten, f"{tag} masters: not moved "
                  f"{still}, not written back to the bf16 params "
                  f"{unwritten}")
            runs[use_flash] = (float(loss.detach()), grads, losses)
            del model, opt, step, start, slots
    finally:
        set_flags({"FLAGS_use_flash_attention": True})
    (lk, gk, tk), (lp, gp, tp) = runs[True], runs[False]
    rel = {n: float((a.float() - b.float()).norm() /
                    b.float().norm().clamp(min=1e-30))
           for n, a, b in zip(names, gk, gp)}
    # the key biases' gradient is zero in exact arithmetic (a constant on
    # every score of a row): summation noise only, on both routes
    rel = {n: v for n, v in rel.items() if not n.endswith("k_proj.bias")}
    worst = max(rel, key=rel.get)
    apart = [abs(a - b) / abs(b) for a, b in zip(tk, tp)]
    print(f"[{tag}] loss kernels {lk:.6f} vs composed {lp:.6f} (|diff| "
          f"{abs(lk - lp):.2e}); gradient leaves: max ||dg||/||g|| "
          f"{rel[worst]:.3e} ({worst}), median "
          f"{sorted(rel.values())[len(rel) // 2]:.3e} (gates: loss "
          f"{PARITY_LOSS_REL} rel, leaves {grad_gate})")
    print(f"[{tag}] {steps} TrainStep steps (fp32 masters): kernels "
          f"{[round(x, 6) for x in tk]}, composed "
          f"{[round(x, 6) for x in tp]}, relative apart "
          f"{[float(f'{x:.3e}') for x in apart]} (gate {PARITY_LOSS_REL} "
          f"each); every master moved and written back on both routes")
    check(np.isfinite(lk) and abs(lk - lp) <= PARITY_LOSS_REL * abs(lp),
          f"{tag}: the loss through the kernels disagrees with the "
          f"composed path")
    check(all(np.isfinite(v) and v <= grad_gate for v in rel.values()),
          f"{tag}: a gradient leaf disagrees with the composed path: {rel}")
    check(all(np.isfinite(tk)) and max(apart) <= PARITY_LOSS_REL,
          f"{tag}: the TrainStep trajectory through the kernels parts from "
          f"the composed path's: {tk} vs {tp}")


def phase_transformer_flash(gen, dev, counts):
    """Rows 4-6 at the Transformer's three attention shapes (encoder self
    [32, 256] with the padding bias, decoder self [32, 128] with the -inf
    square mask, cross [32, 128 x 256] with the padding bias; 8 heads of
    64, dropout 0.1), timed against the bound, the plain versions and
    SDPA with the same float mask and dropout_p. Returns the kernels
    line's rows (the cross-attention's)."""
    p = TRANSFORMER_CONFIGS[TRANSFORMER_MODEL].dropout
    rows = []
    for label, Sq, Sk, kind in (("cross", TF_TGT, TF_SRC, "pad"),
                                ("encoder self", TF_SRC, TF_SRC, "pad"),
                                ("decoder self", TF_TGT, TF_TGT,
                                 "square-inf")):
        q, k, v, do, bias = feature_inputs(gen, dev, TF_B, Sq, Sk, 8, 64,
                                           torch.bfloat16, kind)
        feats = dict(bias=bias, dropout_p=p, key=0x7F)
        o, lse, delta, dq, dk, dv = run_three(q, k, v, do, False, **feats)
        worst = {}
        check_vs_plain("transformer-flash", f"{label} B={TF_B} Sq={Sq} "
                       f"Sk={Sk}, bias {kind}, p={p}", (
                           ("o", o, "flash_fwd"), ("lse", lse, "flash_fwd"),
                           ("dq", dq, "flash_dq"), ("dk", dk, "flash_dkv"),
                           ("dv", dv, "flash_dkv")),
                       plain_three(q, k, v, do, delta, False, **feats),
                       worst)
        calls = {
            "fwd": (lambda: fa.flash_forward(q, k, v, False, **feats),
                    lambda: fa.flash_forward_plain(q, k, v, False, **feats)),
            "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, False,
                                       **feats),
                   lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, False,
                                             **feats)),
            "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, False,
                                         **feats),
                    lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta,
                                               False, **feats)),
        }
        bias_bytes = bias[0, 0].numel() * 4 if kind != "pad" else \
            TF_B * Sk * 4
        bounds = feature_bound(TF_B, Sq, Sk, 8, 64, Sq * Sk, 2,
                               extra_bytes=bias_bytes)
        library = sdpa_library(q, k, v, do, bias, p)
        times = time_three("transformer-timing", f"{label} B={TF_B} Sq={Sq} "
                           f"Sk={Sk} 8 x 64 bf16, bias {kind}, p={p}",
                           calls, bounds, library)
        if label == "cross":
            rows = kernel_rows("cross", times, bounds, library, counts,
                               worst)
        del q, k, v, do, bias, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


def phase_transformer(seed, gen, dev):
    """Phase 14: Transformer-base training steps (and a traced step), the
    2 + 2-layer kernels-vs-composed check at full width, rows 4-6 at its
    shapes. Returns the kernels line's rows."""
    step, batch, counts = phase_transformer_train(seed, dev)
    trace_by_kind(lambda: float(step(batch, ())), "transformer-profile")
    del step, batch
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(TRANSFORMER_CONFIGS[TRANSFORMER_MODEL],
                              num_encoder_layers=2, num_decoder_layers=2)
    parity_routes("transformer-parity",
                  lambda: transformer_model(cfg, seed + 1, dev),
                  TranslationLoss, transformer_batch(cfg, seed + 1, dev),
                  seed, TF_PARITY_STEPS, TF_PARITY_GRAD_REL)
    torch.cuda.empty_cache()
    return phase_transformer_flash(gen, dev, counts)


# -------------------------------------------------- tensor-parallel serving
NVLINK_BYTES_PER_S = 450e9  # one direction of one H100's NVLink


def mp_layout():
    """The tensor-parallel phases' layout, from the card count: one rank
    per card over NCCL when there are MP cards, else all MP ranks on
    cuda:0 over gloo (NCCL refuses two ranks on one card)."""
    return "per_card" if torch.cuda.device_count() >= MP else "shared"


def mp_gemm_cases(cfg):
    """(label, K, F/MP, rows, x dtype) of the fused GEMM + all-gather on the
    mp serving path: the out and down projections at a decode dispatch
    (SLOTS rows) and a full prefill chunk (CHUNK rows), bf16 x; the
    vocab-sharded LM head at a decode dispatch, fp32 x."""
    H, V = cfg.hidden_size, cfg.vocab_size
    inner = cfg.ffn_mult * H
    cases = [(label, K, H // MP, R, torch.bfloat16) for R in (SLOTS, CHUNK)
             for label, K in (("out", H), ("down", inner))]
    cases.append(("head", H, V // MP, SLOTS, torch.float32))
    return cases


def mp_bucket_cases(cfg):
    """(rows, cols per rank) of the data all-gathers: the embedding and
    the attention context ([R, H/MP]) and the FFN activation ([R, I/MP]),
    at a decode dispatch and a full chunk; bf16."""
    H = cfg.hidden_size
    return [(R, F) for R in (SLOTS, CHUNK)
            for F in (H // MP, cfg.ffn_mult * H // MP)]


AG_KERNEL = ("paddle_tpu_torch/csrc/ag_bucket.cu",
             "paddle_tpu/ops/pallas_kernels/fused_collectives.py:409")


def ag_bound(nbytes, n, per_card):
    """(ms, by) of one row-11 call on a row of ``nbytes``. A card per rank:
    the larger of the HBM bytes (the n rows written into their slots, and
    this rank's staging row read by the n ranks) and the bytes received
    over one direction of NVLink (n - 1 rows). One card: one rank's call
    alone (n rows read, n written)."""
    times = {"bytes": 2 * n * nbytes / HBM_BYTES_PER_S}
    if per_card:
        times["nvlink bytes"] = (n - 1) * nbytes / NVLINK_BYTES_PER_S
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def ag_row(label, t, nbytes, n, per_card, launches, err):
    """A ``kernels`` row of row 11 over a row of ``nbytes`` from its whole
    calls' timings ``t`` (``slowest_rank_ms``: the call, the plain ring,
    the library's all-gather)."""
    bound, by = ag_bound(nbytes, n, per_card)
    return {"name": f"fused_ag_bucket[{label}]", "route": "cuda",
            "source": AG_KERNEL[0], "replaces": AG_KERNEL[1],
            "launches": launches, "max_abs_err": err, "ms": t["call_ms"],
            "plain_ms": t["plain_call_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": t["library_call_ms"],
            "covers": (f"whole call, one launch, slowest of {n} ranks on "
                       f"their own cards; library: NCCL's all-gather")
            if per_card else
            (f"path check, not a speed: whole call with {n} ranks "
             f"time-slicing one card; library: gloo's all-gather")}


def _mp_weight(gen, dev, K, F, kind, n=1):
    """n random [K, F] weight shards of ``kind`` ("bf16", "fp32", "int8",
    "fp8") with their scales (None for bf16 and fp32)."""
    ws, ss = [], []
    for _ in range(n):
        w = torch.randn(K, F, generator=gen, device=dev) * 0.02
        if kind in ("bf16", "fp32"):
            ws.append(w.to(torch.bfloat16) if kind == "bf16" else w)
            ss.append(None)
        else:
            q, sc = squant._quantize_leaf(w, kind)
            ws.append(q)
            ss.append(sc)
    return ws, ss


def _same_on_every_rank(group, t):
    """Whether every rank holds the same bytes as this rank's ``t``."""
    raw = t.contiguous().view(torch.uint8)
    return all(torch.equal(o, raw) for o in group.all_gather_list(raw))


def phase_mp_gemm_vs_plain(group, gen, seed, cfg, say):
    """Rows 12-13 at every case of ``mp_gemm_cases`` (bf16, int8, fp8
    weight shards, and the head shard at fp32 as a head passed at fp32
    is stored) and row 11 at every case of ``mp_bucket_cases``: the fused
    wrapper against its plain version on the same inputs, rows 12-13 bit
    for bit against ``fc.gemm_ag_exact``, and the gathered output bitwise
    the same on every rank. x is the same on every rank (``gen``), each
    rank's weight shard and row its own, so a block gathered into the
    wrong slot shows. Returns ({case: max abs error}, failures)."""
    dev = group.device
    wgen = torch.Generator(device=dev).manual_seed(seed + 1000 + group.rank)
    errs, failed = {}, []
    cases = [(kind,) + c for kind in MP_WEIGHTS for c in mp_gemm_cases(cfg)]
    cases += [("fp32",) + c for c in mp_gemm_cases(cfg) if c[0] == "head"]
    for kind, label, K, Fl, R, x_dtype in cases:
        (w,), (s,) = _mp_weight(wgen, dev, K, Fl, kind)
        x = torch.randn(R, K, generator=gen, device=dev).to(x_dtype)
        got = fc.fused_gemm_ag(x, w, group, s)
        torch.cuda.synchronize()
        r = fc.error_vs_plain(got, fc.gemm_ag_plain(x, w, group, s))
        exact = torch.equal(got, fc.gemm_ag_exact(x, w, group, s))
        same = _same_on_every_rank(group, got)
        errs[(kind, label, R)] = r["max_abs"]
        ok = bool(torch.isfinite(got).all()) and same and exact and \
            fc.within_tolerance(r, x_dtype)
        say(f"[mp-kernel] fused_gemm_ag {kind} {label} R={R} K={K} "
            f"F/{MP}={Fl} x={str(x_dtype)[6:]}: max abs "
            f"{r['max_abs']:.2e}, worst element {r['element']:.2e} "
            f"(gate {fc.ELEMENT_TOL[x_dtype]}), worst row "
            f"{r['row']:.2e} (gate {fc.ROW_TOL[x_dtype]}), worst tile "
            f"{r['tile']:.2e} (gate {qg.TILE_TOL[x_dtype]}); bit for bit "
            f"gemm_into + the group's all-gather: {exact}; same bytes on "
            f"every rank: {same}")
        if not ok:
            failed.append(f"fused_gemm_ag {kind} {label} R={R}")
    for R, F in mp_bucket_cases(cfg):
        row = torch.randn(R * F, generator=wgen, device=dev).to(
            torch.bfloat16)
        got = fc.fused_ag_bucket(row, group)
        torch.cuda.synchronize()
        want = fc.ag_bucket_plain(row, group)
        same = _same_on_every_rank(group, got)
        exact = torch.equal(got, want)
        errs[("bucket", R, F)] = float((got.float() - want.float())
                                       .abs().max())
        say(f"[mp-kernel] fused_ag_bucket {R}x{F} bf16: equal to the plain "
            f"gather: {exact}, same bytes on every rank: {same}")
        if not (exact and same):
            failed.append(f"fused_ag_bucket {R}x{F}")
    return errs, failed


def _scripted_decode(cfg, params, dev, ids, heads, pool_dtype, spec,
                     mp=None, wq_kernel=False):
    """One [8, 1] decode step through the kernels after a 100-token prefill
    of each slot (gather path), on fresh pools of ``heads`` heads:
    phase_logits' scenario, for any engine layout. Returns the logits."""
    mpages = 8
    L = cfg.num_layers
    d = cfg.hidden_size // cfg.num_heads
    P = SLOTS * mpages + 1
    shape = (L, P, PAGE, heads, d)
    kc, vc = new_pool(shape, pool_dtype, dev), new_pool(shape, pool_dtype,
                                                        dev)
    kv = {}
    if spec is not None and spec.quantizes_kv:
        kv["kv_scales"] = tuple(torch.from_numpy(sc).to(dev)
                                for sc in squant.kv_scales_for(spec, L, P))
    table = (torch.arange(SLOTS * mpages, dtype=torch.int32, device=dev)
             .view(SLOTS, mpages) + 1)
    layers = layer_params(params)
    i32 = dict(dtype=torch.int32, device=dev)
    plen = ids.shape[1] - 1
    for b in range(SLOTS):
        window = torch.zeros(1, 128, dtype=torch.int64, device=dev)
        window[0, :plen] = ids[b, :plen]
        paged_forward(params, cfg, window, kc, vc, torch.zeros(1, **i32),
                      torch.full((1,), plen, **i32), table[b:b + 1], PAGE,
                      use_kernel=False, layers=layers, wq_kernel=wq_kernel,
                      mp=mp, **kv)
    return paged_forward(params, cfg, ids[:, plen:],
                         kc, vc, torch.full((SLOTS,), plen, **i32),
                         torch.ones(SLOTS, **i32), table, PAGE,
                         use_kernel=True, layers=layers, wq_kernel=wq_kernel,
                         mp=mp, **kv)


def gemm_ag_launches(shapes, cfg, dev):
    """Rows 12-13's launches that their calls by shape (``fused_gemm_ag.
    shapes``) imply: per call the GEMM's one, its k split's reduce where
    its plan splits, and the gather's. The head's x is fp32, every other
    x bf16."""
    total = 0
    for (R, K, Fl, w_dtype), calls in shapes.items():
        x_dtype = (torch.float32 if Fl == cfg.vocab_size // MP
                   else torch.bfloat16)
        splits = qg.plan(R, K, Fl, getattr(torch, w_dtype), x_dtype,
                         dev.index)[2]
        total += calls * (2 + (splits > 1))
    return total


MP_KERNELS = {"fused_gemm_ag": fc.fused_gemm_ag,
              "fused_ag_bucket": fc.fused_ag_bucket,
              "paged_decode": paged_decode_attention,
              "paged_decode_q": paged_decode_attention_q,
              "quant_gemm": qg.quant_gemm}


def phase_mp_serve(group, cfg, params, seed, quant, gen, say, wave1=None):
    """The 16 requests of phase_serve (or the first ``wave1`` of its 14
    wave-1 requests and the two of wave 2) through Engine(mp=MP,
    comm_backend="fused") on this rank. Gates (the failures returned):
    every request finishes with the same tokens on every rank, the pool
    balances, and per dispatch 2L + 1 fused GEMM + all-gathers, 2L + 1
    data all-gathers, per decode dispatch L paged-decode launches and, when
    quantized, 2L local quant GEMMs per dispatch; one decode step's logits
    against the one-card forward on the same weights (rank 0) within
    LOGIT_TOL of max |logit|. Returns the stats, rank 0's tokens, the
    indices of the requests served among the 16 and the launches by
    shape."""
    tag = f"mp-serve-{quant or 'bf16'}"
    failed = []
    t0 = time.perf_counter()
    eng = Engine(params=params, config=cfg, num_slots=SLOTS,
                 prefill_chunk=CHUNK, page_size=PAGE, quant=quant, mp=MP,
                 comm_backend="fused", group=group)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    first, wave2 = make_requests(cfg, np.random.default_rng(seed))
    keep = len(first) if wave1 is None else wave1
    served = list(range(keep)) + [len(first) + i for i in range(len(wave2))]
    wave1 = first[:keep]
    group.barrier()
    # the main path: counts start at 0 here and are read right after
    reset_serving_counters()
    for wrapper in MP_KERNELS.values():
        wrapper.launches = 0
    fc.reset_gemm_ag_counts()
    fc.reset_ag_bucket_counts()
    t0 = time.perf_counter()
    results = eng.run(wave1) if wave1 else {}
    results.update(eng.run(wave2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in MP_KERNELS.items()}
    gemm_ag_calls = fc.fused_gemm_ag.calls
    shapes = {"fused_gemm_ag": dict(fc.fused_gemm_ag.shapes),
              "fused_ag_bucket": dict(fc.fused_ag_bucket.shapes)}
    c = serving_counters()
    reqs = wave1 + wave2
    tokens = [results[r.request_id].tokens if r.request_id in results
              else [] for r in reqs]
    finished = len(results) == len(reqs) and all(
        results[r.request_id].finish_reason in ("length", "stop")
        for r in reqs)
    flat = torch.tensor([len(t) for t in tokens] + sum(tokens, []),
                        dtype=torch.int64, device=group.device)
    lens = group.all_gather_list(torch.tensor([flat.numel()],
                                              device=group.device))
    same = len({int(n) for n in lens}) == 1 and \
        _same_on_every_rank(group, flat)
    say(f"[{tag}] {MP} ranks, engine built in {build_s:.1f}s; "
        f"{serving_summary()}")
    if not (finished and same):
        failed.append(f"{tag}: finished {finished}, same tokens on every "
                      f"rank {same}")
    bal = eng.pool.balance()
    if not (bal["conserved"] and bal["refcounts_accounted"]):
        failed.append(f"{tag}: page pool does not balance: {bal}")
    L = cfg.num_layers
    steps, decode = c["paged_steps"], c["decode_dispatches"]
    # rows 12-13: 2L + 1 calls a dispatch, each the GEMM's one or two
    # launches (its plan's k split) and the gather's
    want_calls = steps * (2 * L + 1)
    say(f"[{tag}] rows 12-13 per dispatch: "
        f"{gemm_ag_calls / max(steps, 1):.2f} calls, "
        f"{counts['fused_gemm_ag'] / max(steps, 1):.2f} launches (GEMM "
        f"and gather), no NCCL or gloo collective")
    if gemm_ag_calls != want_calls:
        failed.append(f"{tag}: {gemm_ag_calls} row 12-13 calls, want "
                      f"{want_calls}")
    want = {"fused_gemm_ag": gemm_ag_launches(shapes["fused_gemm_ag"], cfg,
                                              group.device),
            "fused_ag_bucket": steps * (2 * L + 1),
            "paged_decode": 0 if quant else decode * L,
            "paged_decode_q": decode * L if quant else 0,
            "quant_gemm": steps * 2 * L if quant else 0}
    say(f"[{tag}] launches on rank {group.rank}: {counts} (want {want}: "
        f"{steps} dispatches x ({2 * L + 1} fused GEMM + all-gathers of "
        f"2-3 launches, "
        f"{2 * L + 1} data all-gathers of one launch each"
        f"{', 2 x L local quant GEMMs' if quant else ''}), "
        f"{decode} decode dispatches x {L} paged decodes)")
    if counts != want or decode == 0:
        failed.append(f"{tag}: launches {counts}, want {want}")

    # one decode step: the mp forward against the one-card forward
    ids = torch.randint(0, cfg.vocab_size, (SLOTS, 101), generator=gen,
                        device=group.device)
    spec = eng._quant
    logits = _scripted_decode(cfg, eng.params, group.device, ids,
                              cfg.num_heads // MP, eng._kc.dtype, spec,
                              mp=(group, eng._mp_cfg),
                              wq_kernel=eng.quant_kernel)
    torch.cuda.synchronize()
    same_logits = _same_on_every_rank(group, logits)
    logit_diff = None
    if group.rank == 0:
        one = params
        if spec is not None and spec.quantizes_weights:
            one = squant.quantize_params(one, cfg, spec)
        one = cast_for_compute(one, cfg, group.device)
        ref = _scripted_decode(cfg, one, group.device, ids, cfg.num_heads,
                               eng._kc.dtype, spec, wq_kernel=quant is not None)
        torch.cuda.synchronize()
        logit_diff = float((logits - ref).abs().max())
        scale = float(ref.abs().max())
        agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
        say(f"[{tag}] decode step, mp={MP} forward vs the one-card forward "
            f"on the same weights: max abs diff {logit_diff:.4e} of max "
            f"|logit| {scale:.4e} (tolerance {LOGIT_TOL} x max), argmax "
            f"agreement {agree:.3f}; logits the same bytes on every rank: "
            f"{same_logits}")
        if not (bool(torch.isfinite(logits).all())
                and logit_diff <= LOGIT_TOL * scale):
            failed.append(f"{tag}: logits disagree with the one-card "
                          f"forward")
        del one, ref
    if not same_logits:
        failed.append(f"{tag}: logits differ between ranks")
    if quant in (None, "int8") and group.backend == "nccl":
        group.barrier()
        phase_profile(cfg, eng, np.random.default_rng(seed + 7),
                      group=group, tag=f"mp-profile-{quant or 'bf16'}")
    rec = tp_overlap.serving_step_record(cfg, eng._mp_cfg, SLOTS, 1)
    decode_tokens = c["tokens_out"] - len(reqs)
    stats = {
        "quant": quant, "mp": MP, "layout": mp_layout(),
        "kv_bytes_per_token": eng.kv_bytes_per_token(),  # per rank
        "kv_pool_bytes_per_rank": 2 * eng.kv_shard_bytes(),
        "pages_per_rank": eng.pool.num_pages,
        "requests": len(reqs), "tokens_out": c["tokens_out"],
        "wall_s": wall, "tokens_per_s_wall": c["tokens_out"] / wall,
        "decode_dispatches": decode,
        "decode_tokens_per_s": decode_tokens / c["decode_time_s"],
        "ttft_p50_ms": c["ttft_p50"] * 1e3, "ttft_p99_ms": c["ttft_p99"] * 1e3,
        "token_latency_p50_ms": c["token_latency_p50"] * 1e3,
        "decode_dispatch_gather_bytes_per_rank": rec.ag_bytes,
        "decode_dispatch_all_gathers": rec.collectives,
        "mp_wire_bytes_per_rank": c["mp_wire_bytes"],
        "logit_diff_vs_one_card": logit_diff,
    }
    say(f"[{tag}] {json.dumps(stats)}")
    del eng
    torch.cuda.empty_cache()
    return {"stats": stats, "tokens": tokens, "served": served,
            "counts": counts, "shapes": shapes}, failed


def gemm_ag_former(x, w, s, group, buf):
    """Rows 12-13's former route, before their gather kernel: the GEMM
    into this rank's slot of a dim-0 gather buffer ``buf`` [n R, F/n],
    the group's all-gather in place (NCCL's with a card per rank), and
    the relayout copy to [R, F]."""
    R, Fl = x.shape[0], w.shape[1]
    n, r = group.n, group.rank
    slot = buf[r * R:(r + 1) * R]
    qg.gemm_into(x, w, s, slot)
    group.all_gather_into(buf, slot)
    return buf.view(n, R, Fl).transpose(0, 1).reshape(R, n * Fl)


def phase_mp_timing(group, cfg, gen, say):
    """Rows 11-13 at every case. Rows 12-13: the whole call
    (``fused_gemm_ag``; each call on the next of 24 weight shards, as the
    layers are) by ``slowest_rank_ms`` over eager calls and, with a card
    per rank, by CUDA-graph replay; beside it, eagerly, the plain version,
    the former route (``gemm_ag_former``) and the library's (``torch.mm``
    on the shard, int8/fp8 dequantized beforehand, and the group's
    all-gather); the GEMM alone into the slot by replay on rank 0, the
    other ranks waiting. Row 11's whole calls (the row copied into the
    staging, as ``ag_last`` does) beside its plain ring and the library's
    all-gather. NCCL's with a card per rank; on one card gloo's, and the
    whole calls are a path check. Returns {(kind, label, R) | ("bucket",
    R, F): timings}."""
    dev = group.device
    per_card = group.backend == "nccl"
    out = {}
    for kind in MP_WEIGHTS:
        for label, K, Fl, R, x_dtype in mp_gemm_cases(cfg):
            nw = 1 if label == "head" else cfg.num_layers
            ws, ss = _mp_weight(gen, dev, K, Fl, kind, nw)
            x = torch.randn(R, K, generator=gen, device=dev).to(x_dtype)
            buf = torch.empty((MP * R, Fl), dtype=x_dtype, device=dev)
            deq = [w.to(x_dtype) if sc is None else
                   (w.float() * sc).to(x_dtype) for w, sc in zip(ws, ss)]
            layer = itertools.cycle(range(nw))
            t = {}
            if group.rank == 0:
                def gemm():
                    i = next(layer)
                    qg.gemm_into(x, ws[i], ss[i], buf[:R])

                t["gemm_ms"] = min(graph_ms(gemm, iters=4 * nw)
                                   for _ in range(2))

            def call():
                i = next(layer)
                fc.fused_gemm_ag(x, ws[i], group, ss[i])

            def plain():
                i = next(layer)
                fc.gemm_ag_plain(x, ws[i], group, ss[i])

            def former():
                i = next(layer)
                gemm_ag_former(x, ws[i], ss[i], group, buf)

            def library():
                i = next(layer)
                group.all_gather_into(buf, torch.mm(x, deq[i]))

            group.barrier()
            w = slowest_rank_ms(
                group, {"call": call, "plain": plain, "former": former,
                        "library": library},
                ("call", "former", "library", "plain", "call"),
                100 if per_card else 5)
            t.update(call_ms=w["call"], plain_call_ms=w["plain"],
                     former_call_ms=w["former"],
                     library_call_ms=w["library"])
            if per_card:        # an even number of calls a graph
                t["call_graph_ms"] = slowest_rank_ms(
                    group, {"call": call}, ("call", "call"), 2 * nw,
                    graph=True)["call"]
            out[(kind, label, R)] = t
            say(f"[mp-timing] fused_gemm_ag {kind} {label} R={R} K={K} "
                f"F/{MP}={Fl} ({group.backend}"
                f"{'' if per_card else ', a path check'}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + " ms")
            del ws, ss, x, buf, deq
    for R, F in mp_bucket_cases(cfg):
        row = torch.randn(R * F, generator=gen, device=dev).to(
            torch.bfloat16)
        w = slowest_rank_ms(group, {
            "call": lambda: fc.fused_ag_bucket(row, group),
            "plain": lambda: fc.ag_bucket_plain(row, group),
            "library": lambda: fc.all_gather_stack(row, group)},
            ("call", "plain", "library", "call"), 100 if per_card else 5)
        t = {"call_ms": w["call"], "plain_call_ms": w["plain"],
             "library_call_ms": w["library"]}
        out[("bucket", R, F)] = t
        say(f"[mp-timing] fused_ag_bucket {R}x{F} bf16 ({group.backend}"
            f"{'' if per_card else ', a path check'}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + " ms")
    return out


def mp_serve_plan(backend):
    """What phase_mp_serve serves, (dtype, wave-1 requests kept; None: all
    16 requests): bf16, int8 and fp8 on all 16 with a card per rank. When
    the four ranks share one card over gloo, every all-gather waits on the
    other ranks' time slices of the card (~3-6 ms each, 98 a dispatch:
    ~100 s for the 16 requests), so there bf16 serves the first two
    wave-1 requests and wave 2 (its prefix hits and copy-on-write) and
    int8 wave 2, without the profiles."""
    if backend == "nccl":
        return [(q, None) for q in (None,) + QUANT_DTYPES]
    return [(None, 2), ("int8", 0)]


@contextlib.contextmanager
def peer_record(group):
    """A spawned rank's failure prints, before it propagates, the rank's
    peer-buffer error record (rows 7-13; ``peer.error_record``:
    which wait gave up on which peer, and why), or that it has none."""
    try:
        yield
    except BaseException:
        try:
            rec = peer.error_record()
        except Exception as e:      # noqa: BLE001 - a lost context, say
            rec = f"not readable: {e}"
        print(f"[rank {group.rank}] failed; peer error record (rows "
              f"7-13): {rec}", flush=True)
        raise


def mp_rank_main(group, seed):
    """One rank of the tensor-parallel phases (spawned by
    ``distributed.env.launch``): the fused kernels against their plain
    versions, GPT-3 1.3B served at mp=MP at bf16, int8 and fp8, and the
    timings. Rank 0 prints; every rank returns its readings and the
    failures it saw (and a failing rank its rows 10-11 error record)."""
    with peer_record(group):
        return _mp_rank(group, seed)


def _mp_rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # MP processes share the host's cores: one intra-op thread each, so
    # spinning CPU threads do not starve the collectives
    torch.set_num_threads(1)
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \
        (lambda *a: None)
    gen = torch.Generator(device=group.device).manual_seed(seed + 1)
    cfg = GPT_CONFIGS[MODEL]
    errs, failed = phase_mp_gemm_vs_plain(group, gen, seed, cfg, say)
    params = init_gpt_params(cfg, seed=seed, device=group.device,
                             dtype=torch.bfloat16)
    serve = {}
    for quant, wave1 in mp_serve_plan(group.backend):
        serve[quant or "bf16"], f = phase_mp_serve(group, cfg, params, seed,
                                                   quant, gen, say, wave1)
        failed += f
    del params
    torch.cuda.empty_cache()
    timing = phase_mp_timing(group, cfg, gen, say)
    return {"rank": group.rank, "errs": errs, "failed": failed,
            "serve": serve, "timing": timing}


def one_card(served):
    """What phase 9 compares with from a one-card ``phase_serve`` run: the
    tokens of each request and the stats."""
    return {"tokens": [served["results"][r.request_id].tokens
                       for r in served["reqs"]], "stats": served["stats"]}


def phase_mp(seed, single):
    """The tensor-parallel phases in MP spawned ranks (the layout from the
    card count), after the parent has built every kernel. Fails on any
    rank's failure. Prints token agreement and the serving rates against
    the one-card engines of phase_serve on the same requests in this run
    (``single``: dtype -> ``one_card``); returns rank 0's readings."""
    layout = mp_layout()
    count = torch.cuda.device_count()
    print(f"[mp] {MP} ranks, layout {layout}: "
          + ("one rank per card, NCCL" if layout == "per_card" else
             f"all on cuda:0 of {count} card(s), gloo") + "; the four-card "
          "layout times the all-gathers", flush=True)
    t0 = time.perf_counter()
    outs = env.launch(MP, mp_rank_main, seed, layout=layout, timeout_s=900)
    print(f"[mp] the ranks ran in {time.perf_counter() - t0:.1f}s")
    failed = [f"rank {o['rank']}: {f}" for o in outs for f in o["failed"]]
    check(not failed, "tensor-parallel phases failed:\n" + "\n".join(failed))
    r0 = outs[0]
    for dtype, run in r0["serve"].items():
        one = single[dtype]
        same = total = 0
        for a, i in zip(run["tokens"], run["served"]):
            b = one["tokens"][i]
            same += sum(x == y for x, y in zip(a, b))
            total += min(len(a), len(b))
        m, o = run["stats"], one["stats"]
        ratio = ({k: m[k] / o[k] for k in (
            "decode_tokens_per_s", "tokens_per_s_wall", "ttft_p50_ms",
            "ttft_p99_ms", "kv_bytes_per_token")}
            if len(run["served"]) == o["requests"] else
            "not compared: a subset of the requests")
        print(f"[mp-serve-{dtype}] greedy and sampled tokens equal to the "
              f"one-card engine's on {same}/{total} positions of "
              f"{len(run['served'])} requests (not gated: the GEMMs sum in "
              f"another order); mp={MP} over one card: {json.dumps(ratio)}")
    return r0, layout


GEMM_AG_KERNEL = "paddle_tpu_torch/csrc/gemm_ag.cu"


def mp_rows(r0, layout, cfg):
    """The ``kernels`` rows of rows 11-13 from rank 0's readings (row 11:
    the data all-gathers, ``ag_row``). Rows 12-13's row is the whole call:
    with a card per rank its CUDA-graph replay, slowest rank (eager beside
    it), against the GEMM's bound plus the (n - 1) blocks it receives over
    NVLink; on one card (layout "shared") the eager call of four ranks
    time-slicing the card, a path check, against the GEMM's bound."""
    per_card = layout == "per_card"
    rows = []
    errs, timing = r0["errs"], r0["timing"]
    dev = torch.device("cuda", 0)
    for kind in (k for k in MP_WEIGHTS if k in r0["serve"]):
        run = r0["serve"][kind]
        for label, K, Fl, R, x_dtype in mp_gemm_cases(cfg):
            t = timing[(kind, label, R)]
            bound, bound_by = mp_gemm_bound(R, K, Fl, x_dtype, kind)
            if per_card:        # the GEMM's bound + the blocks received
                link = ((MP - 1) * R * Fl * x_dtype.itemsize /
                        NVLINK_BYTES_PER_S * 1e3)
                if link >= bound:
                    bound_by = "bytes"
                bound += link
            w_dtype = "bfloat16" if kind == "bf16" else \
                str(QUANT_TORCH[kind])[6:]
            key = (R, K, Fl, w_dtype)
            replaces = ("paddle_tpu/ops/pallas_kernels/fused_collectives.py:"
                        + ("448" if kind == "bf16" else "498"))
            rows.append({
                "name": f"fused_gemm_ag[{kind} {label} R={R}]",
                "route": "cuda", "source": GEMM_AG_KERNEL,
                "gemm_source": "paddle_tpu_torch/csrc/quant_gemm.cu",
                "replaces": replaces,
                "launches": gemm_ag_launches(
                    {key: run["shapes"]["fused_gemm_ag"].get(key, 0)}, cfg,
                    dev),
                "max_abs_err": errs[(kind, label, R)],
                "ms": t["call_graph_ms"] if per_card else t["call_ms"],
                "eager_ms": t["call_ms"], "gemm_ms": t["gemm_ms"],
                "former_ms": t["former_call_ms"],
                "plain_ms": t["plain_call_ms"], "bound_ms": bound,
                "bound_by": bound_by, "library_ms": t["library_call_ms"],
                "covers": (f"whole call (GEMM + gather), CUDA-graph replay, "
                           f"slowest of {MP} ranks on their own cards; "
                           f"eager, former, plain and library (torch.mm + "
                           f"NCCL all-gather) eager")
                if per_card else
                (f"path check, not a speed: eager whole call with {MP} "
                 f"ranks time-slicing one card; library: torch.mm + gloo's "
                 f"all-gather")})
    bf16 = r0["serve"]["bf16"]["shapes"]["fused_ag_bucket"]
    for R, F in mp_bucket_cases(cfg):
        rows.append(ag_row(f"{R}x{F}={R * F} bf16", timing[("bucket", R, F)],
                           R * F * 2, MP, per_card, bf16.get(R * F, 0),
                           errs[("bucket", R, F)]))
    return rows


# ------------------------------------------- tensor-parallel training (10)
TP_KERNELS = (  # (kernel, wrapper, TPU kernel it replaces)
    ("ring_ag_gemm", rg.ring_ag_gemm,
     "paddle_tpu/ops/pallas_kernels/fused_collectives.py:201"),
    ("ring_gemm_rs", rg.ring_gemm_rs,
     "paddle_tpu/ops/pallas_kernels/fused_collectives.py:249"),
    ("ring_ag_accum", rg.ring_ag_accum,
     "paddle_tpu/ops/pallas_kernels/fused_collectives.py:307"),
)
TP_WRAPPERS = {name: wrapper for name, wrapper, _ in TP_KERNELS}
# launches a call: rows 7 and 9 the pull and the GEMM (every chunk); row
# 8 its GEMM (every chunk) and its reduce
TP_LAUNCHES = {"ring_ag_gemm": 2, "ring_gemm_rs": 2, "ring_ag_accum": 2}
TP_SOURCES = {"ring_ag_gemm": "paddle_tpu_torch/csrc/ag_gemm.cu",
              "ring_gemm_rs": "paddle_tpu_torch/csrc/gemm_rs.cu",
              "ring_ag_accum": "paddle_tpu_torch/csrc/ag_gemm.cu"}
TP_PLAIN = {"ring_ag_gemm": rg.ag_gemm_plain, "ring_gemm_rs": rg.gemm_rs_plain,
            "ring_ag_accum": rg.ag_accum_plain}
TP_PARITY_B = 2             # the 2-layer copy's batch (phase 6's)


def tp_step_calls(L):
    """Calls per step of each ring kernel under the fused rung with remat
    "full" over L layers: ``fused_ag_gemm`` runs qkv and up in the forward
    (2L) and again in the recompute (2L), and its kernel also gives the
    input gradient of ``fused_gemm_rs`` (2L): 6L; ``fused_gemm_rs`` the
    same, out and down (2L + 2L) plus the input gradient of
    ``fused_ag_gemm`` (2L): 6L; the weight-gradient kernel once per fused
    call in the backward: 4L. Each call launches two kernels
    (``TP_LAUNCHES``)."""
    return {"ring_ag_gemm": 6 * L, "ring_gemm_rs": 6 * L,
            "ring_ag_accum": 4 * L}


def tp_cases(cfg):
    """(kernel, label, shapes, flag) of every ring-kernel call on the
    main path at B=TRAIN_B, S=TRAIN_S, one rank of MP: the operands'
    shapes and ``transpose_w`` / ``transpose``. Row 7 runs the qkv and up
    projections (forward) and the out and down input gradients (w read
    transposed); row 8 out and down (forward) and the qkv and up input
    gradients; row 9 the four weight gradients."""
    H = cfg.hidden_size
    inner = cfg.ffn_mult * H
    B, S, n = TRAIN_B, TRAIN_S, MP
    s = S // n
    cols = {"qkv": 3 * H // n, "up": inner // n, "out": H // n,
            "down": inner // n}
    cases = []
    for lab in ("qkv", "up"):
        cases.append(("ring_ag_gemm", lab, ((B, s, H), (H, cols[lab])),
                      False))
    for lab in ("out", "down"):
        cases.append(("ring_ag_gemm", f"{lab} dx", ((B, s, H),
                                                  (cols[lab], H)), True))
    for lab in ("out", "down"):
        cases.append(("ring_gemm_rs", lab, ((B, S, cols[lab]),
                                            (cols[lab], H)), False))
    for lab in ("qkv", "up"):
        cases.append(("ring_gemm_rs", f"{lab} dx", ((B, S, cols[lab]),
                                                   (H, cols[lab])), True))
    for lab in ("qkv", "up"):
        cases.append(("ring_ag_accum", f"{lab} dw", ((B, s, H),
                                                    (B, S, cols[lab])),
                      False))
    for lab in ("out", "down"):
        cases.append(("ring_ag_accum", f"{lab} dw", ((B, s, H),
                                                    (B, S, cols[lab])),
                      True))
    return cases


def tp_shape_key(kernel, shapes, flag):
    """The wrapper's ``.shapes`` key of a case."""
    a, b = shapes
    if kernel == "ring_ag_gemm":
        F_ = b[0] if flag else b[1]
        return (a[0] * a[1], a[2], F_, flag)
    if kernel == "ring_gemm_rs":
        A_ = b[0] if flag else b[1]
        return (a[0] * a[1] // MP, a[2], A_, flag)
    M, N = (b[2], a[2]) if flag else (a[2], b[2])
    return (a[0] * a[1], M, N, flag)


def tp_work(kernel, shapes, flag):
    """(flops, HBM bytes, NVLink bytes received) of one call per rank: the
    products of every ring step; each input read once and each output
    written once; MP - 1 chunks received (fp32 partials for row 8, as
    the TPU kernel's wire)."""
    (a, b), n = shapes, MP
    if kernel == "ring_ag_gemm":
        B, s, A = a
        F_ = b[0] if flag else b[1]
        rows = B * s * n
        return (2 * rows * A * F_, 2 * (rows * A + A * F_ + rows * F_),
                (n - 1) * B * s * A * 2)
    if kernel == "ring_gemm_rs":
        B, S, F_ = a
        A = b[0] if flag else b[1]
        return (2 * B * S * F_ * A, 2 * (B * S * F_ + F_ * A) +
                2 * B * S // n * A, (n - 1) * B * S // n * A * 4)
    B, s, A = a
    Bf = b[2]
    rows = B * s * n
    return (2 * rows * A * Bf, 2 * (rows * A + rows * Bf) + 4 * A * Bf,
            (n - 1) * B * s * A * 2)


def tp_bound(kernel, shapes, flag, per_card):
    """(ms, by): the larger of the operations over the bf16 tensor-core
    peak, the bytes over HBM and, across cards, the received bytes over
    one direction of NVLink."""
    ops, hbm, wire = tp_work(kernel, shapes, flag)
    times = {"operations": ops / BF16_FLOPS, "bytes": hbm / HBM_BYTES_PER_S}
    if per_card:
        times["nvlink bytes"] = wire / NVLINK_BYTES_PER_S
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def _tp_inputs(gen, dev, kernel, shapes, flag):
    a = torch.randn(shapes[0], generator=gen, device=dev)
    b = torch.randn(shapes[1], generator=gen, device=dev)
    if kernel != "ring_ag_accum":
        b = b * shapes[1][1 if flag else 0] ** -0.5      # unit-scale output
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def _tp_call(kernel, wrapper, a, b, flag, group):
    key = "transpose" if kernel == "ring_ag_accum" else "transpose_w"
    return wrapper(a, b, group, **{key: flag})


def phase_tp_kernels(group, gen, seed, cfg, say):
    """Rows 7-9 at every main-path shape of ``tp_cases``: each wrapper
    against its plain version on this rank's own inputs (row 7 with the
    weight the same on every rank, so its gathered output must be the
    same bytes on every rank). Returns ({case: readings}, failures)."""
    dev = group.device
    own = torch.Generator(device=dev).manual_seed(seed + 2000 + group.rank)
    errs, failed = {}, []
    for kernel, label, shapes, flag in tp_cases(cfg):
        wrapper = TP_WRAPPERS[kernel]
        a, b = _tp_inputs(own, dev, kernel, shapes, flag)
        if kernel == "ring_ag_gemm":
            _, b = _tp_inputs(gen, dev, kernel, shapes, flag)
        got = _tp_call(kernel, wrapper, a, b, flag, group)
        want = _tp_call(kernel, TP_PLAIN[kernel], a, b, flag, group)
        torch.cuda.synchronize()
        r = rg.error_vs_plain(got, want)
        ok = bool(torch.isfinite(got).all()) and \
            rg.within_tolerance(r, got.dtype)
        same = _same_on_every_rank(group, got) \
            if kernel == "ring_ag_gemm" else None
        ok = ok and same is not False
        errs[(kernel, label)] = r
        say(f"[tp-kernel] {kernel} {label} {shapes[0]} x {shapes[1]}"
            f"{' (w transposed)' if flag and kernel != 'ring_ag_accum' else ''}"
            f"{' (transposed)' if flag and kernel == 'ring_ag_accum' else ''}"
            f" -> {tuple(got.shape)} {str(got.dtype)[6:]}: max abs "
            f"{r['max_abs']:.2e}, worst element {r['element']:.2e} (gate "
            f"{rg.ELEMENT_TOL[got.dtype]}), worst 128-row tile "
            f"{r['tile']:.2e} (gate {rg.TILE_TOL[got.dtype]})"
            + (f", same bytes on every rank: {same}" if same is not None
               else ""))
        if not ok:
            failed.append(f"{kernel} {label}")
        del a, b, got, want
    return errs, failed


def tp_counts():
    return {name: (w.calls, w.launches) for name, w, _ in TP_KERNELS}


def tp_train_step(cfg, group, params=None, seed=0, rung="fused"):
    opt = AdamW(2e-4, grad_clip=ClipGradByGlobalNorm(1.0),
                moment_dtype="bfloat16")
    return HybridTrainStep(cfg, opt, param_dtype=torch.bfloat16, seed=seed,
                           params=params, group=group, comm_backend=rung)


def phase_tp_train(group, seed, say, num_layers=None,
                   warmup=WARMUP_STEPS, timed=TIMED_STEPS, rung="fused"):
    """GPT-3 1.3B at full width (and depth, unless ``num_layers``) through
    HybridTrainStep(group=, comm_backend=rung): ``warmup`` and ``timed``
    steps on one batch, the main path of phase 10 on the fused rung:
    finite losses, the last below the first, the same on every rank, and
    each ring kernel's calls and launches as ``tp_step_calls`` says (none
    on the rsag rung). Returns (step, ids, readings, failures)."""
    cfg = train_config(num_layers)
    dev = group.device
    t0 = time.perf_counter()
    step = tp_train_step(cfg, group, seed=seed, rung=rung)
    ids = train_ids(cfg, seed, dev)
    torch.cuda.synchronize()
    say(f"[tp-train] {MODEL}, {cfg.num_layers} layers: "
        f"{step.num_params():,} params bf16 over "
        f"mp={group.n} ({group.backend}), AdamW(2e-4, clip 1.0, bf16 "
        f"moments), remat full, ids [{TRAIN_B}, {TRAIN_S}], rung {rung}; "
        f"set up in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats(dev)
    tp_overlap.reset_mp_counters()
    # the main path: counts start at 0 here and are read right after
    rg.reset_counts()
    losses = []
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(ids))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step(ids))
    stop.record()
    losses = [float(x) for x in losses]
    step_s = start.elapsed_time(stop) / 1e3 / timed
    counts = tp_counts()
    shapes = {name: dict(w.shapes) for name, w, _ in TP_KERNELS}
    steps = warmup + timed
    want = {k: (v * steps, v * steps * TP_LAUNCHES[k]) if rung == "fused"
            else (0, 0) for k, v in tp_step_calls(cfg.num_layers).items()}
    failed = []
    if not all(np.isfinite(losses)):
        failed.append(f"a tp train loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"tp loss did not fall: {losses[0]} -> {losses[-1]}")
    every = group.all_gather_list(torch.tensor(losses, device=dev))
    same = all(torch.equal(every[0], o) for o in every)
    if not same:
        failed.append("the ranks' losses differ")
    if counts != want:
        failed.append(f"ring kernel (calls, launches) {counts} != {want}")
    fpt, _ = flops.model_flops_per_token(cfg, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(dev))
    stats = {"step_s": step_s, "tokens_per_s": tokens / step_s,
             "mfu_over_cards": flops.mfu(fpt * tokens, step_s, peak,
                                         cards=group.n),
             "cards": group.n, "layers": cfg.num_layers,
             "layout": group.backend, "warmup_s": warm,
             "first_loss": losses[0],
             "last_loss": losses[-1], "losses": losses,
             "peak_mem_gb_rank": torch.cuda.max_memory_allocated(dev) / 1e9,
             "mp_counters": tp_overlap.mp_counters()}
    say(f"[tp-train] losses {[round(x, 4) for x in losses]} (the same on "
        f"every rank: {same})")
    say(f"[tp-train] (calls, launches) over {steps} steps: {counts} (want "
        f"{want}: per step {tp_step_calls(cfg.num_layers)} calls of "
        f"{TP_LAUNCHES} launches each)")
    say(f"[tp-train] {json.dumps(stats)}")
    return step, ids, {"stats": stats, "counts": counts,
                       "shapes": shapes}, failed


def phase_tp_profile(group, step, ids, say, tag="tp-profile"):
    """Where a tensor- or pipeline-parallel step's time goes on rank 0:
    torch.profiler (device kernels) over one step, grouped by kind. Every
    rank runs the step; rank 0 traces it. The ranks start it together once
    rank 0's profiler is on (a dp step's rows 10-11 would otherwise wait
    in their 10 s barrier while the profiler starts)."""
    step(ids)
    torch.cuda.synchronize()
    if group.rank != 0:
        group.barrier()
        step(ids)
        torch.cuda.synchronize()
        return None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        group.barrier()
        t0 = time.perf_counter()
        float(step(ids))
        traced = time.perf_counter() - t0

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    events = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e3
    kinds = {"rows 7, 9 (ag_gemm pull + GEMM)": ("ag_gemm",),
             "row 8 (gemm_rs GEMM + reduce)": ("gemm_rs",),
             "boundary kernels (rows 14-15)": ("pp_gemm", "pp_add"),
             "row 10 (rs_pull_kernel)": ("rs_pull_kernel",),
             "row 11 (ag_pull_kernel)": ("ag_pull_kernel",),
             "NCCL": ("nccl",), "flash kernels": ("flash_",),
             "cuBLAS GEMMs": ("gemm", "nvjet", "cutlass", "sm90_xmma",
                              "Kernel2"),
             "reductions": ("reduce",),
             "elementwise": ("elementwise", "vectorized", "unrolled"),
             "copies": ("copy", "Memcpy", "cat")}
    by_kind = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for e in events:
        kind = next((k for k, pats in kinds.items()
                     if any(p in e.key for p in pats)), "other")
        by_kind[kind] += dev_us(e) / 1e3
    say(f"[{tag}] rank 0, one step: {traced * 1e3:.1f} ms host wall "
        f"traced; device busy {busy:.1f} ms = {busy / (traced * 1e3):.1%}"
        f" (NCCL kernels count while they wait for the peers)")
    say(f"[{tag}] device ms by kind: "
        f"{json.dumps({k: round(v, 3) for k, v in by_kind.items()})}")
    for e in events[:12]:
        say(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} calls  "
            f"{e.key[:90]}")
    return {"traced_ms": traced * 1e3, "busy_ms": busy, "by_kind": by_kind,
            "kernels": {e.key: e.count for e in events}}


def phase_tp_parity(group, seed, say):
    """One fused step of a 2-layer copy at full width (B=2, S=2048) against
    the one-card step on the same weights and ids (every rank computes
    it): the loss and every gradient leaf, sharded leaves compared over
    all ranks' shards, within phase 6's tolerances. Returns failures."""
    cfg = train_config(num_layers=2)
    dev = group.device
    params = init_gpt_params(cfg, seed=seed + 1, device=dev,
                             dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (TP_PARITY_B, TRAIN_S),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 4), device=dev)
    step = tp_train_step(cfg, group, params=params)
    loss, grads = step.loss_and_grads(ids)
    loss = float(loss)
    flat = {n: t.detach().clone().requires_grad_(True)
            for n, t in flatten_params(params).items()}
    ref_loss = gpt_loss(unflatten_params(flat), ids, cfg)
    ref = dict(zip(flat, torch.autograd.grad(ref_loss, list(flat.values()))))
    ref_loss = float(ref_loss.detach())
    ref = unflatten_params(ref)
    ref["blocks"] = tp_overlap.to_qkv_head_major(
        ref["blocks"], cfg.hidden_size, cfg.num_heads)
    ref = flatten_params(shard_params(ref, group.rank, group.n))
    names = sorted(grads)
    sq = torch.stack([torch.stack([(grads[n].float() - ref[n].float())
                                   .square().sum(),
                                   ref[n].float().square().sum()])
                      for n in names])
    sharded = torch.tensor([n not in step._replicated for n in names],
                           device=dev)
    total = group.all_reduce_(torch.where(sharded[:, None], sq, 0.0))
    sq = torch.where(sharded[:, None], total, sq)
    rel = {n: float(sq[i, 0].sqrt() / sq[i, 1].sqrt().clamp(min=1e-30))
           for i, n in enumerate(names)}
    worst = max(rel, key=rel.get)
    say(f"[tp-parity] 2-layer {MODEL} width, B={TP_PARITY_B} S={TRAIN_S} "
        f"bf16, mp={group.n} fused: loss {loss:.6f} vs the one-card step "
        f"{ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}); gradient "
        f"leaves over all shards: max ||dg||/||g|| {rel[worst]:.3e} "
        f"({worst}), median {sorted(rel.values())[len(rel) // 2]:.3e} "
        f"(gates: loss {PARITY_LOSS_REL} rel, leaves {PARITY_GRAD_REL})")
    failed = []
    if not (np.isfinite(loss) and
            abs(loss - ref_loss) <= PARITY_LOSS_REL * abs(ref_loss)):
        failed.append(f"tp loss {loss} vs one-card {ref_loss}")
    bad = {n: v for n, v in rel.items()
           if not (np.isfinite(v) and v <= PARITY_GRAD_REL)}
    if bad:
        failed.append(f"tp gradient leaves off the one-card step: {bad}")
    return failed


def phase_tp_timing(group, gen, cfg, say):
    """Each ring kernel at every main-path shape, per rank. With a card per
    rank: the whole wrapper call (rows 7 and 9: the pull over the peers'
    slots and the GEMM; row 8: its GEMM, whose epilogue stores into the
    peers' slots, and its reduce) by CUDA events over eager calls on every
    rank, the slowest rank's, its plain version, and the library yardstick (row
    7: ``all_gather_into_tensor`` + ``torch.mm``; row 8: ``torch.mm`` +
    ``reduce_scatter_tensor``; row 9: the gathered ``torch.mm(r^T,
    stat)``); and each call's GEMMs alone (``tp_gemm_only``) on rank 0.
    With the ranks sharing one card: the GEMMs alone on rank 0, and row
    8's whole call on every rank as a path check (four ranks time-slicing
    the card). Returns {(kernel, label):
    timings}."""
    dev = group.device
    per_card = group.backend == "nccl"
    out = {}
    for kernel, label, shapes, flag in tp_cases(cfg):
        wrapper = TP_WRAPPERS[kernel]
        a, b = _tp_inputs(gen, dev, kernel, shapes, flag)
        t = {}
        if per_card:
            def run(fn, iters):
                group.barrier()
                return cuda_ms(fn, iters=iters, warmup=2)

            bb = b.t() if flag and kernel != "ring_ag_accum" else b
            if kernel == "ring_ag_gemm":
                buf = a.new_empty((MP * a.shape[0] * a.shape[1], a.shape[2]))

                def library():
                    group.all_gather_into(buf, a.reshape(-1, a.shape[2]))
                    torch.mm(buf, bb)
            elif kernel == "ring_gemm_rs":
                red = a.new_empty((a.shape[0] * a.shape[1] // MP,
                                   bb.shape[1]))

                def library():
                    group.reduce_scatter_into(
                        red, torch.mm(a.reshape(-1, a.shape[2]), bb))
            else:
                buf = a.new_empty((MP * a.shape[0] * a.shape[1], a.shape[2]))

                def library():
                    group.all_gather_into(buf, a.reshape(-1, a.shape[2]))
                    torch.mm(buf.t(), b.reshape(-1, b.shape[2]))

            calls = {"kernel": lambda: _tp_call(kernel, wrapper, a, b, flag,
                                                group),
                     "plain": lambda: _tp_call(kernel, TP_PLAIN[kernel], a, b,
                                               flag, group),
                     "library": library}
            k1 = slowest_rank_ms(group, calls, ("kernel",), 10)["kernel"]
            p1 = slowest_rank_ms(group, calls, ("plain",), 3)["plain"]
            lib = slowest_rank_ms(group, calls, ("library",), 10)["library"]
            k2 = slowest_rank_ms(group, calls, ("kernel",), 10)["kernel"]
            t.update(ms=min(k1, k2), ms_runs=(k1, k2), plain_ms=p1,
                     library_ms=lib,
                     covers=("whole call: the GEMM storing into the peers' "
                             "slots + the reduce, slowest rank"
                             if kernel == "ring_gemm_rs" else
                             "whole call: the pull over the peers' slots + "
                             "the GEMM, slowest rank"))
            if group.rank == 0:
                t["gemm_only"] = tp_gemm_only(kernel, a, b, flag)
        else:
            if group.rank == 0:
                t.update(tp_gemm_only(kernel, a, b, flag))
            if kernel == "ring_gemm_rs":
                t["call_ms_shared"] = slowest_rank_ms(
                    group, {"call": lambda: _tp_call(kernel, wrapper, a, b,
                                                     flag, group)},
                    ("call",), 3)["call"]
        group.barrier()
        out[(kernel, label)] = t
        if group.rank == 0:
            say(f"[tp-timing] {kernel} {label}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in t.items()) + " ms")
        del a, b
    return out


def tp_gemm_only(kernel, a, b, flag):
    """One rank's GEMMs of a call without the transfer, by CUDA-graph
    replay: the kernel's GEMM of every chunk in one launch from local
    memory (``ag_gemm_local``, ``gemm_rs_local``, ``ag_accum_local``:
    every rank's chunk taken as this rank's), against MP chunk products of
    the plain version and of torch.mm. ``tflops``: the kernel's rate."""
    n = MP
    if kernel == "ring_ag_gemm":
        B, s, A = a.shape
        xs = a.expand(n, *a.shape).contiguous()

        def kern():
            rg.ag_gemm_local(xs, b, 0, flag)
        x2, w2 = a.reshape(-1, A), (b.t() if flag else b)
    elif kernel == "ring_gemm_rs":
        B, S, F_ = a.shape
        s = S // n

        def kern():
            rg.gemm_rs_local(a, b, n, 0, flag)
        x2, w2 = a[:, :s].reshape(-1, F_), (b.t() if flag else b)
    else:
        B, s, A = a.shape
        Bf = b.shape[2]
        rs = a.expand(n, *a.shape).contiguous()

        def kern():
            rg.ag_accum_local(rs, b, 0, flag)
        r2, s2 = a.reshape(-1, A), b[:, :s].reshape(-1, Bf)
        x2, w2 = (s2.t(), r2) if flag else (r2.t(), s2)
    k1 = graph_ms(kern, iters=8)
    p = graph_ms(lambda: x2.float() @ w2.float(), iters=2, replays=2)
    lib = graph_ms(lambda: torch.mm(x2, w2), iters=8)
    k2 = graph_ms(kern, iters=8)
    ms = min(k1, k2)
    return {"ms": ms, "ms_runs": (k1, k2), "plain_ms": n * p,
            "library_ms": n * lib,
            "tflops": n * 2 * x2.shape[0] * x2.shape[1] * w2.shape[1] / ms
            / 1e9, "covers": "the call's GEMM of every chunk, one launch, "
                             "no peers"}


def tp_rank_main(group, seed):
    """One rank of phase 10 (spawned by ``distributed.env.launch``): the
    ring kernels against their plain versions, the main path (GPT-3 1.3B
    at full depth with a card per rank; 2 layers on one card), the
    profile (a card per rank), the 2-layer parity and the timings. Rank 0
    prints; every rank returns its readings and failures (a failing rank
    its peer error record: row 8 runs over the peer buffers)."""
    with peer_record(group):
        return _tp_rank(group, seed)


def _tp_rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \
        (lambda *a: None)
    gen = torch.Generator(device=group.device).manual_seed(seed + 5)
    cfg = GPT_CONFIGS[MODEL]
    errs, failed = phase_tp_kernels(group, gen, seed, cfg, say)
    out = {"rank": group.rank, "errs": errs}
    per_card = group.backend == "nccl"
    # the main path: full depth with a card per rank; on one card, where
    # every hop goes through host memory, 2 layers and 1 + 2 steps
    step, ids, out["train"], f = phase_tp_train(
        group, seed, say, *(() if per_card else (2, 1, 2)))
    failed += f
    if per_card:
        out["profile"] = phase_tp_profile(group, step, ids, say)
    del step, ids
    torch.cuda.empty_cache()
    if per_card:
        # the rsag rung at full depth from the same weights and ids: is
        # the full-depth gap to one card (PERF.md, PR 5) bf16 noise?
        rsag, _, out["train_rsag"], f = phase_tp_train(group, seed, say,
                                                       rung="rsag")
        failed += f
        del rsag
        torch.cuda.empty_cache()
        a = out["train"]["stats"]
        b = out["train_rsag"]["stats"]
        diff = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
        say(f"[tp-train] fused vs rsag from the same weights and ids: "
            f"losses {a['losses']} vs {b['losses']}, max |diff| "
            f"{diff:.4f}")
    failed += phase_tp_parity(group, seed, say)
    torch.cuda.empty_cache()
    out["timing"] = phase_tp_timing(group, gen, cfg, say)
    out["failed"] = failed
    return out


def phase_tp(seed):
    """Phase 10 in MP spawned ranks (the layout from the card count), after
    the parent has built every kernel. Fails on any rank's failure;
    returns rank 0's readings and the layout."""
    layout = mp_layout()
    print(f"[tp] {MP} ranks, layout {layout}: "
          + ("one rank per card, NCCL" if layout == "per_card" else
             f"all on cuda:0 of {torch.cuda.device_count()} card(s), gloo")
          + "; GPT-3 1.3B trained at mp=4 through the ring kernels",
          flush=True)
    t0 = time.perf_counter()
    outs = env.launch(MP, tp_rank_main, seed, layout=layout, timeout_s=900)
    print(f"[tp] the ranks ran in {time.perf_counter() - t0:.1f}s")
    failed = [f"rank {o['rank']}: {f}" for o in outs for f in o["failed"]]
    check(not failed, "tensor-parallel training failed:\n" +
          "\n".join(failed))
    return outs[0], layout


def tp_rows(r0, layout, cfg):
    """The ``kernels`` rows of rows 7-9, one per main-path shape, from rank
    0's readings: launches from the main path's run at that shape (calls
    times ``TP_LAUNCHES``: the pull and the GEMM for rows 7 and 9, the GEMM
    and the reduce for row 8; on one card the 2-layer run); ms, plain and
    library as ``phase_tp_timing`` took them (``covers`` says what)."""
    per_card = layout == "per_card"
    rows = []
    replaces = {k: r for k, _, r in TP_KERNELS}
    for kernel, label, shapes, flag in tp_cases(cfg):
        t = r0["timing"][(kernel, label)]
        bound, by = tp_bound(kernel, shapes, flag, per_card)
        calls = r0["train"]["shapes"][kernel].get(
            tp_shape_key(kernel, shapes, flag), 0)
        rows.append({
            "name": f"{kernel}[{label}]", "route": "cuda",
            "source": TP_SOURCES[kernel],
            "replaces": replaces[kernel],
            "launches": calls * TP_LAUNCHES[kernel],
            "max_abs_err": r0["errs"][(kernel, label)]["max_abs"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": t["library_ms"],
            "covers": t["covers"],
            **{k: t[k] for k in ("gemm_only", "call_ms_shared", "tflops")
               if k in t}})
    return rows


# ------------------------------------------ pipeline-parallel training (11)
PP = 4                      # pipeline stages of phase 11
PP_M = 8                    # microbatches (tools_mfu_sweep.py:244)
PP_PARITY_LAYERS, PP_PARITY_B, PP_PARITY_M = 4, 2, 2
PP_KERNELS = (  # (kernel, wrapper, TPU kernel it replaces)
    ("gemm_ppsend", ppb.gemm_ppsend,
     "paddle_tpu/ops/pallas_kernels/fused_collectives.py:792"),
    ("gemm_pprecv", ppb.gemm_pprecv,
     "paddle_tpu/ops/pallas_kernels/fused_collectives.py:826"),
)
# (name, comm_backend, pp_schedule); the fused rung is the main path
PP_RUNGS = (("fused", "pp=fused", "gpipe"),
            ("ring-gpipe", "pp=ring", "gpipe"),
            ("ring-1f1b", "pp=ring", "1f1b"))


def pp_shapes(cfg):
    """(R, K, F) of rows 14-15 on the main path: a microbatch's rows
    (TRAIN_B / PP_M sequences of TRAIN_S), the FFN width, the hidden
    width."""
    return TRAIN_B // PP_M * TRAIN_S, cfg.ffn_mult * cfg.hidden_size, \
        cfg.hidden_size


def pp_bound(kernel, R, K, F, per_card):
    """(ms, by) of one call: the larger of the operations over the bf16
    peak, the HBM bytes (each input read once, each output written once)
    and, across cards, the hop's bytes over one direction of NVLink. Row
    14 reads x, w, b, r and writes y; row 15 reads gy, gwire, x, w and
    writes dr, dx (bf16), dw (fp32) and db."""
    if kernel == "gemm_ppsend":
        ops = 2 * R * K * F
        hbm = 2 * (R * K + K * F + F + 2 * R * F)
    else:
        ops = 4 * R * K * F
        hbm = 2 * (2 * R * F + R * K + K * F) + 2 * (R * F + R * K + F) + \
            4 * K * F
    times = {"operations": ops / BF16_FLOPS, "bytes": hbm / HBM_BYTES_PER_S}
    if per_card:
        times["nvlink bytes"] = 2 * R * F / NVLINK_BYTES_PER_S
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def _pp_operands(gen, dev, R, K, F):
    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)
    return {"x": rand(R, K), "w": rand(K, F, scale=K ** -0.5),
            "b": rand(F), "r": rand(R, F), "gy": rand(R, F),
            "gw": rand(R, F)}


def phase_pp_kernels(group, seed, cfg, say):
    """Rows 14-15 at the main path's shapes, each rank with its own
    operands: y, dx (bf16) and dw (fp32) against the plain versions per
    element and per 128-row tile, dr and db bit for bit, row 15's
    products launched alone (``pprecv_gemms``, as the timings run them)
    bit for bit those of the call, and the boundary op's hop: rank r's y
    arrives on rank r + 1 byte for byte. Returns ({output: readings},
    failures)."""
    dev = group.device
    R, K, F = pp_shapes(cfg)
    own = torch.Generator(device=dev).manual_seed(seed + 3000 + group.rank)
    o = _pp_operands(own, dev, R, K, F)
    y = ppb.gemm_ppsend(o["x"], o["w"], o["b"], o["r"])
    dx, dw, db, dr = ppb.gemm_pprecv(o["gy"], o["gw"], o["x"], o["w"])
    pdx, pdw, pdb, pdr = ppb.gemm_pprecv_plain(o["gy"], o["gw"], o["x"],
                                               o["w"])
    yp = ppb.gemm_ppsend_plain(o["x"], o["w"], o["b"], o["r"])
    torch.cuda.synchronize()
    errs, failed = {}, []
    for name, got, want in (("y", y, yp), ("dx", dx, pdx), ("dw", dw, pdw)):
        r = ppb.error_vs_plain(got, want)
        ok = bool(torch.isfinite(got).all()) and got.dtype == want.dtype \
            and ppb.within_tolerance(r, got.dtype)
        errs[name] = r
        say(f"[pp-kernel] {name} {tuple(got.shape)} {str(got.dtype)[6:]}: "
            f"max abs {r['max_abs']:.2e}, worst element {r['element']:.2e} "
            f"(gate {ppb.ELEMENT_TOL[got.dtype]}), worst 128-row tile "
            f"{r['tile']:.2e} (gate {ppb.TILE_TOL[got.dtype]})")
        if not ok:
            failed.append(f"pp kernel {name}")
    same = torch.equal(dr, pdr) and torch.equal(db, pdb)
    say(f"[pp-kernel] dr and db bit for bit: {same}")
    if not same:
        failed.append("pp kernel dr/db")
    # row 15's products alone (the timing's launches): the same bits
    apart = torch.equal(ppb.pprecv_gemms(dr, o["x"], o["w"], ("dx",))[0],
                        dx) and \
        torch.equal(ppb.pprecv_gemms(dr, o["x"], o["w"], ("dw",))[1], dw)
    say(f"[pp-kernel] dx and dw alone as in the call, bit for bit: {apart}")
    if not apart:
        failed.append("pp kernel products apart")
    # the hop: y to the next rank through the boundary op
    pending = []
    if group.rank < group.n - 1:
        ppb.fused_gemm_ppsend(o["x"], o["w"], o["b"], o["r"], group,
                              pending.append)
    got = group.stage_hops_async(recv_prev=((R, F), torch.bfloat16)).wait()[
        0] if group.rank > 0 else None
    for h in pending:
        h.wait()
    sent = group.all_gather_list(y)
    arrived = got is None or torch.equal(
        got.view(torch.uint8), sent[group.rank - 1].view(torch.uint8))
    every = group.all_gather_list(torch.tensor([int(arrived)], device=dev))
    arrived = all(int(t) == 1 for t in every)
    say(f"[pp-kernel] y arrives on the next rank byte for byte: {arrived}")
    if not arrived:
        failed.append("pp hop bytes")
    return errs, failed


def pp_counts():
    return {name: (w.calls, w.launches) for name, w, _ in PP_KERNELS}


def pp_train_step(cfg, group, comm_backend, schedule, params=None, seed=0,
                  microbatches=PP_M):
    opt = AdamW(2e-4, grad_clip=ClipGradByGlobalNorm(1.0),
                moment_dtype="bfloat16")
    return HybridTrainStep(dataclasses.replace(cfg, pp_schedule=schedule),
                           opt, param_dtype=torch.bfloat16, seed=seed,
                           params=params, pp_group=group,
                           num_microbatches=microbatches,
                           comm_backend=comm_backend)


def pp_step_calls(rung, stage, n, M):
    """Row 14 and 15 calls per step on ``stage``: once per microbatch on
    every stage that sends (all but the last) on the fused rung; none on
    the ring rung. Row 14 launches one kernel a call, row 15 two (the
    add, then one GEMM launch of dx's and dw's tiles)."""
    calls = M if rung == "fused" and stage < n - 1 else 0
    return {"gemm_ppsend": (calls, calls),
            "gemm_pprecv": (calls, 2 * calls)}


def phase_pp_train(group, seed, say, rung, comm_backend, schedule,
                   num_layers=None, warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """GPT-3 1.3B at full width (and depth, unless ``num_layers``) through
    HybridTrainStep(pp_group=, num_microbatches=PP_M, comm_backend=) on
    one rung: ``warmup`` and ``timed`` steps on one batch. Gates: finite
    losses, the last below the first, the same on every rank, and rows
    14-15's calls and launches as ``pp_step_calls`` says. Returns (step,
    ids, readings, failures)."""
    cfg = train_config(num_layers)
    dev = group.device
    t0 = time.perf_counter()
    step = pp_train_step(cfg, group, comm_backend, schedule, seed=seed)
    ids = train_ids(cfg, seed, dev)
    torch.cuda.synchronize()
    say(f"[pp-train {rung}] {MODEL}, {cfg.num_layers} layers "
        f"({cfg.num_layers // group.n} a stage): {step.num_params():,} "
        f"params bf16 over pp={group.n} ({group.backend}), M={PP_M}, "
        f"schedule {step._ppc.schedule}, AdamW(2e-4, clip 1.0, bf16 "
        f"moments), remat full, ids [{TRAIN_B}, {TRAIN_S}]; set up in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats(dev)
    pl.reset_pp_counters()
    # the main path: counts start at 0 here and are read right after
    ppb.reset_counts()
    losses = []
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(ids))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step(ids))
    stop.record()
    losses = [float(x) for x in losses]
    step_s = start.elapsed_time(stop) / 1e3 / timed
    counts = pp_counts()
    steps = warmup + timed
    want = {k: (c * steps, n * steps) for k, (c, n) in pp_step_calls(
        rung, group.rank, group.n, PP_M).items()}
    failed = []
    if not all(np.isfinite(losses)):
        failed.append(f"a pp train loss is not finite ({rung}): {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"pp loss did not fall ({rung}): {losses[0]} -> "
                      f"{losses[-1]}")
    every = group.all_gather_list(torch.tensor(losses, device=dev))
    same = all(torch.equal(every[0], o) for o in every)
    if not same:
        failed.append(f"the ranks' losses differ ({rung})")
    if counts != want:
        failed.append(f"rank {group.rank} {rung}: rows 14-15 (calls, "
                      f"launches) {counts} != {want}")
    per_rank = group.all_gather_list(torch.tensor(
        [step_s, torch.cuda.max_memory_allocated(dev) / 1e9,
         pl.pp_counters()["boundary_bytes"] / steps], device=dev,
        dtype=torch.float64))
    step_max = max(float(t[0]) for t in per_rank)
    fpt, _ = flops.model_flops_per_token(cfg, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(dev))
    sched = step._ppc.schedule
    stats = {"rung": rung, "schedule": sched, "step_s": step_max,
             "step_s_by_rank": [float(t[0]) for t in per_rank],
             "tokens_per_s": tokens / step_max,
             "mfu_over_cards": flops.mfu(fpt * tokens, step_max, peak,
                                         cards=group.n),
             "bubble_fraction": pl.bubble_fraction(sched, group.n, PP_M),
             "cards": group.n, "layers": cfg.num_layers,
             "microbatches": PP_M, "layout": group.backend,
             "warmup_s": warm, "losses": losses,
             "peak_mem_gb_by_rank": [float(t[1]) for t in per_rank],
             "boundary_bytes_per_step_by_rank": [int(t[2])
                                                 for t in per_rank]}
    say(f"[pp-train {rung}] losses {[round(x, 4) for x in losses]} (the "
        f"same on every rank: {same})")
    say(f"[pp-train {rung}] rank 0 rows 14-15 (calls, launches) over "
        f"{steps} steps: {counts} (want {want})")
    say(f"[pp-train {rung}] {json.dumps(stats)}")
    return step, ids, {"stats": stats, "counts": counts}, failed


def phase_pp_parity(group, seed, say):
    """One fused step of a PP_PARITY_LAYERS-layer copy at full width
    (B=PP_PARITY_B, S=2048, one layer a stage) against the one-card step
    on the same weights and ids, every rank computing the one-card step
    and comparing its own stage's leaves: the loss and every gradient leaf
    within phase 6's tolerances. Returns failures."""
    cfg = train_config(num_layers=PP_PARITY_LAYERS)
    dev = group.device
    params = init_gpt_params(cfg, seed=seed + 1, device=dev,
                             dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (PP_PARITY_B, TRAIN_S),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 4), device=dev)
    step = pp_train_step(cfg, group, "pp=fused", "gpipe", params=params,
                         microbatches=PP_PARITY_M)
    loss, grads = step.loss_and_grads(ids)
    loss = float(loss)
    flat = {n: t.detach().clone().requires_grad_(True)
            for n, t in flatten_params(params).items()}
    ref_loss = gpt_loss(unflatten_params(flat), ids, cfg)
    ref = dict(zip(flat, torch.autograd.grad(ref_loss, list(flat.values()))))
    ref_loss = float(ref_loss.detach())
    ref = flatten_params(stage_params(unflatten_params(ref), group.rank,
                                      group.n))
    rel = {n: float((grads[n].float() - ref[n].float()).norm() /
                    ref[n].float().norm().clamp(min=1e-30)) for n in grads}
    every = group.all_gather_list(torch.tensor(
        [max(rel.values())], device=dev, dtype=torch.float64))
    worst = max(rel, key=rel.get)
    say(f"[pp-parity] {PP_PARITY_LAYERS}-layer {MODEL} width, "
        f"B={PP_PARITY_B} S={TRAIN_S} bf16, pp={group.n} fused, "
        f"M={PP_PARITY_M}: loss {loss:.6f} vs the one-card step "
        f"{ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}); gradient "
        f"leaves: worst ||dg||/||g|| by rank "
        f"{[round(float(t[0]), 5) for t in every]} (rank 0: {worst}) "
        f"(gates: loss {PARITY_LOSS_REL} rel, leaves {PARITY_GRAD_REL})")
    failed = []
    if not (np.isfinite(loss) and
            abs(loss - ref_loss) <= PARITY_LOSS_REL * abs(ref_loss)):
        failed.append(f"pp loss {loss} vs one-card {ref_loss}")
    bad = {n: v for n, v in rel.items()
           if not (np.isfinite(v) and v <= PARITY_GRAD_REL)}
    if bad:
        failed.append(f"pp gradient leaves off the one-card step: {bad}")
    return failed


def phase_pp_timing(group, seed, cfg, say):
    """Rows 14-15 at the main path's shapes. On rank 0, by CUDA-graph
    replay: the kernels alone (row 15 with db's sum), the plain versions,
    and the library calls (row 14: ``torch.addmm`` + add; row 15: add + two
    ``torch.mm``), and row 15's products apart (``pp_products``). With a
    card per rank, on every rank by CUDA events over
    eager calls, the slowest rank reported: each with its hop as a
    pipeline posts it (row 14: y to the next stage, its input from the
    previous one; row 15: a cotangent from the next stage, one to the
    previous one), and the hop alone. Returns {kernel: timings}."""
    dev = group.device
    per_card = group.backend == "nccl"
    R, K, F = pp_shapes(cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 4000 + group.rank)
    o = _pp_operands(g, dev, R, K, F)
    x, w, b, r, gy, gw = (o[k] for k in ("x", "w", "b", "r", "gy", "gw"))
    spec = ((R, F), torch.bfloat16)
    s, n = group.rank, group.n
    row14 = {"kernel": lambda: ppb.gemm_ppsend(x, w, b, r),
             "plain": lambda: ppb.gemm_ppsend_plain(x, w, b, r),
             "library": lambda: torch.addmm(b, x, w) + r}
    row15 = {"kernel": lambda: ppb.gemm_pprecv(gy, gw, x, w),
             "plain": lambda: ppb.gemm_pprecv_plain(gy, gw, x, w),
             "library": lambda: (torch.mm(gy + gw, w.t()),
                                 torch.mm(x.t(), gy + gw))}
    out = {"gemm_ppsend": {}, "gemm_pprecv": {}}
    if s == 0:
        for name, fns in (("gemm_ppsend", row14), ("gemm_pprecv", row15)):
            t = out[name]
            k1 = graph_ms(fns["kernel"], iters=8)
            t["plain_alone_ms"] = graph_ms(fns["plain"], iters=8)
            t["library_alone_ms"] = graph_ms(fns["library"], iters=8)
            k2 = graph_ms(fns["kernel"], iters=8)
            t["kernel_alone_ms"] = min(k1, k2)
            t["kernel_alone_runs"] = (k1, k2)
            t["tflops"] = (2 if name == "gemm_ppsend" else 4) * R * K * F \
                / t["kernel_alone_ms"] / 1e9
        out["gemm_pprecv"]["products"] = pp_products(gy, gw, x, w, say)
    group.barrier()
    if per_card:
        def fwd_hop(y):
            return group.stage_hops_async(
                send_next=y if s < n - 1 else None,
                recv_prev=spec if s > 0 else None).wait()

        def bwd_hop():
            got = group.stage_hops_async(
                send_prev=gy if s > 0 else None,
                recv_next=spec if s < n - 1 else None).wait()[1]
            return gw if got is None else got

        calls = {
            "gemm_ppsend": {
                "kernel": lambda: fwd_hop(row14["kernel"]()),
                "plain": lambda: fwd_hop(row14["plain"]()),
                "library": lambda: fwd_hop(row14["library"]())},
            "gemm_pprecv": {
                "kernel": lambda: ppb.gemm_pprecv(gy, bwd_hop(), x, w),
                "plain": lambda: ppb.gemm_pprecv_plain(gy, bwd_hop(), x, w),
                "library": lambda: (lambda d: (torch.mm(d, w.t()),
                                               torch.mm(x.t(), d)))(
                                                   gy + bwd_hop())}}
        group.barrier()
        hop = cuda_ms(lambda: fwd_hop(r), iters=10, warmup=2)
        for name, fns in calls.items():
            mine = {}
            for what in ("kernel", "plain", "library", "kernel"):
                group.barrier()
                v = cuda_ms(fns[what], iters=10, warmup=2)
                mine[what] = min(v, mine.get(what, v))
            every = group.all_gather_list(torch.tensor(
                [mine["kernel"], mine["plain"], mine["library"], hop],
                device=dev, dtype=torch.float64))
            worst = [max(float(t[i]) for t in every) for i in range(4)]
            out[name].update(call_ms=worst[0], plain_call_ms=worst[1],
                             library_call_ms=worst[2], hop_ms=worst[3])
    if s == 0:
        for name, t in out.items():
            say(f"[pp-timing] {name} R={R} K={K} F={F}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in t.items() if k != "products") + " ms")
    return out


def pp_products(gy, gw, x, w, say):
    """Row 15's GEMM launch alone (``pprecv_gemms`` on dr = gy + gw), by
    CUDA-graph replay as ``tp_gemm_only`` times rows 7-9's GEMMs: dx and
    dw apart and both in one launch (the main path's), each against
    ``torch.mm`` of the same products. ``tflops``: the kernel's rate.
    Returns {products: timings}."""
    dr = gy + gw
    R, K = x.shape
    F = dr.shape[-1]
    out = {}
    for name, products, library in (
            ("dx", ("dx",), lambda: torch.mm(dr, w.t())),
            ("dw", ("dw",), lambda: torch.mm(x.t(), dr)),
            ("dx+dw", ("dx", "dw"), lambda: (torch.mm(dr, w.t()),
                                             torch.mm(x.t(), dr)))):
        def kern(products=products):
            ppb.pprecv_gemms(dr, x, w, products)
        k1 = graph_ms(kern, iters=8)
        lib = graph_ms(library, iters=8)
        k2 = graph_ms(kern, iters=8)
        ms = min(k1, k2)
        out[name] = {"ms": ms, "ms_runs": (k1, k2), "library_ms": lib,
                     "tflops": 2 * R * K * F * len(products) / ms / 1e9}
        say(f"[pp-timing] gemm_pprecv's GEMM, {name} alone: {ms:.4f} ms "
            f"({k1:.4f}, {k2:.4f}) = {out[name]['tflops']:.1f} TFLOP/s, "
            f"torch.mm {lib:.4f} ms")
    return out


def pp_rank_main(group, seed):
    """One rank (stage) of phase 11 (spawned by ``distributed.env.launch``):
    the boundary kernels against their plain versions, the main path on
    the fused rung and the two ring rungs (GPT-3 1.3B at full depth with a
    card per rank, and a profile of one fused step; 4 layers, 1 + 2 steps
    on one card), the parity copy and the timings. Rank 0 prints; every
    rank returns its readings and failures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \
        (lambda *a: None)
    group.barrier()           # the group's first collective: every rank
    cfg = GPT_CONFIGS[MODEL]
    errs, failed = phase_pp_kernels(group, seed, cfg, say)
    out = {"rank": group.rank, "errs": errs, "train": {}}
    per_card = group.backend == "nccl"
    depth = () if per_card else (PP, 1, 2)
    for rung, comm_backend, schedule in PP_RUNGS:
        step, ids, out["train"][rung], f = phase_pp_train(
            group, seed, say, rung, comm_backend, schedule, *depth)
        failed += f
        if per_card and rung == "fused":
            out["profile"] = phase_tp_profile(group, step, ids, say,
                                              tag="pp-profile")
        del step, ids
        torch.cuda.empty_cache()
    failed += phase_pp_parity(group, seed, say)
    torch.cuda.empty_cache()
    out["timing"] = phase_pp_timing(group, seed, cfg, say)
    out["failed"] = failed
    return out


def phase_pp(seed):
    """Phase 11 in PP spawned ranks (the layout from the card count), after
    the parent has built every kernel. Fails on any rank's failure;
    returns every rank's readings and the layout."""
    layout = mp_layout()
    print(f"[pp] {PP} stages, layout {layout}: "
          + ("one rank per card, NCCL" if layout == "per_card" else
             f"all on cuda:0 of {torch.cuda.device_count()} card(s), gloo")
          + "; GPT-3 1.3B trained at pp=4 through the boundary kernels",
          flush=True)
    t0 = time.perf_counter()
    outs = env.launch(PP, pp_rank_main, seed, layout=layout, timeout_s=900)
    print(f"[pp] the ranks ran in {time.perf_counter() - t0:.1f}s")
    failed = [f"rank {o['rank']}: {f}" for o in outs for f in o["failed"]]
    check(not failed, "pipeline-parallel training failed:\n" +
          "\n".join(failed))
    return outs, layout


def pp_rows(outs, layout, cfg):
    """The ``kernels`` rows of rows 14-15 from the ranks' readings:
    launches summed over the stages in the fused main path's run; ms the
    call with its hop (a card per rank) or the kernels alone (one card,
    ``covers`` says which), plain and library likewise."""
    per_card = layout == "per_card"
    R, K, F = pp_shapes(cfg)
    r0 = outs[0]
    rows = []
    for kernel, _, replaces in PP_KERNELS:
        t = r0["timing"][kernel]
        bound, by = pp_bound(kernel, R, K, F, per_card)
        err = r0["errs"]["y" if kernel == "gemm_ppsend" else "dx"]
        row = {"name": f"{kernel}[R={R} K={K} F={F}]", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/pp_gemm.cu",
               "replaces": replaces,
               "launches": sum(o["train"]["fused"]["counts"][kernel][1]
                               for o in outs),
               "max_abs_err": err["max_abs"], "bound_ms": bound,
               "bound_by": by, "kernel_alone_ms": t["kernel_alone_ms"],
               "tflops": t["tflops"]}
        if per_card:
            row.update(ms=t["call_ms"], plain_ms=t["plain_call_ms"],
                       library_ms=t["library_call_ms"], hop_ms=t["hop_ms"],
                       covers="kernels + hop, slowest rank")
        else:
            row.update(ms=t["kernel_alone_ms"],
                       plain_ms=t["plain_alone_ms"],
                       library_ms=t["library_alone_ms"],
                       covers="kernels alone, CUDA-graph replay")
        if kernel == "gemm_pprecv":
            row["max_abs_err_dw"] = r0["errs"]["dw"]["max_abs"]
            row["products"] = t["products"]
        rows.append(row)
    return rows


# ------------------------------------------ data-parallel training (12)
DP = 4                      # data-parallel replicas of phase 12
DP_KERNEL = ("fused_rs_bucket", fc.fused_rs_bucket,
             "paddle_tpu/ops/pallas_kernels/fused_collectives.py:361")
# row 10 against its plain ring at these widths (GPT-3 1.3B's buckets at
# n=4: LayerNorm / bias rows of 512 and 1,536 cols, 3,072 cols, out and
# wpe 1,048,576, up and down 4,194,304, wte and head 25,755,648)
DP_CHECK_COLS = (512, 1536, 3072, 1_048_576, 4_194_304, 25_755_648)
DP_TIMED_COLS = (512, 1_048_576, 4_194_304, 25_755_648)
# row 10's fp32 wire against NCCL's reduce-scatter of the same bucket:
# four N(0, 1) rows summed in another order, a few fp32 ulps of |sum| < 10
DP_LIB_TOL = 1e-5
DP_DEFAULT_FLAGS = {"FLAGS_grad_comm": "auto",
                    "FLAGS_weight_update_sharding": False,
                    "FLAGS_allreduce_dtype": "float32",
                    "FLAGS_grad_bucket_bytes": 16 * 2 ** 20,
                    "FLAGS_comm_backend": ""}
DP_FUSED = {"FLAGS_comm_backend": "dp=fused",
            "FLAGS_weight_update_sharding": True}
# (name, flags, the schedule the step must resolve to: its grad_comm
# backend, or None for the plain all-reduce); the fused fp32 rung is the
# main path
DP_RUNGS = (("fused", DP_FUSED, "fused"),
            ("fused-bf16", dict(DP_FUSED, FLAGS_allreduce_dtype="bfloat16"),
             "fused"),
            ("ring", {"FLAGS_comm_backend": "dp=ring",
                      "FLAGS_weight_update_sharding": True}, "ring"),
            ("int8", dict(DP_FUSED, FLAGS_allreduce_dtype="int8"), "fused"),
            ("off", {}, None))
# GPT-3 1.3B's buckets a step at full depth, n=4 and 16 MiB (all fp32)
DP_FULL_BUCKETS = 196
DP_PARITY_LAYERS, DP_PARITY_B = 2, 4


def dp_model(cfg, dev, params):
    """The eager GPTForCausalLM of ``cfg`` on ``dev`` (fp32 params, the
    Layer's) holding the functional tree ``params``'s values (phases 5, 10
    and 11's weights, through the Layer-name map)."""
    with torch.device(dev):
        model = GPTForCausalLM(cfg)
    return layer_params_from_numpy(model, layer_params_from_tree(params))


def dp_calls(plan, flags, schedule):
    """(row 10 calls, row 11 calls) per step of a schedule over ``plan``
    (built apart from the step): on the fused schedule one row-10 call
    per float bucket unless the wire is int8, and one row-11 gather per
    bucket (weight-update sharding); none on the ring and plain
    schedules."""
    if schedule != "fused":
        return 0, 0
    floats = sum(bk.dtype.is_floating_point for bk in plan.buckets)
    rs = 0 if flags.get("FLAGS_allreduce_dtype") == "int8" else floats
    return rs, len(plan.buckets)


def dp_bound(cols, n, per_card):
    """(ms, by) of one row-10 call on an (n, cols) fp32 bucket, at either
    wire (the pull reads the fp32 parts whatever the wire). A card per
    rank: the larger of the HBM bytes (this rank's staging bucket read by
    the n ranks, a row each, and the fp32 row written) and the bytes
    received over one direction of NVLink (n - 1 rows of parts). One
    card: one rank's call alone (n rows read, one written)."""
    times = {"bytes": 4 * (n + 1) * cols / HBM_BYTES_PER_S}
    if per_card:
        times["nvlink bytes"] = 4 * (n - 1) * cols / NVLINK_BYTES_PER_S
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def phase_dp_kernels(group, seed, say):
    """Rows 10 and 11 across the ranks at ``DP_CHECK_COLS``, each rank its
    own (n, cols) fp32 bucket: row 10's one-launch kernel against its
    plain ring bit for bit on fp32 and bf16 wires, and its fp32 row
    against NCCL's (gloo's on one card) reduce-scatter of the same bucket
    within ``DP_LIB_TOL``; row 11's kernel on the bucket's row ``rank``
    against its plain ring and the library's all-gather, bit for bit (the
    staging grows from 4 MiB to the largest bucket on the way). Returns
    ({(cols, wire | "library" | "gather"): max abs error}, failures)."""
    dev, n = group.device, group.n
    own = torch.Generator(device=dev).manual_seed(seed + 5000 + group.rank)
    errs, failed = {}, []
    for cols in DP_CHECK_COLS:
        x = torch.randn((n, cols), generator=own, device=dev)
        for wire in (torch.float32, torch.bfloat16):
            got = fc.fused_rs_bucket(x, group, wire)
            want = fc.rs_bucket_plain(x, group, wire)
            torch.cuda.synchronize()
            name = str(wire)[6:]
            errs[(cols, name)] = float((got - want).abs().max())
            if not (torch.equal(got, want) and got.dtype == torch.float32):
                failed.append(f"row 10 vs plain, {cols} cols, {name} wire: "
                              f"max abs {errs[(cols, name)]:.3e}")
            if wire == torch.float32:
                lib = group.reduce_scatter_into(
                    torch.empty(cols, device=dev), x.view(-1))
                errs[(cols, "library")] = float((got - lib).abs().max())
                if not errs[(cols, "library")] <= DP_LIB_TOL:
                    failed.append(f"row 10 vs reduce-scatter, {cols} cols: "
                                  f"{errs[(cols, 'library')]:.3e}")
        row = x[group.rank]
        got = fc.fused_ag_bucket(row, group)
        want = fc.ag_bucket_plain(row, group)
        lib = fc.all_gather_stack(row, group)
        torch.cuda.synchronize()
        errs[(cols, "gather")] = float((got - want).abs().max())
        if not (torch.equal(got, want) and torch.equal(got, lib)):
            failed.append(f"row 11 vs its plain ring and the library "
                          f"all-gather, {cols} cols: max abs "
                          f"{errs[(cols, 'gather')]:.3e}")
        del x, got, want, lib
    say(f"[dp-kernel] row 10 vs its plain ring, bit for bit (fp32 and bf16 "
        f"wires) at {list(DP_CHECK_COLS)} cols, on every rank's own bucket: "
        f"{not any('vs plain' in f for f in failed)}; vs the library "
        f"reduce-scatter (fp32), max abs "
        f"{max(v for (c, k), v in errs.items() if k == 'library'):.2e} "
        f"(gate {DP_LIB_TOL}); row 11 vs its plain ring and the library "
        f"all-gather, bit for bit: {not any('row 11' in f for f in failed)}")
    return errs, failed


def phase_dp_train(group, seed, say, rung, flags, schedule,
                   num_layers=None, warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """GPT-3 1.3B at full width (and depth, unless ``num_layers``) through
    ``jit.TrainStep(GPTForCausalLM, gpt_loss_fn, AdamW, group=)`` at dp=n
    on one rung: phase 5's weights, lr, clip and moment dtype, fp32 params
    and bf16 compute, remat dots_no_batch, the global batch of phase 5
    (``train_ids``) split over the ranks. Gates: finite losses, the last
    below the first, the same on every rank; the step resolved to
    ``schedule``; rows 10 and 11's calls and launches as ``dp_calls``
    says of a bucket plan built apart from the step (at full depth,
    ``DP_FULL_BUCKETS`` float buckets). Returns (step, this rank's ids,
    readings, failures)."""
    cfg = train_config(num_layers)
    dev, n = group.device, group.n
    set_flags(dict(DP_DEFAULT_FLAGS))
    set_flags(flags)
    t0 = time.perf_counter()
    model = dp_model(cfg, dev, init_gpt_params(cfg, seed=seed, device=dev,
                                               dtype=torch.bfloat16))
    opt = AdamW(2e-4, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), moment_dtype="bfloat16")
    step = TrainStep(model, gpt_loss_fn, opt, group=group)
    plan = gcomm.BucketPlan.build(dict(model.named_parameters()), n,
                                  DP_DEFAULT_FLAGS["FLAGS_grad_bucket_bytes"])
    b = TRAIN_B // n
    mine = train_ids(cfg, seed, dev)[group.rank * b:(group.rank + 1) * b]
    torch.cuda.synchronize()
    say(f"[dp-train {rung}] {MODEL}, {cfg.num_layers} layers: "
        f"{model.num_params():,} params fp32 (bf16 compute) over dp={n} "
        f"({group.backend}), flags {flags}, AdamW(2e-4, clip 1.0, bf16 "
        f"moments), remat dots_no_batch, ids [{b}, {TRAIN_S}] a rank; set "
        f"up in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats(dev)
    gcomm.reset_comm_counters()
    # the main path: counts start at 0 here and are read right after
    fc.reset_rs_bucket_counts()
    fc.reset_ag_bucket_counts()
    losses = []
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(mine, mine))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step(mine, mine))
    stop.record()
    losses = [float(x) for x in losses]
    step_s = start.elapsed_time(stop) / 1e3 / timed
    counts = (fc.fused_rs_bucket.calls, fc.fused_rs_bucket.launches)
    ag_counts = (fc.fused_ag_bucket.calls, fc.fused_ag_bucket.launches)
    shapes = {f"{c}/{w}": k for (c, w), k in fc.fused_rs_bucket.shapes.items()}
    ag_shapes = dict(fc.fused_ag_bucket.shapes)
    steps = warmup + timed
    rs_calls, ag_calls = (k * steps for k in dp_calls(plan, flags, schedule))
    # one launch a call
    want, ag_want = (rs_calls, rs_calls), (ag_calls, ag_calls)
    failed = []
    got = None if step._gc_cfg is None else step._gc_cfg.backend
    if got != schedule:
        failed.append(f"{rung}: the step resolved to the {got or 'plain'} "
                      f"schedule, not {schedule or 'plain'}")
    floats = sum(bk.dtype.is_floating_point for bk in plan.buckets)
    if num_layers is None and floats != DP_FULL_BUCKETS:
        failed.append(f"{rung}: {floats} float buckets a step, not "
                      f"{DP_FULL_BUCKETS}")
    if step._gc_cfg is not None and \
            step._gc_cfg.plan.fingerprint() != plan.fingerprint():
        failed.append(f"{rung}: the step's bucket plan differs from the "
                      f"one built apart")
    if not all(np.isfinite(losses)):
        failed.append(f"a dp train loss is not finite ({rung}): {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"dp loss did not fall ({rung}): {losses[0]} -> "
                      f"{losses[-1]}")
    every = group.all_gather_list(torch.tensor(losses, device=dev))
    same = all(torch.equal(every[0], o) for o in every)
    if not same:
        failed.append(f"the ranks' losses differ ({rung})")
    if counts != want:
        failed.append(f"rank {group.rank} {rung}: row 10 (calls, launches) "
                      f"{counts} != {want}")
    if ag_counts != ag_want:
        failed.append(f"rank {group.rank} {rung}: row 11 (calls, launches) "
                      f"{ag_counts} != {ag_want}")
    per_rank = group.all_gather_list(torch.tensor(
        [step_s, torch.cuda.max_memory_allocated(dev) / 1e9], device=dev,
        dtype=torch.float64))
    step_max = max(float(t[0]) for t in per_rank)
    fpt, _ = flops.model_flops_per_token(cfg, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(dev))
    comm = gcomm.comm_counters()
    per_step = {k: comm[k] / steps for k in
                ("reduce_bytes", "gather_bytes", "collectives", "buckets")}
    stats = {"rung": rung, "step_s": step_max,
             "step_s_by_rank": [float(t[0]) for t in per_rank],
             "tokens_per_s": tokens / step_max,
             "mfu_over_cards": flops.mfu(fpt * tokens, step_max, peak,
                                         cards=n),
             "cards": n, "layers": cfg.num_layers, "layout": group.backend,
             "warmup_s": warm, "losses": losses,
             "peak_mem_gb_by_rank": [float(t[1]) for t in per_rank],
             "comm_per_step": per_step,
             "reduce_bytes_by_dtype_per_step": {
                 k: v / steps for k, v in comm["reduce_bytes_by_dtype"].items()},
             "bucket_fill": comm["bucket_fill"],
             "backend": comm["backend"],
             "row10_calls_per_step": counts[0] / steps,
             "row11_calls_per_step": ag_counts[0] / steps}
    say(f"[dp-train {rung}] losses {[round(x, 4) for x in losses]} (the "
        f"same on every rank: {same})")
    say(f"[dp-train {rung}] the {got or 'plain'} schedule (want "
        f"{schedule or 'plain'}), {len(plan.buckets)} buckets a step "
        f"({floats} float); rank 0 row 10 (calls, launches) over {steps} "
        f"steps: {counts} (want {want}), by (cols/wire): {shapes}; row 11: "
        f"{ag_counts} (want {ag_want})")
    say(f"[dp-train {rung}] {json.dumps(stats)}")
    set_flags(dict(DP_DEFAULT_FLAGS))
    return step, mine, {"stats": stats, "counts": counts,
                        "shapes": dict(fc.fused_rs_bucket.shapes),
                        "ag_counts": ag_counts, "ag_shapes": ag_shapes}, failed


def phase_dp_profile(group, step, mine, say):
    """Where a fused dp step's time goes on rank 0: device ms by kind of
    kernel (``phase_tp_profile``) and under the step's record_function
    ranges (a second trace that records host ops too; the backward is
    what the ranges leave). Every rank runs both steps. Fails (rank 0)
    unless the traced step ran rows 10 and 11's pull kernels and the
    reduce-scatter and all-gather ranges took device time, or if it ran
    any NCCL send/recv kernel (rows 10-11 post no hop; nothing else of
    the dp step does)."""
    out = phase_tp_profile(group, lambda ids: step(ids, ids), mine, say,
                           tag="dp-profile")
    group.barrier()
    if group.rank != 0:
        group.barrier()
        step(mine, mine)
        torch.cuda.synchronize()
        return {"failed": []}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        group.barrier()                       # the ranks step together
        float(step(mine, mine))
    ranges = ("train_step/forward", "grad_comm/reduce_scatter",
              "train_step/clip", "train_step/optimizer",
              "grad_comm/all_gather")
    cpu = torch.autograd.DeviceType.CPU
    spans = {r: sum(getattr(e, "device_time_total", 0) for e in prof.events()
                    if e.name == r and e.device_type == cpu) / 1e3
             for r in ranges}
    spans["backward (the rest)"] = out["busy_ms"] - sum(spans.values())
    say(f"[dp-profile] device ms by part of the step (NCCL kernels count "
        f"while they wait): "
        f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}")
    out["spans"] = spans
    kinds = ("row 10 (rs_pull_kernel)", "row 11 (ag_pull_kernel)")
    missing = [k for k in kinds if not out["by_kind"][k] > 0] + \
        [r for r in ("grad_comm/reduce_scatter", "grad_comm/all_gather")
         if not spans[r] > 0]
    hops = {k: c for k, c in out["kernels"].items() if "nccl" in k.lower()
            and re.search(r"SendRecv|_Send|_Recv", k)}
    pulls = sum(c for k, c in out["kernels"].items() if "_pull_kernel" in k)
    say(f"[dp-profile] rows 10 and 11's pull kernels launched {pulls} times "
        f"in the step; NCCL send/recv kernels: {hops or 'none'}")
    out["failed"] = ([f"the profiled fused dp step shows no device time "
                      f"in {missing}"] if missing else []) + \
        ([f"the profiled fused dp step ran NCCL send/recv kernels: {hops}"]
         if hops else [])
    return out


def phase_dp_parity(group, seed, say):
    """One dp=n fused step of a DP_PARITY_LAYERS-layer copy at full width
    (B=DP_PARITY_B, S=2048) against the one-device TrainStep on the same
    weights and ids (rank 0): the loss, and every param's update, within
    phase 6's tolerances. AdamW(1.0, epsilon=1.0, no decay, no clip)
    makes the first update g / (|g| + 1), the gradient to within |g|, so
    the update compares the reduced gradient leaf by leaf. Returns
    failures (rank 0's)."""
    cfg = train_config(num_layers=DP_PARITY_LAYERS)
    dev, n = group.device, group.n
    params = init_gpt_params(cfg, seed=seed + 1, device=dev,
                             dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (DP_PARITY_B, TRAIN_S),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 4), device=dev)

    def one_step(grp, x):
        model = dp_model(cfg, dev, params)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = AdamW(1.0, parameters=model.parameters(), epsilon=1.0,
                    weight_decay=0.0)
        loss = float(TrainStep(model, gpt_loss_fn, opt, group=grp,
                               device=None if grp else dev)(x, x))
        return loss, {k: p.detach() - before[k]
                      for k, p in model.named_parameters()}

    set_flags(dict(DP_DEFAULT_FLAGS))
    set_flags(DP_FUSED)
    b = DP_PARITY_B // n
    loss, delta = one_step(group, ids[group.rank * b:(group.rank + 1) * b])
    set_flags(dict(DP_DEFAULT_FLAGS))
    failed = []
    if group.rank == 0:
        ref_loss, ref = one_step(None, ids)
        rel = {k: float((delta[k] - ref[k]).norm() /
                        ref[k].norm().clamp(min=1e-30)) for k in ref}
        worst = max(rel, key=rel.get)
        say(f"[dp-parity] {DP_PARITY_LAYERS}-layer {MODEL} width, "
            f"B={DP_PARITY_B} S={TRAIN_S} bf16 compute, dp={n} fused: loss "
            f"{loss:.6f} vs the one-device step {ref_loss:.6f} (|diff| "
            f"{abs(loss - ref_loss):.2e}); param updates: worst "
            f"||du||/||u|| {rel[worst]:.3e} ({worst}), median "
            f"{sorted(rel.values())[len(rel) // 2]:.3e} (gates: loss "
            f"{PARITY_LOSS_REL} rel, leaves {PARITY_GRAD_REL})")
        if not (np.isfinite(loss) and
                abs(loss - ref_loss) <= PARITY_LOSS_REL * abs(ref_loss)):
            failed.append(f"dp loss {loss} vs one-device {ref_loss}")
        bad = {k: v for k, v in rel.items()
               if not (np.isfinite(v) and v <= PARITY_GRAD_REL)}
        if bad:
            failed.append(f"dp param updates off the one-device step: {bad}")
    group.barrier()
    return failed


def phase_dp_timing(group, seed, say):
    """Rows 10 and 11's whole calls at ``DP_TIMED_COLS`` (fp32 buckets),
    each operand already in its peer staging, as grad_comm packs it, by
    ``slowest_rank_ms``: row 10 at fp32 and bf16 wires beside its plain
    ring and the library's reduce-scatter of the same bucket, row 11
    beside its plain ring and the library's all-gather of the same row;
    the library is NCCL with a card per rank, gloo on one card, where the
    ranks time-slice the card and the readings check the path, not its
    speed. Returns {cols: timings}."""
    dev, n = group.device, group.n
    per_card = group.backend == "nccl"
    g = torch.Generator(device=dev).manual_seed(seed + 6000 + group.rank)
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for cols in DP_TIMED_COLS:
        x = torch.randn((n, cols), generator=g, device=dev)
        stage = fc.rs_bucket_staging(group, (n, cols), f32)
        stage.copy_(x)
        row = x[group.rank]
        ag_stage = fc.ag_bucket_staging(group, cols, f32)
        ag_stage.copy_(row)
        lib = torch.empty(cols, device=dev)
        w = slowest_rank_ms(group, {
            "call": lambda: fc.fused_rs_bucket(stage, group, f32),
            "bf16": lambda: fc.fused_rs_bucket(stage, group, bf16),
            "plain": lambda: fc.rs_bucket_plain(x, group, f32),
            "library": lambda: group.reduce_scatter_into(lib, x.view(-1)),
            "ag": lambda: fc.fused_ag_bucket(ag_stage, group),
            "ag_plain": lambda: fc.ag_bucket_plain(row, group),
            "ag_library": lambda: fc.all_gather_stack(row, group)},
            ("call", "plain", "library", "bf16", "ag", "ag_plain",
             "ag_library", "ag", "call"), 10 if per_card else 3)
        out[cols] = {"call_ms": w["call"], "bf16_call_ms": w["bf16"],
                     "plain_call_ms": w["plain"],
                     "library_call_ms": w["library"],
                     "ag": {"call_ms": w["ag"],
                            "plain_call_ms": w["ag_plain"],
                            "library_call_ms": w["ag_library"]}}
        del x, stage, row, ag_stage, lib
    if group.rank == 0:
        check_ = "" if per_card else ", a path check"
        for cols, t in out.items():
            say(f"[dp-timing] row 10, ({n}, {cols}) fp32 bucket "
                f"({group.backend}{check_}): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in t.items() if k != "ag")
                + " ms")
            say(f"[dp-timing] row 11, ({cols},) fp32 row ({group.backend}"
                f"{check_}): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in t["ag"].items()) + " ms")
    return out


def dp_rank_main(group, seed):
    """One rank of phase 12 (spawned by ``distributed.env.launch``): row 10
    against its plain ring and the library's reduce-scatter, the main path
    on every rung (GPT-3 1.3B at full depth with a card per rank, and a
    profile of one fused step; 2 layers, 1 + 2 steps on one card), the
    parity copy and the timings. Rank 0 prints; every rank returns its
    readings and failures (a failing rank its rows 10-11 error
    record)."""
    with peer_record(group):
        return _dp_rank(group, seed)


def _dp_rank(group, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    say = (lambda *a: print(*a, flush=True)) if group.rank == 0 else \
        (lambda *a: None)
    group.barrier()           # the group's first collective: every rank
    errs, failed = phase_dp_kernels(group, seed, say)
    out = {"rank": group.rank, "errs": errs, "train": {}}
    per_card = group.backend == "nccl"
    depth = () if per_card else (2, 1, 2)
    for rung, flags, schedule in DP_RUNGS:
        step, mine, out["train"][rung], f = phase_dp_train(
            group, seed, say, rung, flags, schedule, *depth)
        failed += f
        if per_card and rung == "fused":
            out["profile"] = phase_dp_profile(group, step, mine, say)
            failed += out["profile"]["failed"]
            group.barrier()           # rank 0 has read its traces
        del step, mine
        torch.cuda.empty_cache()
    failed += phase_dp_parity(group, seed, say)
    torch.cuda.empty_cache()
    out["timing"] = phase_dp_timing(group, seed, say)
    out["failed"] = failed
    return out


def phase_dp(seed):
    """Phase 12 in DP spawned ranks (the layout from the card count), after
    the parent has built every kernel. Fails on any rank's failure;
    returns rank 0's readings and the layout."""
    layout = "per_card" if torch.cuda.device_count() >= DP else "shared"
    print(f"[dp] {DP} replicas, layout {layout}: "
          + ("one rank per card, NCCL" if layout == "per_card" else
             f"all on cuda:0 of {torch.cuda.device_count()} card(s), gloo")
          + "; GPT-3 1.3B trained at dp=4 through jit.TrainStep and row 10",
          flush=True)
    t0 = time.perf_counter()
    outs = env.launch(DP, dp_rank_main, seed, layout=layout, timeout_s=900)
    print(f"[dp] the ranks ran in {time.perf_counter() - t0:.1f}s")
    failed = [f"rank {o['rank']}: {f}" for o in outs for f in o["failed"]]
    check(not failed, "data-parallel training failed:\n" + "\n".join(failed))
    return outs[0], layout


def dp_rows(r0, layout):
    """The ``kernels`` rows of rows 10 and 11, one each per timed bucket
    width, from rank 0's readings: launches from the main path's run (the
    fused fp32 rung) at that width (one a call); ms, plain and library
    the whole calls of ``phase_dp_timing`` (``covers`` says on which
    layout)."""
    per_card = layout == "per_card"
    rows = []
    fused = r0["train"]["fused"]
    for cols in DP_TIMED_COLS:
        t = r0["timing"][cols]
        bound, by = dp_bound(cols, DP, per_card)
        rows.append({
            "name": f"{DP_KERNEL[0]}[{DP}x{cols} fp32]", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rs_bucket.cu",
            "replaces": DP_KERNEL[2],
            "launches": fused["shapes"].get((cols, "float32"), 0),
            "max_abs_err": r0["errs"][(cols, "float32")],
            "max_abs_err_bf16_wire": r0["errs"][(cols, "bfloat16")],
            "ms": t["call_ms"], "plain_ms": t["plain_call_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": t["library_call_ms"], "bf16_ms": t["bf16_call_ms"],
            "covers": (f"whole call, one launch, slowest of {DP} ranks on "
                       f"their own cards; library: NCCL's reduce-scatter")
            if per_card else
            (f"path check, not a speed: whole call with {DP} ranks "
             f"time-slicing one card; library: gloo's reduce-scatter")})
    for cols in DP_TIMED_COLS:
        rows.append(ag_row(f"{cols} fp32", r0["timing"][cols]["ag"],
                           4 * cols, DP, per_card,
                           fused["ag_shapes"].get(cols, 0),
                           r0["errs"][(cols, "gather")]))
    return rows


# ------------------------------------------- hybrid training (15)
HYBRID = 4                  # ranks of phase 15's worlds
HYBRID_M = 4                # microbatches of its pipelined paths
HYBRID_PARITY_B, HYBRID_PARITY_M = 4, 2
# (name, axes, comm_backend, pp_schedule, ZeRO-1 over dp); the paths run
# in one world per layout, pp2xmp2's two schedules in one
HYBRID_PATHS = (
    ("dp2xmp2", {"dp": 2, "mp": 2, "pp": 1}, "mp=fused,dp=fused", None,
     True),
    ("dp2xpp2", {"dp": 2, "mp": 1, "pp": 2}, "pp=fused,dp=fused", "gpipe",
     True),
    ("pp2xmp2-1f1b", {"dp": 1, "mp": 2, "pp": 2}, "mp=fused,pp=ring",
     "1f1b", False),
    ("pp2xmp2-gpipe", {"dp": 1, "mp": 2, "pp": 2}, "mp=fused,pp=ring",
     "gpipe", False),
)
# the rows a composed step may run: (row, wrapper, launches a call)
HYBRID_ROWS = tuple((name, w, None) for name, w, _ in FLASH_KERNELS) + (
               ("ring_ag_gemm", rg.ring_ag_gemm, 2),
               ("ring_gemm_rs", rg.ring_gemm_rs, 2),
               ("ring_ag_accum", rg.ring_ag_accum, 2),
               ("fused_rs_bucket", fc.fused_rs_bucket, 1),
               ("fused_ag_bucket", fc.fused_ag_bucket, 1),
               ("gemm_ppsend", ppb.gemm_ppsend, 1),
               ("gemm_pprecv", ppb.gemm_pprecv, 2))


def hybrid_layout():
    """One rank per card over NCCL with HYBRID cards, else every rank on
    cuda:0 over gloo."""
    return "per_card" if torch.cuda.device_count() >= HYBRID else "shared"


def hybrid_step_calls(path, step, stage, layers):
    """{row: calls} of one step of ``path`` on a rank of pipeline stage
    ``stage`` holding ``layers`` layers (rows 10-11 from the step's own
    bucket plan): with remat "full" the flash forward runs twice a layer
    per unit of work (the whole replica's rows, or a microbatch under
    pp), dQ and dK/dV once; 1F1B's stages that send run it a third time
    (the forward sub-tick's recompute of the activation stream), and rows
    7-8 likewise 8 calls a layer and unit there, 6 elsewhere
    (``tp_step_calls``); rows 10-11 one call a float bucket and a bucket
    (ZeRO-1's reduce-scatter and param gather); rows 14-15 as
    ``pp_step_calls``."""
    _, axes, comm_backend, schedule, _ = path
    rungs = parse_rungs(comm_backend)
    pp = axes["pp"]
    units = HYBRID_M if pp > 1 else 1
    extra = schedule == "1f1b" and stage < pp - 1
    calls = {"flash_fwd": (3 if extra else 2) * layers * units,
             "flash_dq": layers * units, "flash_dkv": layers * units}
    mp = tp_step_calls(layers) if axes["mp"] > 1 and \
        rungs.get("mp") == "fused" else {}
    for k, v in mp.items():
        calls[k] = (v + (2 * layers if extra and k != "ring_ag_accum"
                         else 0)) * units
    dpc = step._dpc
    if dpc is not None and dpc.backend == "fused":
        plan = dpc.plan
        calls["fused_rs_bucket"] = sum(b.dtype.is_floating_point
                                       for b in plan.buckets)
        calls["fused_ag_bucket"] = len(plan.buckets)
    if pp > 1:
        for k, (c, _) in pp_step_calls(rungs.get("pp"), stage, pp,
                                       HYBRID_M).items():
            calls[k] = c
    return {row: calls.get(row, 0) for row, _, _ in HYBRID_ROWS}


def hybrid_counts():
    return {row: (getattr(w, "calls", None), w.launches)
            for row, w, _ in HYBRID_ROWS}


def reset_hybrid_counts():
    reset_flash_counts()
    rg.reset_counts()
    fc.reset_rs_bucket_counts()
    fc.reset_ag_bucket_counts()
    ppb.reset_counts()
    pF.scaled_dot_product_attention.fallbacks = 0


def world_gather(groups, t):
    """Every rank's ``t`` in world-rank order (mp fastest), gathered axis
    by axis."""
    x = torch.stack(groups.mp.all_gather_list(t))
    x = torch.stack(groups.dp.all_gather_list(x))
    x = torch.stack(groups.pp.all_gather_list(x))
    return list(x.reshape((-1,) + tuple(t.shape)))


def hybrid_step(cfg, groups, path, params=None, seed=0, microbatches=None):
    _, axes, comm_backend, schedule, zero = path
    opt = AdamW(2e-4, grad_clip=ClipGradByGlobalNorm(1.0),
                moment_dtype="bfloat16")
    if zero:
        opt._shard_opt_states_axis = "dp"
    if schedule is not None:
        cfg = dataclasses.replace(cfg, pp_schedule=schedule)
    return HybridTrainStep(cfg, opt, param_dtype=torch.bfloat16, seed=seed,
                           params=params, group=groups.mp,
                           pp_group=groups.pp, dp_group=groups.dp,
                           num_microbatches=microbatches or HYBRID_M,
                           comm_backend=comm_backend)


def phase_hybrid_train(groups, seed, say, path, num_layers=None,
                       warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """GPT-3 1.3B at full width (and depth, unless ``num_layers``) through
    HybridTrainStep(group=mp, pp_group=pp, dp_group=dp) on one composed
    path: ``warmup`` and ``timed`` steps on phase 5's batch (each dp
    replica its rows). Gates: finite losses, the last below the first,
    the same on every rank; every row's calls and launches as
    ``hybrid_step_calls`` says, each row of the path launched; no SDPA
    fallback. Returns (readings, failures)."""
    name = path[0]
    cfg = train_config(num_layers)
    dev = groups.mp.device
    t0 = time.perf_counter()
    step = hybrid_step(cfg, groups, path, seed=seed)
    ids = train_ids(cfg, seed, dev)
    torch.cuda.synchronize()
    stage, pp = groups.pp.rank, groups.pp.n
    layers = cfg.num_layers // pp
    say(f"[hybrid {name}] {MODEL}, {cfg.num_layers} layers: "
        f"{step.num_params():,} params bf16 over {groups.axes} "
        f"({groups.mp.backend}), {path[2]}, schedule {path[3]}, ZeRO-1 "
        f"over dp: {path[4]}, M={HYBRID_M if pp > 1 else 1}, AdamW(2e-4, "
        f"clip 1.0, bf16 moments), remat full, ids [{TRAIN_B}, "
        f"{TRAIN_S}] ({TRAIN_B // groups.dp.n} rows a replica); set up in "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats(dev)
    # the main path: counts start at 0 here and are read right after
    reset_hybrid_counts()
    losses = []
    for g in (groups.mp, groups.dp, groups.pp):
        g.barrier()
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(ids))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        losses.append(step(ids))
    stop.record()
    losses = [float(x) for x in losses]
    step_s = start.elapsed_time(stop) / 1e3 / timed
    counts = hybrid_counts()
    fallbacks = pF.scaled_dot_product_attention.fallbacks
    steps = warmup + timed
    per_step = hybrid_step_calls(path, step, stage, layers)
    want = {row: (None if per_call is None else c * steps,
                  c * steps * (per_call or 1))
            for (row, _, per_call), c in zip(HYBRID_ROWS,
                                             per_step.values())}
    failed = []
    if not all(np.isfinite(losses)):
        failed.append(f"{name}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        failed.append(f"{name}: loss did not fall: {losses[0]} -> "
                      f"{losses[-1]}")
    every = world_gather(groups, torch.tensor(losses, device=dev))
    same = all(torch.equal(every[0], o) for o in every)
    if not same:
        failed.append(f"{name}: the ranks' losses differ")
    if counts != want:
        failed.append(f"rank {groups.rank} {name}: (calls, launches) "
                      f"{counts} != {want}")
    if fallbacks:
        failed.append(f"{name}: {fallbacks} SDPA fallbacks")
    per_rank = world_gather(groups, torch.tensor(
        [step_s, torch.cuda.max_memory_allocated(dev) / 1e9], device=dev,
        dtype=torch.float64))
    step_max = max(float(t[0]) for t in per_rank)
    launched = {row: sum(1 for o in world_gather(groups, torch.tensor(
        [counts[row][1]], device=dev)) if int(o) > 0)
        for row, _, _ in HYBRID_ROWS}
    fpt, _ = flops.model_flops_per_token(cfg, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    peak = flops.peak_flops_bf16(torch.cuda.get_device_name(dev))
    stats = {"path": name, "axes": groups.axes, "comm_backend": path[2],
             "schedule": path[3], "zero1": path[4], "step_s": step_max,
             "step_s_by_rank": [float(t[0]) for t in per_rank],
             "tokens_per_s": tokens / step_max,
             "mfu_over_cards": flops.mfu(fpt * tokens, step_max, peak,
                                         cards=groups.world),
             "cards": groups.world, "layers": cfg.num_layers,
             "layout": groups.mp.backend, "warmup_s": warm,
             "losses": losses,
             "peak_mem_gb_by_rank": [float(t[1]) for t in per_rank],
             "ranks_launching": launched}
    say(f"[hybrid {name}] losses {[round(x, 4) for x in losses]} (the same "
        f"on every rank: {same}); SDPA fallbacks {fallbacks}")
    say(f"[hybrid {name}] rank 0 (calls, launches) over {steps} steps: "
        f"{counts} (want {want}); ranks launching each row: {launched}")
    say(f"[hybrid {name}] {json.dumps(stats)}")
    del step
    torch.cuda.empty_cache()
    return {"stats": stats, "counts": counts, "per_step": per_step}, failed


def phase_hybrid_parity(groups, seed, say, path):
    """One step of a 2-layer (2 a stage under pp) copy of ``path`` at full
    width (B=HYBRID_PARITY_B, S=2048, M=HYBRID_PARITY_M) against the
    one-card step on the same weights and ids, every rank computing it:
    the loss (averaged over dp) and every gradient leaf of this rank's
    stage, mp shards compared over the mp group, within phase 6's
    tolerances. Returns failures."""
    name = path[0]
    pp = groups.pp.n
    cfg = train_config(num_layers=2 * pp)
    if path[3] is not None:
        cfg = dataclasses.replace(cfg, pp_schedule=path[3])
    dev = groups.mp.device
    params = init_gpt_params(cfg, seed=seed + 1, device=dev,
                             dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (HYBRID_PARITY_B, TRAIN_S),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 4), device=dev)
    step = hybrid_step(cfg, groups, path, params=params,
                       microbatches=HYBRID_PARITY_M)
    loss, grads = step.loss_and_grads(ids)
    loss = float(loss)
    flat = {n: t.detach().clone().requires_grad_(True)
            for n, t in flatten_params(params).items()}
    ref_loss = gpt_loss(unflatten_params(flat), ids, cfg)
    ref = unflatten_params(dict(zip(flat, torch.autograd.grad(
        ref_loss, list(flat.values())))))
    ref_loss = float(ref_loss.detach())
    mp = groups.mp
    if mp.n > 1:
        ref["blocks"] = tp_overlap.to_qkv_head_major(
            ref["blocks"], cfg.hidden_size, cfg.num_heads)
        ref = shard_params(ref, mp.rank, mp.n)
    ref = flatten_params(stage_params(ref, groups.pp.rank, pp)
                         if pp > 1 else ref)
    names = sorted(grads)
    sq = torch.stack([torch.stack([(grads[n].float() - ref[n].float())
                                   .square().sum(),
                                   ref[n].float().square().sum()])
                      for n in names])
    sharded = torch.tensor([n not in step._replicated for n in names],
                           device=dev)
    sq = torch.where(sharded[:, None],
                     mp.all_reduce_(torch.where(sharded[:, None], sq, 0.0)),
                     sq)
    rel = {n: float(sq[i, 0].sqrt() / sq[i, 1].sqrt().clamp(min=1e-30))
           for i, n in enumerate(names)}
    worst = max(rel, key=rel.get)
    every = world_gather(groups, torch.tensor([rel[worst]], device=dev,
                                              dtype=torch.float64))
    say(f"[hybrid-parity {name}] {cfg.num_layers}-layer {MODEL} width, "
        f"B={HYBRID_PARITY_B} S={TRAIN_S} bf16, M={HYBRID_PARITY_M}: loss "
        f"{loss:.6f} vs the one-card step {ref_loss:.6f} (|diff| "
        f"{abs(loss - ref_loss):.2e}); gradient leaves: worst "
        f"||dg||/||g|| by rank {[round(float(t[0]), 5) for t in every]} "
        f"(rank 0: {worst}) (gates: loss {PARITY_LOSS_REL} rel, leaves "
        f"{PARITY_GRAD_REL})")
    failed = []
    if not (np.isfinite(loss) and
            abs(loss - ref_loss) <= PARITY_LOSS_REL * abs(ref_loss)):
        failed.append(f"{name} loss {loss} vs one-card {ref_loss}")
    bad = {n: v for n, v in rel.items()
           if not (np.isfinite(v) and v <= PARITY_GRAD_REL)}
    if bad:
        failed.append(f"{name} gradient leaves off the one-card step: {bad}")
    del step
    torch.cuda.empty_cache()
    return failed


def hybrid_rank_main(groups, seed, paths):
    """One rank of phase 15's world (spawned by ``env.launch(...,
    axes=)``): the 2- or 4-layer parity copy and the main path of each of
    ``paths`` (GPT-3 1.3B at full depth with a card per rank; on one card,
    where every hop goes through host memory, one layer a stage and 1 + 2
    steps). Rank 0 prints; every rank returns its readings and
    failures."""
    with peer_record(groups):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(1)
        say = (lambda *a: print(*a, flush=True)) if groups.rank == 0 else \
            (lambda *a: None)
        per_card = groups.mp.backend == "nccl"
        out = {"rank": groups.rank, "train": {}}
        failed = []
        for path in paths:
            failed += phase_hybrid_parity(groups, seed, say, path)
            depth = () if per_card else (groups.pp.n, 1, 2)
            out["train"][path[0]], f = phase_hybrid_train(
                groups, seed, say, path, *depth)
            failed += f
        out["failed"] = failed
        return out


def phase_hybrid(seed):
    """Phase 15: one world of HYBRID spawned ranks per layout of
    ``HYBRID_PATHS`` (the layout from the card count), after the parent
    has built every kernel. Fails on any rank's failure; returns {path:
    rank 0's readings} and the layout."""
    layout = hybrid_layout()
    print(f"[hybrid] {HYBRID} ranks a world, layout {layout}: "
          + ("one rank per card, NCCL sub-groups" if layout == "per_card"
             else f"all on cuda:0 of {torch.cuda.device_count()} card(s), "
                  f"gloo sub-groups")
          + "; GPT-3 1.3B trained at dp2 x mp2, dp2 x pp2 and pp2 x mp2",
          flush=True)
    worlds = {}
    for path in HYBRID_PATHS:
        key = tuple(sorted(path[1].items()))
        worlds.setdefault(key, []).append(path)
    r0, failed = {}, []
    for key, paths in worlds.items():
        t0 = time.perf_counter()
        outs = env.launch(HYBRID, hybrid_rank_main, seed, paths,
                          layout=layout, timeout_s=900, axes=dict(key))
        print(f"[hybrid] {[p[0] for p in paths]}: the ranks ran in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        failed += [f"rank {o['rank']}: {f}" for o in outs
                   for f in o["failed"]]
        r0.update(outs[0]["train"])
    check(not failed, "hybrid-parallel training failed:\n" +
          "\n".join(failed))
    return r0, layout


def phase_trajectories(one_card, tp_r0, pp_r0, dp_r0, hybrid_r0, layout):
    """The training phases' loss trajectories from the same weights and
    ids, side by side (printed, not gated): one card (phase 5), mp=4 on
    the fused and rsag rungs (phase 10), pp=4 on each rung (phase 11),
    dp=4 on each rung (phase 12: the eager model, whose loss is the
    unfused CE over fp32 logits and whose AdamW decays every param) and
    the composed paths (phase 15). Only full-depth runs (a card per rank)
    compare with phase 5."""
    if layout != "per_card":
        print("[trajectories] one card: the mp, pp and dp phases ran cut "
              "depths; nothing to compare with phase 5")
        return
    runs = {"one card": one_card,
            "mp=4 fused": tp_r0["train"]["stats"]["losses"],
            "mp=4 rsag": tp_r0["train_rsag"]["stats"]["losses"]}
    runs.update({f"pp=4 {k}": v["stats"]["losses"]
                 for k, v in pp_r0["train"].items()})
    runs.update({f"dp=4 {k}": v["stats"]["losses"]
                 for k, v in dp_r0["train"].items()})
    runs.update({k: v["stats"]["losses"] for k, v in hybrid_r0.items()})
    for name, losses in runs.items():
        print(f"[trajectories] {name:>16}: "
              f"{[round(x, 4) for x in losses]}, last - one card's "
              f"{losses[-1] - one_card[-1]:+.4f}")


@contextlib.contextmanager
def phase_clock(name):
    """Prints the seconds a phase of the run took, as ``[phase] name``."""
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s", flush=True)


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

    with phase_clock("build"):
        phase_build()
    with phase_clock("kernels vs plain"):
        max_abs = phase_kernel_vs_plain(gen, dev)
        flash_errs = phase_flash_vs_plain(gen, dev)
        cfg = GPT_CONFIGS[MODEL]
        quant_errs = phase_quant_vs_plain(gen, dev, cfg)
    with phase_clock("card tests"):
        phase_card_tests()

    with phase_clock("serving bf16"):
        t0 = time.perf_counter()
        params = cast_for_compute(
            init_gpt_params(cfg, seed=args.seed, device=dev,
                            dtype=torch.bfloat16), cfg)
        torch.cuda.synchronize()
        print(f"[model] {MODEL}: H={cfg.hidden_size} L={cfg.num_layers} "
              f"nh={cfg.num_heads} V={cfg.vocab_size} {cfg.compute_dtype}, "
              f"random weights (seed {args.seed}) in "
              f"{time.perf_counter() - t0:.1f}s")
        fp = phase_serve(cfg, params, np.random.default_rng(args.seed))
        single = {"bf16": one_card(fp)}
        phase_logits(cfg, fp["eng"], gen, dev)
        phase_profile(cfg, fp["eng"], rng)
        phase_oracle(cfg, params, fp["results"], fp["wave1"])
        del fp["eng"]
        torch.cuda.empty_cache()
    quant_rows = []
    for dtype in QUANT_DTYPES:
        with phase_clock(f"serving {dtype}"):
            # the same 16 requests as the bf16 run
            qs = phase_serve(cfg, params, np.random.default_rng(args.seed),
                             quant=dtype)
            single[dtype] = one_card(qs)
            phase_logits(cfg, qs["eng"], gen, dev)
            phase_quant_report(cfg, params, fp, qs, rng)
            if dtype == "int8":
                phase_profile(cfg, qs["eng"], rng)
            quant_rows += phase_quant_timing(cfg, qs, dtype, gen, dev,
                                             quant_errs)
            del qs
            torch.cuda.empty_cache()
    with phase_clock("16 speculative serving"):
        quant_rows += phase_spec(cfg, params, args.seed, single, gen, dev,
                                 rng)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    with phase_clock("9 mp serving"):
        mp_r0, layout = phase_mp(args.seed, single)
    with phase_clock("decode timing"):
        row = phase_timing(gen, dev, max_abs, fp["counts"]["paged_decode"],
                           cfg.num_layers)

    with phase_clock("one-card training"):
        step, ids, counts, one_card_losses = phase_train(args.seed, dev)
        phase_train_profile(step, ids)
        del step, ids
        torch.cuda.empty_cache()
        phase_train_parity(args.seed, gen, dev)
        torch.cuda.empty_cache()
        rows = [row] + quant_rows + phase_flash_timing(gen, dev, flash_errs,
                                                       counts)
        torch.cuda.empty_cache()
    with phase_clock("13 bert"):
        rows += phase_bert(args.seed, gen, dev)
        torch.cuda.empty_cache()
    with phase_clock("flash features"):
        rows += phase_flash_features(args.seed, gen, dev)
        torch.cuda.empty_cache()
    with phase_clock("14 transformer"):
        rows += phase_transformer(args.seed, gen, dev)
        torch.cuda.empty_cache()
    with phase_clock("10 mp training"):
        tp_r0, tp_layout = phase_tp(args.seed)
    with phase_clock("11 pp training"):
        pp_outs, pp_layout = phase_pp(args.seed)
    with phase_clock("12 dp training"):
        dp_r0, dp_layout = phase_dp(args.seed)
    with phase_clock("15 hybrid training"):
        hybrid_r0, _ = phase_hybrid(args.seed)
    phase_trajectories(one_card_losses, tp_r0, pp_outs[0], dp_r0, hybrid_r0,
                       tp_layout)
    mp_kernels = mp_rows(mp_r0, layout, cfg)
    return finish(rows + mp_kernels + tp_rows(tp_r0, tp_layout, cfg) +
                  pp_rows(pp_outs, pp_layout, cfg) +
                  dp_rows(dp_r0, dp_layout), t_start)


def finish(rows, t_start):
    """The result lines: the kernels, the card's name and power limit, and
    the contract line last."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
