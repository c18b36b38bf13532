"""Serving counters (counterpart of ``paddle_tpu/serving/metrics.py``):
a process-wide ledger, ``serving_counters()`` for a snapshot with derived
rates and ``serving_summary()`` for one line.

Times are host-clock seconds. On CUDA the engine synchronises only where
it reads tokens back, so a dispatch that emits nothing (a non-final
prefill chunk) records its enqueue time and its device time lands in the
next dispatch that reads back.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np

_lock = threading.Lock()


def _zero():
    return {
        # request lifecycle
        "submitted": 0, "admitted": 0, "completed": 0, "rejected": 0,
        "expired": 0,
        "finished_stop": 0, "finished_length": 0,
        # fused chunk/decode dispatches; decode dispatches are
        # paged_steps - chunk_steps
        "paged_steps": 0, "chunk_steps": 0, "prefill_chunks": 0,
        "cow_copies": 0,
        # prefix cache
        "prefix_lookups": 0, "prefix_hits": 0, "prefix_tokens_reused": 0,
        # page occupancy observed at step boundaries
        "pages_inuse_sum": 0, "pages_inuse_max": 0, "pages_total": 0,
        "page_boundaries": 0,
        # padded tokens of each request's final prefill chunk
        "prefill_padded_tokens": 0, "prefill_padded_reqs": 0,
        "prefill_padded_max": 0,
        # tokens / time
        "tokens_out": 0,
        "decode_time_s": 0.0, "prefill_time_s": 0.0,
        # occupancy: active slots summed over boundaries / (boundaries * slots)
        "active_slot_steps": 0, "slot_steps": 0,
        # queue depth observed at step boundaries
        "queue_depth_sum": 0, "queue_depth_max": 0, "boundaries": 0,
        # quantized serving (serving/quant.py): the largest logit drift
        # against the fp engine a harness measured (0.0 until one runs)
        "quant_logit_drift_max": 0.0,
        # tensor-parallel serving (serving/mp_forward.py): per dispatch the
        # static collective schedule of the mp rung on this rank: wire
        # bytes sent, all-gathers, fused kernel launches
        # (distributed/tp_overlap.py:serving_step_record)
        "mp_steps": 0, "mp_collectives": 0, "mp_wire_bytes": 0,
        "mp_fused_dispatches": 0,
        # speculative decoding (serving/engine.py): draft and verify
        # dispatches, draft tokens proposed and accepted, and the tokens
        # the verify dispatches emitted; all 0 on a plain engine, whose
        # decode dispatches are plain [B, 1] steps, while a speculative
        # engine's decode dispatches are all verify dispatches
        "draft_dispatches": 0, "verify_dispatches": 0,
        "spec_proposed": 0, "spec_accepted": 0, "spec_tokens_out": 0,
    }


_C = _zero()
# the last quantized engine's configuration: its dtype labels, the bytes
# of its scale tables and the KV bytes one token costs. Configuration, not
# counters: it survives reset_serving_counters, and serving_counters()
# reports the two gauges as quant_scale_bytes / quant_kv_bytes_per_token.
_quant_info = {}
# the last tensor-parallel engine's degree and rung (configuration, not a
# counter: it survives reset_serving_counters)
_mp_info = {}
_MAX_SAMPLES = 65536       # rings: percentiles follow the latest traffic
_ttft = deque(maxlen=_MAX_SAMPLES)      # seconds
_tok_lat = deque(maxlen=_MAX_SAMPLES)   # per-token decode latency (seconds)


def bump(name, n=1):
    with _lock:
        _C[name] += n


def set_mp_info(mp, backend):
    """Record a tensor-parallel engine's degree and rung; set at build."""
    with _lock:
        _mp_info.update(mp=int(mp), backend=str(backend))


def set_quant_info(weight_dtype, kv_dtype, scale_bytes=0,
                   kv_bytes_per_token=0):
    """Record a quantized engine's dtype config (labels) and its gauges
    (scale-table bytes, KV bytes per token); set at engine build."""
    with _lock:
        _quant_info.update(weight_dtype=str(weight_dtype),
                           kv_dtype=str(kv_dtype),
                           scale_bytes=int(scale_bytes),
                           kv_bytes_per_token=int(kv_bytes_per_token))


def observe_logit_drift(drift):
    """Keep the largest logit drift (fp engine against the quantized one
    on the same input) a harness measured."""
    with _lock:
        _C["quant_logit_drift_max"] = max(_C["quant_logit_drift_max"],
                                          float(drift))


def add_time(name, dt):
    with _lock:
        _C[name] += dt


def observe_boundary(queue_depth, active, slots):
    with _lock:
        _C["boundaries"] += 1
        _C["queue_depth_sum"] += queue_depth
        _C["queue_depth_max"] = max(_C["queue_depth_max"], queue_depth)
        _C["active_slot_steps"] += active
        _C["slot_steps"] += slots


def observe_pages(in_use, total):
    with _lock:
        _C["page_boundaries"] += 1
        _C["pages_inuse_sum"] += in_use
        _C["pages_inuse_max"] = max(_C["pages_inuse_max"], in_use)
        _C["pages_total"] = total


def observe_prefill_waste(padded_tokens):
    with _lock:
        _C["prefill_padded_reqs"] += 1
        _C["prefill_padded_tokens"] += padded_tokens
        _C["prefill_padded_max"] = max(_C["prefill_padded_max"],
                                       padded_tokens)


def observe_ttft(seconds):
    with _lock:
        _ttft.append(seconds)


def observe_token_latency(seconds, n=1):
    with _lock:
        _tok_lat.append(seconds / max(n, 1))


def _pct(samples, q):
    return float(np.percentile(samples, q)) if samples else None


def serving_counters():
    """Snapshot of the ledger plus derived rates: TTFT p50/p99, per-token
    latency p50, tokens/s over executable time, slot and page
    occupancy, mean queue depth, prefix hit rate, and the speculative
    accept rate and tokens per dispatch."""
    with _lock:
        out = dict(_C)
        out["quant_scale_bytes"] = _quant_info.get("scale_bytes", 0)
        out["quant_kv_bytes_per_token"] = _quant_info.get(
            "kv_bytes_per_token", 0)
        ttft = list(_ttft)
        lat = list(_tok_lat)
    out["ttft_p50"], out["ttft_p99"] = _pct(ttft, 50), _pct(ttft, 99)
    out["token_latency_p50"] = _pct(lat, 50)
    exec_t = out["decode_time_s"] + out["prefill_time_s"]
    out["tokens_per_s"] = out["tokens_out"] / exec_t if exec_t > 0 else 0.0
    out["decode_dispatches"] = out["paged_steps"] - out["chunk_steps"]
    out["occupancy"] = (out["active_slot_steps"] / out["slot_steps"]
                        if out["slot_steps"] else 0.0)
    out["queue_depth_mean"] = (out["queue_depth_sum"] / out["boundaries"]
                               if out["boundaries"] else 0.0)
    out["page_occupancy"] = (
        out["pages_inuse_sum"] / (out["page_boundaries"] * out["pages_total"])
        if out["page_boundaries"] and out["pages_total"] else 0.0)
    out["prefix_hit_rate"] = (out["prefix_hits"] / out["prefix_lookups"]
                              if out["prefix_lookups"] else 0.0)
    out["mp_bytes_per_dispatch"] = (out["mp_wire_bytes"] / out["mp_steps"]
                                    if out["mp_steps"] else 0.0)
    out["prefill_waste_mean"] = (
        out["prefill_padded_tokens"] / out["prefill_padded_reqs"]
        if out["prefill_padded_reqs"] else 0.0)
    # speculative decoding: the share of proposed tokens the verify
    # accepted, and the tokens one dispatch buys (draft and verify
    # dispatches both count; a plain engine's equivalent is 1.0)
    out["accept_rate"] = (out["spec_accepted"] / out["spec_proposed"]
                          if out["spec_proposed"] else 0.0)
    spec_disp = out["draft_dispatches"] + out["verify_dispatches"]
    out["tokens_per_dispatch"] = (out["spec_tokens_out"] / spec_disp
                                  if spec_disp else 0.0)
    return out


def reset_serving_counters():
    global _C
    with _lock:
        _C = _zero()
        _ttft.clear()
        _tok_lat.clear()


def serving_summary():
    """One-line human-readable serving report."""
    c = serving_counters()
    ttft = ("n/a" if c["ttft_p50"] is None
            else f"{c['ttft_p50'] * 1e3:.1f}/{c['ttft_p99'] * 1e3:.1f}ms")
    paged = ""
    if c["paged_steps"]:
        paged = (f"  pages: {c['page_occupancy'] * 100:.1f}% of "
                 f"{c['pages_total']} used (max {c['pages_inuse_max']})  "
                 f"prefix-hit: {c['prefix_hit_rate'] * 100:.1f}% "
                 f"({c['prefix_tokens_reused']} tok reused)  "
                 f"chunk-interleaved: {c['chunk_steps']}/{c['paged_steps']} "
                 f"steps  cow: {c['cow_copies']}")
    quant = ""
    with _lock:
        qinfo = dict(_quant_info)
    if qinfo:
        drift = (f"  drift-max: {c['quant_logit_drift_max']:.2e}"
                 if c["quant_logit_drift_max"] else "")
        quant = (f"  quant: w={qinfo['weight_dtype']} "
                 f"kv={qinfo['kv_dtype']}  "
                 f"scales: {c['quant_scale_bytes']}B  "
                 f"kv-bytes/tok: {c['quant_kv_bytes_per_token']}{drift}")
    mp = ""
    if c["mp_steps"]:
        with _lock:
            info = dict(_mp_info)
        mp = (f"  mp: {info.get('backend', '?')}x{info.get('mp', '?')}  "
              f"wire: {c['mp_wire_bytes'] / 1e6:.2f}MB over "
              f"{c['mp_collectives']} collectives in {c['mp_steps']} "
              f"dispatches ({c['mp_bytes_per_dispatch'] / 1e6:.2f}MB "
              f"each)  fused-dispatches: {c['mp_fused_dispatches']}")
    spec = ""
    if c["verify_dispatches"]:
        spec = (f"  spec: accept: {c['accept_rate'] * 100:.1f}% "
                f"({c['spec_accepted']}/{c['spec_proposed']})  "
                f"tokens/dispatch: {c['tokens_per_dispatch']:.2f} "
                f"({c['draft_dispatches']} draft + "
                f"{c['verify_dispatches']} verify)")
    waste = ""
    if c["prefill_padded_reqs"]:
        waste = (f"  prefill-waste: {c['prefill_waste_mean']:.1f} "
                 f"avg/{c['prefill_padded_max']} max pad tok")
    return (f"requests: {c['submitted']} submitted / {c['completed']} done "
            f"({c['expired']} expired, {c['rejected']} rejected)  "
            f"tokens: {c['tokens_out']}  tokens/s: {c['tokens_per_s']:.1f}  "
            f"ttft p50/p99: {ttft}  occupancy: {c['occupancy'] * 100:.1f}%  "
            f"queue: {c['queue_depth_mean']:.1f} avg/"
            f"{c['queue_depth_max']} max{paged}{quant}{spec}{mp}{waste}")
