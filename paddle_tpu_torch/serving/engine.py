"""Iteration-level continuous-batching engine over a block-paged KV pool
(counterpart of ``paddle_tpu/serving/engine.py``, paged layout).

The engine owns B decode SLOTS, a pool ``[L, P, page_size, nh, d]`` of
physical KV pages shared by all slots, and a host-side slot->page table
(serving/paged_kv.py). Admission is bounded by pages, not by worst-case
slot length; prompts with a cached prefix map the same pages
copy-on-write; long prompts prefill in chunks interleaved with the other
slots' decode (Sarathi-style), so admitting a 1024-token prompt costs each
decode stream one chunk per boundary, never a monolithic prefill.

Every boundary runs ONE fused step (serving/paged_attention.py) at two
shapes: [1, chunk] for a prefill chunk and [B, 1] for one token of every
decoding slot. Per-slot state (positions, chunk offsets, page table,
sampling parameters) lives in numpy on the host and is uploaded with each
dispatch: one packed int32 and one packed float32 operand, each one
non-blocking copy from pinned memory on CUDA. The KV pool stays on the
device and is updated in place. At T=1 on CUDA, attention reads the pool
through the hand-written paged-decode kernel.

Each request samples from its own ``torch.Generator`` seeded with
``req.seed``, which advances only when the request's slot emits a token,
so a request's tokens equal ``models.generate_from_params``'s for any
admission order, greedy and sampled, with chunking and prefix sharing on
(bit for bit on the CPU; see models/generation.py for the shape rules
that keep the promise).

``quant=`` (a ``serving.quant.QuantSpec``, "int8", "fp8", or None to read
``FLAGS_serving_weight_dtype``/``FLAGS_serving_kv_dtype``) serves with
int8/fp8 GEMM weights (the quantized GEMM kernel on CUDA) and/or an
int8/fp8 KV pool with per-page scales (the quantized paged-decode kernel
on CUDA). The weights are quantized as the caller passes them, before the
compute casts; missing KV clip ranges are calibrated by one fp forward at
build. A quantized engine keeps the promises above at its dtype config
(against itself, not against the fp oracle); the bf16/bf16 config
resolves to None and runs none of that code.

Tensor-parallel serving (serving/mp_forward.py) is SPMD: each rank of a
``distributed.env.MPGroup`` builds ``Engine(..., mp=n, comm_backend=...,
group=group)`` with the same full params and submits the same requests,
and every rank returns the same results. The rank holds its column
shards of the weights and a pool of its nh/n heads; the page table,
scheduler and sampling state stay whole and identical on every rank,
because the schedule only gathers, so the logits, and with the same
seeded generators the tokens, are the same everywhere. Decisions read
from a clock (deadlines) are rank 0's, broadcast, and ``on_token``
callbacks fire on rank 0 only. ``mesh=`` (the reference's single
controller) raises and points to ``group=``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import tp_overlap as _tpov
from ..flags import get_flags
from ..models.generation import _mask_logits, _sample
from ..models.gpt import compute_dtype
from ..models.params import cast_for_compute, layer_params
from ..ops import quant_gemm as _qgemm
from . import metrics
from . import paged_decode
from . import quant as _squant
from .mp_forward import shard_serving_params
from .paged_attention import new_pool, paged_forward
from .paged_kv import PagedKVPool, pages_for
from .request import (EXPIRED, FINISHED, LENGTH, QUEUED, RUNNING, STOP,
                      Request)
from .scheduler import QueueFullError, Scheduler

# Engine options of the reference that later slices of the port bring,
# with the ROADMAP.md item that brings each. Passing one raises instead
# of being ignored.
_LATER_SLICES = {
    "model": "Queue A item 14 (the GPTForCausalLM Layer of the eager API)",
    "prefill_buckets": "Queue A item 7 (the pooled-layout baseline)",
    "speculate_k": "Queue A item 9 (speculative decoding)",
    "draft_source": "Queue A item 9 (speculative decoding)",
    "draft_layers": "Queue A item 9 (speculative decoding)",
    "adapter_slots": "Queue A item 9 (adapters)",
    "adapter_rank": "Queue A item 9 (adapters)",
    "tenant_adapters": "Queue A item 9 (adapters)",
    "priority": "Queue A item 10 (SLO scheduling, slo.py)",
    "tenant_weights": "Queue A item 10 (SLO scheduling, slo.py)",
    "shed": "Queue A item 10 (SLO scheduling, slo.py)",
    "role": "Queue A item 10 (disaggregated prefill/decode)",
    "anomaly": "Queue A item 10 (serving state and fleet)",
    "trace": "Queue A item 10 (observability/tracing.py)",
    "tag": "Queue A item 10 (serving state and fleet)",
    "params_version": "Queue A item 10 (serving state and fleet)",
}


class Engine:
    """Continuous-batching serving engine over a paged KV pool::

        eng = serving.Engine(params=params, config=cfg, num_slots=8)
        eng.submit(serving.Request([1, 2, 3], max_new_tokens=32,
                                   eos_token_id=50256, on_token=stream_cb))
        results = eng.run()        # drain queue + slots

    ``params`` is an ``init_gpt_params``-layout tree (any device/dtype; it
    is cast once for the compute dtype and moved to ``device``). Defaults
    come from FLAGS_serving_* (flags.py); keyword arguments override.
    ``device=None`` means CUDA, the group's device with ``group=``.

    Tensor-parallel: ``group`` (``distributed.env.MPGroup``; the degree is
    its size, and ``mp``, when given, must equal it) and ``comm_backend``
    ("gspmd" | "ring" | "fused"; default from FLAGS_comm_backend)."""

    def __init__(self, params=None, *, config=None, num_slots=None,
                 max_seq_len=None, max_queue=None, top_k=None,
                 kv_layout=None, page_size=None, num_pages=None,
                 prefill_chunk=None, prefix_cache=None, device=None,
                 quant=None, mp=None, comm_backend=None, group=None,
                 mesh=None, **later):
        if mesh is not None:
            raise NotImplementedError(
                "Engine(mesh=...) is the reference's single-controller "
                "API; the port's tensor-parallel serving (ROADMAP Queue A "
                "item 11) is SPMD over torch.distributed: run one Engine "
                "per rank with group= (distributed.env.launch or "
                "init_mp_group) and mp=")
        for name, value in later.items():
            if name not in _LATER_SLICES:
                raise TypeError(f"Engine() got an unexpected keyword "
                                f"argument {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet: it comes with "
                    f"{_LATER_SLICES[name]} in ROADMAP.md")
        if params is None or config is None:
            raise ValueError("Engine needs params= (init_gpt_params layout) "
                             "and config=")
        flags = get_flags()
        self.kv_layout = kv_layout or flags["FLAGS_serving_kv_layout"]
        if self.kv_layout == "pooled":
            raise NotImplementedError(
                "kv_layout='pooled' is not ported yet: it comes with "
                f"{_LATER_SLICES['prefill_buckets']} in ROADMAP.md")
        if self.kv_layout != "paged":
            raise ValueError(f"kv_layout must be 'paged', got "
                             f"{self.kv_layout!r}")
        self.device = resolve_device(
            group.device if device is None and group is not None
            else device)
        self.config = config
        self._init_mp(config, mp, comm_backend, group)
        # quantized serving: resolve the dtype config first; it decides the
        # stored weight leaves, the pool's storage dtype and its scales.
        # The weights quantize as the caller passed them, before the
        # compute casts, and missing KV clips are calibrated on them.
        self._quant = _squant.resolve(quant, flags)
        if self._quant is not None:
            _squant.validate(self._quant, params, config)
            if self.group is None:
                self._quant = _squant.ensure_kv_clips(self._quant, params,
                                                      config)
            elif self._quant.quantizes_kv:
                self._quant = self._rank0_kv_clips(params, config)
        if self.mp > 1:
            self.params = shard_serving_params(
                params, config, self.mp, group.rank,
                self._mp_cfg.shard_vocab, self.device, self._quant)
        else:
            if self._quant is not None and self._quant.quantizes_weights:
                params = _squant.quantize_params(params, config, self._quant)
            self.params = cast_for_compute(params, config, self.device)
        self._layers = layer_params(self.params)
        self.num_slots = int(num_slots or flags["FLAGS_serving_slots"])
        self.max_seq_len = int(max_seq_len or
                               flags["FLAGS_serving_max_seq_len"] or
                               config.max_seq_len)
        if self.max_seq_len > config.max_seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's wpe "
                f"table ({config.max_seq_len})")
        self.scheduler = Scheduler(
            int(max_queue or flags["FLAGS_serving_max_queue"]))
        self.top_k = (None if top_k in (None, 0)
                      else min(int(top_k), config.vocab_size))

        self.page_size = int(page_size or flags["FLAGS_serving_page_size"])
        self.prefill_chunk = int(prefill_chunk or
                                 flags["FLAGS_serving_prefill_chunk"])
        if self.prefill_chunk < self.page_size:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be >= "
                f"page_size ({self.page_size})")
        # the chunk LADDER: power-of-two multiples of page_size up to
        # prefill_chunk. Bulk prefill rides the largest rung; the tail
        # steps down so the final chunk pads fewer than page_size tokens.
        self._chunk_ladder = [self.page_size]
        while self._chunk_ladder[-1] * 2 <= self.prefill_chunk:
            self._chunk_ladder.append(self._chunk_ladder[-1] * 2)
        if prefix_cache is None:
            prefix_cache = bool(flags["FLAGS_serving_prefix_cache"])
        B = self.num_slots
        kv_dtype = "bf16" if self._quant is None else self._quant.kv_dtype
        self._kv_quant = kv_dtype != "bf16"
        pool_kw = {}
        if self._kv_quant:
            pool_kw = dict(kv_dtype=kv_dtype, num_layers=config.num_layers,
                           k_clip=self._quant.kv_k_clip,
                           v_clip=self._quant.kv_v_clip,
                           qmax=_squant.QMAX[kv_dtype])
        self.pool = PagedKVPool(
            B, self.max_seq_len, self.page_size,
            num_pages=int(num_pages or flags["FLAGS_serving_num_pages"] or 0),
            prefix_cache=prefix_cache, **pool_kw)

        nh = config.num_heads
        d = config.hidden_size // nh
        nh_l = nh // self.mp             # the heads of this rank's pool
        dtype = compute_dtype(config)
        store = _squant.STORE_DTYPES[kv_dtype] if self._kv_quant else dtype
        self.use_kernel = bool(flags["FLAGS_serving_paged_kernel"])
        if self.use_kernel and self.device.type == "cuda":
            why = paged_decode.unsupported_reason(d, self.page_size, store)
            if why:
                raise ValueError(
                    f"the paged decode kernel cannot serve this config "
                    f"({why}); set FLAGS_serving_paged_kernel=False to "
                    f"decode through the gather path")
            paged_decode.build()      # nvcc now, not in the first TTFT
        self.quant_kernel = (self._quant is not None
                             and self._quant.quantizes_weights
                             and bool(flags["FLAGS_serving_quant_kernel"]))
        if self.quant_kernel and self.device.type == "cuda":
            self._check_quant_gemm_shapes(dtype)
            _qgemm.build()
        if self.mp > 1 and self._mp_cfg.backend == "fused" and \
                self.device.type == "cuda":
            blocks = self.params["blocks"]
            _tpov.resolve_serving(config, self.mp, "fused", self.device, {
                "out_w": blocks["out_w"].dtype,
                "down_w": blocks["down_w"].dtype,
                "head_w": self.params["head_w"].dtype})
            _qgemm.build()
        # zero-initialized: masked keys of unwritten pages are read as
        # 0 * V, which must stay finite
        shape = (config.num_layers, self.pool.num_pages, self.page_size,
                 nh_l, d)
        self._kc = new_pool(shape, store, self.device)
        self._vc = new_pool(shape, store, self.device)
        # a quantized pool's (k, v) per-page scales [L, P] on the device:
        # the pool's host arrays are the authority, a copy-on-write updates
        # both, so no dispatch uploads them
        self._kv_scales = None
        if self._kv_quant:
            self._kv_scales = tuple(
                torch.from_numpy(sc).to(self.device)
                for sc in (self.pool.k_scale, self.pool.v_scale))
        if self._quant is not None:
            scales = _squant.scale_bytes(self.params)
            if self._kv_quant:
                scales += self.pool.k_scale.nbytes + self.pool.v_scale.nbytes
            metrics.set_quant_info(
                self._quant.weight_dtype, self._quant.kv_dtype,
                scale_bytes=scales,
                kv_bytes_per_token=self.kv_bytes_per_token())

        # host-authoritative per-slot state
        self._slots = [None] * B          # Request or None
        self._pos = np.zeros(B, np.int32)       # write position of next token
        self._tok = np.zeros(B, np.int32)       # last emitted token
        self._temp = np.ones(B, np.float32)
        self._top_p = np.ones(B, np.float32)
        self._do_sample = np.zeros(B, bool)
        self._gens = [None] * B           # per-request torch.Generator
        # next prompt index to prefill (== prompt_len once decoding) and
        # the admission sequence that keeps chunked prefill FCFS
        self._chunk_off = np.zeros(B, np.int32)
        self._admit_seq = np.zeros(B, np.int64)
        self._admit_count = 0
        self._results = {}                # request_id -> GenerationResult

    def _rank0_kv_clips(self, params, config):
        """The KV clip ranges of a quantized pool under mp: rank 0's
        (calibrated on rank 0 where the spec has none), broadcast, so that
        every rank's page scales are the same bits."""
        spec = self._quant
        if self.group.rank == 0:
            spec = _squant.ensure_kv_clips(spec, params, config)
            clips = np.stack([np.broadcast_to(np.asarray(c, np.float64),
                                              (config.num_layers,))
                              for c in (spec.kv_k_clip, spec.kv_v_clip)])
        else:
            clips = np.zeros((2, config.num_layers))
        t = self.group.broadcast(torch.from_numpy(clips).to(self.device))
        k_clip, v_clip = t.cpu().numpy()
        return dataclasses.replace(spec, kv_k_clip=k_clip, kv_v_clip=v_clip)

    def _init_mp(self, config, mp, comm_backend, group):
        """Resolve the tensor-parallel degree and rung: the degree is the
        group's size (1 without a group); ``mp``, when given, is checked
        against it."""
        if mp is None:
            mp = group.n if group is not None else 1
        mp = max(int(mp), 1)
        if mp > 1 and group is None:
            raise ValueError(
                f"mp={mp} needs group= (a distributed.env.MPGroup of {mp} "
                f"ranks: distributed.env.launch or init_mp_group); the "
                f"port's tensor-parallel serving is SPMD, one Engine per "
                f"rank")
        if group is not None and group.n != mp:
            raise ValueError(f"mp={mp} but the group has {group.n} ranks")
        if group is not None:
            if self.device.type != group.device.type or \
                    self.device.index not in (None, group.device.index):
                raise ValueError(f"the engine's device {self.device} is "
                                 f"not the group's {group.device}")
            self.device = group.device
        self.mp = mp
        self.group = group if mp > 1 else None
        self._mp_cfg = _tpov.resolve_serving(config, mp, comm_backend)
        self._mp_records = {}           # dispatch shape -> MpStepRecord
        if self._mp_cfg is not None:
            metrics.set_mp_info(mp, self._mp_cfg.backend)

    def _check_quant_gemm_shapes(self, dtype):
        """Refuse, at build, a config whose quantized GEMMs the kernel
        cannot take (the blocks' x is the compute dtype, the head's fp32)."""
        blocks = self.params["blocks"]
        gemms = [(name, blocks[name].shape[1:], dtype)
                 for name in _squant.BLOCK_WEIGHTS]
        gemms.append(("head_w", self.params["head_w"].shape, torch.float32))
        for name, (K, F), x_dtype in gemms:
            why = _qgemm.unsupported_reason(K, F, blocks["qkv_w"].dtype,
                                            x_dtype)
            if why:
                raise ValueError(
                    f"the quant GEMM kernel cannot serve {name} [{K}, {F}] "
                    f"({why}); set FLAGS_serving_quant_kernel=False to run "
                    f"the plain quantized GEMM")

    # -- submission ----------------------------------------------------------
    def submit(self, request):
        """Queue a request (FCFS). Raises QueueFullError past max_queue and
        ValueError for requests the pool can never hold."""
        if not isinstance(request, Request):
            request = Request(request)
        if request.state != QUEUED:
            raise ValueError(f"request {request.request_id} already "
                             f"{request.state}; requests are single-use")
        if self.group is not None and self.group.rank != 0:
            request.on_token = None       # callbacks fire on rank 0 only
        metrics.bump("submitted")
        plen = request.prompt_len
        if plen + request.max_new_tokens > self.max_seq_len:
            metrics.bump("rejected")
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the KV table capacity "
                f"max_seq_len ({self.max_seq_len})")
        # worst-case demand is exactly the lifetime page count (a CoW spare
        # is needed only when a page is shared, and each shared page saves
        # a fresh one); a request that can NEVER fit fails now instead of
        # blocking the FCFS head forever
        worst = pages_for(plen + request.max_new_tokens, self.page_size)
        if worst > self.pool.num_pages - 1:
            metrics.bump("rejected")
            raise ValueError(f"request needs up to {worst} KV pages but the "
                             f"pool only has {self.pool.num_pages - 1}")
        if request.top_k not in (None, self.top_k):
            metrics.bump("rejected")
            raise ValueError(
                f"request top_k={request.top_k} differs from the engine's "
                f"top_k={self.top_k}; construct the Engine with that top_k")
        if request.do_sample and request.top_k is None \
                and self.top_k is not None:
            metrics.bump("rejected")
            raise ValueError(
                f"sampled request with top_k=None on an engine built with "
                f"top_k={self.top_k}; pass top_k={self.top_k} or serve it "
                f"from an Engine built with top_k=None")
        if request.max_new_tokens == 0:
            request.submit_t = time.perf_counter()
            self._resolve(request, LENGTH)
            return request
        try:
            self.scheduler.submit(request)
        except QueueFullError:
            metrics.bump("rejected")
            raise
        return request

    # -- one engine iteration ------------------------------------------------
    def step(self):
        """One scheduling boundary + one iteration: evict expired
        requests, admit queued ones into free slots (page-aware), advance
        prefill chunks and decode one token for every decoding slot.
        Returns True while any work remains."""
        is_expired = self._deadline_check()
        for b, req in enumerate(self._slots):
            if req is not None and is_expired(req):
                self._free_slot(b)
                self._resolve(req, EXPIRED, count="expired")
        expired = self.scheduler.expire(is_expired=is_expired)
        free = [b for b, r in enumerate(self._slots) if r is None]
        admitted, admit_expired = self.scheduler.admit(
            len(free), fits=self._try_reserve, is_expired=is_expired)
        for req in expired + admit_expired:
            self._resolve(req, EXPIRED, count="expired")
        for req, b in zip(admitted, free):
            self._admit_paged(req, b)

        active = sum(r is not None for r in self._slots)
        metrics.observe_boundary(self.scheduler.qsize(), active,
                                 self.num_slots)
        metrics.observe_pages(self.pool.pages_in_use,
                              self.pool.num_pages - 1)
        if active:
            self._iterate_paged()
        return self.scheduler.qsize() > 0 or \
            any(r is not None for r in self._slots)

    def _deadline_check(self):
        """The boundary's deadline predicate. With mp, rank 0's clock
        decides for every rank: when any request in a slot or the queue
        has a deadline (the same requests on every rank), rank 0's verdicts
        are broadcast once, so no rank frees a slot the others keep."""
        now = time.perf_counter()
        if self.mp <= 1:
            return lambda req: req.expired(now)
        live = [r for r in self._slots if r is not None] + \
            self.scheduler.pending()
        timed = [r for r in live if r.deadline_s is not None]
        if not timed:
            return lambda req: False
        verdict = torch.tensor([r.expired(now) for r in timed],
                               dtype=torch.uint8, device=self.device)
        self.group.broadcast(verdict, src=0)
        gone = {id(r) for r, v in zip(timed, verdict.tolist()) if v}
        return lambda req: id(req) in gone

    def _upload(self, arr):
        """One host->device copy of a packed operand: pinned and
        non-blocking on CUDA (PyTorch's caching host allocator keeps the
        pinned block until its copy has run)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.no_grad()
    def _paged_step(self, ids, start, valid, emit, table, rows):
        """One dispatch of the fused step. ids [R, T] is the token window of
        the slots ``rows`` (R = len(rows)) at offsets ``start`` with
        ``valid`` real tokens; ``emit`` marks rows whose logits produce a
        token. Returns the next tokens [R] on the host when any row emits,
        else None (no host sync)."""
        R, T = ids.shape
        sample = self._do_sample[rows] & emit
        u = np.zeros(R, np.float32)
        for i, b in enumerate(rows):
            if sample[i]:
                u[i] = torch.rand((), generator=self._gens[b]).item()
        ints = self._upload(np.concatenate(
            [ids.ravel(), start, valid, sample, table.ravel()]
        ).astype(np.int32))
        floats = self._upload(np.concatenate(
            [self._temp[rows], self._top_p[rows], u]).astype(np.float32))
        o = R * T
        ids_t = ints[:o].view(R, T)
        start_t, valid_t, sample_t = ints[o:o + 3 * R].view(3, R)
        table_t = ints[o + 3 * R:].view(R, -1)
        temp_t, top_p_t, u_t = floats.view(3, R)

        logits = paged_forward(self.params, self.config, ids_t, self._kc,
                               self._vc, start_t, valid_t, table_t,
                               self.page_size, self.use_kernel,
                               layers=self._layers,
                               kv_scales=self._kv_scales,
                               wq_kernel=self.quant_kernel,
                               mp=None if self.mp <= 1
                               else (self.group, self._mp_cfg))
        self._record_mp(R, T)
        nxt = torch.argmax(logits, dim=-1)
        if sample.any():
            nucleus = top_p_t if (self._top_p[rows][sample] < 1.0).any() \
                else None
            drawn = _sample(_mask_logits(logits, temp_t, self.top_k,
                                         nucleus), u_t)
            nxt = torch.where(sample_t.bool(), drawn, nxt)
        if not emit.any():
            return None
        return nxt.cpu().numpy()

    def _record_mp(self, B, T):
        """The mp counters of one dispatch at window [B, T]: its static
        wire record (tp_overlap.serving_step_record) into the serving
        ledger. Nothing at mp == 1."""
        if self.mp <= 1:
            return
        rec = self._mp_records.get((B, T))
        if rec is None:
            rec = _tpov.serving_step_record(self.config, self._mp_cfg, B, T)
            self._mp_records[(B, T)] = rec
        metrics.bump("mp_steps")
        metrics.bump("mp_collectives", rec.collectives)
        metrics.bump("mp_wire_bytes", rec.ag_bytes)
        metrics.bump("mp_fused_dispatches", rec.fused_dispatches)

    def _cow(self, b, start, end):
        """Copy-on-write guard: split any shared page in [start, end) of
        slot b to a fresh page before the dispatch that writes the
        range."""
        for src, dst in self.pool.make_writable(b, start, end):
            if self._kv_quant:
                # one-byte pages move as uint8, with their page scales
                for pool in (self._kc, self._vc):
                    raw = pool.view(torch.uint8)
                    raw[:, dst] = raw[:, src]
                for sc in self._kv_scales:
                    sc[:, dst] = sc[:, src]
            else:
                self._kc[:, dst] = self._kc[:, src]
                self._vc[:, dst] = self._vc[:, src]
            metrics.bump("cow_copies")

    def _iterate_paged(self):
        """One boundary: the FCFS-oldest slots still consuming their prompt
        advance by one chunk each ([1, chunk] dispatches; how many scales
        with idle decode capacity), then every decode-ready slot emits
        one token ([B, 1] dispatch). Mid-prefill slots ride the decode
        dispatch inert: valid=0 routes their writes to the trash page."""
        B = self.num_slots
        t_boundary = time.perf_counter()
        prefilling = sorted(
            (b for b in range(B) if self._slots[b] is not None
             and self._chunk_off[b] < self._slots[b].prompt_len),
            key=lambda x: self._admit_seq[x])
        n_dec = sum(1 for b in range(B) if self._slots[b] is not None
                    and self._chunk_off[b] >= self._slots[b].prompt_len)
        # prefill budget scales with IDLE decode capacity: while the batch
        # ramps up several prompts chunk per boundary; once half the slots
        # decode, one chunk rides along
        for b in prefilling[:max(1, B // 2 - n_dec)]:
            self._prefill_chunk(b)

        decoding = [b for b in range(B) if self._slots[b] is not None
                    and self._chunk_off[b] >= self._slots[b].prompt_len]
        if not decoding:
            return
        valid = np.zeros(B, np.int32)
        emit = np.zeros(B, bool)
        valid[decoding] = 1
        emit[decoding] = True
        for b in decoding:
            self._cow(b, int(self._pos[b]), int(self._pos[b]) + 1)
        t0 = time.perf_counter()
        nxt = self._paged_step(self._tok[:, None], self._pos, valid, emit,
                               self.pool.table, np.arange(B))
        now = time.perf_counter()
        metrics.bump("paged_steps")
        metrics.add_time("decode_time_s", now - t0)
        # the gap a decode stream observes spans the whole boundary,
        # interleaved prefill chunks and CoW copies included
        metrics.observe_token_latency(now - t_boundary, 1)
        for b in decoding:
            self._pos[b] += 1
            self._emit_token(self._slots[b], b, int(nxt[b]), first=False)

    def _prefill_chunk(self, b):
        """Advance slot b's prefill by one chunk ([1, rung] dispatch); the
        final chunk emits the request's first token."""
        req = self._slots[b]
        plen = req.prompt_len
        off = int(self._chunk_off[b])
        remaining = plen - off
        # largest ladder rung <= the page-rounded remainder
        target = min(-(-remaining // self.page_size) * self.page_size,
                     self._chunk_ladder[-1])
        C = max(c for c in self._chunk_ladder if c <= target)
        v = min(C, remaining)
        last = off + v >= plen
        ids = np.zeros((1, C), np.int32)
        ids[0, :v] = req.prompt[off:off + v]
        self._cow(b, off, off + v)
        t0 = time.perf_counter()
        nxt = self._paged_step(
            ids, np.array([off], np.int32), np.array([v], np.int32),
            np.array([last]), self.pool.table[b:b + 1], np.array([b]))
        t1 = time.perf_counter()
        metrics.bump("paged_steps")
        metrics.bump("chunk_steps")
        metrics.bump("prefill_chunks")
        metrics.add_time("prefill_time_s", t1 - t0)
        if not last:
            self._chunk_off[b] = off + v
            return
        self._chunk_off[b] = plen
        self._pos[b] = plen                   # the next decode writes here
        metrics.observe_prefill_waste(C - v)
        self._emit_token(req, b, int(nxt[0]), first=True)

    def _emit_token(self, req, b, tok, first):
        req._emit(tok)
        metrics.bump("tokens_out")
        self._tok[b] = tok
        if first:
            metrics.observe_ttft(req.first_token_t - req.submit_t)
        if req.stop_token_ids and tok in req.stop_token_ids:
            self._free_slot(b)
            self._resolve(req, STOP)
        elif len(req.tokens) >= req.max_new_tokens:
            self._free_slot(b)
            self._resolve(req, LENGTH)

    def _try_reserve(self, req):
        """Page-aware admission predicate (the scheduler's ``fits``): pin
        the longest cached prompt prefix, then allocate every page the
        request can touch in its WHOLE lifetime (prompt + max_new_tokens,
        plus a copy-on-write spare when a shared page overlaps the write
        range). Returns False, pool untouched, when pages do not suffice;
        the FCFS head then waits for running requests to release pages."""
        pool = self.pool
        ps = self.page_size
        plen = req.prompt_len
        total = pages_for(plen + req.max_new_tokens, ps)
        m, shared, _ = pool.lookup(req.prompt)
        # at least the last prompt token is (re-)forwarded so the first
        # emitted token has logits, even on an exact-prompt hit
        chunk_start = min(m, plen - 1)
        n_shared = len(shared)
        pool.incref(shared)       # pin before eviction can drop the entries
        spare_needed = n_shared > 0 and n_shared - 1 >= chunk_start // ps
        got = pool.try_alloc((total - n_shared) + (1 if spare_needed else 0))
        if got is None:
            pool.decref(shared)
            return False
        spare = got.pop() if spare_needed else None
        req._page_plan = (chunk_start, shared, got, spare)
        if pool.prefix_cache_enabled:
            metrics.bump("prefix_lookups")
        if n_shared:
            metrics.bump("prefix_hits")
            metrics.bump("prefix_tokens_reused", chunk_start)
        return True

    def _admit_paged(self, req, b):
        """Bind slot b to the page plan ``_try_reserve`` made: cached prefix
        pages map logical 0..n_shared-1, fresh pages the rest. No forward
        runs here: the prompt prefills chunk by chunk inside the fused
        step."""
        chunk_start, shared, private, spare = req._page_plan
        del req._page_plan
        self.pool.map_slot(b, list(shared) + list(private), spare)
        req.state = RUNNING
        req.slot = b
        self._slots[b] = req
        self._chunk_off[b] = chunk_start
        self._admit_count += 1
        self._admit_seq[b] = self._admit_count
        self._pos[b] = 0
        self._tok[b] = 0
        self._gens[b] = torch.Generator().manual_seed(int(req.seed))
        self._do_sample[b] = bool(req.do_sample)
        self._temp[b] = float(req.temperature)
        self._top_p[b] = 1.0 if req.top_p is None else float(req.top_p)
        metrics.bump("admitted")

    def _free_slot(self, b):
        req = self._slots[b]
        if req is not None and int(self._chunk_off[b]) >= req.prompt_len:
            # publish the prompt's pages for prefix reuse ON RELEASE: the
            # slot never decodes into a cache-pinned page. Generated KV in
            # the partial last page is harmless: a consumer CoW-copies that
            # page before its first write and never unmasks a position it
            # has not written itself.
            self.pool.register(req.prompt, b)
        self._slots[b] = None
        self._pos[b] = 0
        self._tok[b] = 0
        self._chunk_off[b] = 0
        self._gens[b] = None
        self._temp[b] = 1.0
        self._top_p[b] = 1.0
        self._do_sample[b] = False
        self.pool.release_slot(b)

    def _resolve(self, req, reason, count="completed"):
        if req.state != FINISHED:
            req._finish(reason)
        req.slot = None
        self._results[req.request_id] = req.result()
        metrics.bump(count)
        if reason in (STOP, LENGTH):
            metrics.bump(f"finished_{reason}")

    # -- draining ------------------------------------------------------------
    def pop_results(self):
        """{request_id: GenerationResult} of everything resolved since the
        last call; forgets them."""
        out, self._results = self._results, {}
        return out

    def run(self, requests=None):
        """Submit ``requests`` (optional) and step until queue and slots are
        empty. Returns {request_id: GenerationResult} for everything that
        resolved during this call (earlier submissions included)."""
        if requests is not None:
            for r in requests:
                self.submit(r)
        while self.step():
            pass
        return self.pop_results()

    def generate(self, prompts, **kw):
        """Batch convenience: one Request per prompt (shared kwargs),
        results in submission order."""
        reqs = [Request(p, **kw) for p in prompts]
        results = self.run(reqs)
        return [results[r.request_id] for r in reqs]

    # -- introspection -------------------------------------------------------
    def kv_bytes_per_token(self):
        """KV bytes one token position costs this rank at its dtype config:
        K + V over all layers and this rank's heads (all of them at
        mp == 1, nh/mp under mp), plus a quantized pool's two fp32 scales
        per (layer, page) shared by page_size tokens (rounded up;
        replicated on every rank)."""
        cfg = self.config
        per_tok = 2 * cfg.num_layers * (cfg.hidden_size // self.mp) * \
            self._kc.element_size()
        if self._kv_quant:
            per_tok += -(-2 * cfg.num_layers * 4 // self.page_size)
        return per_tok

    def kv_shard_bytes(self):
        """Bytes of one of the two KV pool arrays on this rank at the pool's
        storage dtype: the whole pool at mp == 1, its head shard (1/mp)
        under mp."""
        return self._kc.numel() * self._kc.element_size()

    @property
    def active_slots(self):
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self):
        return self.scheduler.qsize()
