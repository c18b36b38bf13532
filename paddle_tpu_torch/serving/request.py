"""Serving request and result types (counterpart of
``paddle_tpu/serving/request.py``).

A ``Request`` is one generation job: the engine assigns it a slot in the
fixed decode batch, streams tokens to ``on_token`` as they are produced
and resolves it into a ``GenerationResult``. Sampling parameters are
per-slot operands of the shared fused step, so greedy and sampled
requests batch together.
"""
from __future__ import annotations

import itertools
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from ..models.generation import _normalize_stop

_req_ids = itertools.count()

# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"

# finish reasons
STOP = "stop"          # produced a stop token
LENGTH = "length"      # hit max_new_tokens
EXPIRED = "expired"    # deadline passed before/while running


@dataclass(eq=False)  # identity equality: queue removal compares objects
class Request:
    """One generation job. ``prompt`` is a 1-D int sequence;
    ``eos_token_id`` is the scalar alias of ``stop_token_ids`` (merged).
    ``top_k`` must match the engine's static top_k. ``deadline_s`` is a
    deadline relative to submission: an expired request is failed at the
    next step boundary. ``speculate`` ("auto" | "off") opts a request out
    of speculative decoding: on a speculative engine an "off" request
    decodes one token a boundary inside the same verify dispatch; a plain
    engine ignores it. ``priority``, ``tenant`` and ``adapter`` are
    carried for the scheduling and adapter slices and not read yet."""
    prompt: object
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float | None = None
    top_k: int | None = None
    eos_token_id: int | None = None
    stop_token_ids: object = None
    seed: int = 0
    deadline_s: float | None = None
    on_token: object = None          # callback(request, token_id)
    priority: str = "batch"
    tenant: str = "default"
    speculate: str = "auto"
    adapter: int | None = None

    # -- engine-managed state ------------------------------------------------
    request_id: int = field(default_factory=lambda: next(_req_ids))
    state: str = field(default=QUEUED)
    tokens: list = field(default_factory=list)
    slot: int | None = field(default=None)
    submit_t: float | None = field(default=None)
    first_token_t: float | None = field(default=None)
    finish_t: float | None = field(default=None)
    finish_reason: str | None = field(default=None)
    callback_error: object = field(default=None)  # first on_token exception

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.shape[0] == 0:
            raise ValueError("prompt must be non-empty")
        if self.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {self.max_new_tokens}")
        if self.do_sample and self.temperature <= 0:
            raise ValueError(
                f"temperature must be > 0 for sampled requests, got "
                f"{self.temperature} (use do_sample=False for greedy)")
        self.stop_token_ids = _normalize_stop(
            self.eos_token_id, self.stop_token_ids) or ()
        if self.top_k == 0:            # generate's "disabled" spelling
            self.top_k = None
        if self.speculate not in ("auto", "off"):
            raise ValueError(f"speculate must be 'auto' or 'off', got "
                             f"{self.speculate!r}")

    @property
    def prompt_len(self):
        return int(self.prompt.shape[0])

    @property
    def deadline(self):
        """Absolute deadline (perf_counter clock), or None."""
        if self.deadline_s is None or self.submit_t is None:
            return None
        return self.submit_t + self.deadline_s

    def expired(self, now):
        """THE deadline predicate every expiry site uses: expired from the
        first instant ``now >= deadline``."""
        dl = self.deadline
        return dl is not None and now >= dl

    def _emit(self, token):
        self.tokens.append(int(token))
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        if self.on_token is not None:
            try:
                self.on_token(self, int(token))
            except Exception as e:    # noqa: BLE001 — user callback
                # a broken client stream must not unwind step() after the
                # KV pool and sampling state advanced: disable the
                # callback, record the error, finish the request normally
                self.callback_error = e
                self.on_token = None
                warnings.warn(
                    f"request {self.request_id}: on_token callback raised "
                    f"{type(e).__name__}: {e}; streaming disabled for this "
                    f"request (see GenerationResult.callback_error)")

    def _finish(self, reason):
        self.state = FINISHED
        self.finish_reason = reason
        self.finish_t = time.perf_counter()

    def result(self):
        if self.state != FINISHED:
            raise RuntimeError(
                f"request {self.request_id} not finished (state={self.state})")
        return GenerationResult(
            request_id=self.request_id,
            prompt=self.prompt,
            tokens=list(self.tokens),
            finish_reason=self.finish_reason,
            ttft=(None if self.first_token_t is None or self.submit_t is None
                  else self.first_token_t - self.submit_t),
            latency=(None if self.finish_t is None or self.submit_t is None
                     else self.finish_t - self.submit_t),
            callback_error=self.callback_error,
            priority=self.priority,
            tenant=self.tenant,
        )


@dataclass
class GenerationResult:
    """Resolved output of one Request. ``tokens`` are the NEW tokens only
    (the stop token included when one fired); ``sequence`` is prompt +
    tokens."""
    request_id: int
    prompt: np.ndarray
    tokens: list
    finish_reason: str
    ttft: float | None = None
    latency: float | None = None
    callback_error: object = None
    priority: str = "batch"
    tenant: str = "default"

    @property
    def sequence(self):
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def tokens_per_s(self):
        if not self.tokens or not self.latency:
            return 0.0
        return len(self.tokens) / self.latency
