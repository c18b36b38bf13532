"""Serving: the paged continuous-batching engine (counterpart of
``paddle_tpu/serving``), with quantized serving (``quant``) and
tensor-parallel serving (``mp_forward``; ``Engine(mp=, comm_backend=,
group=)``)."""
from . import mp_forward, quant
from .engine import Engine
from .metrics import (reset_serving_counters, serving_counters,
                      serving_summary)
from .paged_kv import PagedKVPool, PagePoolExhausted, pages_for
from .quant import QuantSpec, QuantSpecError
from .request import (EXPIRED, FINISHED, LENGTH, QUEUED, RUNNING, STOP,
                      GenerationResult, Request)
from .scheduler import QueueFullError, Scheduler

__all__ = ["Engine", "GenerationResult", "Request", "QueueFullError",
           "Scheduler", "PagedKVPool", "PagePoolExhausted", "pages_for",
           "QuantSpec", "QuantSpecError", "quant", "mp_forward",
           "serving_counters", "serving_summary", "reset_serving_counters",
           "QUEUED", "RUNNING", "FINISHED", "STOP", "LENGTH", "EXPIRED"]
