"""Request scheduler for the continuous-batching engine (counterpart of
``paddle_tpu/serving/scheduler.py``): strict FCFS admission at step
boundaries.

The scheduler owns the bounded wait queue (``submit`` raises
``QueueFullError`` past ``max_queue``, the backpressure signal a front end
turns into HTTP 429) and per-request deadlines (expired requests are
failed at the boundary instead of occupying a slot). Priority classes,
weighted fair queueing and load shedding come with the SLO slice.
"""
from __future__ import annotations

import time
from collections import deque

from .request import EXPIRED, FINISHED, QUEUED


class QueueFullError(RuntimeError):
    """submit() past ``max_queue``. Carries ``qsize`` and ``max_queue`` so a
    router can back off in proportion."""

    def __init__(self, message, qsize=None, max_queue=None):
        super().__init__(message)
        self.qsize = qsize
        self.max_queue = max_queue


class Scheduler:
    def __init__(self, max_queue=256):
        self.max_queue = int(max_queue)
        self._q = deque()

    def submit(self, req):
        if len(self._q) >= self.max_queue:
            raise QueueFullError(
                f"serving queue full ({self.max_queue} waiting); retry later",
                qsize=len(self._q), max_queue=self.max_queue)
        if req.state != QUEUED:
            raise ValueError(f"request {req.request_id} already "
                             f"{req.state}; requests are single-use")
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        self._q.append(req)

    def qsize(self):
        return len(self._q)

    def pending(self):
        """The queued requests in arrival order (a copy)."""
        return list(self._q)

    @staticmethod
    def _predicate(now, is_expired):
        """``is_expired`` (a caller's verdict per request, e.g. rank 0's
        under tensor parallelism) or the deadline against ``now``."""
        if is_expired is not None:
            return is_expired
        now = time.perf_counter() if now is None else now
        return lambda req: req.expired(now)

    def expire(self, now=None, is_expired=None):
        """Remove and return every queued request whose deadline passed
        (marked EXPIRED), at every boundary, so dead entries never count
        toward backpressure."""
        is_expired = self._predicate(now, is_expired)
        expired = [r for r in self._q if r.state != FINISHED
                   and is_expired(r)]
        for req in expired:
            self._q.remove(req)
            req._finish(EXPIRED)
        return expired

    def admit(self, free_slots, now=None, fits=None, is_expired=None):
        """Pop up to ``free_slots`` requests in arrival order. Requests
        whose deadline passed are popped, marked EXPIRED and returned
        separately. ``fits`` is the paged engine's page-aware predicate: a
        head that does not fit STOPS admission (no bypass), so the order
        stays deterministic and no request starves."""
        is_expired = self._predicate(now, is_expired)
        admitted, expired = [], []
        if free_slots > 0:
            for req in [r for r in self._q if r.state != FINISHED]:
                if len(admitted) >= free_slots:
                    break
                if is_expired(req):
                    self._q.remove(req)
                    req._finish(EXPIRED)
                    expired.append(req)
                    continue
                if fits is not None and not fits(req):
                    break
                self._q.remove(req)
                admitted.append(req)
        return admitted, expired
