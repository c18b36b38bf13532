"""The port's page pool and scheduler (paddle_tpu_torch/serving/
paged_kv.py, scheduler.py). The pool runs one seeded sequence of
allocations, mappings, prefix registrations, lookups, copy-on-write
splits and releases side by side with the reference's ``PagedKVPool``:
tables, refcounts, free lists and cache entries must stay identical."""
import numpy as np
import pytest

from paddle_tpu.serving.paged_kv import PagedKVPool as JaxPool
from paddle_tpu_torch.serving import (PagedKVPool, QueueFullError, Request,
                                      Scheduler, pages_for)
from paddle_tpu_torch.serving.request import EXPIRED


def _same(a, b):
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.ref, b.ref)
    assert a._free == b._free
    assert list(a._cache.items()) == list(b._cache.items())
    ba, bb = a.balance(), b.balance()
    assert ba == bb and ba["conserved"] and ba["refcounts_accounted"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_tracks_reference_through_random_traffic(seed):
    rng = np.random.default_rng(seed)
    ps, slots = 4, 3
    mine = PagedKVPool(slots, 32, ps, num_pages=20)
    ref = JaxPool(slots, 32, ps, num_pages=20)
    family = rng.integers(0, 50, 12)
    prompts = {}
    for _ in range(60):
        b = int(rng.integers(slots))
        if b in prompts:                         # release (register first)
            if rng.random() < 0.7:
                for pool in (mine, ref):
                    pool.register(prompts[b], b)
            for pool in (mine, ref):
                pool.release_slot(b)
            del prompts[b]
        else:                                    # admit through lookup
            n = int(rng.integers(1, 13))
            prompt = (family[:n].copy() if rng.random() < 0.5
                      else rng.integers(0, 50, n)).astype(np.int32)
            m, shared, exact = mine.lookup(prompt)
            assert ref.lookup(prompt) == (m, shared, exact)
            need = pages_for(n + 4, ps) - len(shared)
            got = []
            for pool in (mine, ref):
                pool.incref(shared)
                got.append(pool.try_alloc(need))
            assert got[0] == got[1]
            if got[0] is None:
                for pool in (mine, ref):
                    pool.decref(shared)
            else:
                for pool in (mine, ref):
                    pool.map_slot(b, list(shared) + got[0])
                w = min(m, n - 1)
                assert mine.make_writable(b, w, n + 1) == \
                    ref.make_writable(b, w, n + 1)
                prompts[b] = prompt
        _same(mine, ref)
    for b in list(prompts):                      # drain: only pins remain
        for pool in (mine, ref):
            pool.release_slot(b)
    _same(mine, ref)
    assert mine.balance()["in_use"] == len(
        {p for k, v in mine._cache.items()
         for p in ([v] if k[0] == b"P" else v[0])})


def test_trash_page_is_never_handed_out_and_cow_uses_spare():
    pool = PagedKVPool(2, 16, 4, num_pages=6)
    pages = pool.try_alloc(5)
    assert 0 not in pages and sorted(pages) == [1, 2, 3, 4, 5]
    assert pool.try_alloc(1) is None
    pool.decref(pages[3:])
    pool.map_slot(0, pages[:2], spare=pages[2])
    pool.incref([pages[1]])                      # a second owner
    assert pool.make_writable(0, 4, 8) == [(pages[1], pages[2])]
    assert pool.table[0, 1] == pages[2]
    with pytest.raises(ValueError):
        pool.incref([0])


def test_scheduler_is_strict_fcfs_with_expiry_and_backpressure():
    s = Scheduler(max_queue=3)
    reqs = [Request([1, 2], max_new_tokens=1) for _ in range(3)]
    for r in reqs:
        s.submit(r)
    with pytest.raises(QueueFullError) as e:
        s.submit(Request([1]))
    assert e.value.qsize == 3 and e.value.max_queue == 3
    # the head does not fit: admission stops, nothing bypasses it
    admitted, _ = s.admit(3, fits=lambda r: r is not reqs[0])
    assert admitted == []
    admitted, _ = s.admit(2, fits=lambda r: True)
    assert admitted == reqs[:2]
    reqs[2].deadline_s = 0.0
    expired = s.expire(reqs[2].submit_t)
    assert expired == [reqs[2]] and reqs[2].finish_reason == EXPIRED
    assert s.qsize() == 0
