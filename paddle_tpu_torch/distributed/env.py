"""Process groups for tensor and pipeline parallelism (counterpart of
``paddle_tpu/distributed/env.py``'s ``create_single_axis_mesh`` and of
``serving/mp_forward.py:396`` ``replica_mesh``).

The reference is single-controller: one process drives every chip through
a 1-D ``('mp',)`` mesh. The port is SPMD in PyTorch's idiom: one process
per rank, each running the same program on its own shards, joined by a
``torch.distributed`` process group. ``MPGroup`` is what the serving
engine and the training step hold: the group, this rank, the degree, the
device and the few collectives their schedules use (all-gathers and ring
hops for serving; also all-reduces, reduce-scatters and ring hops posted
ahead of a GEMM for training; for a pipeline whose ranks are its
stages, hops to the next and the previous stage with no wrap-around,
``stage_hops_async``; and for data parallelism, whose ranks are the
replicas, the exchange of equal row blocks, ``all_to_all_rows``).

Layouts (the caller chooses; nothing here falls back from one to another):

* ``"cpu"``: every rank on the CPU, gloo (the tests);
* ``"shared"``: every rank on ``cuda:(rank % device_count)``, gloo, for a
  machine with fewer cards than ranks (NCCL refuses two ranks on one
  card). gloo's all-gathers take the CUDA tensors as they are (they copy
  through host memory inside gloo; checked on an H100 with torch 2.11);
  its broadcast, all-reduce, reduce-scatter, all-to-all and
  point-to-point ops are given host copies here;
* ``"per_card"``: rank r on ``cuda:r``, NCCL; needs a card per rank.

``launch(n, fn, *args, layout=...)`` spawns the ranks, each of which runs
``fn(group, *args)``, and returns their results in rank order. The
rendezvous is a ``file://`` path in a fresh temporary directory, so
concurrent launches (tests under xdist) never share a port, and every
group has a timeout, so a rank that diverges raises instead of hanging.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from . import peer

LAYOUTS = {"cpu": "gloo", "shared": "gloo", "per_card": "nccl"}


@dataclass
class MPGroup:
    """One rank's view of a tensor-parallel group: the process's default
    ``torch.distributed`` group, ``init_mp_group``'s."""
    rank: int
    n: int
    backend: str                  # "gloo" | "nccl"
    device: torch.device
    # rows 10-11's peer-memory channels by purpose (``distributed.peer``)
    peer_channels: dict = field(default_factory=dict, repr=False,
                                compare=False)

    @property
    def stage_host(self):
        """gloo over CUDA tensors: broadcast and point-to-point ops are
        given host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- the collectives of the gather-only schedule ----------------------
    def all_gather_into(self, out, inp):
        """``out`` [n * rows, ...] <- every rank's ``inp`` [rows, ...] in
        rank order (concatenated along dim 0). ``inp`` may be this rank's
        slot of ``out``: the gather is then in place."""
        dist.all_gather_into_tensor(out, inp)
        return out

    def all_gather_list(self, inp):
        """Every rank's ``inp`` as a list in rank order (out of place)."""
        outs = [torch.empty_like(inp) for _ in range(self.n)]
        dist.all_gather(outs, inp)
        return outs

    def ring_shift(self, send, reverse=False):
        """One ring hop: send ``send`` to rank + 1, return what rank - 1
        sent (same shape and dtype); ``reverse`` hops the other way."""
        return self.ring_shift_async(send, reverse).wait()

    def ring_shift_async(self, send, reverse=False):
        """Post one ring hop (as ``ring_shift``) and return its
        ``RingHop`` at once; ``.wait()`` gives the received tensor. Under
        NCCL the hop runs on NCCL's stream while the caller's stream goes
        on (a GEMM launched now overlaps it), and ``wait`` makes the
        caller's current stream wait for the receive. The hop holds its
        send and receive buffers until it has been waited on."""
        step = -1 if reverse else 1
        right, left = (self.rank + step) % self.n, (self.rank - step) % self.n
        staged = self.stage_host
        src = send.cpu() if staged else send.contiguous()
        recv = torch.empty(src.shape, dtype=src.dtype, device=src.device)
        ops = [dist.P2POp(dist.isend, src, right),
               dist.P2POp(dist.irecv, recv, left)]
        return RingHop(dist.batch_isend_irecv(ops), src, recv,
                       self.device if staged else None)

    # -- the collectives of the training schedule --------------------------
    def all_reduce_(self, t, op="sum"):
        """``t`` summed (or ``op="max"``: the maximum) over the ranks, in
        place; returned."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self.stage_host:
            host = t.cpu()
            dist.all_reduce(host, red)
            return t.copy_(host)
        dist.all_reduce(t, red)
        return t

    def reduce_scatter_into(self, out, inp):
        """``out`` [rows, ...] <- the sum over the ranks of block ``rank``
        of every rank's ``inp`` [n * rows, ...] (blocks concatenated along
        dim 0)."""
        if self.stage_host:
            host = torch.empty(out.shape, dtype=out.dtype)
            _reduce_scatter(host, inp.cpu())
            return out.copy_(host)
        _reduce_scatter(out, inp.contiguous())
        return out

    def all_to_all_rows(self, out, inp):
        """``out`` [n * rows, ...] <- block ``rank`` of every rank's ``inp``
        [n * rows, ...] in rank order (block i of ``out`` is rank i's
        block ``rank``): the exchange of equal row blocks of the
        compressed gradient wire. The blocks move as bytes, so any dtype
        goes."""
        if self.stage_host:
            host = torch.empty(out.shape, dtype=out.dtype)
            dist.all_to_all_single(_bytes(host), _bytes(inp.cpu()))
            return out.copy_(host)
        dist.all_to_all_single(_bytes(out), _bytes(inp.contiguous()))
        return out

    def broadcast(self, t, src=0):
        """``t`` from rank ``src`` on every rank (in place, returned)."""
        if self.stage_host:
            host = t.cpu()
            dist.broadcast(host, src)
            t.copy_(host)
            return t
        dist.broadcast(t, src)
        return t

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def stage_hops_async(self, send_next=None, send_prev=None,
                         recv_prev=None, recv_next=None):
        """Post one batch of pipeline stage hops and return its
        ``StageHops`` at once: ``send_next`` (a tensor or None) to rank +
        1, ``send_prev`` to rank - 1, and receives from rank - 1 and rank +
        1 of ``recv_prev`` / ``recv_next`` = (shape, dtype) (or None). No
        hop wraps around: naming a rank outside [0, n) raises. Every op of
        a batch is in flight at once (one NCCL group), so a stage may send
        and receive in both directions in one batch without deadlock; a
        peer must post the matching op in its batch of the same tick.
        Under NCCL ``wait`` makes the caller's current stream wait for the
        batch; under gloo it blocks the host."""
        ops, recvs = [], [None, None]
        staged = self.stage_host
        host = torch.device("cpu") if staged else self.device
        for t, peer in ((send_next, self.rank + 1),
                        (send_prev, self.rank - 1)):
            if t is None:
                continue
            self._peer(peer)
            t = t.detach()
            ops.append(dist.P2POp(dist.isend, t.cpu() if staged else
                                  t.contiguous(), peer))
        for i, (spec, peer) in enumerate(((recv_prev, self.rank - 1),
                                          (recv_next, self.rank + 1))):
            if spec is None:
                continue
            self._peer(peer)
            shape, dtype = spec
            recvs[i] = torch.empty(shape, dtype=dtype, device=host)
            ops.append(dist.P2POp(dist.irecv, recvs[i], peer))
        works = dist.batch_isend_irecv(ops) if ops else []
        return StageHops(works, ops, recvs, self.device if staged else None)

    def _peer(self, peer):
        if not 0 <= peer < self.n:
            raise ValueError(f"rank {self.rank} of {self.n} has no stage "
                             f"{peer}: stage hops do not wrap around")


def _bytes(t):
    """A contiguous tensor as uint8 [rows, row bytes] (dim 0 kept)."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


# the library's reduce-scatter into one tensor (newer torch names it
# reduce_scatter_single and deprecates reduce_scatter_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class StageHops:
    """One posted batch of stage hops (``MPGroup.stage_hops_async``)."""

    def __init__(self, works, ops, recvs, to_device):
        self._works, self._ops, self._recvs = works, ops, recvs
        self._to = to_device          # gloo over CUDA: host copies go back

    def wait(self):
        """(received from rank - 1, received from rank + 1), None where
        nothing was received; every send of the batch is done on return
        (under NCCL: on the caller's stream)."""
        for w in self._works:
            w.wait()
        out = tuple(None if r is None else
                    r.to(self._to) if self._to is not None else r
                    for r in self._recvs)
        self._works = self._ops = self._recvs = None
        return out


class RingHop:
    """One posted ring hop (``MPGroup.ring_shift_async``)."""

    def __init__(self, works, send, recv, to_device):
        self._works, self._send, self._recv = works, send, recv
        self._to = to_device          # gloo over CUDA: the host copy goes back

    def wait(self):
        for w in self._works:
            w.wait()
        recv = self._recv
        self._works = self._send = self._recv = None
        return recv.to(self._to) if self._to is not None else recv


def init_mp_group(rank, n, init_file, layout="cpu", timeout_s=300):
    """Join the ``n``-rank group that rendezvous at ``init_file`` (a path;
    one per group) as ``rank``, with ``layout``'s backend and device (the
    CPU, or ``cuda:(rank % device_count)``). Collectives that wait longer
    than ``timeout_s`` raise."""
    backend = LAYOUTS[layout]
    device = torch.device("cpu")
    if layout != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError(f"layout {layout!r} needs CUDA, but "
                               f"torch.cuda.is_available() is False")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if layout == "per_card" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"layout 'per_card' needs {n} CUDA devices, this machine has "
            f"{torch.cuda.device_count()}; use layout='shared' (gloo) to "
            f"run {n} ranks on fewer cards")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return MPGroup(rank=rank, n=n, backend=backend, device=device)


def _rank_main(rank, n, layout, init_file, timeout_s, results, fn, args):
    try:
        group = init_mp_group(rank, n, init_file, layout, timeout_s)
        try:
            out = fn(group, *args)
            peer.close(group)         # every rank, before it leaves
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(n, fn, *args, layout="cpu", timeout_s=300, init_dir=None):
    """Run ``fn(group, *args)`` in ``n`` spawned ranks of one group and
    return the ``n`` results in rank order. ``fn`` must be importable by
    the children (a module-level function) and its arguments and result
    picklable. Raises, with every failing rank's traceback, when a rank
    fails or dies, or when the run outlasts ``timeout_s`` (the children
    are then terminated); no child outlives the call."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, got "
                         f"{layout!r}")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mp_group_", dir=init_dir)
    init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, layout, init_file, timeout_s, results,
                               fn, args), daemon=True) for r in range(n)]
    out, errors = {}, {}
    deadline = time.monotonic() + timeout_s + 60
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out
                        and r not in errors]
                for r in dead:
                    errors[r] = f"rank {r} died (exit code {procs[r].exitcode})"
                if time.monotonic() > deadline:
                    errors.setdefault(-1, f"launch timed out after "
                                          f"{timeout_s + 60} s")
                    break
                continue
            (out if ok else errors)[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("tensor-parallel launch failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
    return [out[r] for r in range(n)]
