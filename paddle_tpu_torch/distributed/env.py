"""Process groups for tensor, pipeline and data parallelism (counterpart of
``paddle_tpu/distributed/env.py``'s ``create_single_axis_mesh`` and
``create_hybrid_mesh`` and of ``serving/mp_forward.py:396``
``replica_mesh``).

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

A hybrid world (``init_hybrid_groups``, ``launch(..., axes=)``) is the
SPMD counterpart of the reference's ``create_hybrid_mesh(dp=, mp=, pp=)``:
one process per rank, each in one group per mesh axis, every group a
``torch.distributed`` sub-group of the world. Rank coordinates follow the
reference mesh's axis order (``HYBRID_AXES``, paddle_tpu/distributed/
env.py:28: pp slowest, then dp, mp fastest), so rank r is the
reference's device r. An ``MPGroup`` carries its process group and
its members' global ranks; its collectives run on that group alone and
its point-to-point ops name the peers' global ranks.

Layouts (the caller chooses; nothing here falls back from one to another):

* ``"cpu"``: every rank on the CPU, gloo (the tests);
* ``"shared"``: every rank on ``cuda:(rank % device_count)`` (the global
  rank), gloo, for a
  machine with fewer cards than ranks (NCCL refuses two ranks on one
  card). gloo's all-gathers take the CUDA tensors as they are (they copy
  through host memory inside gloo; checked on an H100 with torch 2.11);
  its broadcast, all-reduce, reduce-scatter, all-to-all and
  point-to-point ops are given host copies here;
* ``"per_card"``: rank r on ``cuda:r``, NCCL; needs a card per rank.

``launch(n, fn, *args, layout=...)`` spawns the ranks, each of which runs
``fn(group, *args)`` (with ``axes=``: ``fn(groups, *args)``, a
``HybridGroups``), and returns their results in rank order. The
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
    """One rank's view of a group: the process's default
    ``torch.distributed`` group (``init_mp_group``'s) or one axis's
    sub-group of a hybrid world (``init_hybrid_groups``'s). ``rank`` is
    the rank in the group; a group of one rank runs no collective."""
    rank: int
    n: int
    backend: str                  # "gloo" | "nccl"
    device: torch.device
    # the process group (None: the default group) and the members' global
    # ranks in group-rank order (None: the group is the world, 0 .. n - 1)
    pg: object = field(default=None, repr=False, compare=False)
    ranks: tuple = None
    # rows 10-11's peer-memory channels by purpose, and the heartbeat
    # segment they share (``distributed.peer``)
    peer_channels: dict = field(default_factory=dict, repr=False,
                                compare=False)
    peer_beat: object = field(default=None, repr=False, compare=False)

    def global_rank(self, r):
        """The world rank of this group's rank ``r`` (what point-to-point
        ops name)."""
        return r if self.ranks is None else self.ranks[r]

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
        if self.n == 1:
            return out.copy_(inp)
        dist.all_gather_into_tensor(out, inp, group=self.pg)
        return out

    def all_gather_list(self, inp):
        """Every rank's ``inp`` as a list in rank order (out of place)."""
        if self.n == 1:
            return [inp.clone()]
        outs = [torch.empty_like(inp) for _ in range(self.n)]
        dist.all_gather(outs, inp, group=self.pg)
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
        ops = [dist.P2POp(dist.isend, src, self.global_rank(right),
                          group=self.pg),
               dist.P2POp(dist.irecv, recv, self.global_rank(left),
                          group=self.pg)]
        return RingHop(dist.batch_isend_irecv(ops), src, recv,
                       self.device if staged else None)

    # -- the collectives of the training schedule --------------------------
    def all_reduce_(self, t, op="sum"):
        """``t`` summed (or ``op="max"``: the maximum) over the ranks, in
        place; returned."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self.n == 1:
            return t
        if self.stage_host:
            host = t.cpu()
            dist.all_reduce(host, red, group=self.pg)
            return t.copy_(host)
        dist.all_reduce(t, red, group=self.pg)
        return t

    def reduce_scatter_into(self, out, inp):
        """``out`` [rows, ...] <- the sum over the ranks of block ``rank``
        of every rank's ``inp`` [n * rows, ...] (blocks concatenated along
        dim 0)."""
        if self.n == 1:
            return out.copy_(inp.view(out.shape))
        if self.stage_host:
            host = torch.empty(out.shape, dtype=out.dtype)
            _reduce_scatter(host, inp.cpu(), group=self.pg)
            return out.copy_(host)
        _reduce_scatter(out, inp.contiguous(), group=self.pg)
        return out

    def all_to_all_rows(self, out, inp):
        """``out`` [n * rows, ...] <- block ``rank`` of every rank's ``inp``
        [n * rows, ...] in rank order (block i of ``out`` is rank i's
        block ``rank``): the exchange of equal row blocks of the
        compressed gradient wire. The blocks move as bytes, so any dtype
        goes."""
        if self.n == 1:
            return out.copy_(inp)
        if self.stage_host:
            host = torch.empty(out.shape, dtype=out.dtype)
            dist.all_to_all_single(_bytes(host), _bytes(inp.cpu()),
                                   group=self.pg)
            return out.copy_(host)
        dist.all_to_all_single(_bytes(out), _bytes(inp.contiguous()),
                               group=self.pg)
        return out

    def broadcast(self, t, src=0):
        """``t`` from rank ``src`` on every rank (in place, returned)."""
        if self.n == 1:
            return t
        root = self.global_rank(src)
        if self.stage_host:
            host = t.cpu()
            dist.broadcast(host, root, group=self.pg)
            t.copy_(host)
            return t
        dist.broadcast(t, root, group=self.pg)
        return t

    def barrier(self):
        if self.n == 1:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.pg, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.pg)

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
                                  t.contiguous(), self.global_rank(peer),
                                  group=self.pg))
        for i, (spec, peer) in enumerate(((recv_prev, self.rank - 1),
                                          (recv_next, self.rank + 1))):
            if spec is None:
                continue
            self._peer(peer)
            shape, dtype = spec
            recvs[i] = torch.empty(shape, dtype=dtype, device=host)
            ops.append(dist.P2POp(dist.irecv, recvs[i],
                                  self.global_rank(peer), group=self.pg))
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


def _device_of(rank, n, layout):
    """The device of world rank ``rank`` of ``n`` under ``layout`` (set as
    the process's current CUDA device)."""
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
    return device


def _init_world(rank, n, init_file, layout, timeout_s):
    backend = LAYOUTS[layout]
    device = _device_of(rank, n, layout)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return backend, device


def init_mp_group(rank, n, init_file, layout="cpu", timeout_s=300):
    """Join the ``n``-rank group that rendezvous at ``init_file`` (a path;
    one per group) as ``rank``, with ``layout``'s backend and device (the
    CPU, or ``cuda:(rank % device_count)``). Collectives that wait longer
    than ``timeout_s`` raise."""
    backend, device = _init_world(rank, n, init_file, layout, timeout_s)
    return MPGroup(rank=rank, n=n, backend=backend, device=device)


@dataclass(frozen=True)
class HybridGroups:
    """One rank's groups in a hybrid world: ``dp``, ``mp`` and ``pp``
    (``MPGroup``s; an axis of degree 1 is a group of one), its world
    ``rank`` and the world's size ``world``."""
    dp: MPGroup
    mp: MPGroup
    pp: MPGroup
    rank: int
    world: int

    @property
    def axes(self):
        return {"dp": self.dp.n, "mp": self.mp.n, "pp": self.pp.n}


def hybrid_coords(rank, dp=1, mp=1, pp=1):
    """(pp, dp, mp) coordinates of world rank ``rank`` in the reference
    mesh's order (pp slowest, mp fastest)."""
    return rank // (dp * mp), (rank // mp) % dp, rank % mp


def hybrid_group_ranks(axis, dp=1, mp=1, pp=1):
    """Every ``axis`` group of a dp x mp x pp world as a list of world-rank
    tuples, in the order every rank creates them."""
    groups = {}
    for r in range(pp * dp * mp):
        c = dict(zip(("pp", "dp", "mp"), hybrid_coords(r, dp, mp, pp)))
        key = tuple(v for a, v in c.items() if a != axis)
        groups.setdefault(key, []).append(r)
    return [tuple(g) for g in groups.values()]


def init_hybrid_groups(rank, dp=1, mp=1, pp=1, init_file=None,
                       layout="cpu", timeout_s=300):
    """Join the dp x mp x pp world that rendezvous at ``init_file`` as
    world rank ``rank`` and make its per-axis sub-groups: a
    ``HybridGroups`` of this rank's dp, mp and pp ``MPGroup``s. Rank r has
    the reference mesh's coordinates (``hybrid_coords``), so its mp group
    is r's mp-fastest neighbours, and its device is ``cuda:(r %
    device_count)``. Every rank creates every sub-group of more than one
    rank, axis by axis in one order (``torch.distributed.new_group`` is
    collective over the world); an axis of degree 1 makes no process
    group."""
    for name, v in (("dp", dp), ("mp", mp), ("pp", pp)):
        if int(v) < 1:
            raise ValueError(f"{name} must be >= 1, got {v}")
    world = dp * mp * pp
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    backend, device = _init_world(rank, world, init_file, layout, timeout_s)
    mine = {}
    for axis, n in (("mp", mp), ("dp", dp), ("pp", pp)):
        for ranks in hybrid_group_ranks(axis, dp, mp, pp):
            pg = dist.new_group(list(ranks), backend=backend) if n > 1 \
                else None
            if rank in ranks:
                mine[axis] = MPGroup(rank=ranks.index(rank), n=n,
                                     backend=backend, device=device, pg=pg,
                                     ranks=ranks)
    return HybridGroups(dp=mine["dp"], mp=mine["mp"], pp=mine["pp"],
                        rank=rank, world=world)


def close_groups(groups):
    """Tear down the peer channels of every group of ``groups`` (an
    ``MPGroup`` or a ``HybridGroups``; collective, every rank in the same
    order: mp, dp, pp)."""
    if isinstance(groups, HybridGroups):
        for g in (groups.mp, groups.dp, groups.pp):
            if g.n > 1:
                peer.close(g)
    else:
        peer.close(groups)


_report = None                      # (rank, results) in a spawned rank


def _rank_main(rank, n, layout, init_file, timeout_s, results, fn, args,
               axes):
    global _report
    _report = (rank, results)
    try:
        group = init_mp_group(rank, n, init_file, layout, timeout_s) \
            if axes is None else init_hybrid_groups(
                rank, init_file=init_file, layout=layout,
                timeout_s=timeout_s, **axes)
        try:
            out = fn(group, *args)
            close_groups(group)       # every rank, before it leaves
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, which raises
        peer.stop_heartbeat()       # its peers need not wait for it
        results.put((rank, False, traceback.format_exc()))


def exit_rank(value):
    """End this rank of ``launch`` at once, as a crash would (no teardown,
    no exit handlers; its heartbeat and mappings go with the process),
    after reporting ``value`` as its result: for tests of a peer that
    dies."""
    rank, results = _report
    results.put((rank, True, value))
    results.close()
    results.join_thread()           # the result has left the process
    os._exit(0)


def _context(layout):
    """The start method of ``launch``'s ranks: on the CPU, forks of one
    server process that has imported torch and this package (a spawned
    rank spends seconds importing torch), started once per process; a
    rank that will use a card is spawned."""
    if layout != "cpu":
        return multiprocessing.get_context("spawn")
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", __name__])
    return ctx


def launch(n, fn, *args, layout="cpu", timeout_s=300, init_dir=None,
           axes=None):
    """Run ``fn(group, *args)`` in ``n`` spawned ranks of one group and
    return the ``n`` results in rank order. With ``axes`` (``{"dp": .,
    "mp": ., "pp": .}``, their product ``n``) the ranks form a hybrid world
    and each runs ``fn(groups, *args)`` with its ``HybridGroups``
    (``init_hybrid_groups``). ``fn`` must be importable by the children (a
    module-level function) and its arguments and result picklable. Raises,
    with every failing rank's traceback, when a rank fails or dies, or when
    the run outlasts ``timeout_s`` (the children are then terminated); no
    child outlives the call."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, got "
                         f"{layout!r}")
    if axes is not None:
        if not set(axes) <= {"dp", "mp", "pp"}:
            raise ValueError(f"axes name dp, mp and pp, got {sorted(axes)}")
        axes = {a: int(axes.get(a, 1)) for a in ("dp", "mp", "pp")}
        if axes["dp"] * axes["mp"] * axes["pp"] != n:
            raise ValueError(f"axes {axes} do not multiply to {n} ranks")
    ctx = _context(layout)
    tmp = tempfile.mkdtemp(prefix="mp_group_", dir=init_dir)
    init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, layout, init_file, timeout_s, results,
                               fn, args, axes), daemon=True)
             for r in range(n)]
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
        raise RuntimeError("launch failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
    return [out[r] for r in range(n)]
