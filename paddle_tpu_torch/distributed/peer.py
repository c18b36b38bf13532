"""Symmetric peer buffers over CUDA IPC: the memory that rows 10 and 11's
one-launch collectives (``ops/fused_collectives.py``: ``fused_rs_bucket``,
``fused_ag_bucket``) read across the ranks of a group, that row 8's
GEMM + reduce-scatter (``ops/ring_gemm.py:ring_gemm_rs``) writes its
partials into, and that rows 7 and 9 (``ring_ag_gemm``,
``ring_ag_accum``) gather their chunks through, and that rows 12-13's
serving GEMM + all-gather (``fused_gemm_ag``) stores its blocks into.

A *channel* is one ``cudaMalloc`` per rank, made by ``csrc/peer_mem.cu``
outside PyTorch's caching allocator (so ``expandable_segments`` does not
matter, and a channel is one IPC handle with no offset bookkeeping): a
signal pad of flags and per-block epochs (``csrc/peer_barrier.cuh``),
zeroed, then the staging region that the caller writes its operand into.
A group holds one channel per purpose (``"rs_bucket"``, ``"ag_bucket"``,
``"gemm_rs"``, ``"ag_gemm"``: rows 7 and 9, ``"gemm_ag"``: rows 12-13) in
``MPGroup.peer_channels``. In a hybrid world (``env.init_hybrid_groups``)
each axis's sub-group holds its own channels and heartbeat, set up over
that sub-group alone, and a kernel addresses its peers by their rank in
the sub-group (the pointer arrays are in group-rank order); a process in
two groups beats in both segments (the native thread bumps every segment
it has mapped).
Row 8's staging holds 2n fp32 slots of a chunk (by call parity and source
rank) that the peers' GEMMs store into; rows 7 and 9's 2 + n bf16 slots
of a chunk: this rank's chunk by call parity, which the peers read, and
a gather slot per rank that this rank's pull copies the peers' into.
Rows 12-13's holds this rank's GEMM block twice, by call parity (the
serving engine sizes it at build for its largest block, so it never grows
in mid-run).

Set-up is collective and happens at a purpose's first call on a group,
on every rank at once (the SPMD ranks make the same calls in the same
order): each rank allocates, exports its channel's 64-byte IPC handle, the
handles are swapped with ``dist.all_gather_object`` over the group (gloo
or NCCL), and each rank maps its peers' channels with
``cudaIpcOpenMemHandle(..., cudaIpcMemLazyEnablePeerAccess)``. Layouts
(``distributed.env``):

* ``per_card`` (NCCL, a card per rank): every pair of cards must have peer
  access (``cudaDeviceCanAccessPeer``); if one lacks it, set-up raises.
  There is no fallback to a ring or to NCCL.
* ``shared`` (gloo ranks on one card): IPC between processes on one device
  is allowed, so the same kernels run; the ranks' kernels time-slice the
  card, so a barrier may wait out the other ranks' slices (slow, right).

A channel only grows: a call that needs more staging than it has closes
it and opens one of at least twice the size, on every rank at the same
call (grad_comm asks for its plan's largest bucket up front, so its
channels never grow). The staging is handed to PyTorch without a copy
(``__cuda_array_interface__`` into ``torch.as_tensor``), so a caller packs
its operand straight into it (``Channel.view``).

Teardown (``close``, on every rank; ``env.launch``'s ranks call it before
they leave the group): every kernel of this rank done, a group barrier,
``cudaIpcCloseMemHandle`` of the peers' mappings, a barrier, then
``cudaFree`` of its own, so no process frees memory that a peer still
maps. Views of a closed channel's staging must not be used.

The group's channels share its heartbeat (``csrc/peer_mem.cu``),
``MPGroup.peer_beat``: a page of shared memory (a file of ``/dev/shm``)
that rank 0 creates at the group's first channel, every rank maps and
registers with the device, and that is unlinked once all have mapped it;
``close`` unmaps it. A native thread of each process bumps its rank's
counter every ``BEAT_PERIOD_S`` without the GIL or a CUDA call, so a rank
whose Python pauses (a profiler starting or collecting its trace, a
checkpoint, a log flush) keeps beating. A barrier wait
(``csrc/peer_barrier.cuh``) gives up only when the awaited peer's counter
has stood still for ``timeout_s`` (10 s with a card per rank, 60 s when
ranks share a card): that peer is gone. A live peer is waited for up to
``BACKSTOP_S`` (300 s), so a deadlocked group still ends. Giving up traps
on the device after writing who waited for whom into a pinned, mapped
error record; ``raise_for`` turns that into a RuntimeError naming the row,
the rank and the epoch. A rank that fails stops its heartbeat
(``stop_heartbeat``: ``raise_for`` and ``env.launch``'s ranks call it, and
so do the ``sys.excepthook`` and ``threading.excepthook`` that the first
heartbeat of a process installs, chained to the hooks before them), so
its peers give up on it after their timeout, also when an uncaught
exception leaves the process lingering (a non-daemon thread keeps it
alive) instead of at the backstop.
"""
from __future__ import annotations

import ctypes
import functools
import os
import sys
import threading
import uuid

import torch
import torch.distributed as dist

from ..cuda_build import load_library

MIN_CAPACITY = 4 * 2 ** 20          # bytes of staging a channel starts with
MAX_RANKS = 8                       # peer_barrier.cuh's kMaxRanks
BEAT_PERIOD_S = 0.1                 # how often a rank's heartbeat moves
# how long a peer's heartbeat may stand still before a barrier wait gives
# up on it (never under five beats: a wait reads the heartbeat every
# quarter of it), and how long a wait for a peer that beats may last
TIMEOUT_S = {"per_card": 10.0, "shared": 60.0}
MIN_TIMEOUT_S = 5 * BEAT_PERIOD_S
BACKSTOP_S = 300.0


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("peer_mem", "peer_mem.cu")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("peer_alloc", [i, ll, p]), ("peer_free", [i, p]),
                       ("peer_handle", [i, p, p]), ("peer_open", [i, p, p]),
                       ("peer_close", [i, p]),
                       ("peer_can_access", [i, i, p]),
                       ("peer_error_record", [p, p]),
                       ("peer_beat_open", [i, ctypes.c_char_p, i, i, ll, p,
                                           p]),
                       ("peer_beat_unlink", [ctypes.c_char_p]),
                       ("peer_beat_close", [i, p, i])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.peer_pad_bytes.restype = ll
    for name in ("peer_handle_bytes", "peer_open_count", "peer_beat_bytes"):
        getattr(lib, name).restype = i
    lib.peer_beat_halt.restype = None
    lib.peer_error_string.argtypes = [i]
    lib.peer_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the peer-memory library now."""
    _library()


def _ok(rc, what):
    if rc != 0:
        msg = _library().peer_error_string(rc).decode()
        raise RuntimeError(f"peer memory: {what} failed ({rc}): {msg}")


class _ErrorRecord(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("row", ctypes.c_int),
                ("rank", ctypes.c_int), ("peer", ctypes.c_int),
                ("block", ctypes.c_int), ("at_end", ctypes.c_int),
                ("epoch", ctypes.c_uint32), ("seen", ctypes.c_uint32),
                ("beat", ctypes.c_uint32)]


@functools.lru_cache(maxsize=None)
def _error_record():
    """(the record as the host reads it, its device pointer)."""
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    _ok(_library().peer_error_record(ctypes.byref(host), ctypes.byref(dev)),
        "the error record's cudaHostAlloc")
    return _ErrorRecord.from_address(host.value), dev.value


def error_pointer():
    """The device pointer of this process's error record (a kernel
    argument)."""
    return _error_record()[1]


def error_record():
    """This process's error record as a dict (``code`` 0: no barrier wait
    gave up; 1: the peer's heartbeat stood still; 2: the backstop; 3: a
    row 12-13 call out of step with the device's call number)."""
    rec = _error_record()[0]
    return {name: getattr(rec, name) for name, _ in rec._fields_}


_beating = False                    # a heartbeat segment was mapped here
_hooked = False                     # the exception hooks are installed


def _hook_uncaught_exceptions():
    """Make an uncaught exception, in the main thread or any other, stop
    this process's heartbeat before the hook that was there reports it:
    the process may linger (a non-daemon thread keeps it alive), and its
    peers must not wait for it until the backstop. Once a process."""
    global _hooked
    if _hooked:
        return
    prev_sys, prev_thread = sys.excepthook, threading.excepthook

    def sys_hook(tp, value, tb):
        stop_heartbeat()
        prev_sys(tp, value, tb)

    def thread_hook(args):
        stop_heartbeat()
        prev_thread(args)

    sys.excepthook = sys_hook
    threading.excepthook = thread_hook
    _hooked = True


def stop_heartbeat():
    """Stop this process's heartbeat as its death would (its counters stand
    still; the segments stay mapped until ``close``), for a rank that has
    failed and will not call again: its peers' barrier waits then give up
    on it after their timeout, not at the backstop. A no-op in a process
    that never mapped one."""
    if _beating:
        _library().peer_beat_halt()


def raise_for(rc, row, rank, describe):
    """Raise when a kernel of ``row`` timed out in a barrier (the record is
    set) or its launch returned ``rc`` != 0 (``describe(rc)`` its text)."""
    rec = _error_record()[0]
    if rec.code or rc != 0:
        stop_heartbeat()
    if rec.code == 3:
        raise RuntimeError(
            f"row {rec.row}: rank {rec.rank}'s gather of call {rec.epoch} "
            f"was launched for slot parity {rec.seen}: the host's and the "
            f"device's call numbers disagree (a captured CUDA graph must "
            f"hold an even number of the channel's calls); the kernel "
            f"trapped and this process's CUDA context is lost")
    if rec.code:
        if rec.row == 8:
            where = ("reduce's wait for a partial" if rec.at_end else
                     "GEMM's wait for a freed slot")
        elif rec.row in (7, 9):
            where = ("pull's wait for a freed slot",
                     "pull's wait for a peer's chunk",
                     "GEMM's wait for a gathered chunk")[rec.at_end]
        elif rec.row in (12, 13):
            where = "gather's wait for a peer's block"
        else:
            where = ("exit" if rec.at_end else "entry") + " barrier"
        why = ("whose heartbeat stood still for the timeout: the process "
               "is gone" if rec.code == 1 else
               "which kept beating but never came before the backstop: "
               "alive and stuck")
        raise RuntimeError(
            f"row {rec.row}: rank {rec.rank}'s {where} at epoch "
            f"{rec.epoch} (block {rec.block}) gave up waiting for rank "
            f"{rec.peer} (its flag stood at {rec.seen}, its heartbeat at "
            f"{rec.beat}), {why}; the kernel trapped and this process's "
            f"CUDA context is lost")
    if rc != 0:
        raise RuntimeError(f"row {row} kernel launch failed on rank {rank} "
                           f"({rc}): {describe(rc)}")


class _CudaBytes:
    """``nbytes`` of device memory at ``ptr``, as ``torch.as_tensor`` takes
    it without a copy (the tensor keeps this object alive)."""

    def __init__(self, ptr, nbytes):
        self.__cuda_array_interface__ = {
            "typestr": "|u1", "shape": (nbytes,), "strides": None,
            "data": (ptr, False), "version": 2}


class _Heartbeat:
    """One rank's mapping of its group's heartbeat segment: ``host`` the
    mapping, ``dev`` its device pointer (the kernels' ``beats``)."""

    def __init__(self, group):
        global _beating
        lib = _library()
        self.device, self.rank = group.device.index, group.rank
        self.host = None
        name = (f"paddle_tpu_torch_beat_{os.getpid()}_{uuid.uuid4().hex}"
                if group.rank == 0 else None)
        try:
            if name is not None:
                self._open(name, create=True)
            names = [None] * group.n
            dist.all_gather_object(names, name, group=group.pg)
            if name is None:
                self._open(names[0], create=False)
            group.barrier()                # every rank has mapped it
        except BaseException:
            self.close()
            raise
        finally:
            if name is not None:
                lib.peer_beat_unlink(name.encode())
        _beating = True
        _hook_uncaught_exceptions()

    def _open(self, name, create):
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _ok(_library().peer_beat_open(
            self.device, name.encode(), int(create), self.rank,
            round(BEAT_PERIOD_S * 1e6), ctypes.byref(host),
            ctypes.byref(dev)), f"mapping the heartbeat segment {name}")
        self.host, self.dev = host.value, dev.value

    def close(self):
        if self.host is not None:
            _ok(_library().peer_beat_close(
                self.device, ctypes.c_void_p(self.host), self.rank),
                "unmapping the heartbeat segment")
            self.host = None


def heartbeat(group):
    """``group``'s heartbeat, mapped at first need: collective, every rank
    at the same call (a channel's set-up)."""
    if group.peer_beat is None:
        group.peer_beat = _Heartbeat(group)
    return group.peer_beat


class Channel:
    """One rank's side of a channel: its own allocation, every rank's
    channel as mapped here (``bases``, its own included), the staging as a
    uint8 tensor, and the pointer arrays the kernels take."""

    def __init__(self, group, purpose, capacity):
        lib = _library()
        n = group.n
        if not 2 <= n <= MAX_RANKS:
            raise ValueError(f"peer memory takes groups of 2 to "
                             f"{MAX_RANKS} ranks, not {n}")
        self.group, self.purpose, self.capacity = group, purpose, capacity
        self.device = group.device.index
        own = ctypes.c_void_p()
        _ok(lib.peer_alloc(self.device, capacity, ctypes.byref(own)),
            f"cudaMalloc of a {capacity:,}-byte {purpose} channel")
        self.own = own.value
        handle = ctypes.create_string_buffer(lib.peer_handle_bytes())
        try:
            self.beats = heartbeat(group).dev
            _ok(lib.peer_handle(self.device, own, handle),
                "cudaIpcGetMemHandle")
            infos = [None] * n
            dist.all_gather_object(infos, (handle.raw, self.device),
                                   group=group.pg)
            devices = [d for _, d in infos]
            for r, d in enumerate(devices):
                ok = ctypes.c_int(1)
                if d != self.device:
                    _ok(lib.peer_can_access(self.device, d,
                                            ctypes.byref(ok)),
                        "cudaDeviceCanAccessPeer")
                if not ok.value:
                    raise RuntimeError(
                        f"peer memory: cuda:{self.device} (rank "
                        f"{group.rank}) has no peer access to cuda:{d} "
                        f"(rank {r}); the peer-buffer kernels need "
                        f"every pair of cards joined (NVLink or PCIe P2P)")
        except BaseException:
            lib.peer_free(self.device, own)
            raise
        self.layout = "shared" if len(set(devices)) < n else "per_card"
        self.timeout_ns = int(TIMEOUT_S[self.layout] * 1e9)
        self.backstop_ns = int(BACKSTOP_S * 1e9)
        self.bases = []
        try:
            for r, (h, _) in enumerate(infos):
                if r == group.rank:
                    self.bases.append(self.own)
                    continue
                p = ctypes.c_void_p()
                _ok(lib.peer_open(self.device, h, ctypes.byref(p)),
                    f"cudaIpcOpenMemHandle of rank {r}'s {purpose} channel")
                self.bases.append(p.value)
        except BaseException:
            self._close_peers()
            lib.peer_free(self.device, own)
            raise
        pad = lib.peer_pad_bytes()
        arr = ctypes.c_void_p * n
        self.pads = arr(*self.bases)
        self.data = arr(*(b + pad for b in self.bases))
        self.staging = torch.as_tensor(
            _CudaBytes(self.own + pad, capacity), device=group.device)
        self._views = {}
        # the calls made on this channel, as the host counts them (rows
        # 12-13 number theirs so, beside the pad's count on the device)
        self.calls = 0

    @property
    def timeout_ns(self):
        """How long the peer's heartbeat may stand still before a barrier
        wait gives up on it (nanoseconds; settable, never under
        ``MIN_TIMEOUT_S``)."""
        return self._timeout_ns

    @timeout_ns.setter
    def timeout_ns(self, ns):
        if ns < MIN_TIMEOUT_S * 1e9:
            raise ValueError(
                f"a barrier timeout of {ns} ns is under {MIN_TIMEOUT_S} s, "
                f"five heartbeats of {BEAT_PERIOD_S} s: a live peer would "
                f"be taken for gone")
        self._timeout_ns = int(ns)

    def view(self, shape, dtype, offset=0):
        """The bytes of this rank's staging from ``offset`` on as a
        contiguous tensor of ``shape`` and ``dtype`` (no copy; cached)."""
        key = (tuple(shape), dtype, offset)
        v = self._views.get(key)
        if v is None:
            numel = 1
            for s in shape:
                numel *= s
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            if offset + nbytes > self.capacity:
                raise ValueError(f"{nbytes:,} bytes at {offset:,} do not "
                                 f"fit the {self.capacity:,}-byte "
                                 f"{self.purpose} staging")
            v = self.staging[offset:offset + nbytes].view(dtype).view(key[0])
            self._views[key] = v
        return v

    def _close_peers(self):
        lib = _library()
        for r, b in enumerate(getattr(self, "bases", [])):
            if r != self.group.rank:
                _ok(lib.peer_close(self.device, ctypes.c_void_p(b)),
                    "cudaIpcCloseMemHandle")
        self.bases = []

    def _free(self):
        self.staging = None
        self._views = {}
        _ok(_library().peer_free(self.device, ctypes.c_void_p(self.own)),
            "cudaFree")


def _teardown(group, channels):
    """Close ``channels`` of ``group`` on every rank (collective)."""
    torch.cuda.synchronize(group.device)
    group.barrier()
    for ch in channels:
        ch._close_peers()
    group.barrier()
    for ch in channels:
        ch._free()


def channel(group, purpose, nbytes):
    """``group``'s channel for ``purpose`` with at least ``nbytes`` of
    staging, set up (or grown) on first need: collective, every rank at the
    same call."""
    chans = group.peer_channels
    ch = chans.get(purpose)
    if ch is not None and ch.capacity >= nbytes:
        return ch
    capacity = max(nbytes, MIN_CAPACITY)
    if ch is not None:
        capacity = max(capacity, 2 * ch.capacity)
        _teardown(group, [chans.pop(purpose)])
    ch = Channel(group, purpose, capacity)
    chans[purpose] = ch
    return ch


def close(group):
    """Tear down every channel of ``group`` and unmap its heartbeat
    (collective; a no-op on a group with neither)."""
    chans = group.peer_channels
    if chans:
        _teardown(group, list(chans.values()))
        chans.clear()
    if group.peer_beat is not None:
        group.peer_beat.close()
        group.peer_beat = None


def open_mappings():
    """Peer mappings open in this process now (0 after ``close``)."""
    return _library().peer_open_count()
