"""Symmetric peer buffers over CUDA IPC: the memory that rows 10 and 11's
one-launch collectives (``ops/fused_collectives.py``: ``fused_rs_bucket``,
``fused_ag_bucket``) read across the ranks of a group.

A *channel* is one ``cudaMalloc`` per rank, made by ``csrc/peer_mem.cu``
outside PyTorch's caching allocator (so ``expandable_segments`` does not
matter, and a channel is one IPC handle with no offset bookkeeping): a
signal pad of flags and per-block epochs (``csrc/peer_barrier.cuh``),
zeroed, then the staging region that the caller writes its operand into.
A group holds one channel per purpose (``"rs_bucket"``, ``"ag_bucket"``)
in ``MPGroup.peer_channels``.

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

A barrier wait that outlasts ``timeout_s`` (10 s with a card per rank,
60 s when ranks share a card) traps on the device after writing who waited
for whom into a pinned, mapped error record; ``raise_for`` turns that into
a RuntimeError naming the row, the rank and the epoch.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from ..cuda_build import load_library

MIN_CAPACITY = 4 * 2 ** 20          # bytes of staging a channel starts with
MAX_RANKS = 8                       # peer_barrier.cuh's kMaxRanks
TIMEOUT_S = {"per_card": 10.0, "shared": 60.0}


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library("peer_mem", "peer_mem.cu")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("peer_alloc", [i, ll, p]), ("peer_free", [i, p]),
                       ("peer_handle", [i, p, p]), ("peer_open", [i, p, p]),
                       ("peer_close", [i, p]),
                       ("peer_can_access", [i, i, p]),
                       ("peer_error_record", [p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.peer_pad_bytes.restype = ll
    for name in ("peer_handle_bytes", "peer_open_count"):
        getattr(lib, name).restype = i
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
                ("epoch", ctypes.c_uint32), ("seen", ctypes.c_uint32)]


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


def raise_for(rc, row, rank, describe):
    """Raise when a kernel of ``row`` timed out in a barrier (the record is
    set) or its launch returned ``rc`` != 0 (``describe(rc)`` its text)."""
    rec = _error_record()[0]
    if rec.code:
        where = "exit" if rec.at_end else "entry"
        raise RuntimeError(
            f"row {rec.row}: rank {rec.rank}'s {where} barrier at epoch "
            f"{rec.epoch} (block {rec.block}) waited past its timeout for "
            f"rank {rec.peer} (its flag stood at {rec.seen}); the kernel "
            f"trapped and this process's CUDA context is lost")
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
            _ok(lib.peer_handle(self.device, own, handle),
                "cudaIpcGetMemHandle")
            infos = [None] * n
            dist.all_gather_object(infos, (handle.raw, self.device))
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
                        f"(rank {r}); rows 10-11's one-launch kernels need "
                        f"every pair of cards joined (NVLink or PCIe P2P)")
        except BaseException:
            lib.peer_free(self.device, own)
            raise
        self.layout = "shared" if len(set(devices)) < n else "per_card"
        self.timeout_ns = int(TIMEOUT_S[self.layout] * 1e9)
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

    def view(self, shape, dtype):
        """The first bytes of this rank's staging as a contiguous tensor of
        ``shape`` and ``dtype`` (no copy; cached)."""
        key = (tuple(shape), dtype)
        v = self._views.get(key)
        if v is None:
            numel = 1
            for s in shape:
                numel *= s
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            if nbytes > self.capacity:
                raise ValueError(f"{nbytes:,} bytes do not fit the "
                                 f"{self.capacity:,}-byte {self.purpose} "
                                 f"staging")
            v = self.staging[:nbytes].view(dtype).view(key[0])
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
    """Tear down every channel of ``group`` (collective; a no-op on a
    group with none)."""
    chans = group.peer_channels
    if chans:
        _teardown(group, list(chans.values()))
        chans.clear()


def open_mappings():
    """Peer mappings open in this process now (0 after ``close``)."""
    return _library().peer_open_count()
