// The device side of the symmetric peer buffers (peer_mem.cu), shared by
// rows 10 and 11 (rs_bucket.cu, ag_bucket.cu): the layout of a channel's
// signal pad, the peer pointers a kernel is given, and the entry and exit
// barriers that every block of a one-launch collective runs.
//
// A channel is one cudaMalloc per rank: the signal pad (kPadBytes) and,
// after it, the staging region the caller writes its operand into. Every
// rank maps every peer's channel through CUDA IPC, so a kernel reads the
// peers' staging and writes the peers' flags with plain loads and stores,
// over NVLink (a card per rank) or on the one card (ranks sharing it).
//
// The barrier. Block b of rank r runs call number e = epoch[b] + 1 (the
// epoch lives in r's own pad and only block b's thread 0 moves it, at the
// end of the call, so no host argument is needed and the launch stays
// capturable in a CUDA graph). Thread p < n stores e into slot [b][r] of
// peer p's start (or end) flags with a system-scope release and then
// waits, with system-scope acquires, until slot [b][p] of its own flags
// has reached e. Block b only ever waits for block b of the peers; every
// rank launches the same grid for the same call, and the grid never holds
// more blocks than the card keeps resident at once, so no spinning block
// waits for a block that cannot be scheduled. Entry: a peer's staging,
// written by the kernels before this one on the peer's stream, is
// complete once its flag arrives. Exit: no rank returns (and lets its
// caller overwrite its staging with the next operand) while a peer may
// still read it.
//
// A wait that outlasts timeout_ns of %globaltimer (wall-clock
// nanoseconds, which keep counting while the context is switched out
// when ranks time-slice one card) records who waited for whom in the
// host-mapped error record and traps; the wrapper turns the sticky CUDA
// error that follows into a RuntimeError naming the row, the rank and the
// epoch. The first wait to time out takes the record; the others (every
// block waits for the same missing peer) wait, bounded, until its code is
// set before they trap, since a trap ends the grid with the record's
// writes still in flight.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace peer {

constexpr int kMaxRanks = 8;
constexpr int kMaxBlocks = 1024;

struct Pad {
  int claim;        // the first block to time out takes the error record
  uint32_t epoch[kMaxBlocks];
  uint32_t start[kMaxBlocks][kMaxRanks];
  uint32_t end[kMaxBlocks][kMaxRanks];
};

// the staging region begins this many bytes into a channel (a multiple of
// 4 KiB after the pad)
constexpr long long kPadBytes = (sizeof(Pad) + 4095) / 4096 * 4096;

// written by the first block that times out (the one that takes the pad's
// claim; no atomics on host memory), read by the host without a CUDA call
// (pinned, mapped memory)
struct ErrorRecord {
  int code;         // 0: none; 1: a barrier wait timed out
  int row;          // 10 or 11
  int rank;
  int peer;         // the rank whose flag never came
  int block;
  int at_end;       // 0: entry barrier, 1: exit barrier
  uint32_t epoch;
  uint32_t seen;    // the flag value last read
};

struct Peers {
  const void* data[kMaxRanks];  // each rank's staging, mapped here
  Pad* pad[kMaxRanks];          // each rank's signal pad, mapped here
  ErrorRecord* err;             // host-mapped
  unsigned long long timeout_ns;
  int n;
  int rank;
  int row;
};

__device__ __forceinline__ void st_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __noinline__ void fail(const Peers& a, int p, uint32_t e,
                                  uint32_t seen, int at_end) {
  if (atomicCAS(&a.pad[a.rank]->claim, 0, 1) == 0) {
    volatile ErrorRecord* r = a.err;
    r->row = a.row;
    r->rank = a.rank;
    r->peer = p;
    r->block = blockIdx.x;
    r->at_end = at_end;
    r->epoch = e;
    r->seen = seen;
    __threadfence_system();
    r->code = 1;
    __threadfence_system();
  } else {
    // another block holds the record: let it finish writing before a
    // trap ends the grid (and with it the writes in flight)
    const volatile int* code = &a.err->code;
    const unsigned long long t0 = global_ns();
    while (*code == 0 && global_ns() - t0 < a.timeout_ns) {
    }
  }
  __trap();
}

// every block: signal call e to every rank's slot for this block, wait
// for every rank's signal of e, then the whole block goes on
__device__ __forceinline__ void barrier(const Peers& a, uint32_t e,
                                        int at_end) {
  if (at_end) __syncthreads();  // this block's reads are done
  const int p = threadIdx.x;
  if (p < a.n) {
    const int b = blockIdx.x;
    Pad* theirs = a.pad[p];
    Pad* mine = a.pad[a.rank];
    st_release_sys(at_end ? &theirs->end[b][a.rank]
                          : &theirs->start[b][a.rank], e);
    const uint32_t* flag = at_end ? &mine->end[b][p] : &mine->start[b][p];
    uint32_t seen = ld_acquire_sys(flag);
    if (static_cast<int32_t>(seen - e) < 0) {
      const unsigned long long t0 = global_ns();
      while (static_cast<int32_t>((seen = ld_acquire_sys(flag)) - e) < 0) {
        if (global_ns() - t0 > a.timeout_ns) fail(a, p, e, seen, at_end);
      }
    }
  }
  __syncthreads();
}

// this block's call number
__device__ __forceinline__ uint32_t next_epoch(const Peers& a) {
  return a.pad[a.rank]->epoch[blockIdx.x] + 1;
}

__device__ __forceinline__ void finish(const Peers& a, uint32_t e) {
  if (threadIdx.x == 0) a.pad[a.rank]->epoch[blockIdx.x] = e;
}

}  // namespace peer
