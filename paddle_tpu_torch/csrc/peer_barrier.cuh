// The device side of the symmetric peer buffers (peer_mem.cu), shared by
// rows 10 and 11 (rs_bucket.cu, ag_bucket.cu), row 8 (gemm_rs.cu), rows 7
// and 9 (ag_gemm.cu) and rows 12-13 (gemm_ag.cu): the layout of a
// channel's signal pad, the
// peer pointers a kernel is given, the bounded wait for a peer's flag,
// and the entry and exit barriers that every block of rows 10-11's
// one-launch collectives runs.
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
// A wait is bounded, but only a gone peer ends it early. Every rank's
// process runs a heartbeat: a host thread (peer_mem.cu) that bumps the
// rank's counter in a small shared-memory segment of the group every beat
// period (peer.py's BEAT_PERIOD_S, 100 ms; every timeout_ns is at least
// five of them), mapped into every rank's device (cudaHostRegisterMapped). The
// thread needs neither the GIL nor a CUDA call, so a rank whose Python is
// busy elsewhere (a profiler starting, a checkpoint, a sleep) keeps beating,
// and one whose process has died stops. A waiting thread reads its peer's
// counter every timeout_ns / 4 of %globaltimer (wall-clock nanoseconds,
// which keep counting while the context is switched out when ranks
// time-slice one card), the first time only once the wait has lasted that
// long: the counter is host memory, read over PCIe, and hundreds of
// blocks reading it at every barrier cost a healthy group several times
// a small call's time, so a wait that ends sooner never reads it. The wait
// gives up when the counter has stood still for timeout_ns (code 1: the
// peer is gone) or when the whole wait outlasts backstop_ns although the
// peer beats (code 2: alive but never arriving, a deadlock). Giving up records who waited for whom in the host-mapped
// error record and traps; the wrapper turns the sticky CUDA error that
// follows into a RuntimeError naming the row, the rank and the epoch. The
// first wait to give up takes the record; the others (every block waits
// for the same missing peer) wait, bounded, until its code is set before
// they trap, since a trap ends the grid with the record's writes still in
// flight. No argument changes per call, so the launch stays capturable in
// a CUDA graph.

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
  // row 8 (gemm_rs.cu), whose calls are numbered by `calls`:
  uint32_t calls;           // this rank's finished calls (its reduce sets)
  uint32_t reduced;         // reduce blocks done this call
  uint32_t tiles[kMaxRanks];      // GEMM tiles of chunk c stored this call
  uint32_t ready[2][kMaxRanks];   // [parity][src]: src's partial of call e
                                  // is in slot [parity][src] (src writes e)
  uint32_t freed[kMaxRanks];      // [dst]: dst has read this rank's slots of
                                  // call e (dst writes e)
  // rows 7 and 9 (ag_gemm.cu) number their calls by `calls` (moved by the
  // GEMM's last block) and use ready and freed as row 8 does, with these:
  uint32_t published;             // pull blocks done copying the own chunk
  uint32_t pulled[kMaxRanks];     // [src]: pull blocks done with src's chunk
  uint32_t gathered[kMaxRanks];   // [src]: src's chunk of call e is in the
                                  // local gather slot (this rank writes e)
  uint32_t finished;              // GEMM blocks done this call
  uint32_t split[kMaxBlocks];     // row 9: chunk partials of output tile i
                                  // stored this call
  // rows 12 and 13 (gemm_ag.cu) number their calls by `calls` (moved by
  // the gather's last block, counted in `finished`) and signal with:
  uint32_t posted[kMaxRanks];     // [src]: src's block of call e is in its
                                  // slot (src writes e)
};

// the staging region begins this many bytes into a channel (a multiple of
// 4 KiB after the pad)
constexpr long long kPadBytes = (sizeof(Pad) + 4095) / 4096 * 4096;

// the heartbeat segment: rank r's counter at beats[r * kBeatStride] (one
// 128-byte line each)
constexpr int kBeatStride = 32;
constexpr int kBeatBytes = 4096;
static_assert(kMaxRanks * kBeatStride * 4 <= kBeatBytes, "beat segment");

// written by the first block that times out (the one that takes the pad's
// claim; no atomics on host memory), read by the host without a CUDA call
// (pinned, mapped memory)
struct ErrorRecord {
  int code;         // 0: none; 1: the peer's heartbeat stood still for the
                    // timeout; 2: the peer beat but never came before the
                    // backstop; 3 (rows 12-13): the call's slot parity is
                    // not the device's call number's (a captured graph of
                    // an odd number of calls replayed)
  int row;          // 7 to 13
  int rank;
  int peer;         // the rank whose flag never came
  int block;
  int at_end;       // rows 10-11: 0 entry barrier, 1 exit barrier; row 8:
                    // 0 the GEMM's wait for a freed slot, 1 the reduce's
                    // wait for a partial; rows 7 and 9: 0 the pull's wait
                    // for a freed slot, 1 its wait for a peer's chunk, 2
                    // the GEMM's wait for a gathered chunk; rows 12-13: 0
                    // the gather's wait for a peer's block
  uint32_t epoch;
  uint32_t seen;    // the flag value last read
  uint32_t beat;    // the peer's heartbeat counter last read
};

struct Peers {
  const void* data[kMaxRanks];  // each rank's staging, mapped here
  Pad* pad[kMaxRanks];          // each rank's signal pad, mapped here
  ErrorRecord* err;             // host-mapped
  const uint32_t* beats;        // the heartbeat segment, host-mapped
  unsigned long long timeout_ns;   // a peer's heartbeat may stand still
  unsigned long long backstop_ns;  // a whole wait may last
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

__device__ __forceinline__ uint32_t ld_relaxed_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];"
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
                                  uint32_t seen, int at_end, int code,
                                  uint32_t beat) {
  if (atomicCAS(&a.pad[a.rank]->claim, 0, 1) == 0) {
    volatile ErrorRecord* r = a.err;
    r->row = a.row;
    r->rank = a.rank;
    r->peer = p;
    r->block = blockIdx.x;
    r->at_end = at_end;
    r->epoch = e;
    r->seen = seen;
    r->beat = beat;
    __threadfence_system();
    r->code = code;
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

// one thread: wait until *flag (written by rank p) has reached e, reading
// p's heartbeat as the note above says; gives up with the record
// (at_end as ErrorRecord says) when p is gone or the backstop passes
__device__ __forceinline__ void wait_flag(const Peers& a, const uint32_t* flag,
                                          uint32_t e, int p, int at_end) {
  uint32_t seen = ld_acquire_sys(flag);
  if (static_cast<int32_t>(seen - e) >= 0) return;
  const uint32_t* beat = a.beats + p * kBeatStride;
  const unsigned long long t0 = global_ns();
  unsigned long long moved = t0, checked = t0;
  uint32_t last = 0;
  while (static_cast<int32_t>((seen = ld_acquire_sys(flag)) - e) < 0) {
    const unsigned long long now = global_ns();
    if (now - checked > a.timeout_ns / 4) {
      const uint32_t b = ld_relaxed_sys(beat);
      if (checked == t0 || b != last) {  // the first reading, or moved
        last = b;
        moved = now;
      } else if (now - moved > a.timeout_ns) {
        fail(a, p, e, seen, at_end, 1, b);
      }
      checked = now;
    }
    if (now - t0 > a.backstop_ns) fail(a, p, e, seen, at_end, 2, last);
  }
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
    wait_flag(a, at_end ? &mine->end[b][p] : &mine->start[b][p], e, p,
              at_end);
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
