// The all-gather of the tensor-parallel serving projections (rows 12 and
// 13) over NVLink peer buffers, for Hopper (sm_90a):
// paddle_tpu_torch/ops/fused_collectives.py: fused_gemm_ag.
//
// Replaces the transfer half of the TPU kernels of paddle_tpu/ops/
// pallas_kernels/fused_collectives.py:
//
// * _gemm_ag_kernel (:448, the pallas_call at :699): a rank's
//   full-contraction column block x @ w_r of a column-parallel projection
//   (bf16 weights; an LM head passed at fp32 against fp32 x), every rank's
//   block gathered so that the result is x @ w with w's columns in order;
// * _gemm_ag_q_kernel (:498, :710): the same over an int8/fp8 shard,
//   (x @ wq_r) * s_r.
//
// The TPU kernels compute the block into a ring buffer and move it around
// the ring with in-kernel remote DMAs, so it never makes an HBM round
// trip. Here the arithmetic half is row 3's kernel (quant_gemm.cu, through
// gemm_into, unchanged: the same bits), whose epilogue stores the block
// [R, F/n] straight into this rank's slot of the group's "gemm_ag" peer
// channel (distributed/peer.py: two slots, by call parity). This file is
// the transfer half, one launch after the GEMM on the same stream:
//
// * One thread publishes the call number e into every peer's pad
//   (posted[rank]): __threadfence_system, then a system-scope release
//   store, as gemm_rs.cu's tile counter does. The GEMM that wrote the slot
//   ran before this kernel on the stream, so the slot is complete when the
//   flag arrives. One one-way signal per rank and call: no barrier, no
//   reply.
// * Every block copies a contiguous range of the output's 16-byte units,
//   the sources taken next peer first (rank + 1, rank + 2, ..., its own
//   block last). Before copying, a block waits on its LOCAL pad for the
//   flags of the peers whose blocks its range holds, and no others
//   (posted[src] >= e, one thread a peer, peer_barrier.cuh's bounded
//   wait_flag, which reads the peer's heartbeat). Peers' slots are read
//   over NVLink through the CUDA IPC mappings with 16-byte loads
//   (ld.global.cg: no stale L1 line of the slot's previous call), four in
//   flight a thread.
// * The output is a fresh [R, F] tensor with block p at columns
//   [p F/n, (p + 1) F/n): unit (src, row, c) of the slots lands at
//   out[row, src F/n + 16 c / size]. There is no relayout copy.
// * The grid is sized by the bytes: a block moves up to 32 KB (512 threads
//   x 4 units of 16 bytes), at most one block an SM. At decode (R = 8, F/n
//   = 512, bf16, n = 4) the whole output is 32 KB: one block.
//
// Slot reuse without a second handshake. Rank q publishes call e + 1 only
// from its gather of call e + 1, which its stream runs after its gather
// of call e has ended: so once this rank has seen every peer's flag of
// e + 1, no peer still reads this rank's slot of call e. This rank's GEMM
// of call e + 2, the next to overwrite that slot (the same parity), runs
// on its stream after its gather of call e + 1, which waited for exactly
// those flags. The flags only grow, so a flag already at e + 1 also
// satisfies a wait for e, and the slot of parity e & 1 still holds call
// e's block then (its owner's next write of it is call e + 2's).
//
// Call numbers live in device memory: `calls` in this rank's pad, read by
// every block at its start and moved by the last block to finish (a count
// in `finished`), so no argument of this launch depends on the call
// number. The slot's parity is an argument (the host's count of the
// channel's calls, which the GEMM's output pointer also follows): a
// captured CUDA graph holds one fixed parity per call, so it must hold an
// even number of the channel's calls; every block checks that the parity
// is e & 1 and, where it is not, fills the error record (code 3) and
// traps rather than read a slot of another call.
//
// No wait is for a kernel that the waiter's own stream has still to run:
// the gather of call e waits for the peers' gathers of call e, each of
// which publishes before it waits. So ranks that time-slice one card (the
// "shared" layout) make progress. A gone peer ends the wait after the
// channel's timeout, a live but stuck one at the backstop; either fills
// the error record (row 12 or 13, at_end 0) and traps, and the wrapper
// raises naming the row, the rank and the call (peer.raise_for).
//
// What bounds it on an H100: latency. At decode a rank receives (n - 1) x
// 8 KB (R = 8 rows of F/n = 512 bf16); at the fp32 LM head of GPT-3 1.3B
// (R = 8, F/n = 12,576) 3 x 402 KB, 2.7 us at 450 GB/s one way. What a
// call costs beyond the GEMM is the launch, one NVLink round trip for the
// flag and one for the loads.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cstdint>

#include "peer_barrier.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kAtBlock = 0;         // the error record's at_end: the wait
                                    // for a peer's block
constexpr int kOutOfStep = 3;       // the error record's code
constexpr int kErrUnsupported = -1;

// out [R, n * row16] (16-byte units) <- every rank's slot [R, row16] of
// parity `par`, block p at columns p * row16
__global__ void __launch_bounds__(kThreads)
gemm_ag_gather_kernel(const peer::Peers a, uint4* __restrict__ out, int R,
                      int row16, long long slot_stride, int par) {
  peer::Pad* mine = a.pad[a.rank];
  const uint32_t e = *reinterpret_cast<volatile uint32_t*>(&mine->calls) + 1;
  if (threadIdx.x == 0 && (e & 1u) != static_cast<uint32_t>(par))
    peer::fail(a, a.rank, e, static_cast<uint32_t>(par), kAtBlock,
               kOutOfStep, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    __threadfence_system();        // the GEMM's block, before the flag
    for (int q = 0; q < a.n; ++q)
      if (q != a.rank) peer::st_release_sys(&a.pad[q]->posted[a.rank], e);
  }
  // this block's units, in source order k = 0 .. n - 1 (src = rank + 1 +
  // k, its own block last)
  const long long per_src = static_cast<long long>(R) * row16;
  const long long total = per_src * a.n;
  const long long span = (total + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * span;
  const long long hi = lo + span < total ? lo + span : total;
  if (lo < hi) {
    const int k0 = static_cast<int>(lo / per_src);
    const int k = k0 + threadIdx.x;
    if (k < a.n - 1 && k <= (hi - 1) / per_src) {
      const int src = (a.rank + 1 + k) % a.n;
      peer::wait_flag(a, &mine->posted[src], e, src, kAtBlock);
    }
  }
  __syncthreads();
  const long long row_out = static_cast<long long>(a.n) * row16;
  for (long long g = lo + threadIdx.x; g < hi; g += kUnroll * kThreads) {
    uint4 v[kUnroll];
    long long to[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = g + u * kThreads;
      if (i < hi) {
        const int k = static_cast<int>(i / per_src);
        const long long w = i - k * per_src;
        const int src = (a.rank + 1 + k) % a.n;
        const uint4* slot = reinterpret_cast<const uint4*>(
            static_cast<const uint8_t*>(a.data[src]) + par * slot_stride);
        v[u] = __ldcg(slot + w);
        const long long row = w / row16;
        to[u] = row * row_out + src * static_cast<long long>(row16) +
                (w - row * row16);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + u * kThreads < hi) out[to[u]] = v[u];
  }
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(&mine->finished, 1u) == gridDim.x - 1) {
    mine->finished = 0;
    *reinterpret_cast<volatile uint32_t*>(&mine->calls) = e;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// The grid of one call gathering n blocks of R rows of row_bytes: the
// bytes over 32 KB a block, at most one block an SM (every block is
// resident at once, so the block that publishes never waits behind
// blocks that spin). 0 when the card cannot be read.
int grid_for(int n, int R, long long row_bytes) {
  const int sms = sm_count();
  if (sms <= 0) return 0;
  const long long units = static_cast<long long>(n) * R * (row_bytes / 16);
  const long long want =
      (units + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  return static_cast<int>(want < sms ? want : sms);
}

}  // namespace

// One row-12 or row-13 call's gather on `stream`, after the GEMM that
// wrote this rank's block into its slot of parity `par`: out [R, n *
// row_bytes] <- every rank's [R, row_bytes] slot. data[p], pads[p]: rank
// p's staging and signal pad as mapped here; slot_stride: the bytes from
// slot 0 to slot 1 of a staging; err, beats, timeout_ns, backstop_ns as
// rs_pull_launch's (rs_bucket.cu); row (12 or 13) names the call in the
// error record. Returns 0, a cudaError_t code, or -1 for arguments this
// library does not take.
extern "C" int gemm_ag_launch(void* const* data, void* const* pads, int n,
                              int rank, int row, int R, long long row_bytes,
                              long long slot_stride, int par, void* out,
                              void* err, const void* beats,
                              unsigned long long timeout_ns,
                              unsigned long long backstop_ns, void* stream) {
  if (n < 2 || n > peer::kMaxRanks || rank < 0 || rank >= n || R <= 0 ||
      row_bytes <= 0 || row_bytes % 16 != 0 || slot_stride % 16 != 0 ||
      R * row_bytes > slot_stride || (par != 0 && par != 1) ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      err == nullptr || beats == nullptr || (row != 12 && row != 13) ||
      row_bytes / 16 > 0x7fffffff)     // row16 is an int
    return kErrUnsupported;
  peer::Peers a = {};
  for (int p = 0; p < n; ++p) {
    if (data[p] == nullptr || pads[p] == nullptr ||
        reinterpret_cast<uintptr_t>(data[p]) % 16 != 0)
      return kErrUnsupported;
    a.data[p] = data[p];
    a.pad[p] = static_cast<peer::Pad*>(pads[p]);
  }
  a.err = static_cast<peer::ErrorRecord*>(err);
  a.beats = static_cast<const uint32_t*>(beats);
  a.timeout_ns = timeout_ns;
  a.backstop_ns = backstop_ns;
  a.n = n;
  a.rank = rank;
  a.row = row;
  const int blocks = grid_for(n, R, row_bytes);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  gemm_ag_gather_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint4*>(out), R, static_cast<int>(row_bytes / 16),
      slot_stride, par);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gemm_ag_error_string(int code) {
  if (code == kErrUnsupported)
    return "unsupported group, row, slot or missing operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
