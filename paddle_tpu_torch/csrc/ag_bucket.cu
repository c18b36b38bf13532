// The bucketed all-gather (row 11) in one launch, for
// paddle_tpu_torch/ops/fused_collectives.py:fused_ag_bucket.
//
// Replaces paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _ag_bucket_kernel (:409, through fused_ag_bucket :667): a flat row of
// `nbytes` on each of n ranks becomes the (n, row) stack of every rank's
// row in rank order. grad_comm gathers the updated param shards of every
// data-parallel step with it, and the mp serving engine its activation
// rows. The TPU kernel moves each row around the ring with in-kernel
// remote DMAs and copies the row it holds at each step into its slot of
// the output.
//
// Here every rank has written its row into the staging region of a
// peer-memory channel (peer_barrier.cuh) before the launch; the kernel
// runs the entry barrier, copies every rank's staging row into out[p], its
// own included, reading the peers' over NVLink through the CUDA IPC
// mappings made once per group, and runs the exit barrier, after which
// the caller may overwrite its staging. One launch a call, no NCCL hop, no
// host round trip. The copy is bytes, so every dtype takes the same
// kernel, and the result is the plain ring's (and NCCL's all-gather's) bit
// for bit.
//
// What bounds it on an H100: NVLink bytes. A rank receives (n - 1) x
// nbytes (at GPT-3 1.3B's largest fp32 row, 25,755,648 x 4 bytes at n = 4:
// 309 MB, 0.687 ms at 450 GB/s one way); its HBM takes n x nbytes of
// output and serves its row to the n readers (2n x nbytes, 0.25 ms at
// 3.35 TB/s). Small rows (serving's 8 x 512 bf16 activations) are bound
// by the launch and the two barriers' round trips. Loads and stores are
// 16 bytes, four in flight a thread, with a byte tail; a slot of the
// output whose address is not 16-byte aligned (a row of odd length) takes
// the byte loop. The grid holds at most two blocks of 512 threads per SM.
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

// out[p] <- rank p's staging row, for every p, starting with the next
// rank so that the ranks read different peers at a time
__global__ void __launch_bounds__(kThreads)
ag_pull_kernel(peer::Peers a, uint8_t* __restrict__ out, long long nbytes) {
  const uint32_t e = peer::next_epoch(a);
  peer::barrier(a, e, 0);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  for (int k = 1; k <= a.n; ++k) {
    const int p = (a.rank + k) % a.n;
    const uint8_t* src = static_cast<const uint8_t*>(a.data[p]);
    uint8_t* dst = out + p * nbytes;
    long long done = 0;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      const long long n16 = nbytes / 16;
      for (long long g = first; g < n16; g += kUnroll * stride) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (g + u * stride < n16) v[u] = s[g + u * stride];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (g + u * stride < n16) d[g + u * stride] = v[u];
      }
      done = 16 * n16;
    }
    for (long long i = done + first; i < nbytes; i += stride)
      dst[i] = src[i];
  }
  peer::barrier(a, e, 1);
  peer::finish(a, e);
}

int resident_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ag_pull_kernel,
                                                  kThreads, 0);
    per_sm = per_sm < 2 ? per_sm : 2;
    grid = sms * per_sm < peer::kMaxBlocks ? sms * per_sm : peer::kMaxBlocks;
  }
  return grid;
}

}  // namespace

// One call of row 11 on `stream`: out (n, nbytes) <- every rank's staging
// row of nbytes, in rank order. data[p] and pads[p]: rank p's staging and
// signal pad as mapped in this process. Returns 0, a cudaError_t code, or
// -1 for arguments this library does not take.
extern "C" int ag_pull_launch(void* const* data, void* const* pads, int n,
                              int rank, long long nbytes, void* out,
                              void* err, unsigned long long timeout_ns,
                              void* stream) {
  if (n < 2 || n > peer::kMaxRanks || rank < 0 || rank >= n ||
      nbytes <= 0 || out == nullptr || err == nullptr)
    return -1;
  peer::Peers a = {};
  for (int p = 0; p < n; ++p) {
    if (data[p] == nullptr || pads[p] == nullptr) return -1;
    a.data[p] = data[p];
    a.pad[p] = static_cast<peer::Pad*>(pads[p]);
  }
  a.err = static_cast<peer::ErrorRecord*>(err);
  a.timeout_ns = timeout_ns;
  a.n = n;
  a.rank = rank;
  a.row = 11;
  const int most = resident_grid();
  if (most <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the grid depends on nbytes alone, so every rank launches the same
  // blocks and block b meets block b
  const long long want =
      ((nbytes + 16 * kUnroll - 1) / (16 * kUnroll) + kThreads - 1) /
      kThreads;
  const int blocks = static_cast<int>(want < most ? want : most);
  ag_pull_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint8_t*>(out), nbytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ag_bucket_error_string(int code) {
  if (code == -1) return "unsupported group size or missing operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
