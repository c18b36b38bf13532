// The ring step of the bucketed all-gather (row 11), for
// paddle_tpu_torch/ops/fused_collectives.py:fused_ag_bucket.
//
// Replaces paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _ag_bucket_kernel (:409, through fused_ag_bucket :667): a flat (cols,)
// row on each of n ranks becomes the (n, cols) stack of every rank's row
// in rank order. grad_comm gathers the updated param shards of every
// data-parallel step with it, and the mp serving engine its activation
// rows. The TPU kernel moves a row around the ring of the n ranks with
// in-kernel remote DMAs between two comm buffers; at ring step t rank i
// holds the row of rank (i - t) mod n and copies it into that slot of the
// output (o[src] = comm[cur]) while the DMA forwards it to the right.
//
// Here a hop is an NCCL send/recv pair outside the kernel (MPGroup.
// ring_shift_async, as rows 7-10 use it): the received row is forwarded
// as it arrived, and this kernel is what each ring step does beside the
// hop, the copy of the step's row into its slot of the output. At t = 0
// that row is the rank's own. The copy is bytes, so every dtype takes the
// same kernel.
//
// What bounds it on an H100: bytes. A step over b bytes reads b and
// writes b (b = 4 x 25,755,648 at GPT-3 1.3B's largest fp32 bucket at
// n = 4: 0.21 GB, 61 us at 3.35 TB/s); the hop beside it moves b over
// NVLink (229 us at 450 GB/s). Loads and stores are 16 bytes a thread
// with a byte tail; a row whose address is not 16-byte aligned takes the
// byte loop throughout.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// dst <- src over nbytes: 16-byte vectors [0, n16), then bytes
// [16 n16, nbytes) one by one.
__global__ void __launch_bounds__(kThreads)
ag_step_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
               long long nbytes, long long n16) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long g = first; g < n16; g += stride) d[g] = s[g];
  for (long long i = 16 * n16 + first; i < nbytes; i += stride)
    dst[i] = src[i];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One ring step's copy of nbytes from src into dst on `stream`. Returns
// 0, a cudaError_t code, or -1 for arguments this library does not take.
extern "C" int ag_bucket_step_launch(const void* src, void* dst,
                                     long long nbytes, void* stream) {
  if (nbytes <= 0) return 0;
  if (src == nullptr || dst == nullptr) return -1;
  const long long n16 = aligned16(src) && aligned16(dst) ? nbytes / 16 : 0;
  const long long work = n16 > 0 ? n16 : nbytes;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  ag_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes,
      n16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ag_bucket_error_string(int code) {
  if (code == -1) return "missing operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
