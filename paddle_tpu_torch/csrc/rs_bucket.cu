// grad_comm's bucketed reduce-scatter (row 10) in one launch, for
// paddle_tpu_torch/ops/fused_collectives.py:fused_rs_bucket.
//
// Replaces paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _rs_bucket_kernel (:361, through fused_rs_bucket :642; oracle
// rs_bucket_reference :1032). Every one of the n data-parallel ranks holds
// an (n, cols) bucket of its flat gradients; rank i's result is row i
// summed over the ranks, in fp32. The TPU kernel runs a ring: at step t
// rank i adds part x_i[(i - t - 1) mod n] to the accumulator its left
// neighbour sent, cast to the wire dtype (fp32 or bf16) before each hop,
// and moves it with in-kernel remote DMAs. Unrolled, row i is
//
//   acc = f32(x_{i+1}[i]);  for k = 2 .. n: acc = f32(wire(acc)) + x_{i+k}[i]
//
// (ranks mod n, wire = round to nearest even, one IEEE fp32 add a term).
//
// Here rank i computes that sum itself, in that order and with those
// roundings, so the result is the plain ring's bit for bit by
// construction. Each rank has written its bucket into its staging region
// of a peer-memory channel (peer_barrier.cuh) before the launch; the
// kernel runs the entry barrier, pulls row i of every peer's staging over
// NVLink (CUDA IPC mappings made once per group) with 16-byte loads, all
// n loads of a group in flight before the adds, writes the fp32 row and
// runs the exit barrier, after which the caller may overwrite its staging.
// One launch a call, no NCCL hop, no host round trip. The division by n
// and the cast to the bucket dtype stay with the caller, as in the
// reference (grad_comm.py:306-309).
//
// The bf16 wire: the pull reads the fp32 parts (the bucket's dtype), so it
// no longer halves the NVLink bytes as the ring's bf16 hops did; it keeps
// the rounding at every term that defines that rung's result.
//
// What bounds it on an H100: NVLink bytes. Rank i receives (n - 1) x cols
// x 4 bytes of fp32 parts (at GPT-3 1.3B's largest bucket, c = 25,755,648
// at n = 4: 309 MB, 0.687 ms at 450 GB/s one way), while its HBM serves
// n x cols x 4 bytes of its staging to the n readers and takes cols x 4 of
// output (0.5 GB, 0.15 ms at 3.35 TB/s). Small buckets are bound by the
// launch and the two barriers' NVLink round trips (a few microseconds).
// The grid holds at most two blocks of 512 threads per SM (never more than
// are resident at once), each thread 8 columns a step.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "peer_barrier.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the value after a hop on the wire: fp32 unchanged, bf16 rounded to
// nearest even and widened back
template <typename WireT>
__device__ __forceinline__ float on_wire(float v);
template <>
__device__ __forceinline__ float on_wire<float>(float v) { return v; }
template <>
__device__ __forceinline__ float on_wire<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight values of group g (elements 8g .. 8g + 7) of a 16-byte aligned row
__device__ __forceinline__ void load8(const float* p, long long g,
                                      float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[2 * g];
  const float4 b = reinterpret_cast<const float4*>(p)[2 * g + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long g,
                                      float v[8]) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[g];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// row `rank` of every rank's (N, cols) staging, summed in the ring's order
// into out (fp32). Groups [0, n8) by 16-byte vectors, elements [8 n8,
// cols) one by one (n8 = 0: the row is not 16-byte aligned).
template <typename PartT, typename WireT, int N>
__global__ void __launch_bounds__(kThreads)
rs_pull_kernel(peer::Peers a, float* __restrict__ out, long long cols,
               long long n8) {
  const uint32_t e = peer::next_epoch(a);
  peer::barrier(a, e, 0);
  // the term order: rank + 1, rank + 2, ..., rank + N (= rank itself)
  const PartT* rows[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    rows[k] = static_cast<const PartT*>(a.data[(a.rank + 1 + k) % N]) +
              a.rank * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  for (long long g = first; g < n8; g += stride) {
    float v[N][8];
#pragma unroll
    for (int k = 0; k < N; ++k) load8(rows[k], g, v[k]);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j] = v[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k)
        acc[j] = __fadd_rn(on_wire<WireT>(acc[j]), v[k][j]);
    }
    reinterpret_cast<float4*>(out)[2 * g] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(out)[2 * g + 1] =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  for (long long c = 8 * n8 + first; c < cols; c += stride) {
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f32(rows[k][c]);
    float acc = v[0];
#pragma unroll
    for (int k = 1; k < N; ++k) acc = __fadd_rn(on_wire<WireT>(acc), v[k]);
    out[c] = acc;
  }
  peer::barrier(a, e, 1);
  peer::finish(a, e);
}

template <typename Kernel>
int resident_grid(Kernel kernel) {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    per_sm = per_sm < 2 ? per_sm : 2;
    grid = sms * per_sm < peer::kMaxBlocks ? sms * per_sm : peer::kMaxBlocks;
  }
  return grid;
}

template <typename PartT, typename WireT, int N>
cudaError_t launch_n(const peer::Peers& a, float* out, long long cols,
                     bool vec, cudaStream_t stream) {
  auto kernel = rs_pull_kernel<PartT, WireT, N>;
  // the grid depends on cols alone (not on this rank's alignment), so
  // every rank launches the same blocks and block b meets block b
  const long long want = ((cols + 7) / 8 + kThreads - 1) / kThreads;
  const int most = resident_grid(kernel);
  if (most <= 0) return cudaErrorInvalidConfiguration;
  const int blocks = static_cast<int>(want < most ? want : most);
  kernel<<<blocks, kThreads, 0, stream>>>(a, out, cols, vec ? cols / 8 : 0);
  return cudaGetLastError();
}

template <typename PartT, typename WireT>
cudaError_t launch(const peer::Peers& a, float* out, long long cols,
                   bool vec, cudaStream_t s) {
  switch (a.n) {
    case 2: return launch_n<PartT, WireT, 2>(a, out, cols, vec, s);
    case 3: return launch_n<PartT, WireT, 3>(a, out, cols, vec, s);
    case 4: return launch_n<PartT, WireT, 4>(a, out, cols, vec, s);
    case 5: return launch_n<PartT, WireT, 5>(a, out, cols, vec, s);
    case 6: return launch_n<PartT, WireT, 6>(a, out, cols, vec, s);
    case 7: return launch_n<PartT, WireT, 7>(a, out, cols, vec, s);
    case 8: return launch_n<PartT, WireT, 8>(a, out, cols, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One call of row 10 on `stream`: out (cols,) fp32 <- row `rank` of the n
// ranks' (n, cols) staging buckets summed in the ring's order. data[p] and
// pads[p]: rank p's staging and signal pad as mapped in this process
// (data[p] = pads[p] + the pad's bytes). part_dtype and wire_dtype: 0
// float32, 1 bfloat16. Returns 0, a cudaError_t code, or -1 for arguments
// this library does not take.
extern "C" int rs_pull_launch(int part_dtype, int wire_dtype,
                              void* const* data, void* const* pads, int n,
                              int rank, long long cols, void* out, void* err,
                              unsigned long long timeout_ns, void* stream) {
  if (n < 2 || n > peer::kMaxRanks || rank < 0 || rank >= n || cols <= 0 ||
      out == nullptr || err == nullptr)
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
  a.row = 10;
  const long long esize = part_dtype == 0 ? 4 : 2;
  const bool vec = (reinterpret_cast<uintptr_t>(data[rank]) +
                    rank * cols * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (part_dtype == 0 && wire_dtype == 0)
    rc = launch<float, float>(a, o, cols, vec, s);
  else if (part_dtype == 0 && wire_dtype == 1)
    rc = launch<float, __nv_bfloat16>(a, o, cols, vec, s);
  else if (part_dtype == 1 && wire_dtype == 0)
    rc = launch<__nv_bfloat16, float>(a, o, cols, vec, s);
  else if (part_dtype == 1 && wire_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(a, o, cols, vec, s);
  else
    return -1;
  return static_cast<int>(rc);
}

extern "C" const char* rs_bucket_error_string(int code) {
  if (code == -1) return "unsupported dtype, group size or missing operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
