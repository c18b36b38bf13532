// The ring step of grad_comm's bucketed reduce-scatter (row 10), for
// paddle_tpu_torch/ops/fused_collectives.py:fused_rs_bucket.
//
// Replaces paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _rs_bucket_kernel (:361, through fused_rs_bucket :642; oracle
// rs_bucket_reference :1032). An (n, cols) bucket of one replica's flat
// gradients goes around the ring of the n data-parallel replicas: at ring
// step t replica i takes part = x[(i - t - 1) mod n] in fp32; at t = 0 the
// traveling accumulator is that part, at t > 0 it is the accumulator the
// left neighbour sent, widened to fp32, plus the part (one IEEE fp32 add).
// Before each of the n - 1 hops the accumulator is cast to the wire dtype
// (fp32 or bf16, round to nearest even); after the last step replica i
// holds row i summed over the replicas, in fp32. The wire is compressed,
// the accumulation is not (EQuARX's trick), which is why NCCL's own
// reduce-scatter (it sums in the wire dtype) cannot stand for a bf16 wire.
//
// The TPU kernel moves the accumulator with in-kernel remote DMAs. Here a
// hop is an NCCL send/recv pair outside the kernel (MPGroup.
// ring_shift_async, as rows 7-9 use it), and this kernel is what each ring
// step computes in between: one fused elementwise pass that reads the
// received wire row and this step's part and writes, in the same pass,
// the next hop's send buffer (the accumulator cast to the wire) and, at the
// last step, the fp32 output row. At t = 0 it only casts the part to the
// wire. No fp32 accumulator is stored between steps: the send buffer is
// the accumulator in flight.
//
// What bounds it on an H100: bytes. One step over c columns at an fp32
// part reads 4c (part) + w c (received) and writes w c (send) or 4c (out),
// w the wire's width: at GPT-3 1.3B's largest bucket (c = 25,755,648, the
// embedding or the head at n = 4) 0.31 GB, 92 us at 3.35 TB/s; the hop
// beside it moves w c bytes over NVLink (103 MB at fp32, 229 us at 450
// GB/s). So a call is bound by NVLink, and a kernel pass costs at most
// ~0.4x its hop. Loads and stores are 16 bytes a thread (eight values a
// group) with a scalar tail; a row whose address is not 16-byte aligned
// (a bucket row of odd width) takes the scalar loop throughout. The
// division by n and the cast to the bucket dtype stay outside the kernel,
// as in the reference (grad_comm.py:306-309).
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
__device__ __forceinline__ void store8(float* p, long long g,
                                       const float v[8]) {
  reinterpret_cast<float4*>(p)[2 * g] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[2 * g + 1] =
      make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, long long g,
                                       const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  reinterpret_cast<uint4*>(p)[g] = u;
}

// acc = part (recv null) or float(recv) + part; out <- acc (fp32, if not
// null), send <- acc cast to the wire (if not null). Groups [0, n8) by
// 16-byte vectors, elements [8 n8, n) one by one.
template <typename PartT, typename WireT>
__global__ void __launch_bounds__(kThreads)
rs_step_kernel(const PartT* __restrict__ part,
               const WireT* __restrict__ recv, float* __restrict__ out,
               WireT* __restrict__ send, long long n, long long n8) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  for (long long g = first; g < n8; g += stride) {
    float acc[8];
    load8(part, g, acc);
    if (recv != nullptr) {
      float r[8];
      load8(recv, g, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(r[j], acc[j]);
    }
    if (out != nullptr) store8(out, g, acc);
    if (send != nullptr) store8(send, g, acc);
  }
  for (long long i = 8 * n8 + first; i < n; i += stride) {
    float acc = to_f32(part[i]);
    if (recv != nullptr) acc = __fadd_rn(to_f32(recv[i]), acc);
    if (out != nullptr) out[i] = acc;
    if (send != nullptr) send[i] = from_f32<WireT>(acc);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename PartT, typename WireT>
cudaError_t launch(const void* part, const void* recv, void* out, void* send,
                   long long n, cudaStream_t stream) {
  const bool vec = aligned16(part) && aligned16(recv) && aligned16(out) &&
                   aligned16(send);
  const long long n8 = vec ? n / 8 : 0;
  const long long work = (n8 > 0 ? n8 : n);
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  rs_step_kernel<PartT, WireT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const PartT*>(part), static_cast<const WireT*>(recv),
      static_cast<float*>(out), static_cast<WireT*>(send), n, n8);
  return cudaGetLastError();
}

}  // namespace

// One ring step over n elements on `stream`. part_dtype and wire_dtype: 0
// float32, 1 bfloat16. recv (wire dtype) may be null (the first step), out
// (float32) and send (wire dtype) may each be null, not both. Returns 0, a
// cudaError_t code, or -1 for arguments this library does not take.
extern "C" int rs_bucket_step_launch(int part_dtype, int wire_dtype,
                                     const void* part, const void* recv,
                                     void* out, void* send, long long n,
                                     void* stream) {
  if (n <= 0) return 0;
  if (part == nullptr || (out == nullptr && send == nullptr)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (part_dtype == 0 && wire_dtype == 0)
    err = launch<float, float>(part, recv, out, send, n, s);
  else if (part_dtype == 0 && wire_dtype == 1)
    err = launch<float, __nv_bfloat16>(part, recv, out, send, n, s);
  else if (part_dtype == 1 && wire_dtype == 0)
    err = launch<__nv_bfloat16, float>(part, recv, out, send, n, s);
  else if (part_dtype == 1 && wire_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(part, recv, out, send, n, s);
  else
    return -1;
  return static_cast<int>(err);
}

extern "C" const char* rs_bucket_error_string(int code) {
  if (code == -1) return "unsupported dtype or missing operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
