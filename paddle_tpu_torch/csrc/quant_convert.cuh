// One-byte quantized values -> fp32, four at a time, shared by the
// quantized kernels (paged_decode.cu's int8/fp8 pools, quant_gemm.cu's
// weights). Both conversions are exact.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

// four int8 values in one word -> fp32: the biased byte b = v + 128 makes
// float(2^23 + b) exactly, and subtracting 2^23 + 128 leaves v
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// four e4m3 values in one word -> fp32 (through the hardware's
// fp8x2 -> half2 conversion)
__device__ __forceinline__ void fp8x4_to_float(uint32_t w, float* out) {
  __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(*reinterpret_cast<__half2*>(&lo));
  const float2 b = __half22float2(*reinterpret_cast<__half2*>(&hi));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
