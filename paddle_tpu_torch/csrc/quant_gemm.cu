// Weight-only quantized GEMM for Hopper (sm_90a), and the local GEMM of the
// tensor-parallel serving projections.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels/quant_gemm.py:
// _quant_gemm_kernel (reached through quant_gemm_kernel, the pallas_call at
// :110):
//
//   out[r, f] = cast_to_x_dtype( (sum_k float(x[r, k]) * float(wq[k, f]))
//                                * scale[f] )
//
// x [R, K] bf16 or fp32, wq [K, F] int8 or float8_e4m3fn (row-major, F
// contiguous), scale [F] fp32 (one per output channel), out [R, F] in x's
// type. The sum is accumulated in fp32 and the scale is multiplied in fp32
// in the epilogue, with one rounding to the output type: the Pallas kernel's
// arithmetic, so the full-precision weight never exists in device memory.
//
// The same kernels carry the arithmetic of the fused GEMM + all-gather
// kernels of paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _gemm_ag_kernel (:448, bf16 weights, no scale) and _gemm_ag_q_kernel
// (:498, int8/fp8 weights with their scale): a rank's full-contraction
// column block x @ w_shard. Two additions serve them. Weights may be bf16
// (scale == nullptr: no multiply), against bf16 x or against the fp32 x of
// the LM head, where the bf16 -> fp32 conversion happens in registers, so
// the fp32 copy of the head shard that the reference makes
// (head_w.astype(float32)) never exists; the conversion is exact, so the
// product is the same. A head passed at fp32 stays fp32: fp32 weights
// (no scale) against fp32 x, on the stream kernel only. And the output
// has a row stride `ldo`: the epilogue
// stores the block straight into this rank's slot of the all-gather buffer
// (paddle_tpu_torch/ops/fused_collectives.py), which torch.distributed
// then gathers in place. The transfer itself, the in-kernel ring of remote
// DMAs on the TPU, is NCCL's all-gather outside the kernel.
//
// What bounds it on an H100. At serving's decode shapes (R = 8 slots) it
// reads each weight byte once and does 2 * R flops with it, far below the
// ~295 flop/byte the card needs before compute matters: bytes. GPT-3 1.3B's
// four block GEMMs read 12.6 + 4.2 + 16.8 + 16.8 MB per layer in int8 and the
// LM head 103 MB: 3.75, 1.25, 5.0, 5.0 and 30.8 us at 3.35 TB/s. A prefill
// chunk of R = 256 bf16 rows does 512 flops per weight byte: operations, on
// the bf16 tensor cores (989 TFLOP/s). A tensor-parallel rank's column
// shard reads 1/n of those bytes; bf16 weights twice the one-byte ones.
//
// Design, two kernels and a reduction:
// * stream (R <= 16, and any R with fp32 x): a block of 8 warps owns a
//   strip of 8 * VEC output columns for one group of RB rows; each thread
//   owns VEC columns (VEC = 16 weights for RB <= 4, VEC = 8 for RB = 8 and
//   16, which keeps the RB * VEC fp32 accumulators to at most 128
//   registers and two blocks on an SM at RB = 8; a k row of VEC weights is
//   one 8- or 16-byte load for one-byte weights, one or two 16-byte loads
//   for bf16, two or four for fp32). The block walks its k range 256 rows at a time: each
//   thread first issues the loads of its 8 weight rows of the chunk, then
//   the block stages the chunk's x in shared memory as fp32, k-major so
//   a thread reads a row's RB values with 16-byte loads, while those
//   loads are in flight. int8 -> fp32 is one byte permute and one add
//   (the 2^23 magic number); e4m3 -> fp32 goes through the hardware's
//   fp8x2 -> half2 conversion; bf16 -> fp32 is a 16-bit shift. The 32
//   k-row partial sums of a column are reduced over the warp with shuffles
//   and over the 8 warps in shared memory. Few column strips (F = 2048 is
//   32 strips) cannot fill 132 SMs, so the k range is split over blocks
//   until the launch fills the SMs once (quant_gemm_plan reads the
//   occupancy): each split writes fp32 partial sums and a second kernel
//   adds them in split order, multiplies the scale and casts. One split
//   writes the output directly.
// * tile (bf16 x, R > 16: prefill chunks): a 64 x 128 output tile per block
//   of 8 warps (each warp 32 x 32), k steps of 32. The x tile is copied to
//   shared memory as it is; the weight tile is converted to bf16 on its way
//   into shared memory (int8 and e4m3 are exact in bf16; bf16 weights are
//   copied as they are); the next step's tiles are loaded into registers
//   while this step computes. Fragments come from shared memory by
//   ldmatrix (the weight's transposed), and the products run on the tensor
//   cores as warp-level mma.sync m16n8k16 with fp32 accumulators (the
//   PTX ISA's m16n8k16 fragment layout). bf16 products are exact in
//   fp32, so this computes the stream kernel's sums up to their order. A
//   launch of few tiles splits k over blocks like the stream kernel. fp32
//   x always takes the stream kernel: rounding x to bf16 would change the
//   function.
// TMA, wgmma and a deeper pipelined ring of tiles are later work.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/quant_gemm.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ----------------------------------------------------------- weight types
struct Int8W { static constexpr int kSize = 1; };
struct Fp8W { static constexpr int kSize = 1; };
struct Bf16W { static constexpr int kSize = 2; };
struct Fp32W { static constexpr int kSize = 4; };

// one 32-bit word of weights -> fp32: four one-byte weights
// (quant_convert.cuh), two bf16 (exact: bf16 is fp32's top half) or one
// fp32
__device__ __forceinline__ void word_to_float(Int8W, uint32_t w, float* out) {
  int8x4_to_float(w, out);
}

__device__ __forceinline__ void word_to_float(Fp8W, uint32_t w, float* out) {
  fp8x4_to_float(w, out);
}

__device__ __forceinline__ void word_to_float(Bf16W, uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void word_to_float(Fp32W, uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}

// VEC weights of one k row, held as raw 32-bit words (8 to 64 bytes)
template <typename WT, int VEC>
struct WVec {
  static constexpr int kBytes = VEC * WT::kSize;
  static constexpr int kWords = kBytes / 4;
  static constexpr int kPerWord = 4 / WT::kSize;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x; w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void to_float(float* out) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) word_to_float(WT{}, w[i], out + i * kPerWord);
  }
};

// ------------------------------------------------------------- x / output
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------ stream kernel
constexpr int kTX = 8;                    // threads across a column strip
constexpr int kTY = kThreads / kTX;       // k rows per pass (32)
constexpr int kUnroll = 8;                // k rows of loads per thread
constexpr int kKC = kTY * kUnroll;        // k rows per chunk (256)

template <int RB>
struct StreamShape {
  static constexpr int kVec = RB <= 4 ? 16 : 8;   // columns per thread
  static constexpr int kStrip = kTX * kVec;       // columns per block
};

// x[i][0..RB) of the k-major staged chunk
template <int RB>
__device__ __forceinline__ void load_x(const float* xs, int i, float* xv) {
  if constexpr (RB % 4 == 0) {
    const float4* p = reinterpret_cast<const float4*>(xs + i * RB);
#pragma unroll
    for (int r = 0; r < RB / 4; ++r) {
      const float4 v = p[r];
      xv[4 * r] = v.x; xv[4 * r + 1] = v.y;
      xv[4 * r + 2] = v.z; xv[4 * r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) xv[r] = xs[i * RB + r];
  }
}

template <typename WT, typename XT, int RB>
__global__ void __launch_bounds__(kThreads)
quant_gemm_stream_kernel(const XT* __restrict__ x,       // [R, K]
                         const uint8_t* __restrict__ wq, // [K, F] raw bytes
                         const float* __restrict__ scale,  // [F] or null
                         XT* __restrict__ out,           // [R, ldo]
                         float* __restrict__ ws,         // [splits, R, F]
                         int R, int K, int F, int ldo, int k_per_split) {
  constexpr int VEC = StreamShape<RB>::kVec;
  constexpr int CB = StreamShape<RB>::kStrip;
  constexpr int kXs = RB * kKC;
  constexpr int kRed = kWarps * RB * CB;
  constexpr int kSmem = kXs > kRed ? kXs : kRed;
  __shared__ __align__(16) float smem[kSmem];

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * CB;
  const int col = col0 + tx * VEC;
  const int row0 = blockIdx.z * RB;
  const int split = blockIdx.y;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool col_ok = col < F;                 // F % 16 == 0: all or none

  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int kc0 = k_begin; kc0 < k_end; kc0 += kKC) {
    const int n = min(kKC, k_end - kc0);
    // this thread's weight rows of the chunk: in flight while x stages
    WVec<WT, VEC> w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = ty + u * kTY;
      if (col_ok && i < n)
        w[u].load(wq + (static_cast<size_t>(kc0 + i) * F + col) * WT::kSize);
      else
        w[u].zero();
    }
    for (int e = threadIdx.x; e < RB * kKC; e += kThreads) {
      const int r = e / kKC;
      const int i = e % kKC;
      const int row = row0 + r;
      smem[i * RB + r] =
          (row < R && i < n) ? to_f(x[static_cast<size_t>(row) * K + kc0 + i])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float wf[VEC];
      w[u].to_float(wf);
      float xv[RB];
      load_x<RB>(smem, ty + u * kTY, xv);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv[r], wf[v], acc[r][v]);
    }
    __syncthreads();
  }

  // the warp's 4 k-row groups share each column: reduce over lanes 8, 16
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float a = acc[r][v];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[r][v] = a;
    }
  float (*red)[RB][CB] = reinterpret_cast<float (*)[RB][CB]>(smem);
  if (lane < kTX) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][r][tx * VEC + v] = acc[r][v];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < RB * CB; e += kThreads) {
    const int r = e / CB;
    const int c = e % CB;
    const int row = row0 + r;
    const int f = col0 + c;
    if (row >= R || f >= F) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
    if (ws == nullptr)
      store(out + static_cast<size_t>(row) * ldo + f,
            scale == nullptr ? sum : sum * scale[f]);
    else
      ws[(static_cast<size_t>(split) * R + row) * F + f] = sum;
  }
}

// the split-k partial sums, added in split order, times the scale (none
// when scale is null)
template <typename XT>
__global__ void __launch_bounds__(kThreads)
quant_gemm_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ scale,
                         XT* __restrict__ out, int splits, int R, int F,
                         int ldo) {
  const size_t n = static_cast<size_t>(R) * F;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[s * n + i];
  const int f = static_cast<int>(i % F);
  const size_t o = (i / F) * static_cast<size_t>(ldo) + f;
  store(out + o, scale == nullptr ? sum : sum * scale[f]);
}

// -------------------------------------------------------------- tile kernel
constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kPadA = 8;                  // bf16 elements added to a row
constexpr int kPadB = 8;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                         a2 (g, 8+2t..)     a3 (g+8, 8+2t..)
//   B (16x8, k x n):      b0 (k = 2t..2t+1, n = g)   b1 (k = 8+2t.., n = g)
//   C (16x8, fp32):       c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// ldmatrix x4 of A at (row lane % 16, col 8 * (lane / 16)) returns a0..a3;
// ldmatrix x4.trans of the k-major weight tile at (k lane % 16, n 8 *
// (lane / 16)) returns b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
quant_gemm_tile_kernel(const __nv_bfloat16* __restrict__ x,   // [R, K]
                       const uint8_t* __restrict__ wq,        // [K, F] raw
                       const float* __restrict__ scale,       // [F] or null
                       __nv_bfloat16* __restrict__ out,       // [R, ldo]
                       float* __restrict__ ws,                // [splits, R, F]
                       int R, int K, int F, int ldo, int k_per_split) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kBK + kPadA];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK][kBN + kPadB];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 4;               // warp rows [wm*32, wm*32+32)
  const int wn = warp % 4;               // warp cols [wn*32, wn*32+32)
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // copy roles: x tile 64 x 32 bf16 = one 16-byte load a thread; weight
  // tile 32 x 128 = 16 weights a thread (one 16-byte load of one-byte
  // weights, two of bf16), written as 16 bf16
  const int ar = tid / 4;
  const int ak = (tid % 4) * 8;
  const int bk = tid / 8;
  const int bc = (tid % 8) * 16;
  uint4 a_next;
  WVec<WT, 16> b_next;
  auto fetch = [&](int k0) {
    a_next = make_uint4(0, 0, 0, 0);
    if (row0 + ar < R && k0 + ak < k_end)
      a_next = __ldg(reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(row0 + ar) * K + k0 + ak));
    if (k0 + bk < k_end && col0 + bc < F)
      b_next.load(wq + (static_cast<size_t>(k0 + bk) * F + col0 + bc) *
                             WT::kSize);
    else
      b_next.zero();
  };

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    *reinterpret_cast<uint4*>(&As[ar][ak]) = a_next;
    {
      uint4 lo, hi;
      if constexpr (WT::kSize == 2) {         // bf16 weights as they are
        lo = make_uint4(b_next.w[0], b_next.w[1], b_next.w[2], b_next.w[3]);
        hi = make_uint4(b_next.w[4], b_next.w[5], b_next.w[6], b_next.w[7]);
      } else {
        float wf[16];
        b_next.to_float(wf);
        lo.x = pack_bf16(wf[0], wf[1]);   lo.y = pack_bf16(wf[2], wf[3]);
        lo.z = pack_bf16(wf[4], wf[5]);   lo.w = pack_bf16(wf[6], wf[7]);
        hi.x = pack_bf16(wf[8], wf[9]);   hi.y = pack_bf16(wf[10], wf[11]);
        hi.z = pack_bf16(wf[12], wf[13]); hi.w = pack_bf16(wf[14], wf[15]);
      }
      *reinterpret_cast<uint4*>(&Bs[bk][bc]) = lo;
      *reinterpret_cast<uint4*>(&Bs[bk][bc + 8]) = hi;
    }
    __syncthreads();
    if (k0 + kBK < k_end) fetch(k0 + kBK);   // in flight while we compute
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], &As[wm * 32 + mi * 16 + (lane % 16)][kk + 8 * (lane / 16)]);
#pragma unroll
      for (int np = 0; np < 4; np += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, &Bs[kk + (lane % 16)][wn * 32 + np * 8 +
                                                8 * (lane / 16)]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the scale (if any) in fp32, one rounding to bf16 (or the
  // split's fp32 partial sums)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = col0 + wn * 32 + ni * 8 + 2 * t;
      if (c >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * 32 + mi * 16 + g + 8 * h;
        if (r >= R) continue;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        if (ws == nullptr)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) *
                                             ldo + c) =
              scale == nullptr ? __floats2bfloat162_rn(v0, v1)
                               : __floats2bfloat162_rn(v0 * scale[c],
                                                       v1 * scale[c + 1]);
        else
          *reinterpret_cast<float2*>(
              ws + (static_cast<size_t>(split) * R + r) * F + c) =
              make_float2(v0, v1);
      }
    }
}

// ---------------------------------------------------------------- dispatch
template <typename XT>
cudaError_t launch_reduce(const void* ws, const void* scale, void* out,
                          int R, int F, int ldo, int splits, cudaStream_t s) {
  const size_t n = static_cast<size_t>(R) * F;
  quant_gemm_reduce_kernel<XT><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                 s>>>(static_cast<const float*>(ws),
                                      static_cast<const float*>(scale),
                                      static_cast<XT*>(out), splits, R, F,
                                      ldo);
  return cudaGetLastError();
}

template <typename WT, typename XT, int RB>
cudaError_t launch_stream(const void* x, const void* wq, const void* scale,
                          void* out, void* ws, int R, int K, int F, int ldo,
                          int splits, int k_per_split, cudaStream_t s) {
  constexpr int CB = StreamShape<RB>::kStrip;
  const dim3 grid((F + CB - 1) / CB, splits, (R + RB - 1) / RB);
  quant_gemm_stream_kernel<WT, XT, RB><<<grid, kThreads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<XT*>(out),
      splits > 1 ? static_cast<float*>(ws) : nullptr, R, K, F, ldo,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<XT>(ws, scale, out, R, F, ldo, splits, s);
}

template <typename WT>
cudaError_t launch_tile(const void* x, const void* wq, const void* scale,
                        void* out, void* ws, int R, int K, int F, int ldo,
                        int splits, int k_per_split, cudaStream_t s) {
  const dim3 grid((F + kBN - 1) / kBN, (R + kBM - 1) / kBM, splits);
  quant_gemm_tile_kernel<WT><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(ws) : nullptr, R, K, F, ldo,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<__nv_bfloat16>(ws, scale, out, R, F, ldo, splits, s);
}

// the instance a (w dtype, x dtype, mode, row group) runs, or null
using Kernel = const void*;

template <typename WT, typename XT>
Kernel stream_instance(int rows) {
  switch (rows) {
    case 1: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, XT, 1>);
    case 2: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, XT, 2>);
    case 4: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, XT, 4>);
    case 8: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, XT, 8>);
    case 16: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, XT, 16>);
  }
  return nullptr;
}

template <typename WT>
Kernel instance(int x_dtype, int mode, int rows) {
  if (mode == 1)
    return x_dtype == 0 ? reinterpret_cast<Kernel>(quant_gemm_tile_kernel<WT>)
                        : nullptr;
  if (mode != 0) return nullptr;
  if (x_dtype == 0) return stream_instance<WT, __nv_bfloat16>(rows);
  if (x_dtype == 1) return stream_instance<WT, float>(rows);
  return nullptr;
}

Kernel any_instance(int w_dtype, int x_dtype, int mode, int rows) {
  switch (w_dtype) {
    case 0: return instance<Int8W>(x_dtype, mode, rows);
    case 1: return instance<Fp8W>(x_dtype, mode, rows);
    case 2: return instance<Bf16W>(x_dtype, mode, rows);
    case 3:  // fp32 weights: fp32 x, stream kernel
      return (x_dtype == 1 && mode == 0) ? stream_instance<Fp32W, float>(rows)
                                         : nullptr;
  }
  return nullptr;
}

template <typename WT, typename XT>
int dispatch_stream(const void* x, const void* wq, const void* scale,
                    void* out, void* ws, int R, int K, int F, int ldo,
                    int rows, int splits, int k_per_split, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch_stream<WT, XT, 1>(x, wq, scale, out, ws, R, K, F, ldo,
                                      splits, k_per_split, s);
    case 2:
      return launch_stream<WT, XT, 2>(x, wq, scale, out, ws, R, K, F, ldo,
                                      splits, k_per_split, s);
    case 4:
      return launch_stream<WT, XT, 4>(x, wq, scale, out, ws, R, K, F, ldo,
                                      splits, k_per_split, s);
    case 8:
      return launch_stream<WT, XT, 8>(x, wq, scale, out, ws, R, K, F, ldo,
                                      splits, k_per_split, s);
    case 16:
      return launch_stream<WT, XT, 16>(x, wq, scale, out, ws, R, K, F, ldo,
                                       splits, k_per_split, s);
  }
  return -1;
}

template <typename WT>
int dispatch(const void* x, const void* wq, const void* scale, void* out,
             void* ws, int R, int K, int F, int ldo, int x_dtype, int mode,
             int rows, int splits, int k_per_split, cudaStream_t s) {
  if (mode == 1) {
    if (x_dtype != 0) return -1;
    return static_cast<int>(launch_tile<WT>(x, wq, scale, out, ws, R, K, F,
                                            ldo, splits, k_per_split, s));
  }
  if (mode != 0) return -1;
  if (x_dtype == 0)
    return dispatch_stream<WT, __nv_bfloat16>(x, wq, scale, out, ws, R, K, F,
                                              ldo, rows, splits, k_per_split,
                                              s);
  if (x_dtype == 1)
    return dispatch_stream<WT, float>(x, wq, scale, out, ws, R, K, F, ldo,
                                      rows, splits, k_per_split, s);
  return -1;
}

}  // namespace

// How one call runs, written to plan[4] = {mode, rows, splits,
// k_per_split}: bf16 x with more than 16 rows takes the tile kernel (mode
// 1), everything else the stream kernel (mode 0) over row groups of
// `rows` = 1, 2, 4, 8 or 16. The k range is split over blocks (k_per_split
// rows each, a multiple of 256) until the launch fills the SMs of the
// current device once, as far as the occupancy of the instance allows;
// the tile kernel splits only a launch of fewer tiles than SMs. w_dtype:
// 0 = int8, 1 = float8_e4m3fn, 2 = bfloat16, 3 = float32. Returns 0, a
// cudaError_t
// code, or -1 for an unsupported combination.
extern "C" int quant_gemm_plan(int R, int K, int F, int w_dtype, int x_dtype,
                               int* plan) {
  if (R <= 0 || K <= 0 || F <= 0 || K % 16 != 0 || F % 16 != 0) return -1;
  const int mode = (x_dtype == 0 && R > 16) ? 1 : 0;
  int rows = 0;
  if (mode == 0) {
    const int want = R < 16 ? R : 16;
    rows = 1;
    while (rows < want) rows *= 2;
  }
  Kernel k = any_instance(w_dtype, x_dtype, mode, rows);
  if (k == nullptr) return -1;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks, splits, step;
  if (mode == 1) {
    blocks = ((F + kBN - 1) / kBN) * ((R + kBM - 1) / kBM);
    splits = blocks >= sms ? 1 : (sms + blocks - 1) / blocks;
    step = kBK;
  } else {
    const int strip = rows <= 4 ? kTX * 16 : kTX * 8;
    blocks = ((F + strip - 1) / strip) * ((R + rows - 1) / rows);
    splits = occ * sms / blocks;
    step = kKC;
  }
  const int max_splits = (K + step - 1) / step;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  int k_per = (K + splits - 1) / splits;
  k_per = (k_per + step - 1) / step * step;
  plan[0] = mode;
  plan[1] = rows;
  plan[2] = (K + k_per - 1) / k_per;
  plan[3] = k_per;
  return 0;
}

// w_dtype: 0 = int8, 1 = float8_e4m3fn, 2 = bfloat16, 3 = float32 (fp32 x
// only; for 2 and 3 scale may be null: no multiply). x_dtype: 0 =
// bfloat16, 1 = float32. out [R, ldo] in
// x's type, row r of the result at out + r * ldo (ldo >= F). mode, rows,
// splits and k_per_split as quant_gemm_plan gives them; ws = fp32
// [splits, R, F] scratch when splits > 1. Returns 0, a cudaError_t code, or
// -1 for an argument combination this library was not built for.
extern "C" int quant_gemm_launch(const void* x, const void* wq,
                                 const void* scale, void* out, void* ws,
                                 int R, int K, int F, int ldo, int w_dtype,
                                 int x_dtype, int mode, int rows, int splits,
                                 int k_per_split, void* stream) {
  if (R <= 0 || F <= 0) return 0;
  if (K % 16 != 0 || F % 16 != 0 || ldo < F || ldo % 2 != 0 || splits < 1 ||
      k_per_split <= 0 || (splits > 1 && ws == nullptr) ||
      (scale == nullptr && w_dtype != 2 && w_dtype != 3))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case 0:
      return dispatch<Int8W>(x, wq, scale, out, ws, R, K, F, ldo, x_dtype,
                             mode, rows, splits, k_per_split, s);
    case 1:
      return dispatch<Fp8W>(x, wq, scale, out, ws, R, K, F, ldo, x_dtype,
                            mode, rows, splits, k_per_split, s);
    case 2:
      return dispatch<Bf16W>(x, wq, scale, out, ws, R, K, F, ldo, x_dtype,
                             mode, rows, splits, k_per_split, s);
    case 3:
      if (x_dtype != 1 || mode != 0) return -1;
      return dispatch_stream<Fp32W, float>(x, wq, scale, out, ws, R, K, F,
                                           ldo, rows, splits, k_per_split, s);
  }
  return -1;
}

extern "C" const char* quant_gemm_error_string(int code) {
  if (code == -1) return "unsupported dtype, mode, row group or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
