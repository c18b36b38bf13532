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
// column block x @ w_shard. Weights may be bf16 (scale == nullptr: no
// multiply), against bf16 x or against the fp32 x of the LM head, and a
// head passed at fp32 stays fp32 (fp32 weights against fp32 x). The output
// has a row stride `ldo`, and the epilogue stores the block wherever the
// caller points it: the fused projections (ops/fused_collectives.py) point
// it at this rank's slot of the group's "gemm_ag" peer channel, whose
// blocks gemm_ag.cu's gather then reads over NVLink.
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
// Design: one kernel for bf16 x at every R, wgmma fed by TMA
// (quant_gemm_tc_kernel), and the CUDA-core stream kernel for fp32 x.
//
// * Swap A and B: the kernel computes out^T[F, R] = W^T x^T, so the
//   weight's output columns fill wgmma's M (64 per consumer warpgroup, two
//   warpgroups: 128 columns a block) and x's rows fill N (R rounded up to
//   8, 16, 32, 64 or 128 a block; more rows are more blocks). Decode's 8
//   rows run on the tensor cores too, as m64n8k16 products.
// * A producer warp streams the stage's weight tile (64 k rows by 128
//   columns, one TMA box of one-byte weights or two of bf16) and x's tile
//   (N rows by 64 k, K-major, zero-filled past R and K by TMA) through a
//   ring of kStages stages with full/empty mbarriers, 128-byte swizzle.
// * wgmma takes 8-bit operands only against 8-bit ones, and x is bf16, so
//   the weight becomes bf16 on chip: each consumer thread reads its bytes
//   of the stage from shared memory and builds wgmma's A fragment in
//   registers (quant_convert.cuh's exact int8 / e4m3 -> fp32 conversions,
//   then fp32 -> bf16, exact for both), and issues register-A wgmma with x
//   from shared memory through its descriptor. The fragment's rows are
//   permuted: the two rows a thread holds (g and g + 8 of its warp's 16)
//   are the adjacent columns 2g and 2g + 1, so a thread reads two bytes (or
//   two bf16) per k row, and its accumulators hold adjacent columns of an
//   output row, stored as one bf16 pair: a warp writes whole 32-byte
//   sectors without staging through shared memory. bf16 weights are read
//   and permuted into the same fragments. Fragments are double-buffered:
//   the products of one stage run while the next stage converts.
// * Epilogue: the scale multiplied in fp32, one rounding to bf16, stored at
//   row stride ldo. A launch whose column tiles cannot fill the SMs (out
//   and down at F = 2048, tensor-parallel shards, decode) splits k over
//   blocks: each split writes its fp32 partial tile to a workspace, and
//   quant_gemm_reduce_kernel, launched after it, adds the partials in
//   split order, multiplies the scale and rounds once: the same bits on
//   every call, and the partials are read by the whole card rather than
//   by one block per tile (PERF.md, PR 11, times both).
// * stream (fp32 x: the LM head's final-LayerNorm output, fp32 weights):
//   a block of 8 warps owns a strip of 8 * VEC output columns for one
//   group of RB rows (RB = 1, 2, 4, 8, 16), each thread VEC columns; the
//   block walks its k range 256 rows at a time, the thread's 8 weight rows
//   of the chunk in flight while x stages in shared memory; the products
//   are fp32 FMAs, so the sum is the fp32 function itself (rounding x to
//   bf16 would change it). Split launches are added up by the same
//   second pass.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/quant_gemm.py). The tensor
// maps are encoded per call in the launch function (csrc/sm90.cuh) and
// passed as __grid_constant__ parameters, so a launch captured in a CUDA
// graph replays with its own maps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant_convert.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Error codes of the launch functions besides cudaError_t's and
// sm90.cuh's encode codes.
constexpr int kErrUnsupported = -1;

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

template <typename WT, int RB>
__global__ void __launch_bounds__(kThreads)
quant_gemm_stream_kernel(const float* __restrict__ x,    // [R, K]
                         const uint8_t* __restrict__ wq, // [K, F] raw bytes
                         const float* __restrict__ scale,  // [F] or null
                         float* __restrict__ out,        // [R, ldo]
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
          (row < R && i < n) ? x[static_cast<size_t>(row) * K + kc0 + i]
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
      out[static_cast<size_t>(row) * ldo + f] =
          scale == nullptr ? sum : sum * scale[f];
    else
      ws[(static_cast<size_t>(split) * R + row) * F + f] = sum;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the split-k partial sums, added in split order, times the scale (none
// when scale is null), one rounding to the output type
template <typename OT>
__global__ void __launch_bounds__(kThreads)
quant_gemm_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ scale,
                         OT* __restrict__ out, int splits, int R, int F,
                         int ldo) {
  const size_t n = static_cast<size_t>(R) * F;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[s * n + i];
  const int f = static_cast<int>(i % F);
  store(out + (i / F) * static_cast<size_t>(ldo) + f,
        scale == nullptr ? sum : sum * scale[f]);
}

// ------------------------------------------------------- tensor-core kernel
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 32;   // + the producer warp
constexpr int kBM = 128;                      // output columns a block
constexpr int kMinSplitK = 256;               // k rows a split takes at least

// weight kinds of the tensor-core kernel (quant_gemm_launch's w_dtype)
constexpr int kInt8 = 0;
constexpr int kFp8 = 1;
constexpr int kBf16 = 2;

// One instance's shape. A stage holds kBK k rows: the weight tile (kBK
// rows by 128 columns: one box of 128-byte rows of one-byte weights, or
// two boxes of 64 bf16) then x's tile as kBK / 64 boxes of N rows of 64
// bf16, every tile a multiple of the swizzle's 1024-byte period. N = 8 to
// 32 (decode) run two blocks an SM, 64-row stages, 4 of them; the wider
// ones one block an SM, 128-row stages, 3 of them (x's tile is then read
// half as often per product). kAcc accumulators (16 registers in all,
// as two blocks an SM allow) take the k16 slices in turn, so that narrow
// products do not wait on each other. (PERF.md, PR 11, has the forms that
// were timed.)
template <int W, int N>
struct TcShape {
  static constexpr bool kNarrow = N <= 32;
  static constexpr int kBK = kNarrow ? 64 : 128;
  static constexpr int kStages = kNarrow ? 4 : 3;
  static constexpr int kChunks = kBK / 64;
  static constexpr int kMinBlocks = kNarrow ? 2 : 1;
  static constexpr int kAcc = N < 32 ? 32 / N : 1;
  static constexpr int kW = kBK * kBM * (W == kBf16 ? 2 : 1);
  static constexpr int kX = N * kBK * 2;
  static constexpr int kStage = kW + kX;
  static constexpr int kBytes = kStages * kStage + 1024;   // + alignment
};

#define WG_F4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])

// d[64 x N] += A[64 x 16] B[16 x N]: A from registers, B K-major in shared
// memory (x's tile; the descriptor's low word)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint32_t b);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%8, %9};\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, db, p, 1, 1, 0;\n}\n"
      : WG_F4(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%12, %13};\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, db, p, 1, 1, 0;\n}\n"
      : WG_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%20, %21};\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, db, p, 1, 1, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 0;\n}\n"
      : WG_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%68, %69};\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 0;\n}\n"
      : WG_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

// A fragment words from the stage's bytes. lo and hi hold this thread's two
// columns (c, c + 1) at k rows k0 and k0 + 1 (one byte or one bf16 each);
// fa and fb become the A words of fragment rows c and c + 1: (k0, k0 + 1)
// as a bf16 pair, k0 in the low half.
template <int W>
__device__ __forceinline__ void to_fragment(uint32_t lo, uint32_t hi,
                                            uint32_t& fa, uint32_t& fb) {
  if constexpr (W == kBf16) {
    fa = __byte_perm(lo, hi, 0x5410);
    fb = __byte_perm(lo, hi, 0x7632);
  } else {
    // bytes (c @ k0, c @ k0 + 1, c+1 @ k0, c+1 @ k0 + 1)
    const uint32_t w = __byte_perm(lo, hi, 0x5140);
    float f[4];
    if constexpr (W == kInt8)
      int8x4_to_float(w, f);
    else
      fp8x4_to_float(w, f);
    fa = pack_bf16(f[0], f[1]);
    fb = pack_bf16(f[2], f[3]);
  }
}

// One block: output columns [f0, f0 + 128) of rows [r0, r0 + N), k steps
// [step0, step0 + n_steps) of kBK rows (split blockIdx.y of gridDim.y).
// barriers: s stage s full; kStages + s stage s empty.
template <int W, int N>
__global__ void __launch_bounds__(kTcThreads, TcShape<W, N>::kMinBlocks)
quant_gemm_tc_kernel(const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tx,
                     const float* __restrict__ scale,    // [F] or null
                     __nv_bfloat16* __restrict__ out,    // [R, ldo]
                     float* __restrict__ ws,     // [splits, R, F] if split
                     int R, int F, int ldo, int k_steps, int split_steps,
                     WaitRecord* rec) {
  using L = TcShape<W, N>;
  constexpr int kStages = L::kStages, kBK = L::kBK;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t base = aligned_base(smem);
  uint8_t* const sm = smem + (base - smem_u32(smem));
  const Waiter wt{smem_u32(bars), rec, 3};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.x * kBM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = blockIdx.z * N;
  const int step0 = split * split_steps;
  const int n_steps = min(k_steps - step0, split_steps);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(wt.at(s), 1);
      mbar_init(wt.at(kStages + s), kConsumers / 32);   // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {                      // the producer
    if (lane == 0) {
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          wt.wait(kStages + s, ((it / kStages) - 1) & 1, it);
        const uint32_t st = base + s * L::kStage;
        const int k = (step0 + it) * kBK;
        mbar_expect_tx(wt.at(s), L::kStage);
        tma_load_2d(st, &tw, wt.at(s), f0, k);
        if constexpr (W == kBf16)
          tma_load_2d(st + L::kW / 2, &tw, wt.at(s), f0 + kBM / 2, k);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_2d(st + L::kW + c * N * 128, &tx, wt.at(s), k + 64 * c,
                      r0);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns columns [f0 + 64 wg, f0 + 64 wg + 64);
  // this thread the columns c and c + 1 (fragment rows 16w + g and
  // 16w + g + 8) at k rows 2q, 2q + 1, 2q + 8, 2q + 9 of each k16 slice
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int cl = 16 * w + 2 * g;                      // column in the 64
  // byte offset of (row k, this thread's columns) in a stage's weight tile
  // less k * 128: 128-byte rows, 16-byte chunk index XOR (k % 8), and
  // k % 8 is 2q (even rows) or 2q + 1 (odd rows) for every row it reads
  // (bf16: warpgroup wg's box of 64 columns; one-byte: its half of the
  // 128-byte row)
  const int byte = W == kBf16 ? 2 * cl : 64 * wg + cl;
  const int box = W == kBf16 ? wg * (L::kW / 2) : 0;
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    off[h] = box + (((byte >> 4) ^ (2 * q + h)) << 4) + (byte & 15);

  constexpr int kAcc = L::kAcc;
  float acc[kAcc][N / 2];
#pragma unroll
  for (int h = 0; h < kAcc; ++h)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[h][i] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[b][j][i] = 0u;

  // 64 k rows of the stage's tiles: the fragments into buffer B, the
  // products issued; the previous chunk's products are then done, so its
  // buffer may be rewritten (and, at a stage's first chunk, the previous
  // stage refilled)
  auto chunk = [&](auto buf, const uint8_t* tile, uint32_t x_lo, int c) {
    constexpr int B = decltype(buf)::value;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int k0 = 64 * c + 16 * j + 8 * m + 2 * q;
        uint32_t lo, hi;
        if constexpr (W == kBf16) {
          lo = *reinterpret_cast<const uint32_t*>(tile + k0 * 128 + off[0]);
          hi = *reinterpret_cast<const uint32_t*>(tile + (k0 + 1) * 128 +
                                                  off[1]);
        } else {
          lo = *reinterpret_cast<const uint16_t*>(tile + k0 * 128 + off[0]);
          hi = *reinterpret_cast<const uint16_t*>(tile + (k0 + 1) * 128 +
                                                  off[1]);
        }
        to_fragment<W>(lo, hi, a[B][j][2 * m], a[B][j][2 * m + 1]);
      }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs<N>(acc[j % kAcc], a[B][j],
                  desc_at(x_lo, c * N * 128 + 32 * j));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(a[1 - B]);
  };
  // one stage: its chunks alternate the buffers, starting at P
  auto step = [&](auto par, int it) {
    constexpr int P = decltype(par)::value;
    const int s = it % kStages;
    wt.wait(s, (it / kStages) & 1, it);
    __syncwarp();
    const uint8_t* tile = sm + s * L::kStage;
    const uint32_t x_lo = desc_lo(base + s * L::kStage + L::kW);
    chunk(std::integral_constant<int, P>{}, tile, x_lo, 0);
    __syncwarp();
    if (it > 0 && lane == 0) mbar_arrive(wt.at(kStages + (it - 1) % kStages));
    if constexpr (L::kChunks == 2)
      chunk(std::integral_constant<int, 1 - P>{}, tile, x_lo, 1);
  };
  static_assert(L::kChunks == 1 || L::kChunks == 2, "a stage's chunks");
  int it = 0;
  if constexpr (L::kChunks % 2 == 0) {
    for (; it < n_steps; ++it) step(std::integral_constant<int, 0>{}, it);
  } else {
    for (; it + 1 < n_steps; it += 2) {
      step(std::integral_constant<int, 0>{}, it);
      step(std::integral_constant<int, 1>{}, it + 1);
    }
    if (it < n_steps) step(std::integral_constant<int, 0>{}, it);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < kAcc; ++h) fence_regs(acc[h]);
  fence_regs(a[0]);
  fence_regs(a[1]);
#pragma unroll
  for (int h = 1; h < kAcc; ++h)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[0][i] += acc[h][i];

  // epilogue: accumulator d[4j + e] holds fragment row g + 8 (e / 2), that
  // is column c + e / 2, of x row 8j + 2q + e % 2
  const int c = f0 + 64 * wg + cl;    // F % 16 == 0: c < F is c + 1 < F
  float sa = 1.f, sb = 1.f;
  if (scale != nullptr && c < F) {
    const float2 s2 = *reinterpret_cast<const float2*>(scale + c);
    sa = s2.x;
    sb = s2.y;
  }
  if (splits == 1) {
    if (c >= F) return;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * j + 2 * q + e;
        if (r < R)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(r) * ldo + c) =
              __floats2bfloat162_rn(acc[0][4 * j + e] * sa,
                                    acc[0][4 * j + 2 + e] * sb);
      }
    return;
  }

  // a split: this block's fp32 partial tile; quant_gemm_reduce_kernel
  // adds the splits in split order
  if (c >= F) return;
  float* part = ws + static_cast<size_t>(split) * R * F;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * j + 2 * q + e;
      if (r < R)
        *reinterpret_cast<float2*>(part + static_cast<size_t>(r) * F + c) =
            make_float2(acc[0][4 * j + e], acc[0][4 * j + 2 + e]);
    }
}

// ---------------------------------------------------------------- dispatch
template <typename OT>
cudaError_t launch_reduce(const void* ws, const void* scale, void* out,
                          int R, int F, int ldo, int splits, cudaStream_t s) {
  const size_t n = static_cast<size_t>(R) * F;
  quant_gemm_reduce_kernel<OT><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                 s>>>(static_cast<const float*>(ws),
                                      static_cast<const float*>(scale),
                                      static_cast<OT*>(out), splits, R, F,
                                      ldo);
  return cudaGetLastError();
}

template <typename WT, int RB>
cudaError_t launch_stream(const void* x, const void* wq, const void* scale,
                          void* out, void* ws, int R, int K, int F, int ldo,
                          int splits, int k_per_split, cudaStream_t s) {
  constexpr int CB = StreamShape<RB>::kStrip;
  const dim3 grid((F + CB - 1) / CB, splits, (R + RB - 1) / RB);
  quant_gemm_stream_kernel<WT, RB><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out),
      splits > 1 ? static_cast<float*>(ws) : nullptr, R, K, F, ldo,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<float>(ws, scale, out, R, F, ldo, splits, s);
}

// the stream instance of a weight type and row group, or null
using Kernel = const void*;

template <typename WT>
Kernel stream_instance(int rows) {
  switch (rows) {
    case 1: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, 1>);
    case 2: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, 2>);
    case 4: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, 4>);
    case 8: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, 8>);
    case 16: return reinterpret_cast<Kernel>(quant_gemm_stream_kernel<WT, 16>);
  }
  return nullptr;
}

Kernel stream_any(int w_dtype, int rows) {
  switch (w_dtype) {
    case 0: return stream_instance<Int8W>(rows);
    case 1: return stream_instance<Fp8W>(rows);
    case 2: return stream_instance<Bf16W>(rows);
    case 3: return stream_instance<Fp32W>(rows);
  }
  return nullptr;
}

template <typename WT>
int dispatch_stream(const void* x, const void* wq, const void* scale,
                    void* out, void* ws, int R, int K, int F, int ldo,
                    int rows, int splits, int k_per_split, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch_stream<WT, 1>(x, wq, scale, out, ws, R, K, F, ldo,
                                  splits, k_per_split, s);
    case 2:
      return launch_stream<WT, 2>(x, wq, scale, out, ws, R, K, F, ldo,
                                  splits, k_per_split, s);
    case 4:
      return launch_stream<WT, 4>(x, wq, scale, out, ws, R, K, F, ldo,
                                  splits, k_per_split, s);
    case 8:
      return launch_stream<WT, 8>(x, wq, scale, out, ws, R, K, F, ldo,
                                  splits, k_per_split, s);
    case 16:
      return launch_stream<WT, 16>(x, wq, scale, out, ws, R, K, F, ldo,
                                   splits, k_per_split, s);
  }
  return kErrUnsupported;
}

template <int W, int N>
cudaError_t tc_ready(unsigned* ready) {
  return allow_smem(quant_gemm_tc_kernel<W, N>, TcShape<W, N>::kBytes,
                    ready);
}

template <int W, int N>
int launch_tc(const void* x, const void* wq, const void* scale, void* out,
              void* ws, int R, int K, int F, int ldo, int splits,
              int k_per_split, cudaStream_t s) {
  using L = TcShape<W, N>;
  static unsigned ready = 0;
  cudaError_t err = tc_ready<W, N>(&ready);
  if (err != cudaSuccess) return err;
  const int k_steps = (K + L::kBK - 1) / L::kBK;
  if (k_per_split % L::kBK != 0 ||
      (k_per_split / L::kBK) * (splits - 1) >= k_steps)
    return kErrUnsupported;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tw, tx;
  int rc;
  if ((rc = W == kBf16
                ? encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wq, K,
                            F, kBM / 2, L::kBK)
                : encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, F,
                            kBM, L::kBK)) ||
      (rc = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, R, K, 64,
                      N)))
    return rc;
  const dim3 grid((F + kBM - 1) / kBM, splits, (R + N - 1) / N);
  quant_gemm_tc_kernel<W, N><<<grid, kTcThreads, L::kBytes, s>>>(
      tw, tx, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), R, F, ldo,
      k_steps, k_per_split / L::kBK, rec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<__nv_bfloat16>(ws, scale, out, R, F, ldo, splits, s);
}

// Calls FN<W, N>(args...) for the runtime weight kind and row width.
#define TC_DISPATCH(FN, w, n, ...)                                   \
  do {                                                               \
    switch ((w) * 1000 + (n)) {                                      \
      case 8: return FN<kInt8, 8>(__VA_ARGS__);                      \
      case 16: return FN<kInt8, 16>(__VA_ARGS__);                    \
      case 32: return FN<kInt8, 32>(__VA_ARGS__);                    \
      case 64: return FN<kInt8, 64>(__VA_ARGS__);                    \
      case 128: return FN<kInt8, 128>(__VA_ARGS__);                  \
      case 1008: return FN<kFp8, 8>(__VA_ARGS__);                    \
      case 1016: return FN<kFp8, 16>(__VA_ARGS__);                   \
      case 1032: return FN<kFp8, 32>(__VA_ARGS__);                   \
      case 1064: return FN<kFp8, 64>(__VA_ARGS__);                   \
      case 1128: return FN<kFp8, 128>(__VA_ARGS__);                  \
      case 2008: return FN<kBf16, 8>(__VA_ARGS__);                   \
      case 2016: return FN<kBf16, 16>(__VA_ARGS__);                  \
      case 2032: return FN<kBf16, 32>(__VA_ARGS__);                  \
      case 2064: return FN<kBf16, 64>(__VA_ARGS__);                  \
      case 2128: return FN<kBf16, 128>(__VA_ARGS__);                 \
    }                                                                \
  } while (0)

// an instance's blocks an SM and k rows a stage
template <int W, int N>
int tc_info(int* occ, int* bk) {
  static unsigned ready = 0;
  cudaError_t err = tc_ready<W, N>(&ready);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, quant_gemm_tc_kernel<W, N>, kTcThreads, TcShape<W, N>::kBytes);
  *bk = TcShape<W, N>::kBK;
  return static_cast<int>(err);
}

int tc_info_any(int w_dtype, int n, int* occ, int* bk) {
  TC_DISPATCH(tc_info, w_dtype, n, occ, bk);
  return kErrUnsupported;
}

int tc_launch_any(int w_dtype, int n, const void* x, const void* wq,
                  const void* scale, void* out, void* ws, int R, int K,
                  int F, int ldo, int splits, int k_per_split,
                  cudaStream_t s) {
  TC_DISPATCH(launch_tc, w_dtype, n, x, wq, scale, out, ws, R, K, F, ldo,
              splits, k_per_split, s);
  return kErrUnsupported;
}

}  // namespace

// How one call runs, written to plan[4] = {mode, rows, splits,
// k_per_split}. bf16 x (x_dtype 0) with int8, fp8 or bf16 weights takes the
// tensor-core kernel (mode 1) at row width `rows` = 8, 16, 32, 64 or 128
// (R rounded up, at most 128; more rows are more blocks); fp32 x takes the
// stream kernel (mode 0) over row groups of `rows` = 1, 2, 4, 8 or 16. A
// launch whose blocks fill the SMs of the current device less than once
// (by the instance's occupancy) splits k over blocks, k_per_split rows each
// (a multiple of 64 for mode 1, of 256 for mode 0). w_dtype: 0 = int8, 1 =
// float8_e4m3fn, 2 = bfloat16, 3 = float32 (fp32 x only). Returns 0, a
// cudaError_t code, or -1 for an unsupported combination.
extern "C" int quant_gemm_plan(int R, int K, int F, int w_dtype, int x_dtype,
                               int* plan) {
  if (R <= 0 || K <= 0 || F <= 0 || K % 16 != 0 || F % 16 != 0)
    return kErrUnsupported;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int mode, rows, blocks, step, min_steps;
  if (x_dtype == 0) {
    if (w_dtype < 0 || w_dtype > 2) return kErrUnsupported;
    mode = 1;
    rows = 8;
    while (rows < R && rows < 128) rows *= 2;
    const int rc = tc_info_any(w_dtype, rows, &occ, &step);
    if (rc != 0) return rc;
    blocks = ((F + kBM - 1) / kBM) * ((R + rows - 1) / rows);
    min_steps = (kMinSplitK + step - 1) / step;
  } else if (x_dtype == 1) {
    mode = 0;
    const int want = R < 16 ? R : 16;
    rows = 1;
    while (rows < want) rows *= 2;
    Kernel k = stream_any(w_dtype, rows);
    if (k == nullptr) return kErrUnsupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int strip = rows <= 4 ? kTX * 16 : kTX * 8;
    blocks = ((F + strip - 1) / strip) * ((R + rows - 1) / rows);
    step = kKC;
    min_steps = 1;
  } else {
    return kErrUnsupported;
  }
  const int k_steps = (K + step - 1) / step;
  int splits = occ * sms / blocks;
  int max_splits = k_steps / min_steps;
  splits = splits < 1 ? 1 : (splits > max_splits ? max_splits : splits);
  if (splits < 1) splits = 1;
  const int steps_per = (k_steps + splits - 1) / splits;
  plan[0] = mode;
  plan[1] = rows;
  plan[2] = (k_steps + steps_per - 1) / steps_per;
  plan[3] = steps_per * step;
  return 0;
}

// w_dtype: 0 = int8, 1 = float8_e4m3fn, 2 = bfloat16, 3 = float32 (fp32 x
// only; for 2 and 3 scale may be null: no multiply). x_dtype: 0 =
// bfloat16, 1 = float32. out [R, ldo] in x's type, row r of the result at
// out + r * ldo (ldo >= F). mode, rows, splits and k_per_split as
// quant_gemm_plan gives them; ws = fp32 [splits, R, F] scratch when splits
// > 1. Returns 0, a cudaError_t code, or a negative code of
// quant_gemm_error_string.
extern "C" int quant_gemm_launch(const void* x, const void* wq,
                                 const void* scale, void* out, void* ws,
                                 int R, int K, int F, int ldo, int w_dtype,
                                 int x_dtype, int mode, int rows, int splits,
                                 int k_per_split, void* stream) {
  if (R <= 0 || F <= 0) return 0;
  if (K % 16 != 0 || F % 16 != 0 || ldo < F || ldo % 2 != 0 || splits < 1 ||
      k_per_split <= 0 || (splits > 1 && ws == nullptr) ||
      (scale == nullptr && w_dtype != 2 && w_dtype != 3))
    return kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    if (x_dtype != 0) return kErrUnsupported;
    return tc_launch_any(w_dtype, rows, x, wq, scale, out, ws, R, K, F, ldo,
                         splits, k_per_split, s);
  }
  if (mode != 0 || x_dtype != 1) return kErrUnsupported;
  switch (w_dtype) {
    case 0:
      return dispatch_stream<Int8W>(x, wq, scale, out, ws, R, K, F, ldo,
                                    rows, splits, k_per_split, s);
    case 1:
      return dispatch_stream<Fp8W>(x, wq, scale, out, ws, R, K, F, ldo,
                                   rows, splits, k_per_split, s);
    case 2:
      return dispatch_stream<Bf16W>(x, wq, scale, out, ws, R, K, F, ldo,
                                    rows, splits, k_per_split, s);
    case 3:
      return dispatch_stream<Fp32W>(x, wq, scale, out, ws, R, K, F, ldo,
                                    rows, splits, k_per_split, s);
  }
  return kErrUnsupported;
}

// The tensor-core kernel's mbarrier timeout record's 8 ints (code, row,
// block x, block y, warp, barrier, parity, step); all zero when no wait
// has timed out. Reads host memory only, so it works after the trap has
// poisoned the CUDA context.
extern "C" void quant_gemm_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* quant_gemm_error_string(int code) {
  switch (code) {
    case kErrUnsupported: return "unsupported dtype, mode, row group or shape";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found through "
             "cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
