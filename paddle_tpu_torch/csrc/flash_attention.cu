// Flash attention's dQ kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels/
//   flash_attention_bwd.py:_dq_kernel    (pallas_call at :286)  -> flash_dq_kernel
// in its causal and non-causal form, without bias, segment ids or dropout.
// The forward and dK/dV kernels are in flash_sm90.cu. For every batch b and
// head h, with s = q.k * scale:
//
//   dQ       P = exp(s - LSE), dP = dO V^T, dS = P (dP - delta) scale,
//            dQ = dS K                    (delta = rowsum(dO o O), computed
//                                          beside the kernels, as the TPU
//                                          path computes it in XLA)
//
// q, k, v and dO are read in their [B, S, H, D] layout through the element
// strides the caller gives (the last dimension contiguous), so the qkv split
// of the model hands over strided views and nothing is copied to [B*H, S, D].
// dQ is written contiguous [B, S, H, D]; LSE and delta are fp32 [B*H, S].
// Rows and keys past S are masked here, so any S >= 1 works (the TPU path
// needs S to be a multiple of 128). The head dim is not padded.
//
// What bounds it on an H100: operations. At the GPT-3 1.3B training shapes
// (B=8, S=2048, 16 heads of 128, bf16, causal) dQ does 2.06e11 flops on
// 337 MB: over 600 flops per byte, above the ~295 the card needs before its
// tensor cores, not its memory, are the limit. So the products run on the
// tensor cores (989 TFLOP/s bf16), never as fp32 FMA (67 TFLOP/s).
//
// Design, for the GPU rather than copied from the TPU grid:
// * the TPU grid's sequential dimension becomes a loop inside one block:
//   one block per (b*h, q-tile) loops over k-tiles up to the diagonal, so
//   every output tile is owned by one block: no atomics and no cross-block
//   reduction;
// * 4 warps per block, each owning 16 rows of the block's tile. Products are
//   warp-level mma.sync m16n8k16 with bf16 operands and fp32
//   accumulators. The accumulator layout of one product is the operand
//   layout of the next, so dS goes from registers straight into the dS.K
//   product without a trip through memory;
// * tiles are staged in shared memory with 16-byte loads, rows padded by 8
//   elements so that fragment reads are free of bank conflicts. K, which
//   the dS.K product needs with its contraction along the sequence, is
//   also stored transposed;
// * causal blocks above the diagonal are skipped by the loop bounds, the
//   diagonal tile is masked per element, and blocks are numbered so that
//   the heaviest tiles start first.
// Copies are synchronous (no cp.async/TMA pipeline) and products use
// mma.sync, not wgmma: flash_sm90.cu shows the Hopper design for the other
// two kernels.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                  // elements added to each smem row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                         // element strides of [B, S, H, D]
  long long b, s, h;
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // c[16x8] += a[16x16] * b[16x8], fp32 accumulators
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16, row-major): a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                         a2 (g, 8+2t..)     a3 (g+8, 8+2t..)
//   B (16x8, k x n):      b0 (k = 2t..2t+1, n = g)   b1 (k = 8+2t.., n = g)
//   C (16x8, fp32):       c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)

// A fragment of rows [r0, r0+16) and columns [k0, k0+16) of a shared tile
// stored row-major with leading dimension ld.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* s, int ld,
                                       int r0, int k0, int lane) {
  const T* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment with B[k][n] = s[(n0 + n) * ld + k0 + k]: the contraction runs
// along a row of the shared tile.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const T* s, int ld, int n0, int k0,
                                       int lane) {
  const T* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The A fragment of columns [16j, 16j+16) of a 16-row result held as C
// fragments c[n-tile][4], rounded to T.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t* a, float (*c)[4],
                                       int j) {
  a[0] = Mma<T>::pack(c[2 * j][0], c[2 * j][1]);
  a[1] = Mma<T>::pack(c[2 * j][2], c[2 * j][3]);
  a[2] = Mma<T>::pack(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = Mma<T>::pack(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// Rows [row0, row0 + ROWS) of one (b, h) slice (src points at its row 0,
// ss is the sequence stride) into shared memory, rows at or past S as
// zeros. `dst` gets them row-major with leading dimension D + kPad (skipped
// when null); `dst_t` gets them transposed, [D][ROWS + kPad] (skipped when
// null). The transposed copy walks rows fastest so that a warp's 2-byte
// stores land in consecutive words.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, T* dst_t, const T* src,
                                          int row0, int S, long long ss) {
  constexpr int kChunks = D / 8;         // 16-byte chunks per row
  constexpr int kLd = D + kPad;
  constexpr int kLdT = ROWS + kPad;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = dst_t ? c % ROWS : c / kChunks;
    const int c8 = dst_t ? c / ROWS : c % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c8 * 8);
    if (dst) *reinterpret_cast<uint4*>(dst + r * kLd + c8 * 8) = v;
    if (dst_t) {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst_t[(c8 * 8 + i) * kLdT + r] = e[i];
    }
  }
}

// --------------------------------------------------------------------- dQ
constexpr int kDqBq = 64;                // q rows per block (16 per warp)
constexpr int kDqBk = 32;                // keys per loop step

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * (2 * kDqBq * (D + kPad) + 2 * kDqBk * (D + kPad) +
              D * (kDqBk + kPad));
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int H, Strides qs, Strides ks, Strides vs, Strides dos,
                float scale, float scale_log2) {
  constexpr int BQ = kDqBq, BK = kDqBk, LD = D + kPad, LDT = BK + kPad;
  extern __shared__ uint4 smem_u4[];
  T* Qs = reinterpret_cast<T*>(smem_u4);
  T* dOs = Qs + BQ * LD;
  T* Ks = dOs + BQ * LD;
  T* Vs = Ks + BK * LD;
  T* Kt = Vs + BK * LD;                  // K transposed: [D][BK + kPad]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;

  load_tile<T, BQ, D>(Qs, nullptr, qb, q0, S, qs.s);
  load_tile<T, BQ, D>(dOs, nullptr, dob, q0, S, dos.s);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);
    load_a(dof[kk], dOs, LD, warp * 16, kk * 16, lane);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    const long long at = static_cast<long long>(bh) * S + row[i];
    lse2[i] = in ? lse[at] * kLog2e : 0.f;
    dlt[i] = in ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int kv_end = kCausal ? min(S, q0 + BQ) : S;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_tile<T, BK, D>(Ks, Kt, kb, k0, S, ks.s);
    load_tile<T, BK, D>(Vs, nullptr, vb, k0, S, vs.s);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks, LD, n * 8, kk * 16, lane);
        Mma<T>::run(s[n], qf[kk], b0, b1);
        load_b(b0, b1, Vs, LD, n * 8, kk * 16, lane);
        Mma<T>::run(dp[n], dof[kk], b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1];
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = r < S && col < S && (!kCausal || col <= r);
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * scale;     // dS
      }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t da[4];
      c_to_a<T>(da, s, j);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Kt, LDT, n * 8, j * 16, lane);
        Mma<T>::run(acc[n], da, b0, b1);
      }
    }
  }

  T* out = dq + (static_cast<long long>(b) * S * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < S) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + row[i] * os + n * 8 + 2 * t) =
            Mma<T>::pack(acc[n][2 * i], acc[n][2 * i + 1]);
    }
}

// ---------------------------------------------------------------- launches
Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Shared memory above 48 KB must be opted into once per kernel instance.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D, bool C>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dqp, int B, int S,
               int H, const long long* st, float scale,
               cudaStream_t stream) {
  static bool ready = false;
  constexpr int smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_kernel<T, D, C>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kDqBq - 1) / kDqBq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), S, H, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), scale, scale * kLog2e);
  return cudaGetLastError();
}

// Calls FN<bf16, D, causal>(args...) for the runtime D and causal; -1 when
// this library has no such instance.
#define FLASH_DISPATCH(FN, ...)                                            \
  do {                                                                     \
    if (head_dim == 64 && causal)                                          \
      return static_cast<int>(FN<__nv_bfloat16, 64, true>(__VA_ARGS__));  \
    if (head_dim == 64 && !causal)                                         \
      return static_cast<int>(FN<__nv_bfloat16, 64, false>(__VA_ARGS__)); \
    if (head_dim == 128 && causal)                                         \
      return static_cast<int>(FN<__nv_bfloat16, 128, true>(__VA_ARGS__)); \
    if (head_dim == 128 && !causal)                                        \
      return static_cast<int>(FN<__nv_bfloat16, 128, false>(__VA_ARGS__));\
    return -1;                                                             \
  } while (0)

}  // namespace

// Operands are bfloat16. strides: [B, S, H] element strides of q, k, v and
// dout, three per tensor. Returns 0, a cudaError_t code, or -1 for a
// head_dim not built here.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dqp, int B, int S,
                               int H, int head_dim, int causal,
                               const long long* strides, float scale,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dqp, B, S, H, strides, scale,
                 s);
}

extern "C" const char* flash_error_string(int code) {
  if (code == -1) return "unsupported head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
