// Paged one-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/serving/paged_attention.py:_decode_kernel
// (reached through paged_decode_attention, the pallas_call at :258): for
// every serving slot b and head h,
//
//   ctx[b, h] = softmax_s(q[b, h] . K[s, h] / sqrt(d)) @ V[s, h],  s <= pos[b]
//
// where the keys of slot b live in the physical pages table[b, 0..] of the
// pool kc/vc [P, page_size, nh, d]. Online softmax in fp32 over the slot's
// pages, fp32 accumulation, the same fully-masked-page guard as the TPU
// kernel (alpha = 0 while the running max is still -inf).
//
// The int8 and float8_e4m3fn pool instances also replace the quantized TPU
// kernel paddle_tpu/serving/paged_attention.py:_decode_kernel_q (reached
// through paged_decode_attention_q, the pallas_call at :221): each page p
// carries dequant scales ksc[p], vsc[p] (fp32 [P], the layer's row of the
// pool's [L, P] scales). A score is (q . k_raw) / sqrt(d) * ksc[page], the
// scale applied after the dot as in the TPU kernel, and a page's values
// join the context times vsc[page]; the softmax sum never sees vsc.
//
// What bounds it on an H100: bytes. Each live key and value is read once
// and used for 2*d flops, far below the ~295 flop/byte the card needs
// before compute matters. The least time is
//   sum_b (live pages_b * page_size) * nh * d * 2 (K and V) * sizeof(pool)
// over 3.35 TB/s (B=8, 512 live tokens each, nh=16, d=128, bf16:
// 33.5 MB, about 10 us; an int8 or fp8 pool halves it to 16.8 MB, 5 us).
//
// Design, for the GPU rather than copied from the TPU grid:
// * one block of 8 warps per (slot, head); the block reads its own page
//   indices from the table (the TPU kernel had them prefetched to scalar
//   memory);
// * the page loop stops at page pos[b] / page_size, so unmapped pages are
//   never touched (the TPU grid sweeps all MP pages and masks them);
// * each warp walks every 8th page of the slot with its own online
//   softmax, so the page loop has no block barrier; the 8 partial
//   softmaxes are combined once, at the end, through shared memory (the
//   TPU grid instead carried one running state through VMEM scratch);
// * a key row of d elements is spread over d/8 lanes, each issuing one
//   16-byte load (8 bf16) for K and one for V (8 bytes for 8 one-byte
//   elements of a quantized pool); the lanes of a row reduce the q.k dot
//   product with warp shuffles;
// * the warp's next page is loaded into registers before the current one
//   is reduced, and the page-table entry after that is read one page
//   ahead, so no page waits on a dependent table load;
// * a quantized page's two scales are loaded with its bytes, one page
//   ahead like them;
// * bf16 -> fp32 with __bfloat162float; int8 -> fp32 with one byte permute
//   and one add (the 2^23 magic number); e4m3 -> fp32 through the
//   hardware's fp8x2 -> half2 conversion; all math in fp32.
// Split-K across blocks, TMA and wgmma are left for later work.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/serving/paged_decode.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant_convert.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per (slot, head)
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;                   // pool elements per thread per row

// Eight contiguous pool elements held as raw 16-byte words.
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_float(float* out) const {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = __bfloat162float(e[i]);
  }
};

template <>
struct Raw8<float> {
  uint4 w[2];
  __device__ __forceinline__ void load(const float* p) {
    const uint4* s = reinterpret_cast<const uint4*>(p);
    w[0] = __ldg(s);
    w[1] = __ldg(s + 1);
  }
  __device__ __forceinline__ void to_float(float* out) const {
    const float* e = reinterpret_cast<const float*>(w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = e[i];
  }
};

template <>
struct Raw8<int8_t> {
  uint2 w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void to_float(float* out) const {
    int8x4_to_float(w.x, out);
    int8x4_to_float(w.y, out + 4);
  }
};

template <>
struct Raw8<__nv_fp8_e4m3> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_fp8_e4m3* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void to_float(float* out) const {
    fp8x4_to_float(w.x, out);
    fp8x4_to_float(w.y, out + 4);
  }
};

template <typename T, int D, int PS>
struct Shape {
  // one-byte pools carry per-page dequant scales
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kLanes = D / kVec;              // threads per key row
  static constexpr int kRowsPerStep = 32 / kLanes;     // rows a warp holds
  static constexpr int kPer = PS / kRowsPerStep;       // rows/thread/page
  // double-buffer a page in registers only while a page fits in 64 of
  // them (larger pages or fp32 pools would spill)
  static constexpr bool kPrefetch = kPer * sizeof(Raw8<T>) * 2 <= 256;
  static_assert(D % kVec == 0, "head_dim must be a multiple of 8");
  static_assert(kLanes <= 32 && 32 % kLanes == 0,
                "a key row must stay inside one warp");
  static_assert(PS % kRowsPerStep == 0, "page_size must fill warp steps");
};

// Load this thread's K and V rows of one page: rows t = sub + r*kRowsPerStep.
template <typename T, int D, int PS>
__device__ __forceinline__ void load_page(const T* __restrict__ kc,
                                          const T* __restrict__ vc,
                                          size_t base, size_t row, int sub,
                                          Raw8<T>* k, Raw8<T>* v) {
  using S = Shape<T, D, PS>;
#pragma unroll
  for (int r = 0; r < S::kPer; ++r) {
    const size_t off = base + static_cast<size_t>(sub + r * S::kRowsPerStep)
                       * row;
    k[r].load(kc + off);
    v[r].load(vc + off);
  }
}

template <typename T, int D, int PS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,        // [B, nh, D] fp32
                    const T* __restrict__ kc,           // [P, PS, nh, D]
                    const T* __restrict__ vc,           // [P, PS, nh, D]
                    const int32_t* __restrict__ table,  // [B, max_pages]
                    const int32_t* __restrict__ pos,    // [B]
                    const float* __restrict__ ksc,      // [P] or null
                    const float* __restrict__ vsc,      // [P] or null
                    float* __restrict__ out,            // [B, nh, D] fp32
                    int nh, int max_pages, float scale) {
  using S = Shape<T, D, PS>;
  constexpr unsigned kAll = 0xffffffffu;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / S::kLanes;        // which row of the warp step
  const int col = lane % S::kLanes;        // which 8 elements of the row

  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_acc[kWarps][D];

  const int p = pos[b];
  const int n_pages = p < 0 ? 0 : min(p / PS + 1, max_pages);

  float qv[kVec];
  {
    const float4* q4 = reinterpret_cast<const float4*>(
        q + (static_cast<size_t>(b) * nh + h) * D + col * kVec);
    const float4 a = q4[0];
    const float4 c = q4[1];
    qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
    qv[4] = c.x; qv[5] = c.y; qv[6] = c.z; qv[7] = c.w;
  }

  const size_t row = static_cast<size_t>(nh) * D;    // token stride
  const size_t page = static_cast<size_t>(PS) * row;  // page stride
  const size_t head = static_cast<size_t>(h) * D + col * kVec;
  const int32_t* tab = table + static_cast<size_t>(b) * max_pages;

  // this warp's running softmax state over its pages warp, warp+kWarps, ...
  float m = -INFINITY;
  float l = 0.f;        // this thread's rows only; summed over the warp
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  Raw8<T> kr[S::kPer], vr[S::kPer];
  float ks = 1.f, vs = 1.f;             // the page's dequant scales
  int j = warp;
  int phys_next = j + kWarps < n_pages ? tab[j + kWarps] : 0;
  if (S::kPrefetch && j < n_pages) {
    const int phys = tab[j];
    load_page<T, D, PS>(kc, vc, static_cast<size_t>(phys) * page + head,
                        row, sub, kr, vr);
    if constexpr (S::kQuant) {
      ks = ksc[phys];
      vs = vsc[phys];
    }
  }

  for (; j < n_pages; j += kWarps) {
    Raw8<T> kn[S::kPer], vn[S::kPer];
    float ksn = 1.f, vsn = 1.f;
    const bool more = j + kWarps < n_pages;
    if constexpr (S::kPrefetch) {
      if (more) {
        load_page<T, D, PS>(kc, vc, static_cast<size_t>(phys_next) * page +
                            head, row, sub, kn, vn);
        if constexpr (S::kQuant) {
          ksn = ksc[phys_next];
          vsn = vsc[phys_next];
        }
      }
    } else {
      const int phys = tab[j];
      load_page<T, D, PS>(kc, vc, static_cast<size_t>(phys) * page + head,
                          row, sub, kr, vr);
      if constexpr (S::kQuant) {
        ks = ksc[phys];
        vs = vsc[phys];
      }
    }
    // the table entry after next: its latency hides behind this page
    const int j2 = j + 2 * kWarps;
    const int phys_after = j2 < n_pages ? tab[j2] : 0;

    // scores of this thread's rows; masked keys score -inf
    float s[S::kPer];
    float m_page = -INFINITY;
#pragma unroll
    for (int r = 0; r < S::kPer; ++r) {
      float kf[kVec];
      kr[r].to_float(kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[i], kf[i], dot);
#pragma unroll
      for (int off = S::kLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kAll, dot, off);
      const int key = j * PS + sub + r * S::kRowsPerStep;
      if constexpr (S::kQuant) dot = dot * scale * ks;
      else dot = dot * scale;
      s[r] = key <= p ? dot : -INFINITY;
      m_page = fmaxf(m_page, s[r]);
    }
#pragma unroll
    for (int off = S::kLanes; off < 32; off <<= 1)
      m_page = fmaxf(m_page, __shfl_xor_sync(kAll, m_page, off));

    // online softmax update (the TPU kernel's fully-masked-page guard)
    const float m_new = fmaxf(m, m_page);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < S::kPer; ++r) {
      const float pr = (s[r] == -INFINITY) ? 0.f : expf(s[r] - m_new);
      l += pr;
      const float pv = S::kQuant ? pr * vs : pr;
      float vf[kVec];
      vr[r].to_float(vf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(pv, vf[i], acc[i]);
    }
    m = m_new;

    if constexpr (S::kPrefetch) {
      if (more) {
#pragma unroll
        for (int r = 0; r < S::kPer; ++r) {
          kr[r] = kn[r];
          vr[r] = vn[r];
        }
        ks = ksn;
        vs = vsn;
      }
    }
    phys_next = phys_after;
  }

  // sum the warp's row partials (same m everywhere in the warp)
#pragma unroll
  for (int off = S::kLanes; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kAll, l, off);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      acc[i] += __shfl_xor_sync(kAll, acc[i], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) s_acc[warp][col * kVec + i] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // combine the warps' partial softmaxes
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = (s_m[w] == -INFINITY) ? 0.f : expf(s_m[w] - mx);
      den = fmaf(f, s_l[w], den);
      num = fmaf(f, s_acc[w][e], num);
    }
    out[(static_cast<size_t>(b) * nh + h) * D + e] = num / den;
  }
}

template <typename T, int D, int PS>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* table, const void* pos, const void* ksc,
                   const void* vsc, void* out, int B, int nh, int max_pages,
                   float scale, cudaStream_t stream) {
  const dim3 grid(nh, B);
  paged_decode_kernel<T, D, PS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<float*>(out), nh,
      max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* table,
             const void* pos, const void* ksc, const void* vsc, void* out,
             int B, int nh, int head_dim, int page_size, int max_pages,
             float scale, cudaStream_t stream) {
#define PAGED_DECODE_CASE(DD, PP)                                        \
  if (head_dim == DD && page_size == PP)                                 \
    return static_cast<int>(launch<T, DD, PP>(q, kc, vc, table, pos, ksc, \
                                              vsc, out, B, nh, max_pages, \
                                              scale, stream));
  PAGED_DECODE_CASE(64, 8)
  PAGED_DECODE_CASE(64, 16)
  PAGED_DECODE_CASE(64, 32)
  PAGED_DECODE_CASE(128, 8)
  PAGED_DECODE_CASE(128, 16)
  PAGED_DECODE_CASE(128, 32)
#undef PAGED_DECODE_CASE
  return -1;
}

}  // namespace

// pool_dtype: 0 = bfloat16, 1 = float32. Returns 0, a cudaError_t code, or
// -1 for a shape or dtype this library was not built for.
extern "C" int paged_decode_launch(const void* q, const void* kc,
                                   const void* vc, const void* table,
                                   const void* pos, void* out, int B, int nh,
                                   int head_dim, int page_size, int max_pages,
                                   int pool_dtype, float scale,
                                   void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return dispatch<__nv_bfloat16>(q, kc, vc, table, pos, nullptr, nullptr,
                                   out, B, nh, head_dim, page_size,
                                   max_pages, scale, s);
  if (pool_dtype == 1)
    return dispatch<float>(q, kc, vc, table, pos, nullptr, nullptr, out, B,
                           nh, head_dim, page_size, max_pages, scale, s);
  return -1;
}

// The quantized pools: pool_dtype 2 = int8, 3 = float8_e4m3fn; ksc / vsc
// are the layer's per-page scales, fp32 [P]. Returns as above.
extern "C" int paged_decode_q_launch(const void* q, const void* kc,
                                     const void* vc, const void* table,
                                     const void* pos, const void* ksc,
                                     const void* vsc, void* out, int B,
                                     int nh, int head_dim, int page_size,
                                     int max_pages, int pool_dtype,
                                     float scale, void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 2)
    return dispatch<int8_t>(q, kc, vc, table, pos, ksc, vsc, out, B, nh,
                            head_dim, page_size, max_pages, scale, s);
  if (pool_dtype == 3)
    return dispatch<__nv_fp8_e4m3>(q, kc, vc, table, pos, ksc, vsc, out, B,
                                   nh, head_dim, page_size, max_pages, scale,
                                   s);
  return -1;
}

extern "C" const char* paged_decode_error_string(int code) {
  if (code == -1) return "unsupported head_dim, page_size or pool dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
