// Paged one-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/serving/paged_attention.py:_decode_kernel
// (reached through paged_decode_attention, the pallas_call at :258): for
// every serving slot b and head h,
//
//   ctx[b, h] = softmax_s(q[b, h] . K[s, h] / sqrt(d)) @ V[s, h],  s <= pos[b]
//
// where the keys of slot b live in the physical pages table[b, 0..] of the
// pool kc/vc [P, page_size, nh, d]. Online softmax in fp32, fp32
// accumulation, the same fully-masked guard as the TPU kernel (a running
// max still at -inf weighs 0, never exp(-inf - -inf)).
//
// The int8 and float8_e4m3fn pool instances also replace the quantized TPU
// kernel paddle_tpu/serving/paged_attention.py:_decode_kernel_q (reached
// through paged_decode_attention_q, the pallas_call at :221): each page p
// carries dequant scales ksc[p], vsc[p] (fp32 [P], the layer's row of the
// pool's [L, P] scales). A score is (q . k_raw) / sqrt(d) * ksc[page], the
// scale applied after the dot as in the TPU kernel, and a page's values
// join the context times vsc[page]; the softmax sum never sees vsc. One
// template serves the bf16, fp32, int8 and e4m3 pools.
//
// What bounds it on an H100: bytes. Each live key and value is read once
// and used for 2*d flops, far below the ~295 flop/byte the card needs
// before compute matters. The least time is
//   sum_b (live pages_b * page_size) * nh * d * 2 (K and V) * sizeof(pool)
// over 3.35 TB/s (B=8, 512 live tokens each, nh=16, d=128, bf16:
// 33.5 MB, about 10 us; an int8 or fp8 pool halves it to 16.8 MB, 5 us).
// Reaching it takes many bytes in flight on every SM at every load, short
// or long context, many slots or one.
//
// Design (flash-decoding over the page table):
// * The grid is (head, slot, split): a slot's pages are cut into splits,
//   so a slot with a long context spreads over many blocks (B=1 x 2048
//   tokens: 16 splits x 16 heads = 256 blocks, where one block per (slot,
//   head) gave 16). The split length is planned on the host from what is
//   static, the batch, the heads, the table's width and the card's SMs:
//   as many splits as fill the card twice over (at 16 heads: 16 splits of
//   8 pages at B=1, 3 of 43 at B=8 with a 128-page table), never shorter
//   than 8 pages nor longer than 64. Longer splits leave fewer blocks that
//   a short context never reaches and fewer partials to join; a block's
//   fixed chain of dependent latencies (pos, table, first pages, join)
//   then weighs less against its bytes. (Fixed splits of 8 or 16 pages
//   were no faster at 8 slots x 512 tokens and up to 1.4x slower at 8 x
//   2048; PERF.md.) A block whose split starts past
//   pos[b] exits at once, and the split is the grid's slowest index, so
//   the live (first) splits of every slot are scheduled before the dead
//   ones. No host argument depends on the live lengths (pos stays on the
//   device), so the launch can be captured in a CUDA graph.
// * Bulk page loads through an mbarrier ring: a producer warp reads the
//   split's page-table entries once, at its start, and loads each page's
//   K and V of head h (page_size rows of d elements, nh*d elements apart)
//   into shared memory with two TMA tile loads, through tensor maps over
//   the layer's pool viewed as [P * page_size, nh * d] (box [page, d], no
//   swizzle; a row of d is cut into pieces of at most 256 bytes, a box's
//   innermost extent), completing on the stage's full barrier. The ring
//   holds as many stages of one page as fill 64 KB, 4 to 16 (page 16,
//   d=128: bf16 8, int8 / fp8 16; three blocks an SM), so a one-byte pool
//   keeps as many bytes in flight as a bf16 one. The table entries are
//   read beside pos, not after it.
//   Consumer warp w takes the pages w, w + 4, ... of its split, so a stage
//   only ever has one consumer, frees each stage on its empty barrier, and
//   the producer refills it with the split's next page. (Copying a page
//   row by row with cp.async.bulk, 32 copies a page, left the kernel bound
//   by the copy count: 0.0208 ms at 8 x 512 tokens for bf16 and int8
//   alike, PERF.md.) A quantized page's two scales are loaded with the
//   split's table entries, by the producer lanes, and published by each
//   first-filled stage's second arrival.
// * The products stay on the CUDA cores in fp32: a decode query is one row
//   per head, and GPT-3 has no grouped KV heads to stack into a tile, so a
//   tensor-core product would be 1/64 full and buy nothing against the
//   bytes. A key row of d elements is spread over d/8 lanes, 8 elements
//   each (one 16-byte shared load at bf16, 8 bytes at one byte); the lanes
//   of a row reduce the q.k dot with shuffles.
// * Each consumer warp keeps an online softmax over its pages; the four
//   are joined through shared memory into the split's (max, sum, d-wide
//   accumulator). A slot whose context fits one split writes its context
//   there. Otherwise every split writes its partial to a workspace, and a
//   second launch, one block per (slot, head), joins the live splits in
//   split order, so every call gives the same bits; it loads the splits'
//   partials all at once, not as a chain of dependent loads. The join is
//   a programmatic dependent launch: the split blocks let it start as soon
//   as they are all resident, its blocks read pos while the splits run,
//   and wait (griddepcontrol.wait) only before they read the partials, so
//   the boundary between the launches costs no drain and relaunch. (The
//   last split block of a (slot, head) to arrive at a device counter can
//   join them in one launch instead; that form keeps a counter per device
//   between calls and ties every call on a device to one stream.)
//   Splits wholly past pos never write and are never read, so they cannot
//   bring a NaN into the join.
// * bf16 -> fp32 with __bfloat162float; int8 -> fp32 with one byte permute
//   and one add (the 2^23 magic number); e4m3 -> fp32 through the
//   hardware's fp8x2 -> half2 conversion; all math in fp32.
// * Every mbarrier wait is bounded by %globaltimer (csrc/sm90.cuh): a
//   phase slip writes a record (row 1) and traps instead of hanging.
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
#include "sm90.cuh"

namespace {

constexpr int kMinSplit = 8;               // pages a split takes at least
constexpr int kMaxSplit = 64;              // and at most
constexpr int kRingBytes = 65536;          // eight stages where they fit
constexpr int kConsumerWarps = 4;          // warp w consumes pages w + 4i
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kFill = 2;                   // blocks a call plans per SM
constexpr int kVec = 8;                    // pool elements per lane per row
constexpr int kFullArrivals = 2;           // the bytes' arrival, the scales'
constexpr int kPartStride = 4;             // floats before a partial's acc

// Eight contiguous pool elements held as raw words, read from shared memory.
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
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
    w[0] = s[0];
    w[1] = s[1];
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
    w = *reinterpret_cast<const uint2*>(p);
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
    w = *reinterpret_cast<const uint2*>(p);
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
  static constexpr int kLanes = D / kVec;              // lanes per key row
  static constexpr int kRowsPerStep = 32 / kLanes;     // rows a warp holds
  static constexpr int kPer = PS / kRowsPerStep;       // rows/lane/page
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kPageBytes = PS * kRowBytes;    // K (or V) of a page
  static constexpr int kStageBytes = 2 * kPageBytes;   // K then V
  // as many stages as fill kRingBytes, 4 to 16 and a multiple of the
  // consumer warps, so a stage is only ever waited on by its one warp, at
  // most one phase ahead of it (page 16, d=128: bf16 8, int8 / fp8 16)
  static constexpr int kFit = kRingBytes / kStageBytes;
  static constexpr int kStages =
      kFit < 4 ? 4 : (kFit > 16 ? 16 : kFit / kConsumerWarps * kConsumerWarps);
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  static_assert(D % kVec == 0, "head_dim must be a multiple of 8");
  static_assert(kLanes <= 32 && 32 % kLanes == 0,
                "a key row must stay inside one warp");
  static_assert(PS % kRowsPerStep == 0, "page_size must fill warp steps");
  static_assert(kPageBytes % 1024 == 0 || 1024 % kPageBytes == 0,
                "stages keep TMA's 128-byte alignment");
  // the TMA box: a row of D as kPieces pieces of kPiece elements
  static constexpr int kPiece = kRowBytes <= 256 ? D : 256 / sizeof(T);
  static constexpr int kPieces = D / kPiece;
};

// The producer's loads of page j of the split (physical page phys) into
// its stage: K's box, then V's, on the stage's full barrier.
template <typename T, int D, int PS>
__device__ __forceinline__ void load_page(const CUtensorMap* tk,
                                          const CUtensorMap* tv, int phys,
                                          int h, uint32_t stage,
                                          uint32_t bar) {
  using S = Shape<T, D, PS>;
  mbar_expect_tx(bar, S::kStageBytes);
  tma_load_3d(stage, tk, bar, 0, h * S::kPieces, phys * PS);
  tma_load_3d(stage + S::kPageBytes, tv, bar, 0, h * S::kPieces, phys * PS);
}

template <typename T, int D, int PS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __grid_constant__ CUtensorMap tk,  // K pool
                    const __grid_constant__ CUtensorMap tv,  // V pool
                    const float* __restrict__ q,        // [B, nh, D] fp32
                    const int32_t* __restrict__ table,  // [B, max_pages]
                    const int32_t* __restrict__ pos,    // [B]
                    const float* __restrict__ ksc,      // [P] or null
                    const float* __restrict__ vsc,      // [P] or null
                    float* __restrict__ out,            // [B, nh, D] fp32
                    float* __restrict__ ws,     // [B, nh, splits, D + 4]
                    int nh, int max_pages, int split_pages, float scale,
                    WaitRecord* rec) {
  using S = Shape<T, D, PS>;
  constexpr int kStages = S::kStages;
  constexpr unsigned kAll = 0xffffffffu;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the join may launch once every split block has started
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int j0 = split * split_pages;
  // the producer's page-table entries are read beside pos, not after it:
  // lane j holds the split's page j's and j + 32's (entries past the live
  // pages are read, in the table's bounds, and never used)
  const int32_t* tab = table + static_cast<size_t>(b) * max_pages + j0;
  const int room = min(split_pages, max_pages - j0);
  int phys_a = 0, phys_b = 0;
  if (warp == kConsumerWarps) {
    if (lane < room) phys_a = tab[lane];
    if (lane + 32 < room) phys_b = tab[lane + 32];
  }
  // and a consumer lane's 8 elements of q likewise
  const int col = lane % S::kLanes;        // which 8 elements of a row
  float qv[kVec];
  if (warp < kConsumerWarps) {
    const float4* q4 = reinterpret_cast<const float4*>(
        q + (static_cast<size_t>(b) * nh + h) * D + col * kVec);
    const float4 a = q4[0];
    const float4 c = q4[1];
    qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
    qv[4] = c.x; qv[5] = c.y; qv[6] = c.z; qv[7] = c.w;
  }
  const int p = pos[b];
  const int n_pages = p < 0 ? 0 : min(p / PS + 1, max_pages);
  // split 0 always runs, so a slot with no live key still gets its
  // (0 / 0) context, as the TPU kernel's
  if (j0 >= n_pages && split > 0) return;
  const int np = max(0, min(split_pages, n_pages - j0));    // pages here
  const int live = max(1, (n_pages + split_pages - 1) / split_pages);

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ float s_ks[kMaxSplit], s_vs[kMaxSplit];
  __shared__ float s_m[kConsumerWarps], s_l[kConsumerWarps];
  __shared__ __align__(16) float s_acc[kConsumerWarps][D];
  const uint32_t base = aligned_base(smem_raw);
  const uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const Waiter wt{smem_u32(bars), rec, 1};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(wt.at(s), kFullArrivals);
      mbar_init(wt.at(kStages + s), 1);       // its consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {                         // the producer
    auto phys_of = [&](int j) {
      return __shfl_sync(kAll, j < 32 ? phys_a : phys_b, j % 32);
    };
    for (int j = 0; j < min(np, kStages); ++j) {
      const int phys = phys_of(j);
      if (lane == 0)
        load_page<T, D, PS>(&tk, &tv, phys, h, base + j * S::kStageBytes,
                            wt.at(j));
    }
    if constexpr (S::kQuant) {
      if (lane < np) {
        s_ks[lane] = ksc[phys_a];
        s_vs[lane] = vsc[phys_a];
      }
      if (lane + 32 < np) {
        s_ks[lane + 32] = ksc[phys_b];
        s_vs[lane + 32] = vsc[phys_b];
      }
    }
    __syncwarp();
    // the second arrival: the scales (written above) are in place
    if (lane == 0)
      for (int j = 0; j < min(np, kStages); ++j) mbar_arrive(wt.at(j));
    for (int j = kStages; j < np; ++j) {
      const int s = j % kStages;
      const int phys = phys_of(j);
      if (lane == 0) {
        wt.wait(kStages + s, (j / kStages - 1) & 1, j);
        load_page<T, D, PS>(&tk, &tv, phys, h, base + s * S::kStageBytes,
                            wt.at(s));
        mbar_arrive(wt.at(s));
      }
    }
  } else {                                              // a consumer
    const int sub = lane / S::kLanes;      // which row of the warp step
    // this warp's running softmax state over its pages
    float m = -INFINITY;
    float l = 0.f;        // this lane's rows only; summed over the warp
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

    for (int j = warp; j < np; j += kConsumerWarps) {
      const int s = j % kStages;
      wt.wait(s, (j / kStages) & 1, j);
      __syncwarp();
      const T* kp = reinterpret_cast<const T*>(smem + s * S::kStageBytes);
      const T* vp = kp + PS * D;
      float ks = 1.f, vs = 1.f;
      if constexpr (S::kQuant) {
        ks = s_ks[j];
        vs = s_vs[j];
      }
      const int key0 = (j0 + j) * PS;
      // scores of this lane's rows; masked keys score -inf
      float sc[S::kPer];
      float m_page = -INFINITY;
#pragma unroll
      for (int r = 0; r < S::kPer; ++r) {
        const int t = sub + r * S::kRowsPerStep;
        Raw8<T> kr;
        kr.load(kp + t * D + col * kVec);
        float kf[kVec];
        kr.to_float(kf);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot = fmaf(qv[i], kf[i], dot);
#pragma unroll
        for (int off = S::kLanes / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kAll, dot, off);
        if constexpr (S::kQuant) dot = dot * scale * ks;
        else dot = dot * scale;
        sc[r] = key0 + t <= p ? dot : -INFINITY;
        m_page = fmaxf(m_page, sc[r]);
      }
#pragma unroll
      for (int off = S::kLanes; off < 32; off <<= 1)
        m_page = fmaxf(m_page, __shfl_xor_sync(kAll, m_page, off));

      // online softmax update (the TPU kernel's fully-masked guard)
      const float m_new = fmaxf(m, m_page);
      const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] *= alpha;
#pragma unroll
      for (int r = 0; r < S::kPer; ++r) {
        const int t = sub + r * S::kRowsPerStep;
        const float pr = (sc[r] == -INFINITY) ? 0.f : expf(sc[r] - m_new);
        l += pr;
        const float pv = S::kQuant ? pr * vs : pr;
        Raw8<T> vr;
        vr.load(vp + t * D + col * kVec);
        float vf[kVec];
        vr.to_float(vf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(pv, vf[i], acc[i]);
      }
      m = m_new;
      __syncwarp();
      if (lane == 0) mbar_arrive(wt.at(kStages + s));   // the stage is free
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
  }
  __syncthreads();

  // join the warps' softmaxes into this split's (m, l, acc)
  const size_t bh = static_cast<size_t>(b) * nh + h;
  float* part = ws + (bh * splits + split) * (D + kPartStride);
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float f = (s_m[w] == -INFINITY) ? 0.f : expf(s_m[w] - mx);
      den = fmaf(f, s_l[w], den);
      num = fmaf(f, s_acc[w][e], num);
    }
    if (live == 1) {
      out[bh * D + e] = num / den;
    } else {
      part[kPartStride + e] = num;
      if (e == 0) {
        part[0] = mx;
        part[1] = den;
      }
    }
  }
}

// The second launch: one block of D threads per (slot, head) joins the
// live splits' partials in split order (a slot whose context fits one
// split has its context already). Launched as a programmatic dependent of
// the split kernel: pos is read before griddepcontrol.wait, the partials
// after it.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_join_kernel(const int32_t* __restrict__ pos,  // [B]
                         const float* __restrict__ ws,
                         float* __restrict__ out,          // [B, nh, D]
                         int nh, int max_pages, int page_size,
                         int split_pages, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p = pos[b];
  const int n_pages = p < 0 ? 0 : min(p / page_size + 1, max_pages);
  const int live = max(1, (n_pages + split_pages - 1) / split_pages);
  if (live == 1) return;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // every split's (max, sum) at once, then the weights, then each context
  // column over the splits in order, eight loads in flight at a time: no
  // chain of dependent loads
  extern __shared__ float sw[];                         // [2 * splits]
  const size_t bh = static_cast<size_t>(b) * nh + h;
  const float* parts = ws + bh * splits * (D + kPartStride);
  for (int k = threadIdx.x; k < live; k += D) {
    sw[k] = parts[k * (D + kPartStride)];
    sw[live + k] = parts[k * (D + kPartStride) + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int k = 0; k < live; ++k) mx = fmaxf(mx, sw[k]);
  __syncthreads();
  for (int k = threadIdx.x; k < live; k += D)
    sw[k] = (sw[k] == -INFINITY) ? 0.f : expf(sw[k] - mx);
  __syncthreads();
  float den = 0.f;
  for (int k = 0; k < live; ++k) den = fmaf(sw[k], sw[live + k], den);
  const int e = threadIdx.x;
  float num = 0.f;
  for (int k0 = 0; k0 < live; k0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = k0 + i < live
                 ? parts[(k0 + i) * (D + kPartStride) + kPartStride + e]
                 : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k0 + i < live) num = fmaf(sw[k0 + i], v[i], num);
  }
  out[bh * D + e] = num / den;
}

template <typename T> constexpr CUtensorMapDataType kMapType =
    CU_TENSOR_MAP_DATA_TYPE_UINT8;
template <> constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
template <> constexpr CUtensorMapDataType kMapType<float> =
    CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// The splits of a call and their length in pages (*split_pages): as many
// splits as fill the card's SMs twice over with B * nh blocks each, within
// [kMinSplit, kMaxSplit] pages a split. Static: the batch, heads, table
// width and card. Returns the split count, or minus a cudaError_t.
int plan(int B, int nh, int max_pages, int* split_pages) {
  static int sms_of[64] = {};               // each device's SMs, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || sms_of[dev] == 0)) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < 64) sms_of[dev] = sms;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int sms = dev < 64 ? sms_of[dev] : 132;
  const long long per = static_cast<long long>(B) * nh;
  const int want = static_cast<int>((1LL * kFill * sms + per - 1) / per);
  const int most = (max_pages + kMinSplit - 1) / kMinSplit;
  const int least = (max_pages + kMaxSplit - 1) / kMaxSplit;
  const int splits = want < least ? least : (want > most ? most : want);
  *split_pages = (max_pages + splits - 1) / splits;
  return (max_pages + *split_pages - 1) / *split_pages;
}

// The map of a pool [P * PS rows, nh * D]: dims (piece, nh * pieces, rows),
// box (piece, pieces, PS): a page's head is one box, [PS][D] in shared
// memory.
template <typename T, int D, int PS>
int encode_pool(CUtensorMap* map, const void* pool, int P, int nh) {
  using S = Shape<T, D, PS>;
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  const cuuint64_t dims[3] = {S::kPiece,
                              static_cast<cuuint64_t>(nh) * S::kPieces,
                              static_cast<cuuint64_t>(P) * PS};
  const cuuint64_t strides[2] = {S::kPiece * sizeof(T),
                                 static_cast<cuuint64_t>(nh) * D * sizeof(T)};
  const cuuint32_t box[3] = {S::kPiece, S::kPieces, PS};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r =
      fn(map, kMapType<T>, 3, const_cast<void*>(pool), dims, strides, box,
         one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename T, int D, int PS>
int launch(const void* q, const void* kc, const void* vc, const void* table,
           const void* pos, const void* ksc, const void* vsc, void* out,
           void* ws, int B, int nh, int P, int max_pages, float scale,
           cudaStream_t stream) {
  using S = Shape<T, D, PS>;
  auto kernel = paged_decode_kernel<T, D, PS>;
  static unsigned ready = 0;
  cudaError_t err = allow_smem(kernel, S::kSmem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tk, tv;
  int rc;
  if ((rc = encode_pool<T, D, PS>(&tk, kc, P, nh)) ||
      (rc = encode_pool<T, D, PS>(&tv, vc, P, nh)))
    return rc;
  int split_pages = 0;
  const int splits = plan(B, nh, max_pages, &split_pages);
  if (splits <= 0) return splits < 0 ? -splits : -1;
  if (2 * splits * static_cast<int>(sizeof(float)) > 48 * 1024) return -1;
  const dim3 grid(nh, B, splits);
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      tk, tv, static_cast<const float*>(q),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(pos), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<float*>(out),
      static_cast<float*>(ws), nh, max_pages, split_pages, scale, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh, B);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 2 * splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_decode_join_kernel<D>,
                            static_cast<const int32_t*>(pos),
                            static_cast<const float*>(ws),
                            static_cast<float*>(out), nh, max_pages, PS,
                            split_pages, splits);
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* table,
             const void* pos, const void* ksc, const void* vsc, void* out,
             void* ws, int B, int nh, int P, int head_dim,
             int page_size, int max_pages, float scale,
             cudaStream_t stream) {
#define PAGED_DECODE_CASE(DD, PP)                                          \
  if (head_dim == DD && page_size == PP)                                   \
    return launch<T, DD, PP>(q, kc, vc, table, pos, ksc, vsc, out, ws, B,   \
                             nh, P, max_pages, scale, stream);
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

// Floats of the split workspace ws of a call with B slots, nh heads and a
// table of max_pages pages on the current device (one (max, sum, d-wide
// sum) partial a split), and the split length in pages (*split_pages);
// -1 when the device cannot be asked.
extern "C" long long paged_decode_workspace_floats(int B, int nh,
                                                   int head_dim,
                                                   int max_pages,
                                                   int* split_pages) {
  const int splits = plan(B, nh, max_pages, split_pages);
  if (splits <= 0) return -1;
  return static_cast<long long>(B) * nh * splits * (head_dim + kPartStride);
}

// kc, vc: the layer's pools [P, page_size, nh, head_dim]. pool_dtype: 0 =
// bfloat16, 1 = float32, 2 = int8, 3 = float8_e4m3fn; ksc and vsc are the
// layer's per-page scales, fp32 [P], for 2 and 3 (null otherwise). ws:
// paged_decode_workspace_floats fp32. Two launches on the stream: the
// splits, then their join. Returns 0, a cudaError_t code, or a negative
// code of paged_decode_error_string.
extern "C" int paged_decode_launch(const void* q, const void* kc,
                                   const void* vc, const void* table,
                                   const void* pos, const void* ksc,
                                   const void* vsc, void* out, void* ws,
                                   int B, int nh, int P,
                                   int head_dim, int page_size,
                                   int max_pages, int pool_dtype,
                                   float scale, void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  if (max_pages <= 0 || P <= 0 || B > 65535 || nh > 65535) return -1;
  const bool quant = pool_dtype == 2 || pool_dtype == 3;
  if (quant != (ksc != nullptr && vsc != nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case 0:
      return dispatch<__nv_bfloat16>(q, kc, vc, table, pos, ksc, vsc, out,
                                     ws, B, nh, P, head_dim,
                                     page_size, max_pages, scale, s);
    case 1:
      return dispatch<float>(q, kc, vc, table, pos, ksc, vsc, out, ws,
                             B, nh, P, head_dim, page_size,
                             max_pages, scale, s);
    case 2:
      return dispatch<int8_t>(q, kc, vc, table, pos, ksc, vsc, out, ws,
                              B, nh, P, head_dim, page_size,
                              max_pages, scale, s);
    case 3:
      return dispatch<__nv_fp8_e4m3>(q, kc, vc, table, pos, ksc, vsc, out,
                                     ws, B, nh, P, head_dim,
                                     page_size, max_pages, scale, s);
  }
  return -1;
}

// The mbarrier timeout record's 8 ints (code, row, block x, block y, warp,
// barrier, parity, step); all zero when no wait has timed out. Reads host
// memory only, so it works after the trap has poisoned the CUDA context.
extern "C" void paged_decode_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* paged_decode_error_string(int code) {
  switch (code) {
    case -1:
      return "unsupported head_dim, page_size, pool dtype or table width";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found through "
             "cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
