// The local GEMMs of the ring collectives of sequence-parallel training and
// of the pipeline boundary, for Hopper (sm_90a).
//
// Replaces five TPU kernels of paddle_tpu/ops/pallas_kernels/
// fused_collectives.py. Three are a ring of n steps in which a chunk of
// the sequence moves to the right neighbour while the chunk in hand is
// GEMMed:
//
// * _ag_gemm_kernel (:201, the pallas_call at :590): ring all-gather of the
//   seq shard x [B, s, A] with each arriving chunk GEMMed against the
//   column shard w [A, F] into its block-row of [B, n*s, F];
// * _gemm_rs_kernel (:249, :610): GEMM of the per-rank partial y [B, S, F]
//   chunk by chunk against the row shard w [F, A], accumulated in fp32
//   into the chunk's traveling ring destination: acc = recv + part,
//   [B, s, A] after n steps;
// * _ag_accum_kernel (:307, :631): the weight gradient of both, sum over
//   the ring steps of r_c^T @ stat_c in fp32, [A, Bf].
//
// Two are the last GEMM of a pipeline stage and its backward:
//
// * _gemm_ppsend_kernel (:792, the pallas_call at :886): the stage tail
//   y = r + (x @ w + b) (x the last block's gelu activation [R, 4H], w
//   its down projection, r the residual [R, H]), y sent to the next stage;
// * _gemm_pprecv_kernel (:826, :904): its backward, dr = gy + gwire as
//   the next stage's cotangent lands, then dx = dr @ w^T and dw = x^T @ dr.
//
// The TPU kernels move data with in-kernel remote DMAs. Hopper has no
// in-kernel remote copy this port may write, so every hop is an NCCL
// point-to-point pair outside the kernel (paddle_tpu_torch/ops/
// ring_gemm.py, ops/pp_boundary.py), and each step launches kernels of
// this file: a tile GEMM with bf16 operands, fp32 accumulation on the
// tensor cores, and an epilogue that does the schedule's own work:
//
// * row 7, mode NN (and NT for the backward's w^T): stores the bf16 block
//   straight into the chunk's rows of the [B, n*s, F] output (a row map:
//   row r of the chunk lands at b * (n*s*F) + (src*s + i) * F with
//   b = r / s, i = r % s), so the gathered result needs no relayout;
// * row 8, mode NN (NT in the backward): reads the chunk's rows of y in
//   place through the same row map, and writes fp32 acc = recv + part
//   (the reference's order, fused_collectives.py:277; plain part at the
//   first step) into the buffer the next hop sends, or at the last step
//   the bf16 result;
// * row 9, mode TN: both operands row-major over the B*s contraction rows
//   (the ring chunk, and the rows of the stationary operand belonging to
//   chunk src, read in place through the row map); the transposed operand
//   comes from shared memory by ldmatrix.trans. fp32 output, with
//   out += part after the first step;
// * row 14, mode NN with the bias + residual epilogue: y = r + (acc + b)
//   in fp32 (the reference's association; one rounding to bf16 where the
//   reference rounds after each op), one launch over all R rows (a launch
//   per 256-row chunk would have 32 tiles for 132 SMs). The wrapper then
//   posts y's hop on NCCL's stream;
// * row 15: pp_add_kernel, dr = gy + gwire elementwise in fp32 rounded to
//   bf16 (the bits of PyTorch's bf16 add), once the received cotangent has
//   landed; then this GEMM in mode NT for dx = dr @ w^T (bf16) and in mode
//   TN for dw = x^T @ dr (fp32). db is a sum of dr outside the kernel.
//   The TPU kernel keeps one full-matrix product so that the fused rung
//   equals the unfused one bit for bit (:805-807); here every output
//   element is summed over k in the same order whatever rows a launch
//   covers, so one launch over all rows keeps that property.
//
// What bounds them on an H100. Rows 7-9, per rank at GPT-3 1.3B, B=8,
// S=2048, n=4 (chunk rows B*s = 4096): one qkv chunk GEMM is
// 2*4096*2048*1536 = 25.8 GFLOP, 26 us at 989 TFLOP/s (operations: ~1,900
// flops per byte moved); the hop beside it moves a 16.8 MB bf16 chunk
// (rows 7, 9) or 33.5 MB of fp32 partials (row 8), 37 / 75 us at 450 GB/s
// NVLink. Row 7 posts hop t+1 before launching step t's GEMM, so the
// transfer runs under the GEMM, as the TPU kernel's double buffer does;
// row 9 likewise. Row 8's step needs the partial that arrives with the
// hop, and this first version waits for it and then launches the GEMM
// with it as its fp32 addend: no overlap, no extra pass over the partials.
// Row 14 at pp=4, M=8 (R = 2048 rows a microbatch, K = 8192, F = 2048):
// 2*2048*8192*2048 = 68.7 GFLOP, 69.5 us at 989 TFLOP/s, against ~84 MB
// of HBM traffic (25 us) and an 8.39 MB hop (18.6 us at 450 GB/s): bound
// by operations. Row 15: two such GEMMs, 137.4 GFLOP, 139 us. The TPU
// kernel sends y in chunks from its epilogue so that the hop overlaps the
// GEMM; here the hop follows the launch on NCCL's stream and overlaps the
// next microbatch's work instead. An epilogue that stores into the next
// card's buffer (CUDA IPC) is the NVLink design of later work.
//
// Design of the GEMM: a 128 x 128 output tile per block of 8 warps (each
// warp 64 x 32), k steps of 32, a four-stage cp.async ring of shared-memory
// tiles (80 KB of dynamic shared memory, two blocks an SM: three k steps
// load while one computes), fragments by ldmatrix (.trans for a k-major
// operand), mma.sync m16n8k16 bf16 with fp32 accumulators (the fragment
// layouts of quant_gemm.cu). The row map's division is done once per
// thread: a load walks its k rows with a cursor. With two stages and the
// division in the loop the same GEMMs ran at 55-188 TFLOP/s on an H100,
// with these changes at 111-284 (PERF.md). wgmma, TMA, split k for the
// few-tile weight gradients, and an NVLink design whose epilogue stores
// into the peers' buffers are later work.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/ring_gemm.py,
// ops/pp_boundary.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kPad = 8;                        // bf16 elements added to a row
constexpr int kTileElems = kBM * (kBK + kPad);  // the larger of a tile's two
                                                // shared layouts
static_assert(kBK * (kBN + kPad) <= kTileElems, "tile layout");
constexpr int kStages = 4;                      // the cp.async ring
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;   // 81,920

// operand modes: A [M, K] or its k-major storage, B [K, N] or [N, K]
constexpr int kNN = 0;   // A row-major [M][K], B row-major [K][N]
constexpr int kNT = 1;   // A row-major [M][K], B stored [N][K] (B = W^T)
constexpr int kTN = 2;   // A stored [K][M] (A = P^T), B row-major [K][N]

// epilogues: v = acc in fp32, then
constexpr int kEpiAddend = 0;     // v = addend + v (addend fp32 [M][N], or
                                  // none)
constexpr int kEpiBiasResid = 1;  // v = resid + (v + bias): bias bf16 [N],
                                  // resid bf16 [M][N] (row 14)

// Where storage row r of an operand lies: rows come in batches of `rpb`
// rows, `bstride` elements apart, rows of a batch `ld` elements apart. A
// contiguous matrix has rpb >= its rows (one batch).
struct RowMap {
  long long ld;
  long long bstride;
  int rpb;
};

__device__ __forceinline__ long long row_off(const RowMap& m, int r) {
  return static_cast<long long>(r / m.rpb) * m.bstride +
         static_cast<long long>(r % m.rpb) * m.ld;
}

// the offset of storage row r and its place in its batch, moved kBK rows
// on by `advance`
struct Cursor {
  long long off;
  int rem;
};

__device__ __forceinline__ Cursor cursor_at(const RowMap& m, int r) {
  return Cursor{row_off(m, r), r % m.rpb};
}

__device__ __forceinline__ void advance(Cursor& c, const RowMap& m) {
  c.off += kBK * m.ld;
  c.rem += kBK;
  while (c.rem >= m.rpb) {
    c.rem -= m.rpb;
    c.off += m.bstride - static_cast<long long>(m.rpb) * m.ld;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;          // 0: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16, m x k): a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                     a2 (g, 8+2t..)     a3 (g+8, 8+2t..)
//   B (16x8, k x n):  b0 (k = 2t..2t+1, n = g)   b1 (k = 8+2t.., n = g)
//   C (16x8, fp32):   c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// For each operand layout the ldmatrix below gives lane l the address of
// row l % 8 of matrix i = l / 8, and the four matrices land in a0..a3, or
// in b0, b1 of n-tile 0 and b0, b1 of n-tile 1:
//   A [m][k], no trans:   matrix i = (m 8*(i%2), k 8*(i/2))
//   A [k][m], trans:      matrix i = (k 8*(i/2), m 8*(i%2))
//   B [k][n], trans:      matrix i = (k 8*(i%2), n 8*(i/2))
//   B [n][k], no trans:   matrix i = (n 8*(i/2), k 8*(i%2))
template <int MODE, bool OUT_BF16, int EPI>
__global__ void __launch_bounds__(kThreads)
ring_gemm_tile_kernel(const __nv_bfloat16* a, RowMap am,
                      const __nv_bfloat16* b, RowMap bm, void* c, RowMap cm,
                      const float* addend, const __nv_bfloat16* bias,
                      const __nv_bfloat16* resid, int M, int N, int K) {
  // kStages x {A tile, B tile}, dynamic: above the 48 KB of static memory
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / 4;               // warp rows [wm*64, wm*64+64)
  const int wn = warp % 4;               // warp cols [wn*32, wn*32+32)
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  constexpr int kLdA = MODE == kTN ? kBM + kPad : kBK + kPad;
  constexpr int kLdB = MODE == kNT ? kBK + kPad : kBN + kPad;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // each tile is 4096 bf16 = 512 chunks of 16 bytes, two a thread. A
  // chunk whose storage row is fixed (an m row of A [M][K], an n row of B
  // [N][K]) has its row's offset computed once; a chunk on a k row (A
  // [K][M], B [K][N]) walks the k rows with a cursor, kBK rows a load:
  // no integer division in the loop
  long long fixed_a[2], fixed_b[2];
  Cursor ka[2], kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ch = tid + i * kThreads;
    if constexpr (MODE == kTN) ka[i] = cursor_at(am, ch / 16);
    else fixed_a[i] = row0 + ch / 4 < M ? row_off(am, row0 + ch / 4) : 0;
    if constexpr (MODE == kNT)
      fixed_b[i] = col0 + ch / 4 < N ? row_off(bm, col0 + ch / 4) : 0;
    else kb[i] = cursor_at(bm, ch / 16);
  }
  auto load = [&](int stage, int k0) {      // k steps in order, from 0
    __nv_bfloat16* As = smem + stage * 2 * kTileElems;
    __nv_bfloat16* Bs = As + kTileElems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + i * kThreads;
      if constexpr (MODE == kTN) {          // A stored [K][M]: 32 x 128
        const int k = ch / 16, m = (ch % 16) * 8;
        const bool ok = k0 + k < K && row0 + m < M;
        cp_async16(&As[k * kLdA + m], ok ? a + ka[i].off + row0 + m : a, ok);
        advance(ka[i], am);
      } else {                              // A [M][K]: 128 x 32
        const int m = ch / 4, k = (ch % 4) * 8;
        const bool ok = row0 + m < M && k0 + k < K;
        cp_async16(&As[m * kLdA + k], ok ? a + fixed_a[i] + k0 + k : a, ok);
      }
      if constexpr (MODE == kNT) {          // B stored [N][K]: 128 x 32
        const int n = ch / 4, k = (ch % 4) * 8;
        const bool ok = col0 + n < N && k0 + k < K;
        cp_async16(&Bs[n * kLdB + k], ok ? b + fixed_b[i] + k0 + k : b, ok);
      } else {                              // B [K][N]: 32 x 128
        const int k = ch / 16, n = (ch % 16) * 8;
        const bool ok = k0 + k < K && col0 + n < N;
        cp_async16(&Bs[k * kLdB + n], ok ? b + kb[i].off + col0 + n : b, ok);
        advance(kb[i], bm);
      }
    }
  };

  // a ring of kStages tiles: kStages - 1 k steps in flight while one is
  // computed; one (possibly empty) commit group per k step keeps the
  // wait count uniform
  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();           // this step's tiles have landed
    __syncthreads();                        // and step kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next * kBK);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % kStages) * 2 * kTileElems;
    const __nv_bfloat16* Bs = As + kTileElems;
    const int i = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16;
        if constexpr (MODE == kTN)
          ldsm_x4_trans(af[mi], &As[(kk + r + 8 * (i >> 1)) * kLdA + m +
                                    8 * (i & 1)]);
        else
          ldsm_x4(af[mi], &As[(m + r + 8 * (i & 1)) * kLdA + kk +
                              8 * (i >> 1)]);
      }
#pragma unroll
      for (int np = 0; np < 4; np += 2) {
        const int n = wn * 32 + np * 8;
        uint32_t bf[4];
        if constexpr (MODE == kNT)
          ldsm_x4(bf, &Bs[(n + r + 8 * (i >> 1)) * kLdB + kk + 8 * (i & 1)]);
        else
          ldsm_x4_trans(bf, &Bs[(kk + r + 8 * (i & 1)) * kLdB + n +
                                8 * (i >> 1)]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: v = addend + part in fp32 (the reference's recv + part), or
  // v = resid + (part + bias) (its stage tail), one rounding to bf16 or
  // stored in fp32
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0 = acc[mi][ni][2 * h];
        float v1 = acc[mi][ni][2 * h + 1];
        if constexpr (EPI == kEpiBiasResid) {
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + col));
          const float2 rr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  resid + static_cast<long long>(row) * N + col));
          v0 = rr.x + (v0 + bb.x);
          v1 = rr.y + (v1 + bb.y);
        } else if (addend != nullptr) {
          const float2 s = *reinterpret_cast<const float2*>(
              addend + static_cast<long long>(row) * N + col);
          v0 = s.x + v0;
          v1 = s.y + v1;
        }
        const long long o = row_off(cm, row) + col;
        if constexpr (OUT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(c) + o) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(c) + o) =
              make_float2(v0, v1);
      }
    }
}

template <int MODE, bool OUT_BF16, int EPI = kEpiAddend>
cudaError_t launch(const void* a, RowMap am, const void* b, RowMap bm,
                   void* c, RowMap cm, const void* addend, int M, int N,
                   int K, cudaStream_t s, const void* bias = nullptr,
                   const void* resid = nullptr) {
  static bool opted_in[64] = {};            // above 48 KB: opt in once
  int dev = 0;                              // per device
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(ring_gemm_tile_kernel<MODE, OUT_BF16, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ring_gemm_tile_kernel<MODE, OUT_BF16, EPI>
      <<<grid, kThreads, kSmemBytes, s>>>(
          static_cast<const __nv_bfloat16*>(a), am,
          static_cast<const __nv_bfloat16*>(b), bm, c, cm,
          static_cast<const float*>(addend),
          static_cast<const __nv_bfloat16*>(bias),
          static_cast<const __nv_bfloat16*>(resid), M, N, K);
  return cudaGetLastError();
}

// dr = gy + gwire over n bf16 values, eight (16 bytes) a thread: each sum
// in fp32, rounded once to bf16
__global__ void __launch_bounds__(kThreads)
pp_add_kernel(const uint4* a, const uint4* b, uint4* out, long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 va = a[i], vb = b[i];
    uint4 vo;
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&va);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&vb);
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&vo);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(pa[j]);
      const float2 fb = __bfloat1622float2(pb[j]);
      po[j] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
    }
    out[i] = vo;
  }
}

template <int MODE>
cudaError_t launch_mode(const void* a, RowMap am, const void* b, RowMap bm,
                        void* c, RowMap cm, int out_bf16, const void* addend,
                        int M, int N, int K, cudaStream_t s) {
  return out_bf16 ? launch<MODE, true>(a, am, b, bm, c, cm, addend, M, N, K, s)
                  : launch<MODE, false>(a, am, b, bm, c, cm, addend, M, N, K,
                                        s);
}

}  // namespace

// One ring step's GEMM on `stream`: C[M, N] = addend + A @ B in fp32, stored
// as bf16 (out_bf16) or fp32. mode 0 (NN): A row-major [M][K], B row-major
// [K][N]; 1 (NT): B stored [N][K]; 2 (TN): A stored [K][M]. Each operand's
// storage rows are placed by (ld, bstride, rpb) as RowMap says, in
// elements; addend (fp32, may be null, may be C itself) is contiguous
// [M][N]. M, N, K multiples of 16, every row 16-byte aligned. Returns 0, a
// cudaError_t code, or -1 for arguments this library does not take.
extern "C" int ring_gemm_launch(int mode, const void* a, long long lda,
                                long long a_bstride, int a_rpb,
                                const void* b, long long ldb,
                                long long b_bstride, int b_rpb, void* c,
                                long long ldc, long long c_bstride, int c_rpb,
                                int out_bf16, const void* addend, int M,
                                int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (M % 16 || N % 16 || K % 16 || lda % 8 || ldb % 8 || ldc % 8 ||
      a_bstride % 8 || b_bstride % 8 || c_bstride % 8 || a_rpb <= 0 ||
      b_rpb <= 0 || c_rpb <= 0 || (out_bf16 && addend == c))
    return -1;
  const RowMap am{lda, a_bstride, a_rpb};
  const RowMap bm{ldb, b_bstride, b_rpb};
  const RowMap cm{ldc, c_bstride, c_rpb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNN:
      return launch_mode<kNN>(a, am, b, bm, c, cm, out_bf16, addend, M, N, K,
                              s);
    case kNT:
      return launch_mode<kNT>(a, am, b, bm, c, cm, out_bf16, addend, M, N, K,
                              s);
    case kTN:
      return launch_mode<kTN>(a, am, b, bm, c, cm, out_bf16, addend, M, N, K,
                              s);
  }
  return -1;
}

// Row 14: y[M, N] = resid + (x @ w + bias) stored bf16, one launch on
// `stream`; x [M][K], w [K][N], resid [M][N] and y contiguous, bias [N];
// all bf16. M, N, K multiples of 16, 16-byte aligned. Returns as
// ring_gemm_launch does.
extern "C" int pp_gemm_launch(const void* x, const void* w, const void* bias,
                              const void* resid, void* y, int M, int N, int K,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (M % 16 || N % 16 || K % 16 || resid == y) return -1;
  const int all = 1 << 30;                  // one batch of rows
  return launch<kNN, true, kEpiBiasResid>(
      x, RowMap{K, 0, all}, w, RowMap{N, 0, all}, y, RowMap{N, 0, all},
      nullptr, M, N, K, static_cast<cudaStream_t>(stream), bias, resid);
}

// Row 15's elementwise part: out[n] = a + b, bf16, n a multiple of 8,
// every pointer 16-byte aligned (out may be a or b).
extern "C" int pp_add_launch(const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  if (n % 8) return -1;
  const long long n8 = n / 8;
  const long long want = (n8 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  pp_add_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<uint4*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ring_gemm_error_string(int code) {
  if (code == -1) return "unsupported mode, shape, stride or alignment";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
