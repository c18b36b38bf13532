// Flash attention's forward, dQ and dK/dV kernels for Hopper (sm_90a):
// wgmma products fed by TMA loads through an mbarrier ring.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas_kernels/:
//   flash_attention.py:_fwd_kernel  (pallas_call at :280) -> flash_fwd_kernel
//   flash_attention_bwd.py:_dq_kernel  (pallas_call at :286) -> flash_dq_kernel
//   flash_attention_bwd.py:_dkv_kernel (pallas_call at :300) -> flash_dkv_kernel
// in their causal and non-causal forms, with or without an additive bias,
// dropout and segment ids, on bf16 or fp16 operands, with q and key
// lengths Sq and Sk that may differ. For each batch b and head h, with s =
// q.k * scale (+ bias[b, h, i, j]), -inf where the segment ids of query i
// and key j differ or, when causal, where j > i (top-left alignment, the
// reference's k_pos <= q_pos), keep the dropout mask (csrc/philox.cuh) and
// r = 1 / (1 - p):
//
//   forward  P = softmax(s), O = (keep r P) V, LSE = logsumexp(s) (natural
//            log, masked keys excluded; the row sum is taken before
//            dropout)
//   dQ       P = exp(s - LSE), dP = keep r (dO V^T), dS = P (dP - delta)
//            scale, dQ = dS K
//   dK, dV   P and dS as for dQ, dV = (keep r P)^T dO, dK = dS^T Q
//            (delta = rowsum(dO o O), computed beside the kernels in
//            PyTorch)
//
// The features live in instances of their own (template parameter kFeat,
// FLASH_FEATURES below): level 1 takes the bias and dropout at equal q and
// key lengths, level 2 also segment ids (a pointer that may be null) and
// lengths apart, so the instances without them (level 0) and BERT's
// (level 1) compile as they did before level 2 came. The
// bias is fp32 and read by plain loads through its four element strides
// (a broadcast dimension at stride 0: BERT's [B, 1, 1, S] key-padding
// bias costs S values a batch), never at a row or key past Sq or Sk. The
// segment ids are int32 [B, Sq] and [B, Sk], with each 64-row tile's
// least and greatest id beside them (ops/flash_attention.py:
// segment_ranges): a tile of keys whose range does not meet the range of
// a tile of queries holds no pair with equal ids, and its loads and
// products are skipped (in a varlen pack, whose ids rise along the pack,
// only the tiles holding a pair from one document remain). A row
// whose every score is at most -5e29 (a bool mask's -1e30 over the whole
// row, or a query whose segment no key shares) gets O = 0 and LSE =
// +1e30, so that the backward's P underflows to 0, as the reference's
// kernel does. The bias and the ids get no gradient. The element type is
// a template parameter: fp16 runs wgmma's .f16 form with the same fp32
// accumulators, P and dS rounded to fp16 where bf16 rounds them to bf16.
//
// q, k, v and dO are read in their [B, S, H, D] layout through a TMA tensor
// map per operand (4-D, innermost first: D, H, S, B, with the caller's byte
// strides), so the model's qkv split is read in place. O, dQ, dK and dV
// are written contiguous [B, S, H, D] bf16; LSE and delta are fp32
// [B*H, S]. Any S >= 1; head dims 64 and 128; bf16.
//
// What bounds them on an H100: operations. At the GPT-3 1.3B training
// shapes (B=8, S=2048, 16 heads of 128, causal) the forward does 1.37e11
// flops on 270 MB, dQ 2.06e11 on 337 MB and dK/dV 2.75e11 on 404 MB: over
// 500 flops a byte, above the ~295 at which the bf16 tensor cores (989
// TFLOP/s), not HBM, become the limit. So the design keeps the tensor
// cores fed:
//
// * Products are warpgroup wgmma.mma_async (m64nNk16, bf16 in, fp32
//   accumulators). Operands that live in shared memory are read there by
//   the tensor cores through matrix descriptors; the softmax's P and dS go
//   from the accumulators straight into wgmma's A-from-registers form (the
//   m64nNk16 accumulator of one 16-column slice is the A fragment of one
//   k16 step), so they never touch memory.
// * Tiles arrive by TMA (cp.async.bulk.tensor) with the 128-byte swizzle,
//   as boxes of 64 columns (128 bytes, the swizzle's row) by the tile's
//   rows: a d=128 tile is two boxes side by side. The descriptors use the
//   same swizzle: K-major operands (Q and K in S = Q K^T; dO and V in dQ's
//   dP = dO V^T; K, V, Q, dO in the dK/dV kernel's S^T and dP^T) step 32
//   bytes inside the swizzle row per k16 slice; MN-major operands (V in O
//   += P V; K in dQ += dS K; dO and Q in dV += P^T dO and dK += dS^T Q)
//   are read transposed through the descriptor's transpose bit, one
//   64-column box per instruction, so no transposed copy is ever made.
//   Every descriptor carries 1024 bytes (8 rows of 128 bytes) as the
//   stride between 8-row groups.
// * Loads run ahead through a ring of stages, each with a full barrier (an
//   arrive with the stage's byte count; TMA's transaction bytes complete
//   it) and an empty barrier (every consumer thread arrives when its
//   products have read the stage), so the loads of the next tiles overlap
//   this tile's products and softmax. The forward and dQ are
//   warp-specialised: warps 0-7 are two consumer warpgroups, warps 8-11 a
//   producer warpgroup whose first thread issues every load and refills a
//   stage as soon as it is empty; setmaxnreg moves registers from the
//   producer to the consumers. The forward's consumers take turns issuing
//   S = Q K^T (named barriers) so that one's product overlaps the other's
//   softmax (the same turns cost dQ 5 % and dK/dV 17 %). A block of 384
//   threads is compiled to 168 registers a thread (65536 / 384; ptxas of
//   CUDA 12.9 reports that count whatever setmaxnreg asks), which holds
//   the forward's O and S accumulators and dQ's accumulator with S and dP
//   of 64 keys, but not dK/dV's two accumulators: that kernel runs the two
//   consumer warpgroups alone (256 threads, up to 255 registers) and its
//   thread 0 issues the loads two steps ahead through a 3-stage ring.
// * Forward: one block per (b*h, 128-row q tile), heaviest causal tiles
//   first; each consumer warpgroup owns 64 q rows. Q is loaded once; K
//   and V tiles of 128 keys stream through the ring. The online softmax
//   keeps each row's running max and sum in registers in log2 units
//   (exp2f), reduced over the 4 lanes that share a row.
// * dK/dV: one block per (b*h, 128-key tile), each warpgroup owning 64
//   keys; K and V are loaded once and stay; 64-row tiles of Q and dO
//   stream through the ring from the diagonal on. Each thread loads the
//   LSE and delta of its 16 q columns from global memory while the tile's
//   first products run (plain loads: a row's offset bh*S + q0 need not
//   be the 16-byte multiple a TMA box must start on). S^T = K Q^T and
//   dP^T = V dO^T put keys on wgmma's M, so P^T and dS^T are already the
//   A operands of dV += P^T dO and dK += dS^T Q. Every dK/dV row is owned
//   by one block: no atomics, the same bits on every run.
// * dQ: the forward's grid and loop with the LSE known (no online
//   softmax): one block per (b*h, 128-row q tile), heaviest first, each
//   consumer warpgroup owning 64 q rows; Q and dO are loaded once and
//   stay (the A operands of S = Q K^T and dP = dO V^T); tiles of 64 keys
//   of K and V stream through a 3-stage ring. Each thread loads the LSE
//   and delta of its two rows once, by plain loads. S and dP are two
//   commit groups, so P is computed while dP is in the tensor cores; dS
//   goes from the accumulators into the A fragments of dQ += dS K. Every
//   dQ row is owned by one block and sums its key tiles in order: no
//   atomics, the same bits on every run (dQ is not folded into dK/dV's
//   block, which would need a sum across blocks).
// * The mask is evaluated only where it can bite: the forward's last key
//   tile (the diagonal when causal, the one holding key Sk-1 otherwise);
//   in dQ the key tiles on the warpgroup's diagonal and the one holding
//   key Sk-1; in dK/dV the diagonal q tile and the one holding q row
//   Sq-1; with segment ids also every tile whose ids are not all one
//   value (a tile inside one document reads no id). What TMA reads past
//   Sq or Sk comes as zeros: such keys are masked to -inf in the forward
//   and to P = 0 in dQ, such q rows to P = 0 in dK/dV, the sums over
//   them; the output rows past the lengths (forward and dQ q rows, dK/dV
//   keys) are computed and not written. A dQ or dK/dV warpgroup whose
//   rows all lie before a causal tile's keys skips it.
// * Every mbarrier wait is bounded by %globaltimer: a wait that outlasts
//   kWaitTimeoutNs writes the kernel, block, warp, barrier, parity and
//   loop step into a host-mapped record and traps, so a phase slip fails
//   the run instead of hanging it.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/flash_attention.py). The
// tensor maps are encoded per call on the host by cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (nothing more to link),
// and passed as __grid_constant__ kernel parameters, so a launch captured
// in a CUDA graph replays with its own maps. The mbarrier, TMA, descriptor
// and wgmma helpers are csrc/sm90.cuh's, shared with quant_gemm.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// the stuck test build's waits trap after 1 s (the shipped build's 10 s)
#ifdef FLASH_SM90_STUCK
#define SM90_WAIT_TIMEOUT_NS 1000000000ull
#endif
#include "philox.cuh"
#include "sm90.cuh"

namespace {

constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + the producer's
constexpr int kConsumers = kConsumerWarps * 32;
// The forward's register split: the producer warpgroup keeps 40 a thread
// and the consumers ask for 232 (2 x 128 x 232 + 128 x 40 = 64512).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 2;
constexpr int kBoxCols = 64;      // 2-byte columns of a TMA box (128 bytes)
constexpr int kRowBytes = 128;    // bytes of one box row in shared memory
constexpr int kFwdBq = 128;       // q rows per forward block
constexpr int kFwdBk = 128;       // keys per forward loop step
constexpr int kDkvBk = 128;       // keys per dK/dV block
constexpr int kDkvBq = 64;        // q rows per dK/dV loop step
constexpr int kDqBq = 128;        // q rows per dQ block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a row whose largest score (log2 units) is at or below this is fully
// masked (the reference's m <= 0.5 * -1e30, flash_attention.py:148)
constexpr float kMaskedRowLog2 = -0.5e30f * kLog2e;
constexpr float kMaskedLse = 1e30f;

// The features of the kExtra instances: an additive fp32 bias read
// through its element strides (0 on a broadcast dimension; nullptr: no
// bias), dropout, and segment ids (nullptr: none) with their 64-row
// ranges [B, ceil(S / 64)] of (least, greatest) id.
struct Extra {
  const float* bias;
  long long sb, sh, si, sj;
  int dropout;
  philox::Dropout drop;
  const int* qseg;
  const int* kseg;
  const int2* qrange;
  const int2* krange;
};

constexpr int kSegTile = 64;      // rows of a segment-id range

// bias[b, h] of a kExtra instance, or nullptr
__device__ __forceinline__ const float* bias_of(const Extra& ex, int b,
                                                int h) {
  return ex.bias ? ex.bias + b * ex.sb + h * ex.sh : nullptr;
}

// bias[i, j] of one (b, h) in log2 units, 0 past Sq or Sk
__device__ __forceinline__ float bias_log2(const Extra& ex, const float* bb,
                                           int i, int j, int Sq, int Sk) {
  return i < Sq && j < Sk ? __ldg(bb + i * ex.si + j * ex.sj) * kLog2e
                          : 0.f;
}

// The (least, greatest) segment id of rows [r0, r0 + rows) of one batch
// (its ranges rg, S rows in all), rows a multiple of kSegTile; empty
// (INT_MAX, INT_MIN) past S.
__device__ __forceinline__ int2 seg_range(const int2* rg, int r0, int rows,
                                          int S) {
  int2 r = make_int2(INT_MAX, INT_MIN);
  const int end = min((r0 + rows + kSegTile - 1) / kSegTile,
                      (S + kSegTile - 1) / kSegTile);
  for (int t = r0 / kSegTile; t < end; ++t) {
    const int2 v = __ldg(rg + t);
    r.x = min(r.x, v.x);
    r.y = max(r.y, v.y);
  }
  return r;
}

// True when no id of range a can equal one of range b.
__device__ __forceinline__ bool apart(int2 a, int2 b) {
  return a.y < b.x || b.y < a.x;
}

// True when a tile of queries (ids in range q) against a tile of keys
// (range k) may hold pairs of two segments; false when every id of both
// is one value, so every pair matches and no id needs reading.
__device__ __forceinline__ bool mixed(int2 q, int2 k) {
  return !(q.x == q.y && k.x == k.y && q.x == k.x);
}

// The batch's ranges of a segment-id operand of S rows.
__device__ __forceinline__ const int2* ranges_of(const int2* rg, int b,
                                                 int S) {
  return rg + static_cast<long long>(b) * ((S + kSegTile - 1) / kSegTile);
}

// The feature levels of the instances (template parameter kFeat): 0 none;
// 1 an additive bias and dropout, q and key lengths equal (the kExtra
// instances of BERT's encoder); 2 the same with segment ids (a pointer
// that may be null) and q and key lengths that may differ. Levels 0 and 1
// read Sk as Sq, so their code is that of the instances before levels
// were split (their registers and spills stay as they were); a call with
// segment ids or Sq != Sk takes level 2.
#define FLASH_FEATURES(F)                                                \
  constexpr bool kExtra = (F) > 0;                                       \
  constexpr bool kGeneral = (F) == 2;                                    \
  const int Sk = kGeneral ? Sk_arg : Sq

// The element types: bf16 or fp16 operands, their TMA data type, and two
// fp32 values rounded into one 32-bit register of the type.
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// Arrivals that complete a stage's full barrier: the loads' one. A test
// build (-DFLASH_SM90_STUCK) expects one more, which never comes, so every
// kernel's first wait on a stage times out after 1 s and leaves its record
// (the forced-timeout card test; the shipped library is never built so).
#ifdef FLASH_SM90_STUCK
constexpr uint32_t kFullCount = 2;
#else
constexpr uint32_t kFullCount = 1;
#endif

// Error codes of the launch functions besides cudaError_t's.
constexpr int kErrHeadDim = -1;
constexpr int kErrMapArgs = -4;     // -2 and -3: sm90.cuh's encode codes

// The rows [row0, row0 + rows) of head h of batch b, all D columns, as
// D / 64 boxes of [rows][64] one after the other from dst.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int h,
                                         int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c)
    tma_load_4d(dst + c * rows * kRowBytes, map, bar, c * kBoxCols, h, row0,
                b);
}

// Named barriers 1 and 2 (0 is __syncthreads) take turns between the
// forward's two consumer warpgroups: warpgroup w syncs on 1 + w before it
// issues S = Q K^T and then arrives on the other's, so one's product runs
// while the other does its softmax. (In dK/dV the same turns cost 17 %:
// 1.05 ms against 0.90 at the 1.3B shape, one H100.)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumers)
               : "memory");
}

// ------------------------------------------------ the flash products
// The wgmma forms below for one element type TY ("bf16" or "f16"); the
// fp32 accumulators are the same for both.
#define FLASH_WGMMA_SS_N128(TY)                                          \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                             \
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"                \
      "setp.ne.b32 p, %67, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
      "da, db, p, 1, 1, 0, 0;\n}\n"                                       \
      : WG_F64(d)                                                        \
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate))
#define FLASH_WGMMA_SS_N64(TY)                                           \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                             \
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"                \
      "setp.ne.b32 p, %35, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, "                                             \
      "da, db, p, 1, 1, 0, 0;\n}\n"                                       \
      : WG_F32(d)                                                        \
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate))
#define FLASH_WGMMA_RS_N64_T(TY)                                         \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                                 \
      "mov.b64 db, {%36, %37};\n"                                         \
      "setp.ne.b32 p, %38, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31}, "                                             \
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"                         \
      : WG_F32(d)                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi), \
        "r"(1))

// d[64x128] (+)= A[64x16] B[16x128]; A and B K-major in shared memory,
// given by their descriptors' low words
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint32_t a,
                                              uint32_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_WGMMA_SS_N128("f16");
  else
    FLASH_WGMMA_SS_N128("bf16");
}

// d[64x64] (+)= A[64x16] B[16x64]; A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a,
                                             uint32_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_WGMMA_SS_N64("f16");
  else
    FLASH_WGMMA_SS_N64("bf16");
}

// d[64x64] += A[64x16] B[16x64]; A from registers, B MN-major in shared
// memory (read transposed through the descriptor)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint32_t b) {
  if constexpr (kIsHalf<T>)
    FLASH_WGMMA_RS_N64_T("f16");
  else
    FLASH_WGMMA_RS_N64_T("bf16");
}

// A fragments of the k16 slices of a 64 x (8 * NB) accumulator, rounded
template <typename T, int NB>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NB / 2][4],
                                         const float (&d)[4 * NB]) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack2<T>(d[8 * j + 2 * i], d[8 * j + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -------------------------------------------------------------- forward
template <int D>
struct FwdSmem {
  static constexpr int kTile = kFwdBk * D * 2;      // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kStage0 = kFwdBq * D * 2;
  static constexpr int kStageBytes = 2 * kTile;     // K then V
  static constexpr int kBytes = kStage0 + kStages * kStageBytes + 1024;
};

// barriers: 0 Q full; 1 + s stage s full; 1 + kStages + s stage s empty
template <typename T, int D, bool kCausal, int kFeat>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk_arg, int H,
                 float scale_log2, WaitRecord* rec, const Extra ex) {
  using L = FwdSmem<D>;
  FLASH_FEATURES(kFeat);
  constexpr int BQ = kFwdBq, BK = kFwdBk, ND = D / kBoxCols;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t base = aligned_base(smem);
  const Waiter w{smem_u32(bars), rec, 4};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warpgroup();
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int n_tiles =
      kCausal ? (kGeneral ? min(q0 / BK + 1, (Sk + BK - 1) / BK)
                          : q0 / BK + 1)
              : (Sk + BK - 1) / BK;
  // with segment ids (level 2), the key tiles whose ids cannot meet the
  // block's q rows' are skipped: live(it) says which remain, next(it) the
  // first that remains from it on, n_run how many
  const bool seg = kGeneral && ex.qseg != nullptr;
  const int2 q_ids = seg ? seg_range(ranges_of(ex.qrange, b, Sq), q0, BQ, Sq)
                         : make_int2(0, 0);
  auto next = [&](int it) {
    if (seg)
      while (it < n_tiles &&
             apart(q_ids, seg_range(ranges_of(ex.krange, b, Sk), it * BK, BK,
                                    Sk)))
        ++it;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(w.at(0), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w.at(1 + s), kFullCount);
      mbar_init(w.at(1 + kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumerWarps / 4) {                     // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(w.at(0), BQ * D * 2);
      tma_tile<D>(base + L::kQ, &tq, w.at(0), BQ, h, q0, b);
      for (int it = next(0), jj = 0; it < n_tiles; it = next(it + 1), ++jj) {
        const int j = kGeneral ? jj : it;                 // the load's turn
        const int s = j % kStages;
        if (j >= kStages)
          w.wait(1 + kStages + s, ((j / kStages) - 1) & 1, j);
        const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
        mbar_expect_tx(w.at(1 + s), 2 * L::kTile);
        tma_tile<D>(st, &tk, w.at(1 + s), BK, h, it * BK, b);
        tma_tile<D>(st + L::kTile, &tv, w.at(1 + s), BK, h, it * BK, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  setmaxnreg_inc<kConsumerRegs>();
  const int g = lane / 4, t = lane % 4;
  const int row[2] = {q0 + 64 * wg + 16 * (warp % 4) + g,
                      q0 + 64 * wg + 16 * (warp % 4) + g + 8};
  float acc[ND][32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const uint32_t q_lo = desc_lo(base + L::kQ + wg * 64 * kRowBytes);
  const float* bb = kExtra ? bias_of(ex, b, h) : nullptr;
  // this thread's rows' segment ids and the batch's key ids
  const int* ks = seg ? ex.kseg + static_cast<long long>(b) * Sk : nullptr;
  int qid[2] = {0, 0};
  int n_run = n_tiles;
  if (seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qid[i] = row[i] < Sq
                   ? __ldg(ex.qseg + static_cast<long long>(b) * Sq + row[i])
                   : INT_MIN;
    n_run = 0;
    for (int it = next(0); it < n_tiles; it = next(it + 1)) ++n_run;
  }

  // warpgroup 0 takes the first turn
  if (wg == 1 && (!kGeneral || n_run > 0)) turn_pass(wg);
  w.wait(0, 0, -1);
  for (int it = next(0), jj = 0; it < n_tiles; it = next(it + 1), ++jj) {
    const int j = kGeneral ? jj : it;                     // the tile's turn
    const int s = j % kStages;
    const uint32_t k_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t v_lo = desc_at(k_lo, L::kTile);
    const uint32_t qa = opaque(q_lo);
    w.wait(1 + s, (j / kStages) & 1, j);
    __syncwarp();

    // S = Q K^T over the D / 16 k16 slices of the head dim: 32 bytes a
    // slice inside a box's 128-byte rows, then the next box
    float sc[64];
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128<T>(sc,
                       desc_at(qa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                       desc_at(k_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                       kk > 0);
    wgmma_commit();
    if (wg == 0 || j + 1 < n_run) turn_pass(wg);      // passes match waits
    wgmma_wait<0>();
    fence_regs(sc);

    // the row max of the raw scores (the scale is positive), then P =
    // exp2(s scale_log2 - max scale_log2) in one FMA and one exp2; with
    // kExtra the scores first become s scale_log2 + bias log2e
    const int key0 = it * BK;
    // with segment ids, a tile of two segments compares the ids
    const bool mix =
        seg && mixed(q_ids, seg_range(ranges_of(ex.krange, b, Sk), key0, BK,
                                      Sk));
    const bool masked =
        mix || (it == n_tiles - 1 && (kCausal || Sk % BK != 0));
    float mx[2] = {-INFINITY, -INFINITY};
    if constexpr (kExtra) {
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + 8 * n + 2 * t + (e & 1);
          sc[4 * n + e] = bb ? fmaf(sc[4 * n + e], scale_log2,
                                    bias_log2(ex, bb, row[e >> 1], col, Sq,
                                              Sk))
                             : sc[4 * n + e] * scale_log2;
          if (masked && (col >= Sk || (kCausal && col > row[e >> 1]) ||
                         (mix && __ldg(ks + col) != qid[e >> 1])))
            sc[4 * n + e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked) {
            const int col = key0 + 8 * n + 2 * t + (e & 1);
            if (col >= Sk || (kCausal && col > row[e >> 1]))
              sc[4 * n + e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
        }
    }
    float mu[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new =
          fmaxf(m[i], kExtra ? quad_max(mx[i]) : quad_max(mx[i]) * scale_log2);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;       // row without keys yet
      corr[i] = exp2f(m[i] - mu[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            kExtra ? exp2f(sc[4 * n + e] - mu[e >> 1])
                   : exp2f(fmaf(sc[4 * n + e], scale_log2, -mu[e >> 1]));
        sc[4 * n + e] = p;
        rs[e >> 1] += p;
      }
    l[0] = l[0] * corr[0] + rs[0];      // per-lane partial sums; the four
    l[1] = l[1] * corr[1] + rs[1];      // lanes of a row are summed at the end
    if constexpr (kExtra) {             // O takes keep r P; l took P
      if (ex.dropout) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const uint32_t kb = philox::keep4<true>(ex.drop, bh, row[0],
                                                  key0 + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * n + e] = kb >> e & 1 ? sc[4 * n + e] * ex.drop.inv_keep
                                        : 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[c][4 * n] *= corr[0];
        acc[c][4 * n + 1] *= corr[0];
        acc[c][4 * n + 2] *= corr[1];
        acc[c][4 * n + 3] *= corr[1];
      }
    uint32_t pa[8][4];
    acc_to_a<T, 16>(pa, sc);

    // O += P V: V's rows are the k dim, read MN-major, one box a product
    wgmma_fence();
#pragma unroll
    for (int jv = 0; jv < 8; ++jv)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t<T>(acc[c], pa[jv],
                          desc_at(v_lo,
                                  c * BK * kRowBytes + 16 * jv * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ND; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    mbar_arrive(w.at(1 + kStages + s));
  }

  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    // a fully masked row (kExtra): O = 0, LSE = +1e30
    const bool dead = kExtra && m[i] <= kMaskedRowLog2;
    const float inv = lsum > 0.f && !dead ? 1.f / lsum : 0.f;
    if (row[i] < Sq) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(ob + row[i] * os + c * 64 + 8 * n +
                                       2 * t) =
              pack2<T>(acc[c][4 * n + 2 * i] * inv,
                       acc[c][4 * n + 2 * i + 1] * inv);
      if (t == 0)
        lse[static_cast<long long>(bh) * Sq + row[i]] =
            dead ? kMaskedLse
                 : lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : INFINITY;
    }
  }
}

// ---------------------------------------------------------------- dK/dV
// Two consumer warpgroups and no producer warpgroup: each consumer thread
// holds the dK and dV accumulators of 64 keys (128 fp32 registers at
// d=128) beside S^T and dP^T (64 more), which a 384-thread block's 168
// registers a thread cannot hold without spilling. Thread 0 issues the
// loads, kDkvStages - 1 tiles ahead.
constexpr int kDkvThreads = kConsumers;
constexpr int kDkvStages = 3;

template <int D>
struct DkvSmem {
  static constexpr int kKV = kDkvBk * D * 2;        // K or V, whole block
  static constexpr int kQT = kDkvBq * D * 2;        // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kStage0 = 2 * kKV;
  static constexpr int kStageBytes = 2 * kQT;       // Q then dO
  static constexpr int kBytes = kStage0 + kDkvStages * kStageBytes + 1024;
};

// barriers: 0 K and V full; 1 + s stage s full; 1 + kDkvStages + s empty
template <typename T, int D, bool kCausal, int kFeat>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk_arg, int H, float scale,
                 float scale_log2, WaitRecord* rec, const Extra ex) {
  using L = DkvSmem<D>;
  FLASH_FEATURES(kFeat);
  constexpr int BK = kDkvBk, BQ = kDkvBq, ND = D / kBoxCols;
  constexpr int ST = kDkvStages;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];
  const uint32_t base = aligned_base(smem);
  const Waiter w{smem_u32(bars), rec, 6};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warpgroup();
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;        // heaviest (earliest keys) first
  const int q_begin = kCausal ? k0 : 0;
  const int n_tiles = !kGeneral || q_begin < Sq
                          ? (Sq - q_begin + BQ - 1) / BQ
                          : 0;
  const bool issuer = threadIdx.x == 0;
  // with segment ids (level 2), the q tiles whose ids cannot meet the
  // block's keys' are skipped: next(it) is the first q tile from it on
  // that remains
  const bool seg = kGeneral && ex.qseg != nullptr;
  const int2 k_ids = seg ? seg_range(ranges_of(ex.krange, b, Sk), k0, BK, Sk)
                         : make_int2(0, 0);
  auto next = [&](int it) {
    if (seg)
      while (it < n_tiles &&
             apart(k_ids, seg_range(ranges_of(ex.qrange, b, Sq),
                                    q_begin + it * BQ, BQ, Sq)))
        ++it;
    return it;
  };

  // Q and dO rows of q tile it into the stage of load turn j (thread 0)
  auto load_step = [&](int j, int it) {
    const int s = j % ST;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
    mbar_expect_tx(w.at(1 + s), 2 * L::kQT);
    tma_tile<D>(st, &tq, w.at(1 + s), BQ, h, q_begin + it * BQ, b);
    tma_tile<D>(st + L::kQT, &tdo, w.at(1 + s), BQ, h, q_begin + it * BQ, b);
  };
  int ld_it = 0, ld_j = 0;  // kGeneral: thread 0's next q tile, its turn

  if (issuer) {
    mbar_init(w.at(0), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(w.at(1 + s), kFullCount);
      mbar_init(w.at(1 + ST + s), kDkvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(w.at(0), 2 * L::kKV);
    tma_tile<D>(base + L::kK, &tk, w.at(0), BK, h, k0, b);
    tma_tile<D>(base + L::kV, &tv, w.at(0), BK, h, k0, b);
    if constexpr (kGeneral) {
      for (ld_it = next(0); ld_j < ST - 1 && ld_it < n_tiles;
           ++ld_j, ld_it = next(ld_it + 1))
        load_step(ld_j, ld_it);
    } else {
      for (int i = 0; i < ST - 1 && i < n_tiles; ++i) load_step(i, i);
    }
  }
  __syncthreads();

  // warpgroup wg owns keys [kw, kw + 64)
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 64 * wg;
  const int key[2] = {kw + 16 * (warp % 4) + g, kw + 16 * (warp % 4) + g + 8};
  const float* lse_bh = lse + static_cast<long long>(bh) * Sq;
  const float* dlt_bh = delta + static_cast<long long>(bh) * Sq;
  float dka[ND][32], dva[ND][32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
  const uint32_t k_lo = desc_lo(base + L::kK + wg * 64 * kRowBytes);
  const uint32_t v_lo = desc_lo(base + L::kV + wg * 64 * kRowBytes);
  const float* bb = kExtra ? bias_of(ex, b, h) : nullptr;
  // this thread's keys' segment ids and the batch's q ids
  const int* qs = seg ? ex.qseg + static_cast<long long>(b) * Sq : nullptr;
  int kid[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kid[i] = key[i] < Sk
                   ? __ldg(ex.kseg + static_cast<long long>(b) * Sk + key[i])
                   : INT_MIN;
  }

  w.wait(0, 0, -1);
  for (int it = next(0), jj = 0; it < n_tiles; it = next(it + 1), ++jj) {
    const int j = kGeneral ? jj : it;                     // the tile's turn
    const int s = j % ST, q0 = q_begin + it * BQ;
    if constexpr (kGeneral) {
      // load turn j + ST - 1 goes where turn j - 1 was, once both
      // warpgroups are done with it: the other may lag this one a turn
      if (issuer && ld_it < n_tiles) {
        if (j > 0) w.wait(1 + ST + (j - 1) % ST, ((j - 1) / ST) & 1, j);
        load_step(ld_j, ld_it);
        ++ld_j;
        ld_it = next(ld_it + 1);
      }
    } else {
      if (issuer && it + ST - 1 < n_tiles) {
        // step it + ST - 1 goes where step it - 1 was, once both
        // warpgroups are done with it: the other may lag this one a step
        if (it > 0) w.wait(1 + ST + (it - 1) % ST, ((it - 1) / ST) & 1, it);
        load_step(it + ST - 1, it + ST - 1);
      }
    }
    const uint32_t q_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t do_lo = desc_at(q_lo, L::kQT);
    const uint32_t ka = opaque(k_lo), va = opaque(v_lo);
    w.wait(1 + s, (j / ST) & 1, j);
    __syncwarp();
    if (kCausal && q0 + BQ - 1 < kw) {     // every key above every row
      mbar_arrive(w.at(1 + ST + s));
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys on M, as two
    // groups: the softmax of S^T runs while dP^T is in the tensor cores
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(st,
                      desc_at(ka, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                      desc_at(q_lo, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                      kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(dpt,
                      desc_at(va, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                      desc_at(do_lo, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                      kk > 0);
    wgmma_commit();
    // this thread's q columns' LSE (log2 units) and delta, 0 past Sq,
    // loaded while the products run
    float lse2[16], dlt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = q0 + 8 * (i / 2) + 2 * t + i % 2;
      lse2[i] = r < Sq ? __ldg(lse_bh + r) * kLog2e : 0.f;
      dlt[i] = r < Sq ? __ldg(dlt_bh + r) : 0.f;
    }
    // with segment ids, for a tile of two segments, bit 4n + e: whether
    // the ids of element (n, e)'s query and key agree
    uint32_t same = ~0u;
    const bool mix =
        seg && mixed(seg_range(ranges_of(ex.qrange, b, Sq), q0, BQ, Sq),
                     k_ids);
    if constexpr (kGeneral) {
      if (mix) {
        same = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = q0 + 8 * (i / 2) + 2 * t + i % 2;
          const int id = r < Sq ? __ldg(qs + r) : INT_MIN;
          same |= static_cast<uint32_t>(id == kid[0])
                  << (4 * (i / 2) + i % 2);
          same |= static_cast<uint32_t>(id == kid[1])
                  << (4 * (i / 2) + 2 + i % 2);
        }
      }
    }
    wgmma_wait<1>();                      // S^T is in
    fence_regs(st);

    const bool masked = mix || (kCausal && q0 < kw + 64) || q0 + BQ > Sq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 2 * n + (e & 1);    // column 8n + 2t + (e & 1)
        float p;
        if constexpr (kExtra) {
          const int r = q0 + 8 * n + 2 * t + (e & 1);
          const float x = bb ? fmaf(st[4 * n + e], scale_log2,
                                    bias_log2(ex, bb, r, key[e >> 1], Sq,
                                              Sk))
                             : st[4 * n + e] * scale_log2;
          p = exp2f(x - lse2[i]);
        } else {
          p = exp2f(st[4 * n + e] * scale_log2 - lse2[i]);
        }
        if (masked) {
          const int r = q0 + 8 * n + 2 * t + (e & 1);
          p = r < Sq && (!kCausal || key[e >> 1] <= r) &&
                      (same >> (4 * n + e) & 1)
                  ? p
                  : 0.f;
        }
        st[4 * n + e] = p;                            // P^T
      }
    // the dropout's keep bits of this thread's 32 elements (bit 4n + e):
    // dV takes keep r P^T, dS the dropped dP^T
    uint32_t keep = ~0u;
    if constexpr (kExtra) {
      if (ex.dropout) {
        keep = 0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          keep |= philox::keep4<false>(ex.drop, bh, key[0],
                                       q0 + 8 * n + 2 * t) << (4 * n);
      }
    }
    uint32_t pa[4][4];
    if (kExtra && ex.dropout) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = 8 * jp + 2 * i;
          pa[jp][i] = pack2<T>(
              keep >> x & 1 ? st[x] * ex.drop.inv_keep : 0.f,
              keep >> (x + 1) & 1 ? st[x + 1] * ex.drop.inv_keep : 0.f);
        }
    } else {
      acc_to_a<T, 8>(pa, st);
    }

    // dV += P^T dO (dO read MN-major), beside dP^T
    wgmma_fence();
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t<T>(dva[c], pa[jp],
                          desc_at(do_lo,
                                  c * BQ * kRowBytes + 16 * jp * kRowBytes));
    wgmma_commit();
    wgmma_wait<1>();                      // dP^T is in; dV may still run
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta) scale, from the fp32 P^T (dP^T dropped
    // as P^T was for dV)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dpv = dpt[4 * n + e];
        if (kExtra && ex.dropout)
          dpv = keep >> (4 * n + e) & 1 ? dpv * ex.drop.inv_keep : 0.f;
        dpt[4 * n + e] = st[4 * n + e] * (dpv - dlt[2 * n + (e & 1)]) * scale;
      }
    uint32_t da[4][4];
    acc_to_a<T, 8>(da, dpt);

    // dK += dS^T Q (Q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t<T>(dka[c], da[jp],
                          desc_at(q_lo,
                                  c * BQ * kRowBytes + 16 * jp * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      fence_regs(dva[c]);
      fence_regs(dka[c]);
    }
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(w.at(1 + ST + s));
  }

  const long long base_o = (static_cast<long long>(b) * Sk * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (key[i] < Sk) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const long long at = base_o + key[i] * os + c * 64 + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(dk + at) =
              pack2<T>(dka[c][4 * n + 2 * i], dka[c][4 * n + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack2<T>(dva[c][4 * n + 2 * i], dva[c][4 * n + 2 * i + 1]);
        }
    }
}

// ------------------------------------------------------------------- dQ
// The forward's loop with the LSE known: Q and dO stay, K and V tiles of
// 64 keys stream, filled by the producer warpgroup. Each consumer thread
// holds dQ's accumulator of its two q rows (64 fp32 at d=128) beside S
// and dP of the key tile (32 each), which fits the 168 registers ptxas
// gives a 384-thread block (PERF.md §6 records the other forms measured).
constexpr int kDqBk = 64;       // keys per loop step
constexpr int kDqStages = 3;

template <int D>
struct DqSmem {
  static constexpr int kQT = kDqBq * D * 2;         // Q or dO, whole block
  static constexpr int kTile = kDqBk * D * 2;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDo = kQT;
  static constexpr int kStage0 = 2 * kQT;
  static constexpr int kStageBytes = 2 * kTile;     // K then V
  static constexpr int kBytes = kStage0 + kDqStages * kStageBytes + 1024;
};

// barriers: 0 Q and dO full; 1 + s stage s full; 1 + kDqStages + s empty
template <typename T, int D, bool kCausal, int kFeat>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk_arg, int H, float scale, float scale_log2,
                WaitRecord* rec, const Extra ex) {
  using L = DqSmem<D>;
  FLASH_FEATURES(kFeat);
  constexpr int BQ = kDqBq, BK = kDqBk, ND = D / kBoxCols;
  constexpr int ST = kDqStages;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * ST];
  const uint32_t base = aligned_base(smem);
  const Waiter w{smem_u32(bars), rec, 5};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warpgroup();
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int kv_end = kCausal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  // with segment ids (level 2), the key tiles whose ids cannot meet the
  // block's q rows' are skipped: next(it) is the first from it on that
  // remains
  const bool seg = kGeneral && ex.qseg != nullptr;
  const int2 q_ids = seg ? seg_range(ranges_of(ex.qrange, b, Sq), q0, BQ, Sq)
                         : make_int2(0, 0);
  auto next = [&](int it) {
    if (seg)
      while (it < n_tiles &&
             apart(q_ids, seg_range(ranges_of(ex.krange, b, Sk), it * BK, BK,
                                    Sk)))
        ++it;
    return it;
  };

  // K and V keys of key tile it into the stage of load turn j
  auto load_step = [&](int j, int it) {
    const int s = j % ST;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
    mbar_expect_tx(w.at(1 + s), 2 * L::kTile);
    tma_tile<D>(st, &tk, w.at(1 + s), BK, h, it * BK, b);
    tma_tile<D>(st + L::kTile, &tv, w.at(1 + s), BK, h, it * BK, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(w.at(0), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(w.at(1 + s), kFullCount);
      mbar_init(w.at(1 + ST + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(w.at(0), 2 * L::kQT);
    tma_tile<D>(base + L::kQ, &tq, w.at(0), BQ, h, q0, b);
    tma_tile<D>(base + L::kDo, &tdo, w.at(0), BQ, h, q0, b);
  }
  __syncthreads();

  if (wg == kConsumerWarps / 4) {                     // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0)
      for (int it = next(0), jj = 0; it < n_tiles; it = next(it + 1), ++jj) {
        const int j = kGeneral ? jj : it;                 // the load's turn
        if (j >= ST) w.wait(1 + ST + j % ST, ((j / ST) - 1) & 1, j);
        load_step(j, it);
      }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // a consumer: warpgroup wg owns q rows [qw, qw + 64)
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + 64 * wg;
  const int row[2] = {qw + 16 * (warp % 4) + g, qw + 16 * (warp % 4) + g + 8};
  // this thread's rows' LSE (log2 units) and delta, 0 past Sq
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * Sq + row[i];
    lse2[i] = row[i] < Sq ? __ldg(lse + at) * kLog2e : 0.f;
    dlt[i] = row[i] < Sq ? __ldg(delta + at) : 0.f;
  }
  float acc[ND][32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint32_t q_lo = desc_lo(base + L::kQ + wg * 64 * kRowBytes);
  const uint32_t do_lo = desc_lo(base + L::kDo + wg * 64 * kRowBytes);
  const float* bb = kExtra ? bias_of(ex, b, h) : nullptr;
  // this thread's rows' segment ids and the batch's key ids
  const int* ks = seg ? ex.kseg + static_cast<long long>(b) * Sk : nullptr;
  int qid[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qid[i] = row[i] < Sq
                   ? __ldg(ex.qseg + static_cast<long long>(b) * Sq + row[i])
                   : INT_MIN;
  }

  w.wait(0, 0, -1);
  for (int it = next(0), jj = 0; it < n_tiles; it = next(it + 1), ++jj) {
    const int j = kGeneral ? jj : it;                     // the tile's turn
    const int s = j % ST, key0 = it * BK;
    const uint32_t k_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t v_lo = desc_at(k_lo, L::kTile);
    const uint32_t qa = opaque(q_lo), doa = opaque(do_lo);
    w.wait(1 + s, (j / ST) & 1, j);
    __syncwarp();
    if (kCausal && key0 > qw + 63) {    // every key above every row
      mbar_arrive(w.at(1 + ST + s));
      continue;
    }

    // S = Q K^T and dP = dO V^T over the D / 16 k16 slices of the head
    // dim, as two groups: P is computed while dP is in the tensor cores
    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(sc,
                      desc_at(qa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                      desc_at(k_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                      kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(dp,
                      desc_at(doa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                      desc_at(v_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                      // S is in
    fence_regs(sc);

    // P = exp2(s scale_log2 - LSE log2e), 0 where the mask bites: keys
    // past Sk (TMA's zeros), keys of another segment and, when causal,
    // keys after the row
    const bool mix =
        seg && mixed(q_ids, seg_range(ranges_of(ex.krange, b, Sk), key0, BK,
                                      Sk));
    const bool masked =
        mix || (kCausal && key0 + BK - 1 > qw) || key0 + BK > Sk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if constexpr (kExtra) {
          const int col = key0 + 8 * n + 2 * t + (e & 1);
          p = exp2f((bb ? fmaf(sc[4 * n + e], scale_log2,
                               bias_log2(ex, bb, row[e >> 1], col, Sq, Sk))
                        : sc[4 * n + e] * scale_log2) -
                    lse2[e >> 1]);
          if (masked && (col >= Sk || (kCausal && col > row[e >> 1]) ||
                         (mix && __ldg(ks + col) != qid[e >> 1])))
            p = 0.f;
        } else {
          p = exp2f(fmaf(sc[4 * n + e], scale_log2, -lse2[e >> 1]));
          if (masked) {
            const int col = key0 + 8 * n + 2 * t + (e & 1);
            if (col >= Sk || (kCausal && col > row[e >> 1])) p = 0.f;
          }
        }
        sc[4 * n + e] = p;
      }
    wgmma_wait<0>();                      // dP is in
    fence_regs(dp);
    if constexpr (kExtra) {               // dP = keep r (dO V^T)
      if (ex.dropout) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const uint32_t kb = philox::keep4<true>(ex.drop, bh, row[0],
                                                  key0 + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * n + e] = kb >> e & 1 ? dp[4 * n + e] * ex.drop.inv_keep
                                        : 0.f;
        }
      }
    }

    // dS = P (dP - delta) scale, rounded into A fragments
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] =
            sc[4 * n + e] * (dp[4 * n + e] - dlt[e >> 1]) * scale;
    uint32_t da[BK / 16][4];
    acc_to_a<T, BK / 8>(da, dp);

    // dQ += dS K: K's rows are the k dim, read MN-major, one box a product
    wgmma_fence();
#pragma unroll
    for (int jd = 0; jd < BK / 16; ++jd)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t<T>(acc[c], da[jd],
                          desc_at(k_lo,
                                  c * BK * kRowBytes + 16 * jd * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ND; ++c) fence_regs(acc[c]);
    fence_regs(da);
    mbar_arrive(w.at(1 + ST + s));
  }

  T* out = dq + (static_cast<long long>(b) * Sq * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < Sq) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(out + row[i] * os + c * 64 + 8 * n +
                                       2 * t) =
              pack2<T>(acc[c][4 * n + 2 * i], acc[c][4 * n + 2 * i + 1]);
    }
}

// ------------------------------------------------------------- host side
// One operand's map arguments as ops/flash_attention.py:tensor_map_args
// packs them, 11 values: dims[4] (D, H, S, B), byte strides[3] (of H, S,
// B), box[4].
constexpr int kMapArgs = 11;

// Encodes the map of one [B, S, H, D] operand of element type T (128-byte
// swizzle) and checks that its box is the tile the kernel loads: 64
// columns of one head by `rows` rows of one batch.
template <typename T>
int encode(CUtensorMap* map, const long long* a, const void* ptr, int rows) {
  if (a[7] != kBoxCols || a[8] != 1 || a[9] != rows || a[10] != 1)
    return kErrMapArgs;
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], one[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(a[i]);
    box[i] = static_cast<cuuint32_t>(a[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(a[4 + i]);
  const CUresult r =
      fn(map,
         kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         4, const_cast<void*>(ptr), dims, strides, box, one,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename T, int D, bool C, int X>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int Sq, int Sk, int H, const long long* maps, float scale,
        const Extra& ex, cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = FwdSmem<D>::kBytes;
  auto kernel = flash_fwd_kernel<T, D, C, X>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  int rc;
  if ((rc = encode<T>(&tq, maps, q, kFwdBq)) ||
      (rc = encode<T>(&tk, maps + kMapArgs, k, kFwdBk)) ||
      (rc = encode<T>(&tv, maps + 2 * kMapArgs, v, kFwdBk)))
    return rc;
  const dim3 grid((Sq + kFwdBq - 1) / kFwdBq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H,
      scale * kLog2e, rec, ex);
  return cudaGetLastError();
}

template <typename T, int D, bool C, int X>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, int B,
        int Sq, int Sk, int H, const long long* maps, float scale,
        const Extra& ex, cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = DkvSmem<D>::kBytes;
  auto kernel = flash_dkv_kernel<T, D, C, X>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = encode<T>(&tq, maps, q, kDkvBq)) ||
      (rc = encode<T>(&tk, maps + kMapArgs, k, kDkvBk)) ||
      (rc = encode<T>(&tv, maps + 2 * kMapArgs, v, kDkvBk)) ||
      (rc = encode<T>(&tdo, maps + 3 * kMapArgs, dout, kDkvBq)))
    return rc;
  const dim3 grid((Sk + kDkvBk - 1) / kDkvBk, B * H);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dkp),
      static_cast<T*>(dvp), Sq, Sk, H, scale, scale * kLog2e, rec, ex);
  return cudaGetLastError();
}

template <typename T, int D, bool C, int X>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int Sq, int Sk,
       int H, const long long* maps, float scale, const Extra& ex,
       cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = DqSmem<D>::kBytes;
  auto kernel = flash_dq_kernel<T, D, C, X>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = encode<T>(&tq, maps, q, kDqBq)) ||
      (rc = encode<T>(&tk, maps + kMapArgs, k, kDqBk)) ||
      (rc = encode<T>(&tv, maps + 2 * kMapArgs, v, kDqBk)) ||
      (rc = encode<T>(&tdo, maps + 3 * kMapArgs, dout, kDqBq)))
    return rc;
  const dim3 grid((Sq + kDqBq - 1) / kDqBq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqp), Sq, Sk, H,
      scale, scale * kLog2e, rec, ex);
  return cudaGetLastError();
}

// Calls FN<T, D, causal, level>(args...) for the runtime D and causal.
#define FLASH_DISPATCH_X(FN, T, X, ...)                                  \
  do {                                                                  \
    if (head_dim == 64 && causal)                                       \
      return FN<T, 64, true, X>(__VA_ARGS__);                           \
    if (head_dim == 64 && !causal)                                      \
      return FN<T, 64, false, X>(__VA_ARGS__);                          \
    if (head_dim == 128 && causal)                                      \
      return FN<T, 128, true, X>(__VA_ARGS__);                          \
    if (head_dim == 128 && !causal)                                     \
      return FN<T, 128, false, X>(__VA_ARGS__);                         \
    return kErrHeadDim;                                                 \
  } while (0)
// ... and for the element type and the feature level: 2 with segment ids
// or q and key lengths apart, else 1 with a bias or dropout, else 0.
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    const Extra ex = extra(bias, bias_strides, dropout, thr, key,       \
                           inv_keep, qseg, kseg, qrange, krange);       \
    const int level = ex.qseg || Sq != Sk ? 2 : ex.bias || ex.dropout;  \
    if (half) {                                                         \
      if (level == 2) FLASH_DISPATCH_X(FN, __half, 2, __VA_ARGS__, ex, s); \
      if (level == 1) FLASH_DISPATCH_X(FN, __half, 1, __VA_ARGS__, ex, s); \
      FLASH_DISPATCH_X(FN, __half, 0, __VA_ARGS__, ex, s);              \
    }                                                                   \
    if (level == 2)                                                     \
      FLASH_DISPATCH_X(FN, __nv_bfloat16, 2, __VA_ARGS__, ex, s);       \
    if (level == 1)                                                     \
      FLASH_DISPATCH_X(FN, __nv_bfloat16, 1, __VA_ARGS__, ex, s);       \
    FLASH_DISPATCH_X(FN, __nv_bfloat16, 0, __VA_ARGS__, ex, s);         \
  } while (0)

// The kExtra features of a call: bias (nullptr: none) with its element
// strides of b, h, query and key; dropout with its threshold, 64-bit key
// and 1 / (1 - p); segment ids (nullptr: none) and their ranges.
Extra extra(const void* bias, const long long* strides, int dropout,
            unsigned thr, unsigned long long key, float inv_keep,
            const void* qseg, const void* kseg, const void* qrange,
            const void* krange) {
  Extra ex{};
  ex.bias = static_cast<const float*>(bias);
  if (bias) {
    ex.sb = strides[0];
    ex.sh = strides[1];
    ex.si = strides[2];
    ex.sj = strides[3];
  }
  ex.dropout = dropout;
  ex.drop = philox::Dropout{static_cast<uint32_t>(key),
                            static_cast<uint32_t>(key >> 32), thr, inv_keep};
  if (qseg && kseg && qrange && krange) {
    ex.qseg = static_cast<const int*>(qseg);
    ex.kseg = static_cast<const int*>(kseg);
    ex.qrange = static_cast<const int2*>(qrange);
    ex.krange = static_cast<const int2*>(krange);
  }
  return ex;
}

}  // namespace

// Operands are bfloat16 (half = 0) or float16 (half = 1): q and dout
// [B, Sq, H, D], k and v [B, Sk, H, D]; lse and delta fp32 [B*H, Sq],
// contiguous. maps: kMapArgs values per operand in argument order (q, k,
// v, and for dQ and dK/dV dout), from ops/flash_attention.py:
// tensor_map_args. bias: nullptr or fp32, read at bias_strides' element
// strides of (b, h, query, key); dropout (0 or 1) with thr = floor(p
// 2^32), the 64-bit Philox key and inv_keep = 1 / (1 - p)
// (ops/philox.py); qseg and kseg: nullptr or int32 [B, Sq] and [B, Sk]
// segment ids, qrange and krange their (least, greatest) id per 64 rows,
// int32 [B, ceil(S / 64), 2] (ops/flash_attention.py:segment_ranges).
// Each returns 0, a cudaError_t code, or one of the negative codes above.
#define FLASH_EXTRA_ARGS                                                \
  const void *bias, const long long *bias_strides, int dropout,         \
      unsigned thr, unsigned long long key, float inv_keep,             \
      const void *qseg, const void *kseg, const void *qrange,           \
      const void *krange

extern "C" int flash_sm90_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int Sq, int Sk, int H,
                                     int head_dim, int causal, int half,
                                     const long long* maps, float scale,
                                     FLASH_EXTRA_ARGS, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, B, Sq, Sk, H, maps, scale);
}

extern "C" int flash_sm90_dkv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dkp, void* dvp, int B, int Sq,
                                     int Sk, int H, int head_dim, int causal,
                                     int half, const long long* maps,
                                     float scale, FLASH_EXTRA_ARGS,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dkp, dvp, B, Sq, Sk, H,
                 maps, scale);
}

extern "C" int flash_sm90_dq_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dqp, int B, int Sq, int Sk, int H,
                                    int head_dim, int causal, int half,
                                    const long long* maps, float scale,
                                    FLASH_EXTRA_ARGS, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dqp, B, Sq, Sk, H, maps,
                 scale);
}

// The timeout record's 8 ints (code, row, block x, block y, warp, barrier,
// parity, step) into out; all zero when no wait has timed out (or no
// kernel has launched). Reads host memory only, so it works after the
// trap has poisoned the CUDA context.
extern "C" void flash_sm90_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* flash_sm90_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "unsupported head_dim";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found through "
             "cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrMapArgs:
      return "tensor map arguments do not match the kernel's tiles";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
