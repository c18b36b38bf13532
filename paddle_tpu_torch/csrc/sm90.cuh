// Hopper (sm_90a) building blocks shared by the kernels written for it:
// flash_sm90.cu (rows 4-6), quant_gemm.cu (row 3), gemm_rs.cu (row 8),
// ag_gemm.cu (rows 7 and 9), pp_gemm.cu (rows 14-15) and paged_decode.cu
// (rows 1-2; its mbarriers and bounded waits).
//
// * mbarriers (init, arrive, arrive with a TMA transaction count, parity
//   waits), every wait bounded by %globaltimer: a wait that outlasts
//   kWaitTimeoutNs writes the kernel's row, block, warp, barrier, parity
//   and loop step into a host-mapped WaitRecord and traps, so a phase
//   slip fails the run instead of hanging it;
// * TMA tile loads (cp.async.bulk.tensor, 2-D to 4-D) that complete on
//   an mbarrier;
// * wgmma matrix descriptors of tiles laid out by TMA's 128-byte swizzle,
//   and the warpgroup fence / commit / wait around wgmma.mma_async;
// * setmaxnreg, register fences, bf16 packing;
// * tile256: the 128 x 256 GEMM tile of rows 7-9 and 14-15 (its ring,
//   producer loop, consumer loop and fp32 staging);
// * host side: cuTensorMapEncodeTiled through the runtime's driver entry
//   point (and the 2-D swizzled map of a row-major operand), the
//   host-mapped WaitRecord, the opt-in to more than 48 KB of dynamic
//   shared memory.
//
// Everything lives in an anonymous namespace: each library that includes
// this header has its own copy, its own g_claim and its own record.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A test build may shorten the wait bound (flash_sm90.cu's
// FLASH_SM90_STUCK) by defining this before the include.
#ifndef SM90_WAIT_TIMEOUT_NS
#define SM90_WAIT_TIMEOUT_NS 10000000000ull   // 10 s
#endif

namespace {

constexpr unsigned long long kWaitTimeoutNs = SM90_WAIT_TIMEOUT_NS;

// ------------------------------------------------------- timeout record
// Written by the first wait of the process's kernels that times out (the
// one that takes g_claim), read by the host without a CUDA call. The
// failure path is inlined: a call in a kernel makes ptxas serialize its
// wgmma instructions.
struct WaitRecord {
  int code;       // 0: none; 1: an mbarrier wait timed out
  int row;        // the kernel's PERF.md row (1 paged decode, 3 quant
                  // GEMM, 4-6 flash, 7-9 the ring GEMMs, 14-15 the
                  // pipeline-boundary GEMMs)
  int block_x;
  int block_y;
  int warp;       // the waiting warp (a producer's or a consumer's)
  int barrier;    // index into the block's barrier array
  int parity;     // the phase parity waited for
  int step;       // the loop step (-1 before the loop)
};

__device__ int g_claim = 0;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void wait_failed(WaitRecord* rec, int row,
                                         int barrier, int parity,
                                         int step) {
  if (atomicCAS(&g_claim, 0, 1) == 0) {
    volatile WaitRecord* r = rec;
    r->row = row;
    r->block_x = blockIdx.x;
    r->block_y = blockIdx.y;
    r->warp = threadIdx.x / 32;
    r->barrier = barrier;
    r->parity = parity;
    r->step = step;
    __threadfence_system();
    r->code = 1;
    __threadfence_system();
  } else {
    // another wait holds the record: let it finish writing before a trap
    // ends the grid (and with it the writes in flight)
    const volatile int* code = &rec->code;
    const unsigned long long t0 = global_ns();
    while (*code == 0 && global_ns() - t0 < kWaitTimeoutNs) {
    }
  }
  __trap();
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed; traps
// with a record after kWaitTimeoutNs. A consumer warp reconverges after it
// (__syncwarp) before its next wgmma.
struct Waiter {
  uint32_t bars;      // shared address of the block's barrier array
  WaitRecord* rec;
  int row;

  __device__ __forceinline__ uint32_t at(int i) const { return bars + 8 * i; }

  __device__ __forceinline__ void wait(int i, int parity, int step) const {
    if (!mbar_try_wait(at(i), parity)) {
      const unsigned long long t0 = global_ns();
      while (!mbar_try_wait(at(i), parity))
        if (global_ns() - t0 > kWaitTimeoutNs)
          wait_failed(rec, row, i, parity, step);
    }
  }
};

// ----------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// --------------------------------------------------------------- wgmma
// Matrix descriptor of a tile in shared memory laid out as TMA's 128-byte
// swizzle writes it: rows of 128 bytes, 8-row groups 1024 bytes apart. The
// leading and stride byte offsets are both 1024: every product below spans
// one swizzle row in its contiguous direction (a k16 slice of a K-major
// operand, or one 64-column box of an MN-major one), so only the 8-row
// group stride is ever applied. The products take the descriptor's low
// word (start address / 16 and the leading offset) and build the 64-bit
// descriptor inside their asm with the constant high word (the stride
// offset and the swizzle mode): a tile's descriptors are then one 32-bit
// base plus immediates, not 64-bit values the compiler keeps in registers
// across the loop.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((1024u >> 4) << 16);
}
constexpr uint32_t kDescHi = (1024u >> 4) | (1u << 30);  // SBO; 128B swizzle

// The low word of the descriptor `bytes` past the one of lo (bytes a
// multiple of 16; the start address field does not carry over).
__device__ __forceinline__ uint32_t desc_at(uint32_t lo, uint32_t bytes) {
  return lo + (bytes >> 4);
}

// lo, made opaque: the compiler rebuilds what derives from it in each loop
// step instead of hoisting a register per product out of the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t lo) {
  asm volatile("" : "+r"(lo));
  return lo;
}

// This thread's warpgroup, broadcast from lane 0 so that the compiler
// knows it is the same across the warp (the wgmma branches are
// warpgroup-uniform).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous window of the products (issue to wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_F8(d, i)                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),   \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),             \
      "+f"(d[(i) + 7])
#define WG_F32(d) WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
#define WG_F64(d) \
  WG_F32(d), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48), WG_F8(d, 56)
#define WG_F64_AT(d, i)                                                  \
  WG_F8(d, (i)), WG_F8(d, (i) + 8), WG_F8(d, (i) + 16), WG_F8(d, (i) + 24), \
      WG_F8(d, (i) + 32), WG_F8(d, (i) + 40), WG_F8(d, (i) + 48),          \
      WG_F8(d, (i) + 56)
#define WG_F128(d) WG_F64_AT(d, 0), WG_F64_AT(d, 64)

// d[64 x 256] += A[64 x 16] B[16 x 256], both in shared memory (the GEMMs
// of rows 7-9, gemm_rs.cu and ag_gemm.cu): each K-major (0) or MN-major
// (1, the descriptor's transpose bit); a and b are descriptors' low words.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint32_t a,
                                              uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%128, %130};\nmov.b64 db, {%129, %130};\n"
      "setp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, da, db, p, 1, 1, %132, %133;\n}\n"
      : WG_F128(d)
      : "r"(a), "r"(b), "r"(kDescHi), "r"(1), "n"(TA), "n"(TB));
}

// The descriptor's low word of an MN-major tile of 64-column boxes
// box_bytes apart (the leading byte offset; the stride byte offset, 1024,
// is the high word's). A k16 slice starts 16 rows (2048 bytes) further.
__device__ __forceinline__ uint32_t desc_lo_mn(uint32_t addr,
                                               uint32_t box_bytes) {
  return ((addr & 0x3FFFF) >> 4) | ((box_bytes >> 4) << 16);
}

// Accumulator layout of m64nNk16 (fp32), thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, q = t % 4: d[4j + e] holds row 16w + g +
// 8 (e / 2), column 8j + 2q + (e % 2). The A-from-registers fragment of
// k16 slice j is {pack(d[8j], d[8j+1]), pack(d[8j+2], d[8j+3]),
// pack(d[8j+4], d[8j+5]), pack(d[8j+6], d[8j+7])} of a 16-column slice.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The block's shared memory from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 1024 bytes and both TMA and the descriptors
// assume that tiles start on that period.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// ------------------------------------------- the 128 x 256 GEMM tile
// The core of rows 7-9 (ag_gemm.cu, gemm_rs.cu) and 14-15 (pp_gemm.cu):
// a 128 x 256 output tile a block, k steps of 64 through a kStages-deep
// full/empty mbarrier ring of TMA-loaded stages, one producer thread, two
// consumer warpgroups of 64 rows running wgmma m64n256k16 from shared
// memory into fp32 accumulators. Operand layouts, by mode:
//   A [M, k] K-major (NN, NT): one box of 64 k columns by 128 rows;
//   A read MN-major (TN) from [k rows, M columns]: two 64-column boxes;
//   B [N, k] K-major (NT): one box of 64 k columns by 256 rows;
//   B read MN-major (NN, TN) from [k rows, N columns]: four 64-column
//   boxes, the descriptor's leading byte offset one box apart (no
//   transposed copy).
// The producer waits for a stage to drain, arms its full barrier with the
// stage's bytes and issues its loads; a consumer warpgroup waits for the
// stage, issues its four k16 products, and releases the stage before it
// once those are done (one product group in flight). The epilogue then
// stages the fp32 tile in the drained ring, rows padded by 16 bytes, so
// that each warp stores whole rows.
namespace tile256 {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kBM = 128;                      // output rows a block
constexpr int kBN = 256;                      // output columns a block
constexpr int kBK = 64;                       // k a stage
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2;        // A's stage
constexpr int kBoxBytes = kBK * 64 * 2;       // one 64-column box, 64 k rows
constexpr int kBBytes = kBK * kBN * 2;        // B's stage
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment
constexpr int kTileRow = kBN + 4;             // the staged fp32 tile's row
static_assert(kBM * kTileRow * 4 <= kStages * kStageBytes, "tile staging");
constexpr int kNN = 0;
constexpr int kNT = 1;
constexpr int kTN = 2;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Thread 0, before the block's __syncthreads: stage st's full barrier is
// wt.at(st) (the producer's arrival + the TMA bytes), its empty barrier
// wt.at(kStages + st) (one arrival a consumer warp).
__device__ __forceinline__ void init_ring(const Waiter& wt) {
  for (int st = 0; st < kStages; ++st) {
    mbar_init(wt.at(st), 1);
    mbar_init(wt.at(kStages + st), kConsumers / 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A's stage at dst: the tile's rows from m, k its k step's start (both
// in the map's own coordinates: a K-major map's (k, m), an MN-major one's
// (m + 64 h, k)).
template <int MODE>
__device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int m, int k) {
  if constexpr (MODE == kTN) {
#pragma unroll
    for (int h = 0; h < kBM / 64; ++h)
      tma_load_2d(dst + h * kBoxBytes, map, bar, m + 64 * h, k);
  } else {
    tma_load_2d(dst, map, bar, k, m);
  }
}

// B's stage at dst + kABytes: the tile's columns from n, as load_a.
template <int MODE>
__device__ __forceinline__ void load_b(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int n, int k) {
  if constexpr (MODE == kNT) {
    tma_load_2d(dst + kABytes, map, bar, k, n);
  } else {
#pragma unroll
    for (int b = 0; b < kBN / 64; ++b)
      tma_load_2d(dst + kABytes + b * kBoxBytes, map, bar, n + 64 * b, k);
  }
}

// The producer's thread: load(dst, bar, k) issues the TMA loads of the
// stage at dst (load_a, load_b) for the k step starting at k.
template <class Load>
__device__ __forceinline__ void produce(const Waiter& wt, uint32_t base,
                                        int k_steps, const Load& load) {
  for (int it = 0; it < k_steps; ++it) {
    const int st = it % kStages;
    if (it >= kStages) wt.wait(kStages + st, ((it / kStages) - 1) & 1, it);
    mbar_expect_tx(wt.at(st), kStageBytes);
    load(base + st * kStageBytes, wt.at(st), it * kBK);
  }
}

// A consumer warpgroup wg: its 64 rows' products over every k step into
// acc (zeroed here), all complete on return.
template <int MODE>
__device__ __forceinline__ void consume(float (&acc)[128], const Waiter& wt,
                                        uint32_t base, int k_steps, int wg,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int it = 0; it < k_steps; ++it) {
    const int st = it % kStages;
    wt.wait(st, (it / kStages) & 1, it);
    __syncwarp();
    const uint32_t tile = base + st * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t b_mn = desc_lo_mn(tile + kABytes + 16 * j * 128,
                                       kBoxBytes);
      if constexpr (MODE == kTN)
        wgmma_ss_n256<1, 1>(
            acc, desc_lo_mn(tile + wg * kBoxBytes + 16 * j * 128, kBoxBytes),
            b_mn);
      else if constexpr (MODE == kNN)
        wgmma_ss_n256<0, 1>(
            acc, desc_at(desc_lo(tile + wg * 64 * 128), 32 * j), b_mn);
      else
        wgmma_ss_n256<0, 0>(
            acc, desc_at(desc_lo(tile + wg * 64 * 128), 32 * j),
            desc_at(desc_lo(tile + kABytes), 32 * j));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    __syncwarp();
    if (it > 0 && lane == 0) mbar_arrive(wt.at(kStages + (it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// The accumulators into the fp32 tile [kBM][kTileRow] at `tile` (the
// drained ring; both warpgroups' products done: consumers_sync before
// and after). Accumulator d[4j + e] holds row 16w + g + 8 (e / 2),
// column 8j + 2q + e % 2; lanes q and q ^ 1 trade halves so that each
// stores four adjacent columns of one row.
__device__ __forceinline__ void stage_tile(const float (&acc)[128],
                                           float* tile, int wg, int warp,
                                           int lane) {
  const int w = warp % 4, g = lane / 4, q = lane % 4;
  const bool odd = q & 1;
  const int row = wg * 64 + 16 * w + g + (odd ? 8 : 0);
  const int col = 2 * (q & ~1);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v = odd ? make_float4(r0, r1, acc[4 * j + 2],
                                       acc[4 * j + 3])
                         : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
    *reinterpret_cast<float4*>(tile + row * kTileRow + 8 * j + col) = v;
  }
}

}  // namespace tile256

// ------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// Codes of a failed tensor-map encode (the launch functions' negative
// codes besides cudaError_t's).
constexpr int kErrEntryPoint = -2;
constexpr int kErrEncode = -3;

// A 2-D map of a row-major [rows, cols] operand of `elem` bytes (rows
// `cols` elements apart), 128-byte swizzle, its box `box_cols` by
// `box_rows`, zero fill past the edges; 0 or an encode code above.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
              const void* ptr, long long rows, long long cols, int box_cols,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEntryPoint;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, one,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// the host-mapped timeout record, allocated at the first launch
WaitRecord* g_host_record = nullptr;
WaitRecord* g_dev_record = nullptr;

cudaError_t record(WaitRecord** dev) {
  if (!g_dev_record) {
    void* h = nullptr;
    cudaError_t err = cudaHostAlloc(
        &h, sizeof(WaitRecord), cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return err;
    *static_cast<WaitRecord*>(h) = WaitRecord{};
    void* d = nullptr;
    err = cudaHostGetDevicePointer(&d, h, 0);
    if (err != cudaSuccess) return err;
    g_host_record = static_cast<WaitRecord*>(h);
    g_dev_record = static_cast<WaitRecord*>(d);
  }
  *dev = g_dev_record;
  return cudaSuccess;
}

// Shared memory above 48 KB must be opted into once per kernel instance
// (and device: ready is per instance, and the attribute is set again on a
// device it has not seen).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned* ready_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*ready_mask & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *ready_mask |= bit;
  return err;
}

}  // namespace
