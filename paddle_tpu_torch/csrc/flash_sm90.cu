// Flash attention's forward, dQ and dK/dV kernels for Hopper (sm_90a):
// wgmma products fed by TMA loads through an mbarrier ring.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas_kernels/:
//   flash_attention.py:_fwd_kernel  (pallas_call at :280) -> flash_fwd_kernel
//   flash_attention_bwd.py:_dq_kernel  (pallas_call at :286) -> flash_dq_kernel
//   flash_attention_bwd.py:_dkv_kernel (pallas_call at :300) -> flash_dkv_kernel
// in their causal and non-causal forms (no bias, segment ids or dropout).
// For each batch b and head h, with s = q.k * scale:
//
//   forward  O = softmax(s) V, LSE = logsumexp(s) (natural log, masked keys
//            excluded)
//   dQ       P = exp(s - LSE), dP = dO V^T, dS = P (dP - delta) scale,
//            dQ = dS K
//   dK, dV   P and dS as for dQ, dV = P^T dO, dK = dS^T Q
//            (delta = rowsum(dO o O), computed beside the kernels in
//            PyTorch)
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
//   tile (the diagonal when causal, the one holding key S-1 otherwise); in
//   dQ the key tiles on the warpgroup's diagonal and the one holding key
//   S-1; in dK/dV the diagonal q tile and the one holding q row S-1. What
//   TMA reads past S comes as zeros: such keys are masked to -inf in the
//   forward and to P = 0 in dQ, such q rows to P = 0 in dK/dV, the sums
//   over them; the output rows past S (forward and dQ q rows, dK/dV keys)
//   are computed and not written. A dQ or dK/dV warpgroup whose rows all
//   lie before a causal tile's keys skips it.
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
// in a CUDA graph replays with its own maps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + the producer's
constexpr int kConsumers = kConsumerWarps * 32;
// The forward's register split: the producer warpgroup keeps 40 a thread
// and the consumers ask for 232 (2 x 128 x 232 + 128 x 40 = 64512).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 2;
constexpr int kBoxCols = 64;      // bf16 columns of a TMA box (128 bytes)
constexpr int kRowBytes = 128;    // bytes of one box row in shared memory
constexpr int kFwdBq = 128;       // q rows per forward block
constexpr int kFwdBk = 128;       // keys per forward loop step
constexpr int kDkvBk = 128;       // keys per dK/dV block
constexpr int kDkvBq = 64;        // q rows per dK/dV loop step
constexpr int kDqBq = 128;        // q rows per dQ block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Arrivals that complete a stage's full barrier: the loads' one. A test
// build (-DFLASH_SM90_STUCK) expects one more, which never comes, so every
// kernel's first wait on a stage times out after 1 s and leaves its record
// (the forced-timeout card test; the shipped library is never built so).
#ifdef FLASH_SM90_STUCK
constexpr uint32_t kFullCount = 2;
constexpr unsigned long long kWaitTimeoutNs = 1000000000ull;   // 1 s
#else
constexpr uint32_t kFullCount = 1;
constexpr unsigned long long kWaitTimeoutNs = 10000000000ull;  // 10 s
#endif

// Error codes of the launch functions besides cudaError_t's.
constexpr int kErrHeadDim = -1;
constexpr int kErrEntryPoint = -2;
constexpr int kErrEncode = -3;
constexpr int kErrMapArgs = -4;

// ------------------------------------------------------- timeout record
// Written by the first wait of the process's kernels that times out (the
// one that takes g_claim), read by the host without a CUDA call. The
// failure path is inlined: a call in a kernel makes ptxas serialize its
// wgmma instructions.
struct WaitRecord {
  int code;       // 0: none; 1: an mbarrier wait timed out
  int row;        // the kernel's PERF.md row: 4 forward, 5 dQ, 6 dK/dV
  int block_x;
  int block_y;
  int warp;       // 8: the forward's or dQ's producer
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

// Accumulator layout of m64nNk16 (fp32), thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, q = t % 4: d[4j + e] holds row 16w + g +
// 8 (e / 2), column 8j + 2q + (e % 2). The A-from-registers fragment of
// k16 slice j is {pack(d[8j], d[8j+1]), pack(d[8j+2], d[8j+3]),
// pack(d[8j+4], d[8j+5]), pack(d[8j+6], d[8j+7])} of a 16-column slice.

// d[64x128] (+)= A[64x16] B[16x128]; A and B K-major in shared memory,
// given by their descriptors' low words
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint32_t a,
                                              uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : WG_F64(d)
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] B[16x64]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a,
                                             uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(d)
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate));
}

// d[64x64] += A[64x16] B[16x64]; A from registers, B MN-major in shared
// memory (read transposed through the descriptor)
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "mov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : WG_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of the k16 slices of a 64 x (8 * NB) accumulator, rounded
template <int NB>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NB / 2][4],
                                         const float (&d)[4 * NB]) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack_bf16(d[8 * j + 2 * i], d[8 * j + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The block's shared memory from a 1024-byte aligned base: the 128-byte
// swizzle repeats every 1024 bytes and both TMA and the descriptors
// assume that tiles start on that period.
__device__ __forceinline__ uint32_t aligned_base(const uint8_t* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
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
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, int H, float scale_log2, WaitRecord* rec) {
  using L = FwdSmem<D>;
  constexpr int BQ = kFwdBq, BK = kFwdBk, ND = D / kBoxCols;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t base = aligned_base(smem);
  const Waiter w{smem_u32(bars), rec, 4};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warpgroup();
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int n_tiles = kCausal ? q0 / BK + 1 : (S + BK - 1) / BK;

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
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          w.wait(1 + kStages + s, ((it / kStages) - 1) & 1, it);
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

  if (wg == 1) turn_pass(wg);            // warpgroup 0 takes the first turn
  w.wait(0, 0, -1);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t k_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t v_lo = desc_at(k_lo, L::kTile);
    const uint32_t qa = opaque(q_lo);
    w.wait(1 + s, (it / kStages) & 1, it);
    __syncwarp();

    // S = Q K^T over the D / 16 k16 slices of the head dim: 32 bytes a
    // slice inside a box's 128-byte rows, then the next box
    float sc[64];
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc, desc_at(qa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                    desc_at(k_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                    kk > 0);
    wgmma_commit();
    if (wg == 0 || it + 1 < n_tiles) turn_pass(wg);   // passes match waits
    wgmma_wait<0>();
    fence_regs(sc);

    // the row max of the raw scores (the scale is positive), then P =
    // exp2(s scale_log2 - max scale_log2) in one FMA and one exp2
    const int key0 = it * BK;
    const bool masked = it == n_tiles - 1 && (kCausal || S % BK != 0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int col = key0 + 8 * n + 2 * t + (e & 1);
          if (col >= S || (kCausal && col > row[e >> 1]))
            sc[4 * n + e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
      }
    float mu[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;       // row without keys yet
      corr[i] = exp2f(m[i] - mu[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * n + e], scale_log2, -mu[e >> 1]));
        sc[4 * n + e] = p;
        rs[e >> 1] += p;
      }
    l[0] = l[0] * corr[0] + rs[0];      // per-lane partial sums; the four
    l[1] = l[1] * corr[1] + rs[1];      // lanes of a row are summed at the end
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
    acc_to_a<16>(pa, sc);

    // O += P V: V's rows are the k dim, read MN-major, one box a product
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t(acc[c], pa[j],
                       desc_at(v_lo, c * BK * kRowBytes + 16 * j * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ND; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    mbar_arrive(w.at(1 + kStages + s));
  }

  __nv_bfloat16* ob = o + (static_cast<long long>(b) * S * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
    if (row[i] < S) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(ob + row[i] * os + c * 64 + 8 * n +
                                       2 * t) =
              pack_bf16(acc[c][4 * n + 2 * i] * inv,
                        acc[c][4 * n + 2 * i + 1] * inv);
      if (t == 0)
        lse[static_cast<long long>(bh) * S + row[i]] =
            lsum > 0.f ? (m[i] + log2f(lsum)) * kLn2 : INFINITY;
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
template <int D, bool kCausal>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int S, int H, float scale,
                 float scale_log2, WaitRecord* rec) {
  using L = DkvSmem<D>;
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
  const int n_tiles = (S - q_begin + BQ - 1) / BQ;
  const bool issuer = threadIdx.x == 0;

  // Q and dO rows of loop step i into its stage (thread 0)
  auto load_step = [&](int i) {
    const int s = i % ST;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
    mbar_expect_tx(w.at(1 + s), 2 * L::kQT);
    tma_tile<D>(st, &tq, w.at(1 + s), BQ, h, q_begin + i * BQ, b);
    tma_tile<D>(st + L::kQT, &tdo, w.at(1 + s), BQ, h, q_begin + i * BQ, b);
  };

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
    for (int i = 0; i < ST - 1 && i < n_tiles; ++i) load_step(i);
  }
  __syncthreads();

  // warpgroup wg owns keys [kw, kw + 64)
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 64 * wg;
  const int key[2] = {kw + 16 * (warp % 4) + g, kw + 16 * (warp % 4) + g + 8};
  const float* lse_bh = lse + static_cast<long long>(bh) * S;
  const float* dlt_bh = delta + static_cast<long long>(bh) * S;
  float dka[ND][32], dva[ND][32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
  const uint32_t k_lo = desc_lo(base + L::kK + wg * 64 * kRowBytes);
  const uint32_t v_lo = desc_lo(base + L::kV + wg * 64 * kRowBytes);

  w.wait(0, 0, -1);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, q0 = q_begin + it * BQ;
    if (issuer && it + ST - 1 < n_tiles) {
      // step it + ST - 1 goes where step it - 1 was, once both
      // warpgroups are done with it: the other may lag this one a step
      if (it > 0) w.wait(1 + ST + (it - 1) % ST, ((it - 1) / ST) & 1, it);
      load_step(it + ST - 1);
    }
    const uint32_t q_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t do_lo = desc_at(q_lo, L::kQT);
    const uint32_t ka = opaque(k_lo), va = opaque(v_lo);
    w.wait(1 + s, (it / ST) & 1, it);
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
      wgmma_ss_n64(st, desc_at(ka, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                   desc_at(q_lo, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_at(va, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                   desc_at(do_lo, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                   kk > 0);
    wgmma_commit();
    // this thread's q columns' LSE (log2 units) and delta, 0 past S,
    // loaded while the products run
    float lse2[16], dlt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = q0 + 8 * (i / 2) + 2 * t + i % 2;
      lse2[i] = r < S ? __ldg(lse_bh + r) * kLog2e : 0.f;
      dlt[i] = r < S ? __ldg(dlt_bh + r) : 0.f;
    }
    wgmma_wait<1>();                      // S^T is in
    fence_regs(st);

    const bool masked = (kCausal && q0 < kw + 64) || q0 + BQ > S;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 2 * n + (e & 1);    // column 8n + 2t + (e & 1)
        float p = exp2f(st[4 * n + e] * scale_log2 - lse2[i]);
        if (masked) {
          const int r = q0 + 8 * n + 2 * t + (e & 1);
          p = r < S && (!kCausal || key[e >> 1] <= r) ? p : 0.f;
        }
        st[4 * n + e] = p;                            // P^T
      }
    uint32_t pa[4][4];
    acc_to_a<8>(pa, st);

    // dV += P^T dO (dO read MN-major), beside dP^T
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t(dva[c], pa[j],
                       desc_at(do_lo, c * BQ * kRowBytes + 16 * j * kRowBytes));
    wgmma_commit();
    wgmma_wait<1>();                      // dP^T is in; dV may still run
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta) scale, from the fp32 P^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * n + e] = st[4 * n + e] *
                         (dpt[4 * n + e] - dlt[2 * n + (e & 1)]) * scale;
    uint32_t da[4][4];
    acc_to_a<8>(da, dpt);

    // dK += dS^T Q (Q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t(dka[c], da[j],
                       desc_at(q_lo, c * BQ * kRowBytes + 16 * j * kRowBytes));
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

  const long long base_o = (static_cast<long long>(b) * S * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (key[i] < S) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const long long at = base_o + key[i] * os + c * 64 + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(dk + at) =
              pack_bf16(dka[c][4 * n + 2 * i], dka[c][4 * n + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dv + at) =
              pack_bf16(dva[c][4 * n + 2 * i], dva[c][4 * n + 2 * i + 1]);
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
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int S, int H, float scale,
                float scale_log2, WaitRecord* rec) {
  using L = DqSmem<D>;
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
  const int kv_end = kCausal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // K and V keys of loop step i into its stage
  auto load_step = [&](int i) {
    const int s = i % ST;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
    mbar_expect_tx(w.at(1 + s), 2 * L::kTile);
    tma_tile<D>(st, &tk, w.at(1 + s), BK, h, i * BK, b);
    tma_tile<D>(st + L::kTile, &tv, w.at(1 + s), BK, h, i * BK, b);
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
      for (int it = 0; it < n_tiles; ++it) {
        if (it >= ST) w.wait(1 + ST + it % ST, ((it / ST) - 1) & 1, it);
        load_step(it);
      }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // a consumer: warpgroup wg owns q rows [qw, qw + 64)
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + 64 * wg;
  const int row[2] = {qw + 16 * (warp % 4) + g, qw + 16 * (warp % 4) + g + 8};
  // this thread's rows' LSE (log2 units) and delta, 0 past S
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * S + row[i];
    lse2[i] = row[i] < S ? __ldg(lse + at) * kLog2e : 0.f;
    dlt[i] = row[i] < S ? __ldg(delta + at) : 0.f;
  }
  float acc[ND][32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint32_t q_lo = desc_lo(base + L::kQ + wg * 64 * kRowBytes);
  const uint32_t do_lo = desc_lo(base + L::kDo + wg * 64 * kRowBytes);

  w.wait(0, 0, -1);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST, key0 = it * BK;
    const uint32_t k_lo = desc_lo(base + L::kStage0 + s * L::kStageBytes);
    const uint32_t v_lo = desc_at(k_lo, L::kTile);
    const uint32_t qa = opaque(q_lo), doa = opaque(do_lo);
    w.wait(1 + s, (it / ST) & 1, it);
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
      wgmma_ss_n64(sc,
                   desc_at(qa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                   desc_at(k_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp,
                   desc_at(doa, (kk / 4) * BQ * kRowBytes + kk % 4 * 32),
                   desc_at(v_lo, (kk / 4) * BK * kRowBytes + kk % 4 * 32),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                      // S is in
    fence_regs(sc);

    // P = exp2(s scale_log2 - LSE log2e), 0 where the mask bites: keys
    // past S (TMA's zeros) and, when causal, keys after the row
    const bool masked = (kCausal && key0 + BK - 1 > qw) || key0 + BK > S;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(sc[4 * n + e], scale_log2, -lse2[e >> 1]));
        if (masked) {
          const int col = key0 + 8 * n + 2 * t + (e & 1);
          if (col >= S || (kCausal && col > row[e >> 1])) p = 0.f;
        }
        sc[4 * n + e] = p;
      }
    wgmma_wait<0>();                      // dP is in
    fence_regs(dp);

    // dS = P (dP - delta) scale, rounded into A fragments
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] =
            sc[4 * n + e] * (dp[4 * n + e] - dlt[e >> 1]) * scale;
    uint32_t da[BK / 16][4];
    acc_to_a<BK / 8>(da, dp);

    // dQ += dS K: K's rows are the k dim, read MN-major, one box a product
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int c = 0; c < ND; ++c)
        wgmma_rs_n64_t(acc[c], da[j],
                       desc_at(k_lo, c * BK * kRowBytes + 16 * j * kRowBytes));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < ND; ++c) fence_regs(acc[c]);
    fence_regs(da);
    mbar_arrive(w.at(1 + ST + s));
  }

  __nv_bfloat16* out = dq + (static_cast<long long>(b) * S * H + h) * D;
  const long long os = static_cast<long long>(H) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < S) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(out + row[i] * os + c * 64 + 8 * n +
                                       2 * t) =
              pack_bf16(acc[c][4 * n + 2 * i], acc[c][4 * n + 2 * i + 1]);
    }
}

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

// One operand's map arguments as ops/flash_attention.py:tensor_map_args
// packs them, 11 values: dims[4] (D, H, S, B), byte strides[3] (of H, S,
// B), box[4].
constexpr int kMapArgs = 11;

// Encodes the map of one [B, S, H, D] bf16 operand (128-byte swizzle) and
// checks that its box is the tile the kernel loads: 64 columns of one
// head by `rows` rows of one batch.
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
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

template <int D, bool C>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int S, int H, const long long* maps, float scale,
        cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = FwdSmem<D>::kBytes;
  auto kernel = flash_fwd_kernel<D, C>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  int rc;
  if ((rc = encode(&tq, maps, q, kFwdBq)) ||
      (rc = encode(&tk, maps + kMapArgs, k, kFwdBk)) ||
      (rc = encode(&tv, maps + 2 * kMapArgs, v, kFwdBk)))
    return rc;
  const dim3 grid((S + kFwdBq - 1) / kFwdBq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      S, H, scale * kLog2e, rec);
  return cudaGetLastError();
}

template <int D, bool C>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, int B,
        int S, int H, const long long* maps, float scale,
        cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = DkvSmem<D>::kBytes;
  auto kernel = flash_dkv_kernel<D, C>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = encode(&tq, maps, q, kDkvBq)) ||
      (rc = encode(&tk, maps + kMapArgs, k, kDkvBk)) ||
      (rc = encode(&tv, maps + 2 * kMapArgs, v, kDkvBk)) ||
      (rc = encode(&tdo, maps + 3 * kMapArgs, dout, kDkvBq)))
    return rc;
  const dim3 grid((S + kDkvBk - 1) / kDkvBk, B * H);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dkp),
      static_cast<__nv_bfloat16*>(dvp), S, H, scale, scale * kLog2e, rec);
  return cudaGetLastError();
}

template <int D, bool C>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int B, int S, int H,
       const long long* maps, float scale, cudaStream_t stream) {
  static unsigned ready = 0;
  constexpr int smem = DqSmem<D>::kBytes;
  auto kernel = flash_dq_kernel<D, C>;
  cudaError_t err = allow_smem(kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = encode(&tq, maps, q, kDqBq)) ||
      (rc = encode(&tk, maps + kMapArgs, k, kDqBk)) ||
      (rc = encode(&tv, maps + 2 * kMapArgs, v, kDqBk)) ||
      (rc = encode(&tdo, maps + 3 * kMapArgs, dout, kDqBq)))
    return rc;
  const dim3 grid((S + kDqBq - 1) / kDqBq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqp), S,
      H, scale, scale * kLog2e, rec);
  return cudaGetLastError();
}

// Calls FN<D, causal>(args...) for the runtime D and causal.
#define FLASH_DISPATCH(FN, ...)                                 \
  do {                                                          \
    if (head_dim == 64 && causal) return FN<64, true>(__VA_ARGS__);   \
    if (head_dim == 64 && !causal) return FN<64, false>(__VA_ARGS__); \
    if (head_dim == 128 && causal) return FN<128, true>(__VA_ARGS__); \
    if (head_dim == 128 && !causal)                             \
      return FN<128, false>(__VA_ARGS__);                       \
    return kErrHeadDim;                                         \
  } while (0)

}  // namespace

// Operands are bfloat16 [B, S, H, D]; lse and delta fp32 [B*H, S],
// contiguous. maps: kMapArgs values per operand in argument order (q, k,
// v, and for dK/dV dout), from ops/flash_attention.py:tensor_map_args.
// Each returns 0, a cudaError_t code, or one of the negative codes above.
extern "C" int flash_sm90_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int B, int S, int H, int head_dim,
                                     int causal, const long long* maps,
                                     float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, B, S, H, maps, scale, s);
}

extern "C" int flash_sm90_dkv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dkp, void* dvp, int B, int S,
                                     int H, int head_dim, int causal,
                                     const long long* maps, float scale,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dkp, dvp, B, S, H, maps,
                 scale, s);
}

extern "C" int flash_sm90_dq_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dqp, int B, int S, int H,
                                    int head_dim, int causal,
                                    const long long* maps, float scale,
                                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dqp, B, S, H, maps, scale, s);
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
