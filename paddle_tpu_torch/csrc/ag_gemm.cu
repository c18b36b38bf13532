// Ring all-gather + GEMM (row 7) and the ring weight gradient (row 9) of
// sequence-parallel training over NVLink peer buffers, for Hopper
// (sm_90a): paddle_tpu_torch/ops/ring_gemm.py: ring_ag_gemm, ring_ag_accum.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_kernels/
// fused_collectives.py:
//
// * _ag_gemm_kernel (:201, the pallas_call at :590): every rank's seq shard
//   x [B, s, A] GEMMed against this rank's column shard w [A, F] (mode NN;
//   mode NT: w stored [F, A], the backward's w^T) into its block-row of
//   out [B, n*s, F], bf16, each element rounded once;
// * _ag_accum_kernel (:307, :631): the sum over the chunks src of r_src^T
//   @ stat_src in fp32 [A, Bf] (r [B, s, A] every rank's ring operand,
//   stat [B, n*s, Bf] this rank's stationary operand, chunk src its rows
//   [src*s, src*s + s) of each batch row), or its transpose [Bf, A].
//
// What bounds them on an H100, per rank at GPT-3 1.3B (B=8, S=2048, n=4,
// A = 2048; chunk rows B*s = 4096): the products, 2 * 16384 * 2048 * F =
// 34-137 GFLOP a call (0.035-0.139 ms at 989 TFLOP/s), and the n - 1
// chunks of 16.8 MB bf16 that must cross NVLink, 50.3 MB received (0.112
// ms at 450 GB/s one way). The TPU kernels ring the chunks with in-kernel
// remote DMAs; here each chunk crosses NVLink once, through CUDA IPC
// (distributed/peer.py), with no NCCL hop and no host round trip:
//
// * ag_gemm_pull_kernel, the first launch: waits until every peer has read
//   this rank's slot of call e - 2, copies x (r) into slot [e & 1] of its
//   own channel, and tells each peer (ready[e & 1][rank] in the peer's
//   pad, a system-scope release). It then copies each remote chunk, in
//   ring order (src = rank - 1, rank - 2, ...), from the peer's slot over
//   NVLink into a local gather slot, sets gathered[src] in its own pad
//   and tells src that its slot is read (freed[rank] in src's pad). It
//   lets the GEMM launch at once (griddepcontrol.launch_dependents; the
//   GEMM is a programmatic dependent launch), so the pulls run under the
//   own chunk's products. Each remote chunk crosses NVLink once (TMA
//   loads straight from the peers' slots, the other form timed, fetch
//   each remote tile once per 256-column output tile: PERF.md §6).
// * ag_gemm_kernel, the second launch: a 128 x 256 output tile a block,
//   warpgroup products (wgmma m64n256k16, bf16 in, fp32 accumulators) fed
//   by TMA through a 4-stage full/empty mbarrier ring from a producer
//   warp, two consumer warpgroups of 64 rows, 128-byte swizzle: row 8's
//   core (sm90.cuh's tile256, shared with gemm_rs.cu and pp_gemm.cu).
//   The grid runs the chunks in ring order, the own chunk's tiles first
//   (read from x in place); a block of a remote chunk first waits for its
//   gather slot (gathered[src]).
//   Row 7, modes NN and NT: A is the chunk [B*s, A] K-major; NN reads w [A,
//   F] MN-major through the descriptor's transpose bit (one 256-wide
//   product spans four 64-column boxes), NT reads w [F, A] K-major. The
//   epilogue stages the fp32 tile in the drained ring and stores bf16 rows
//   of 512 bytes a warp into block-row src of out: row m of the chunk is
//   out[m / s, src * s + m % s].
//   Row 9, mode TN: both operands are read MN-major from their [k rows,
//   columns] storage (A = r^T or, transposed, stat^T), so there is no
//   transposed copy; stat's rows of chunk src through a 2-D map over [B*S,
//   Bf] (a 64-row k step lies in one batch row: s is a multiple of 64).
//   Each block sums one chunk's contraction (B*s rows) in its
//   accumulators and stores the fp32 partial into ws[t] (t the chunk's
//   ring step); the last of a tile's n blocks (a counter per tile) sums
//   ws[0] + ws[1] + ... + ws[n - 1] in that order, one fp32 add a term,
//   into out: the ring's order, so the plain form (ops/ring_gemm.py:
//   ag_accum_peer_plain) is the plain ring's sum and the kernel is held to
//   it per element. The n blocks a tile also fill 128-256 tiles' worth of
//   grid for outputs of 32-128 tiles.
// * Slots are double-buffered by the call's parity; a source rewrites
//   slot [e & 1] only after every reader has freed call e - 2's. Call
//   numbers live in device memory (`calls` in the pad, moved by the GEMM's
//   last block), so no launch argument changes from call to call and the
//   two launches can be captured in a CUDA graph.
// * Every wait is bounded and reads the awaited peer's heartbeat
//   (peer_barrier.cuh's wait_flag): a late but live peer is waited for, a
//   gone one ends the wait after the channel's timeout with the error
//   record (row 7 or 9; at_end 0 the pull's wait for a freed slot, 1 its
//   wait for a peer's chunk, 2 the GEMM's wait for a gathered chunk) and a
//   trap. The pull waits only for the peers' pulls, and the GEMM only for
//   its own pull, which is resident before any GEMM block starts; so
//   ranks that time-slice one card (the "shared" layout) make progress.
//   A block's flag wait comes before its mbarrier ring starts, so the
//   ring's own 10 s bound never times a peer.
//
// ag_*_local_launch runs the same GEMM over every chunk of a local buffer
// [n, B*s, A] (no peers, no flags): the products alone, for timing them
// apart from the transfer.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/ring_gemm.py). The tensor
// maps are encoded per call in the launch function and passed as a
// __grid_constant__ parameter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "peer_barrier.cuh"
#include "sm90.cuh"

namespace {

// modes (tile256): row 7 NN (w [A, F]), NT (w stored [F, A]); row 9 TN
using namespace tile256;

constexpr int kPullThreads = 512;
constexpr int kUnroll = 4;
constexpr int kAtFreed = 0;      // the error record's at_end codes
constexpr int kAtChunk = 1;
constexpr int kAtGathered = 2;
constexpr int kErrUnsupported = -1;

struct Maps {
  CUtensorMap own;                      // this rank's chunk, in place
  CUtensorMap ring[peer::kMaxRanks];    // chunk src: its gather slot (or
                                        // the local buffer's chunk)
  CUtensorMap other;                    // w (row 7) or stat (row 9)
};

struct Geo {
  int rows;       // a chunk's rows, B*s (row 9's contraction)
  int s;          // a chunk's rows of one batch row
  int S;          // n*s
  int M, N;       // the output tile grid: row 7 a chunk's [B*s, F]; row 9
                  // [A, Bf] or [Bf, A]
  int k_steps;
  int tiles_m, tiles_n;
  int swap;       // row 9: stat is A (the transposed result)
};

__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t load_calls(const peer::Pad* pad) {
  return *reinterpret_cast<const volatile uint32_t*>(&pad->calls);
}

// 16-byte copy of n16 units, grid-strided, kUnroll loads in flight
__device__ __forceinline__ void copy16(uint4* __restrict__ dst,
                                       const uint4* __restrict__ src,
                                       long long n16) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n16; g += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + u * stride < n16) v[u] = __ldcg(src + g + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + u * stride < n16) dst[g + u * stride] = v[u];
  }
}

// Publish this rank's chunk (x, chunk16 units of 16 bytes) into slot
// [e & 1] of its staging and gather every remote chunk into gather slot
// src (staging + (2 + src) * slot bytes).
__global__ void __launch_bounds__(kPullThreads)
ag_gemm_pull_kernel(const peer::Peers a, const uint4* __restrict__ x,
                    long long chunk16, long long slot_bytes) {
  peer::Pad* mine = a.pad[a.rank];
  const uint32_t e = load_calls(mine) + 1;
  // the GEMM may start: its own chunk needs nothing of this kernel
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int par = e & 1;
  uint8_t* own = static_cast<uint8_t*>(const_cast<void*>(a.data[a.rank]));
  const int p = threadIdx.x;
  if (e > 2 && p < a.n && p != a.rank)
    peer::wait_flag(a, &mine->freed[p], e - 2, p, kAtFreed);
  __syncthreads();
  copy16(reinterpret_cast<uint4*>(own + par * slot_bytes), x, chunk16);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(&mine->published, 1u) == gridDim.x - 1) {
    mine->published = 0;
    __threadfence_system();
    for (int q = 0; q < a.n; ++q)
      if (q != a.rank) peer::st_release_sys(&a.pad[q]->ready[par][a.rank], e);
  }
  for (int t = 1; t < a.n; ++t) {
    const int src = (a.rank - t + a.n) % a.n;
    if (threadIdx.x == 0)
      peer::wait_flag(a, &mine->ready[par][src], e, src, kAtChunk);
    __syncthreads();
    const uint8_t* from = static_cast<const uint8_t*>(a.data[src]);
    copy16(reinterpret_cast<uint4*>(own + (2 + src) * slot_bytes),
           reinterpret_cast<const uint4*>(from + par * slot_bytes), chunk16);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0 &&
        atomicAdd(&mine->pulled[src], 1u) == gridDim.x - 1) {
      mine->pulled[src] = 0;
      __threadfence_system();
      peer::st_release_sys(&mine->gathered[src], e);
      peer::st_release_sys(&a.pad[src]->freed[a.rank], e);
    }
  }
}

// One block: output tile (m0, n0) of chunk step t (chunk src = rank - t),
// as the note above says; without peers every chunk from the local
// buffer's maps, no flags.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
ag_gemm_kernel(const __grid_constant__ Maps maps, const peer::Peers a,
               const Geo g, void* __restrict__ out, float* __restrict__ ws,
               uint32_t* __restrict__ split, bool peers, WaitRecord* rec) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  __shared__ int last_split;
  const uint32_t base = aligned_base(smem);
  uint8_t* const sm = smem + (base - smem_u32(smem));
  const Waiter wt{smem_u32(bars), rec, MODE == kTN ? 9 : 7};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpc = g.tiles_m * g.tiles_n;
  const int t = blockIdx.x / tpc;                     // own chunk first
  const int src = (a.rank - t + a.n) % a.n;
  const int tile_id = blockIdx.x - t * tpc;
  const int m0 = (tile_id / g.tiles_n) * kBM;
  const int n0 = (tile_id % g.tiles_n) * kBN;
  peer::Pad* mine = peers ? a.pad[a.rank] : nullptr;
  const uint32_t e = peers ? load_calls(mine) + 1 : 0;
  // the chunk's map: x in place, the gather slot or the local buffer's
  // chunk
  const CUtensorMap* ring = peers && t == 0 ? &maps.own : &maps.ring[src];

  if (threadIdx.x == 0) {
    if (peers && t > 0)
      peer::wait_flag(a, &mine->gathered[src], e, src, kAtGathered);
    init_ring(wt);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {                      // the producer
    if (lane == 0) {
      fence_async_global();      // the chunk's bytes, acquired above
      produce(wt, base, g.k_steps, [&](uint32_t dst, uint32_t bar, int k) {
        if constexpr (MODE == kTN) {
          // k rows of the chunk; stat's row of chunk row k
          const int srow = (k / g.s) * g.S + src * g.s + k % g.s;
          load_a<MODE>(dst, g.swap ? &maps.other : ring, bar, m0,
                       g.swap ? srow : k);
          load_b<MODE>(dst, g.swap ? ring : &maps.other, bar, n0,
                       g.swap ? k : srow);
        } else {
          load_a<MODE>(dst, ring, bar, m0, k);
          load_b<MODE>(dst, &maps.other, bar, n0, k);
        }
      });
    }
    return;
  }

  // a consumer: warpgroup wg owns the tile's rows [64 wg, 64 wg + 64);
  // the epilogue stages the fp32 tile in the drained ring
  const int wg = warpgroup();
  float acc[128];
  consume<MODE>(acc, wt, base, g.k_steps, wg, lane);
  consumers_sync();
  float* tile = reinterpret_cast<float*>(sm);
  stage_tile(acc, tile, wg, warp, lane);
  consumers_sync();
  if constexpr (MODE == kTN) {
    // this chunk's partial into ws[t]; the tile's last block sums them
    const long long MN = static_cast<long long>(g.M) * g.N;
    float* part = ws + t * MN;
    for (int r = 0; r < kBM / 8; ++r) {
      const int row = warp * (kBM / 8) + r;
      if (m0 + row >= g.M) break;
      float* o = part + (m0 + row) * static_cast<long long>(g.N) + n0;
#pragma unroll
      for (int h = 0; h < kBN / 128; ++h) {
        const int col = 128 * h + 4 * lane;
        if (n0 + col < g.N)
          *reinterpret_cast<float4*>(o + col) =
              *reinterpret_cast<const float4*>(tile + row * kTileRow + col);
      }
    }
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) {
      last_split = atomicAdd(&split[tile_id], 1u) ==
                   static_cast<uint32_t>(a.n - 1);
      if (last_split) split[tile_id] = 0;        // ready for the next call
    }
    consumers_sync();
    if (last_split) {
      __threadfence();
      float* res = static_cast<float*>(out);
      for (int r = 0; r < kBM / 8; ++r) {
        const int row = warp * (kBM / 8) + r;
        if (m0 + row >= g.M) break;
        const long long off = (m0 + row) * static_cast<long long>(g.N) + n0;
#pragma unroll
        for (int h = 0; h < kBN / 128; ++h) {
          const int col = 128 * h + 4 * lane;
          if (n0 + col >= g.N) continue;
          float4 v = __ldcg(reinterpret_cast<const float4*>(ws + off + col));
          for (int u = 1; u < a.n; ++u) {
            const float4 p = __ldcg(
                reinterpret_cast<const float4*>(ws + u * MN + off + col));
            v.x = __fadd_rn(v.x, p.x);
            v.y = __fadd_rn(v.y, p.y);
            v.z = __fadd_rn(v.z, p.z);
            v.w = __fadd_rn(v.w, p.w);
          }
          *reinterpret_cast<float4*>(res + off + col) = v;
        }
      }
    }
  } else {
    // bf16 rows of 512 bytes a warp into block-row src of out
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    for (int r = 0; r < kBM / 8; ++r) {
      const int row = warp * (kBM / 8) + r;
      const int m = m0 + row;
      if (m >= g.M) break;
      const long long orow =
          (static_cast<long long>(m / g.s) * a.n + src) * g.s + m % g.s;
      const int col = 8 * lane;
      if (n0 + col < g.N) {
        const float* f = tile + row * kTileRow + col;
        uint4 pk;
        pk.x = pack_bf16(f[0], f[1]);
        pk.y = pack_bf16(f[2], f[3]);
        pk.z = pack_bf16(f[4], f[5]);
        pk.w = pack_bf16(f[6], f[7]);
        *reinterpret_cast<uint4*>(o + orow * g.N + n0 + col) = pk;
      }
    }
  }
  if (peers) {
    consumers_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(&mine->finished, 1u) == gridDim.x - 1) {
        mine->finished = 0;
        *reinterpret_cast<volatile uint32_t*>(&mine->calls) = e;
      }
    }
  }
}

int pull_grid() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The maps, grids and launches of one call: with peers, the pull and the
// GEMM, a programmatic dependent launch after it; without, the GEMM over
// the local buffer. ring[p] the start of chunk p (its gather slot, or the
// local buffer's chunk); x this rank's chunk; other w or stat; the chunks
// [geo.rows, A].
template <int MODE>
int launch(const void* const* ring, const void* x, const void* other,
           long long other_rows, long long other_cols, void* out, float* ws,
           uint32_t* split, const peer::Peers& a, const Geo& geo, bool peers,
           long long slot_bytes, int A, cudaStream_t stream) {
  auto kernel = ag_gemm_kernel<MODE>;
  static unsigned ready = 0;
  cudaError_t err = allow_smem(kernel, kSmemBytes, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  Maps maps;
  const int box_rows = MODE == kTN ? kBK : kBM;   // a chunk's box
  int rc = encode_2d(&maps.own, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                     geo.rows, A, 64, box_rows);
  for (int p = 0; p < a.n && rc == 0; ++p)
    rc = encode_2d(&maps.ring[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   ring[p], geo.rows, A, 64, box_rows);
  if (rc == 0)
    rc = encode_2d(&maps.other, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, other,
                   other_rows, other_cols, 64, MODE == kNT ? kBN : kBK);
  if (rc) return rc;
  if (peers) {
    const long long chunk16 = static_cast<long long>(geo.rows) * A * 2 / 16;
    const long long want =
        (chunk16 + kUnroll * kPullThreads - 1) / (kUnroll * kPullThreads);
    const int most = pull_grid();
    ag_gemm_pull_kernel<<<static_cast<int>(want < most ? want : most),
                          kPullThreads, 0, stream>>>(
        a, static_cast<const uint4*>(x), chunk16, slot_bytes);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n * geo.tiles_m * geo.tiles_n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = peers ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, a, geo, out, ws, split, peers,
                           rec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Peers of a call, or kErrUnsupported in *rc
peer::Peers peers_of(int n, int rank, int row, void* const* data,
                     void* const* pads, void* err, const void* beats,
                     unsigned long long timeout_ns,
                     unsigned long long backstop_ns, int* rc) {
  peer::Peers a = {};
  *rc = 0;
  if (err == nullptr || beats == nullptr) *rc = kErrUnsupported;
  for (int p = 0; p < n && *rc == 0; ++p) {
    if (data[p] == nullptr || pads[p] == nullptr) *rc = kErrUnsupported;
    a.data[p] = data[p];
    a.pad[p] = static_cast<peer::Pad*>(pads[p]);
  }
  a.err = static_cast<peer::ErrorRecord*>(err);
  a.beats = static_cast<const uint32_t*>(beats);
  a.timeout_ns = timeout_ns;
  a.backstop_ns = backstop_ns;
  a.n = n;
  a.rank = rank;
  a.row = row;
  return a;
}

// The chunk starts of the maps: the gather slots of this rank's staging,
// or, locally, chunk p of `local` (chunk bytes apart).
void ring_starts(const void** ring, int n, const uint8_t* base,
                 long long stride) {
  for (int p = 0; p < n; ++p) ring[p] = base + p * stride;
}

bool group_ok(int n, int rank) {
  return n >= 2 && n <= peer::kMaxRanks && rank >= 0 && rank < n;
}

// row 7's geometry, or false
bool ag_geo(int B, int s, int A, int F, int n, Geo* g) {
  if (B <= 0 || s <= 0 || A <= 0 || F <= 0 || A % 16 || F % 16) return false;
  *g = Geo{B * s, s, n * s, B * s, F, (A + kBK - 1) / kBK,
           (B * s + kBM - 1) / kBM, (F + kBN - 1) / kBN, 0};
  return true;
}

// row 9's geometry, or false
bool accum_geo(int B, int s, int A, int Bf, int n, int swap, Geo* g) {
  if (B <= 0 || s <= 0 || A <= 0 || Bf <= 0 || A % 16 || Bf % 16 ||
      s % kBK)
    return false;
  const int M = swap ? Bf : A, N = swap ? A : Bf;
  *g = Geo{B * s, s, n * s, M, N, B * s / kBK, (M + kBM - 1) / kBM,
           (N + kBN - 1) / kBN, swap};
  return g->tiles_m * g->tiles_n <= peer::kMaxBlocks;
}

int ag_dispatch(int mode, const void* const* ring, const void* x,
                const void* w, void* out, const peer::Peers& a, const Geo& g,
                bool peers, long long slot_bytes, int A, cudaStream_t s) {
  // NN: w [A, F]; NT: w stored [F, A]
  return mode == kNN
             ? launch<kNN>(ring, x, w, A, g.N, out, nullptr, nullptr, a, g,
                           peers, slot_bytes, A, s)
             : launch<kNT>(ring, x, w, g.N, A, out, nullptr, nullptr, a, g,
                           peers, slot_bytes, A, s);
}

bool slots_ok(long long slot_bytes, int B, int s, int A) {
  return slot_bytes >= 2LL * B * s * A && slot_bytes % 16 == 0;
}

}  // namespace

// One row-7 call on `stream`: the pull and the GEMM of every chunk into
// out, bf16 [B, n*s, F]. mode 0: w [A, F]; 1: w stored [F, A]. x bf16 [B,
// s, A]. data[p], pads[p]: rank p's staging and signal pad as mapped here;
// slot_bytes: bytes between the staging's 2 + n slots (at least B*s*A*2,
// a multiple of 16); err, beats, timeout_ns, backstop_ns as
// rs_pull_launch's (rs_bucket.cu). Returns 0, a cudaError_t code, or a
// negative code of ag_gemm_error_string.
extern "C" int ag_gemm_launch(int mode, const void* x, const void* w,
                              void* out, int B, int s, int A, int F, int n,
                              int rank, void* const* data, void* const* pads,
                              long long slot_bytes, void* err,
                              const void* beats,
                              unsigned long long timeout_ns,
                              unsigned long long backstop_ns, void* stream) {
  Geo g;
  if ((mode != kNN && mode != kNT) || !group_ok(n, rank) ||
      !ag_geo(B, s, A, F, n, &g) || !slots_ok(slot_bytes, B, s, A))
    return kErrUnsupported;
  int rc;
  const peer::Peers a = peers_of(n, rank, 7, data, pads, err, beats,
                                 timeout_ns, backstop_ns, &rc);
  if (rc) return rc;
  const void* ring[peer::kMaxRanks];
  ring_starts(ring, n, static_cast<const uint8_t*>(data[rank]) +
                           2 * slot_bytes, slot_bytes);
  return ag_dispatch(mode, ring, x, w, out, a, g, true, slot_bytes, A,
                     static_cast<cudaStream_t>(stream));
}

// One row-9 call on `stream`: the pull and the GEMM of every chunk's
// partial into ws (fp32 [n, M, N]), summed in ring order into out (fp32
// [M, N]: [A, Bf], or [Bf, A] with swap). r bf16 [B, s, A], stat bf16 [B,
// n*s, Bf], s a multiple of 64; the rest as ag_gemm_launch.
extern "C" int ag_accum_launch(int swap, const void* r, const void* stat,
                               void* out, void* ws, int B, int s, int A,
                               int Bf, int n, int rank, void* const* data,
                               void* const* pads, long long slot_bytes,
                               void* err, const void* beats,
                               unsigned long long timeout_ns,
                               unsigned long long backstop_ns, void* stream) {
  Geo g;
  if (!group_ok(n, rank) || !accum_geo(B, s, A, Bf, n, swap, &g) ||
      ws == nullptr || !slots_ok(slot_bytes, B, s, A))
    return kErrUnsupported;
  int rc;
  const peer::Peers a = peers_of(n, rank, 9, data, pads, err, beats,
                                 timeout_ns, backstop_ns, &rc);
  if (rc) return rc;
  const void* ring[peer::kMaxRanks];
  ring_starts(ring, n, static_cast<const uint8_t*>(data[rank]) +
                           2 * slot_bytes, slot_bytes);
  return launch<kTN>(ring, r, stat, static_cast<long long>(B) * n * s, Bf,
                     out, static_cast<float*>(ws), a.pad[rank]->split, a, g,
                     true, slot_bytes, A, static_cast<cudaStream_t>(stream));
}

// The GEMMs alone: every chunk from local [n, B*s, A] (chunk p = rank p's
// x or r), in rank `rank`'s order; no peers, no flags. Row 7 writes out as
// ag_gemm_launch; row 9 needs split, its tiles' counters zeroed (it leaves
// them zeroed), and ws as ag_accum_launch.
extern "C" int ag_gemm_local_launch(int mode, const void* local,
                                    const void* w, void* out, int B, int s,
                                    int A, int F, int n, int rank,
                                    void* stream) {
  Geo g;
  if ((mode != kNN && mode != kNT) || !group_ok(n, rank) ||
      !ag_geo(B, s, A, F, n, &g) || local == nullptr)
    return kErrUnsupported;
  peer::Peers a = {};
  a.n = n;
  a.rank = rank;
  const void* ring[peer::kMaxRanks];
  ring_starts(ring, n, static_cast<const uint8_t*>(local), 2LL * B * s * A);
  return ag_dispatch(mode, ring, ring[rank], w, out, a, g, false, 0, A,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ag_accum_local_launch(int swap, const void* local,
                                     const void* stat, void* out, void* ws,
                                     void* split, int B, int s, int A,
                                     int Bf, int n, int rank, void* stream) {
  Geo g;
  if (!group_ok(n, rank) || !accum_geo(B, s, A, Bf, n, swap, &g) ||
      local == nullptr || ws == nullptr || split == nullptr)
    return kErrUnsupported;
  peer::Peers a = {};
  a.n = n;
  a.rank = rank;
  const void* ring[peer::kMaxRanks];
  ring_starts(ring, n, static_cast<const uint8_t*>(local), 2LL * B * s * A);
  return launch<kTN>(ring, ring[rank], stat,
                     static_cast<long long>(B) * n * s, Bf, out,
                     static_cast<float*>(ws), static_cast<uint32_t*>(split),
                     a, g, false, 0, A, static_cast<cudaStream_t>(stream));
}

// The output tiles of a row-9 call (its per-tile counters), or -1.
extern "C" int ag_accum_tiles(int B, int s, int A, int Bf, int n, int swap) {
  Geo g;
  return accum_geo(B, s, A, Bf, n, swap, &g) ? g.tiles_m * g.tiles_n : -1;
}

// The mbarrier timeout record's 8 ints (code, row, block x, block y, warp,
// barrier, parity, step); all zero when no wait has timed out.
extern "C" void ag_gemm_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* ag_gemm_error_string(int code) {
  switch (code) {
    case kErrUnsupported:
      return "unsupported mode, shape, group or missing operand";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found through "
             "cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
