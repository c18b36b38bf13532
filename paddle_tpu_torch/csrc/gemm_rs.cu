// GEMM + reduce-scatter of sequence-parallel training over NVLink peer
// buffers, for Hopper (sm_90a): row 8, paddle_tpu_torch/ops/ring_gemm.py:
// ring_gemm_rs.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels/fused_collectives.py:
// _gemm_rs_kernel (:249, the pallas_call at :610). Each of the n ranks holds
// a partial y [B, S, F] (S = n*s) and a row shard w [F, A] (mode NN) or w
// stored [A, F] (mode NT, the backward of fused_ag_gemm); rank r's result
// is its sequence chunk r, [B, s, A] in bf16, summed over the ranks in
// fp32 in the ring's order: chunk c is ((p_{c+1} + p_{c+2}) + p_{c+3}) +
// p_c, p_j rank j's fp32 partial y_j[:, chunk c] @ w_j (ranks mod n; the
// TPU kernel's ring, fused_collectives.py:256-258). The wire is fp32.
//
// What bounds it on an H100, per rank at GPT-3 1.3B (B=8, S=2048, n=4, A =
// 2048, F = 512 / 1536 / 2048): the products, 2 * 4 * 4096 * A * F = 34-137
// GFLOP a call (0.035-0.139 ms at 989 TFLOP/s), and the partials that must
// cross NVLink, 3 chunks of 4096 x 2048 fp32 = 100.7 MB received (0.224 ms
// at 450 GB/s one way). The call is bound by communication, but only if
// the products run while the partials travel. The TPU kernel overlaps
// them with in-kernel remote DMAs; this kernel does it with stores into the
// peers' memory (CUDA IPC, distributed/peer.py):
//
// * gemm_rs_kernel, one launch: a 128 x 256 output tile a block, warpgroup
//   products (wgmma m64n256k16, bf16 in, fp32 accumulators) fed by TMA
//   through a 4-stage full/empty mbarrier ring from a producer warp, two
//   consumer warpgroups of 64 rows (sm90.cuh's tile256 core; 128-byte
//   swizzle, 64-column boxes). y's chunk rows are read in place through a
//   2-D map over [B*S, F]: a chunk's 128-row tile lies inside one batch
//   row because s is a multiple of 128 (the wrapper refuses other s). Mode
//   NT reads w [A, F] K-major; mode NN reads w [F, A] MN-major through the
//   descriptor's transpose bit (one 256-wide product spans four 64-column
//   boxes, the leading byte offset one box apart), so no transposed copy.
// * Remote chunks first: the grid's tiles run in the chunk order r + 1,
//   r + 2, ..., and rank r's own chunk last, so the bytes that must cross
//   NVLink are produced first.
// * The epilogue pushes: a tile's fp32 partial goes through shared memory
//   (the drained ring) and is stored with 16-byte stores, a warp writing
//   512 contiguous bytes a row, straight into slot [parity][r] of the
//   destination rank c's channel; the own chunk's into its own slot. The
//   transfer runs under the remaining tiles' products. The block that
//   stores a chunk's last tile (a counter in the rank's pad) publishes
//   the call's number into c's ready[parity][r] with a system-scope
//   release.
// * gemm_rs_reduce_kernel, the second launch, at the destination: waits
//   for the n - 1 ready flags, then sums its slots in the ring's order
//   (slot r + 1 first, its own last) with one fp32 add a term, and writes
//   bf16 [B, s, A]: given the same partials, the plain ring's fp32 sum bit
//   for bit. Its last block then tells every source that the slots of
//   this call are read (freed[r] in the source's pad) and moves the call
//   counter.
// * Slot reuse: slots are double-buffered by the call's parity, and a
//   GEMM tile writes into c's slot of call e only after c has read the
//   slot of call e - 2 (freed). Call numbers live in device memory (the
//   pad's `calls`, moved by the reduce), so no host argument changes from
//   call to call and the two launches can be captured in a CUDA graph.
// * Every wait is bounded and reads the awaited peer's heartbeat
//   (peer_barrier.cuh's wait_flag): a late but live peer is waited for, a
//   gone one ends the wait after the channel's timeout with the error
//   record (row 8; at_end 0 the GEMM's wait for a freed slot, 1 the
//   reduce's wait for a partial) and a trap. No wait is for a kernel that
//   the waiter's own stream still has to run, so ranks that time-slice one
//   card (the "shared" layout) make progress too: the GEMM of call e waits
//   for peers' reduces of call e - 2, the reduce of call e for peers'
//   GEMMs of call e.
//
// Rows 7 and 9 (ag_gemm.cu) run this core over the peer buffers too;
// rows 14 and 15 (pp_gemm.cu) run it with NCCL hops.
//
// gemm_rs_local_launch runs the same GEMM with every chunk's partial into
// a local buffer [n, B*s, A] (no peers, no flags): the products alone, for
// timing them apart from the transfer.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/ring_gemm.py). The tensor
// maps are encoded per call in the launch function and passed as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "peer_barrier.cuh"
#include "sm90.cuh"

namespace {

using namespace tile256;

constexpr int kReduceThreads = 512;
constexpr int kErrUnsupported = -1;

// One tile: output rows [m0, m0 + 128) of chunk c (rows of the chunk's
// [B*s, A] result) and columns [n0, n0 + 256). PEER: the partial goes into
// slot [parity][rank] of rank c's channel and the flags follow; else into
// local + c * M * A.
template <int MODE, bool PEER>
__global__ void __launch_bounds__(kThreads, 1)
gemm_rs_kernel(const __grid_constant__ CUtensorMap ty,
               const __grid_constant__ CUtensorMap tw, const peer::Peers a,
               float* __restrict__ local, int S, int s, int A, int k_steps,
               int tiles_m, int tiles_n, long long slot_stride,
               WaitRecord* rec) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t base = aligned_base(smem);
  uint8_t* const sm = smem + (base - smem_u32(smem));
  const Waiter wt{smem_u32(bars), rec, 8};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpc = tiles_m * tiles_n;
  const int o = blockIdx.x / tpc;                     // remote chunks first
  const int c = (a.rank + 1 + o) % a.n;
  const int within = blockIdx.x - o * tpc;
  const int m0 = (within / tiles_n) * kBM;
  const int n0 = (within % tiles_n) * kBN;
  const int yrow = (m0 / s) * S + c * s + m0 % s;     // y's row of m0

  if (threadIdx.x == 0) init_ring(wt);
  __syncthreads();

  if (warp == kConsumers / 32) {                      // the producer
    if (lane == 0)
      produce(wt, base, k_steps, [&](uint32_t dst, uint32_t bar, int k) {
        load_a<MODE>(dst, &ty, bar, yrow, k);
        load_b<MODE>(dst, &tw, bar, n0, k);
      });
    return;
  }

  // a consumer: warpgroup wg owns the tile's rows [64 wg, 64 wg + 64);
  // the epilogue stages the fp32 tile in the drained ring
  const int wg = warpgroup();
  float acc[128];
  consume<MODE>(acc, wt, base, k_steps, wg, lane);
  consumers_sync();
  float* tile = reinterpret_cast<float*>(sm);
  stage_tile(acc, tile, wg, warp, lane);
  const long long M = static_cast<long long>(tiles_m) * kBM;
  uint32_t e = 0;
  float* dst;
  if constexpr (PEER) {
    peer::Pad* mine = a.pad[a.rank];
    e = *reinterpret_cast<volatile uint32_t*>(&mine->calls) + 1;
    dst = static_cast<float*>(const_cast<void*>(a.data[c])) +
          ((e & 1) * a.n + a.rank) * slot_stride;
    // the destination has read its slot of call e - 2
    if (threadIdx.x == 0 && c != a.rank && e > 2)
      peer::wait_flag(a, &mine->freed[c], e - 2, c, 0);
  } else {
    dst = local + c * M * A;
  }
  consumers_sync();
  // each warp stores 16 rows, 512 contiguous bytes an instruction
  for (int r = 0; r < kBM / 8; ++r) {
    const int row = warp * (kBM / 8) + r;
    float* out = dst + (m0 + row) * static_cast<long long>(A) + n0;
#pragma unroll
    for (int h = 0; h < kBN / 128; ++h) {
      const int col = 128 * h + 4 * lane;
      if (n0 + col < A)
        *reinterpret_cast<float4*>(out + col) =
            *reinterpret_cast<const float4*>(tile + row * kTileRow + col);
    }
  }
  if constexpr (PEER) {
    __threadfence_system();
    consumers_sync();
    if (threadIdx.x == 0) {
      peer::Pad* mine = a.pad[a.rank];
      if (atomicAdd(&mine->tiles[c], 1u) == static_cast<uint32_t>(tpc - 1)) {
        mine->tiles[c] = 0;                  // ready for the next call
        if (c != a.rank) {
          __threadfence_system();
          peer::st_release_sys(&a.pad[c]->ready[e & 1][a.rank], e);
        }
      }
    }
  }
}

// this rank's chunk: its slots of the call summed in the ring's order
// (rank + 1 first, its own last), bf16 out [M, A] contiguous
template <int N>
__global__ void __launch_bounds__(kReduceThreads)
gemm_rs_reduce_kernel(const peer::Peers a, __nv_bfloat16* __restrict__ out,
                      long long elems, long long slot_stride) {
  peer::Pad* mine = a.pad[a.rank];
  const uint32_t e = *reinterpret_cast<volatile uint32_t*>(&mine->calls) + 1;
  const int p = threadIdx.x;
  if (p < N && p != a.rank) peer::wait_flag(a, &mine->ready[e & 1][p], e, p, 1);
  __syncthreads();
  const float* slots = static_cast<const float*>(a.data[a.rank]) +
                       (e & 1) * N * slot_stride;
  const float4* rows[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    rows[k] = reinterpret_cast<const float4*>(
        slots + ((a.rank + 1 + k) % N) * slot_stride);
  const long long groups = elems / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < groups; i += stride) {
    float4 v[N][2];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k][0] = __ldcg(rows[k] + 2 * i);
      v[k][1] = __ldcg(rows[k] + 2 * i + 1);
    }
    float s[8] = {v[0][0].x, v[0][0].y, v[0][0].z, v[0][0].w,
                  v[0][1].x, v[0][1].y, v[0][1].z, v[0][1].w};
#pragma unroll
    for (int k = 1; k < N; ++k) {
      s[0] = __fadd_rn(s[0], v[k][0].x);
      s[1] = __fadd_rn(s[1], v[k][0].y);
      s[2] = __fadd_rn(s[2], v[k][0].z);
      s[3] = __fadd_rn(s[3], v[k][0].w);
      s[4] = __fadd_rn(s[4], v[k][1].x);
      s[5] = __fadd_rn(s[5], v[k][1].y);
      s[6] = __fadd_rn(s[6], v[k][1].z);
      s[7] = __fadd_rn(s[7], v[k][1].w);
    }
    uint4 pk;
    pk.x = pack_bf16(s[0], s[1]);
    pk.y = pack_bf16(s[2], s[3]);
    pk.z = pack_bf16(s[4], s[5]);
    pk.w = pack_bf16(s[6], s[7]);
    reinterpret_cast<uint4*>(out)[i] = pk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&mine->reduced, 1u) == gridDim.x - 1) {
      mine->reduced = 0;
      __threadfence_system();
      for (int q = 0; q < N; ++q)
        if (q != a.rank) peer::st_release_sys(&a.pad[q]->freed[a.rank], e);
      *reinterpret_cast<volatile uint32_t*>(&mine->calls) = e;
    }
  }
}

// The maps, grid and GEMM launch of one call (PEER: with its reduce).
template <int MODE, bool PEER>
int launch(const void* y, const void* w, float* local, void* out,
           const peer::Peers& a, int B, int S, int F, int A,
           long long slot_stride, cudaStream_t stream) {
  auto kernel = gemm_rs_kernel<MODE, PEER>;
  static unsigned ready = 0;
  cudaError_t err = allow_smem(kernel, kSmemBytes, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  const int s = S / a.n;
  CUtensorMap ty, tw;
  int rc;
  if ((rc = encode_2d(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y,
                      static_cast<long long>(B) * S, F, 64, kBM)) ||
      (rc = MODE == kNN
                ? encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, F, A,
                            64, kBK)
                : encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, A, F,
                            64, kBN)))
    return rc;
  const int tiles_m = B * s / kBM;
  const int tiles_n = (A + kBN - 1) / kBN;
  const int k_steps = (F + kBK - 1) / kBK;
  kernel<<<a.n * tiles_m * tiles_n, kThreads, kSmemBytes, stream>>>(
      ty, tw, a, local, S, s, A, k_steps, tiles_m, tiles_n, slot_stride, rec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !PEER) return err;
  const long long elems = static_cast<long long>(B) * s * A;
  const long long want = (elems / 8 + kReduceThreads - 1) / kReduceThreads;
  const int blocks = static_cast<int>(want < 132 * 4 ? want : 132 * 4);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (a.n) {
#define GEMM_RS_REDUCE(NN_)                                                 \
  case NN_:                                                                 \
    gemm_rs_reduce_kernel<NN_><<<blocks, kReduceThreads, 0, stream>>>(      \
        a, o, elems, slot_stride);                                          \
    break;
    GEMM_RS_REDUCE(2)
    GEMM_RS_REDUCE(3)
    GEMM_RS_REDUCE(4)
    GEMM_RS_REDUCE(5)
    GEMM_RS_REDUCE(6)
    GEMM_RS_REDUCE(7)
    GEMM_RS_REDUCE(8)
#undef GEMM_RS_REDUCE
    default: return kErrUnsupported;
  }
  return cudaGetLastError();
}

bool shapes_ok(int mode, int B, int S, int F, int A, int n, int rank) {
  return (mode == kNN || mode == kNT) && B > 0 && n >= 2 &&
         n <= peer::kMaxRanks && rank >= 0 && rank < n && S % n == 0 &&
         (S / n) % kBM == 0 && F > 0 && F % 16 == 0 && A > 0 && A % 16 == 0;
}

}  // namespace

// One row-8 call on `stream`: the GEMM of every chunk (its remote tiles
// stored into the peers' slots) and the reduce of this rank's chunk into
// out, bf16 [B, S/n, A]. mode 0: w [F, A]; 1: w stored [A, F]. y bf16
// [B, S, F]. data[p], pads[p]: rank p's staging and signal pad as mapped
// here; slot_stride: fp32 elements between the staging's 2n slots (at
// least B*S/n*A). err, beats, timeout_ns, backstop_ns as rs_pull_launch's
// (rs_bucket.cu). Returns 0, a cudaError_t code, or a negative code of
// gemm_rs_error_string.
extern "C" int gemm_rs_launch(int mode, const void* y, const void* w,
                              void* out, int B, int S, int F, int A, int n,
                              int rank, void* const* data, void* const* pads,
                              long long slot_stride, void* err,
                              const void* beats,
                              unsigned long long timeout_ns,
                              unsigned long long backstop_ns, void* stream) {
  if (!shapes_ok(mode, B, S, F, A, n, rank) || err == nullptr ||
      beats == nullptr ||
      slot_stride < static_cast<long long>(B) * (S / n) * A ||
      slot_stride % 4 != 0)
    return kErrUnsupported;
  peer::Peers a = {};
  for (int p = 0; p < n; ++p) {
    if (data[p] == nullptr || pads[p] == nullptr) return kErrUnsupported;
    a.data[p] = data[p];
    a.pad[p] = static_cast<peer::Pad*>(pads[p]);
  }
  a.err = static_cast<peer::ErrorRecord*>(err);
  a.beats = static_cast<const uint32_t*>(beats);
  a.timeout_ns = timeout_ns;
  a.backstop_ns = backstop_ns;
  a.n = n;
  a.rank = rank;
  a.row = 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == kNN
             ? launch<kNN, true>(y, w, nullptr, out, a, B, S, F, A,
                                 slot_stride, s)
             : launch<kNT, true>(y, w, nullptr, out, a, B, S, F, A,
                                 slot_stride, s);
}

// The GEMM alone: every chunk's fp32 partial y[:, chunk c] @ w into local
// + c * (B*S/n*A), in the tile order of rank `rank`; no peers, no flags.
extern "C" int gemm_rs_local_launch(int mode, const void* y, const void* w,
                                    void* local, int B, int S, int F, int A,
                                    int n, int rank, void* stream) {
  if (!shapes_ok(mode, B, S, F, A, n, rank) || local == nullptr)
    return kErrUnsupported;
  peer::Peers a = {};
  a.n = n;
  a.rank = rank;
  float* l = static_cast<float*>(local);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == kNN
             ? launch<kNN, false>(y, w, l, nullptr, a, B, S, F, A, 0, s)
             : launch<kNT, false>(y, w, l, nullptr, a, B, S, F, A, 0, s);
}

// The mbarrier timeout record's 8 ints (code, row, block x, block y, warp,
// barrier, parity, step); all zero when no wait has timed out.
extern "C" void gemm_rs_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* gemm_rs_error_string(int code) {
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
