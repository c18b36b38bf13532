// The local GEMMs of the pipeline boundary, for Hopper (sm_90a): rows 14
// and 15, paddle_tpu_torch/ops/pp_boundary.py: gemm_ppsend, gemm_pprecv.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas_kernels/
// fused_collectives.py, the last GEMM of a pipeline stage and its backward:
//
// * _gemm_ppsend_kernel (:792, the pallas_call at :886): the stage tail
//   y = r + (x @ w + b) (x the last block's gelu activation [R, 4H], w
//   its down projection, r the residual [R, H]), y sent to the next stage;
// * _gemm_pprecv_kernel (:826, :904): its backward, dr = gy + gwire as
//   the next stage's cotangent lands, then dx = dr @ w^T and dw = x^T @ dr.
//
// The TPU kernels move data with in-kernel remote DMAs; here every hop is
// an NCCL point-to-point pair outside the kernels (pp_boundary.py).
//
// What bounds them on an H100. Row 14 at pp=4, M=8 (R = 2048 rows a
// microbatch, K = 8192, F = 2048): 2*2048*8192*2048 = 68.7 GFLOP, 69.5 us
// at 989 TFLOP/s, against ~84 MB of HBM traffic (25 us) and an 8.39 MB
// hop (18.6 us at 450 GB/s): bound by operations. Row 15: two such GEMMs,
// 137.4 GFLOP, 139 us. So both are built for the tensor cores' rate, on
// the 128 x 256 wgmma tile of rows 7-9 (sm90.cuh's tile256: TMA loads
// through a 4-stage full/empty mbarrier ring from a producer warp, two
// consumer warpgroups running wgmma m64n256k16 from shared memory, fp32
// accumulators):
//
// * pp_gemm_kernel<NN>, row 14, one launch over all R rows: x [R, K]
//   K-major, w [K, F] read MN-major through the descriptor's transpose bit
//   (no transposed copy). 16 x 8 = 128 tiles for 132 SMs, 128 k steps a
//   tile. The epilogue stages the fp32 tile in the drained ring; each
//   warp then reads 16-byte runs of b and r beside it and stores y = r +
//   (acc + b) in fp32 (the reference's association), rounded once to bf16
//   (where the reference rounds after each op), 512 contiguous bytes a
//   row. The wrapper then posts y's hop on NCCL's stream.
// * pp_add_kernel, row 15's first launch: dr = gy + gwire elementwise in
//   fp32 rounded to bf16 (the bits of PyTorch's bf16 add), once the
//   received cotangent has landed. dr is an output and the operand of both
//   products, so it is written once (25 MB, ~8 us).
// * pp_gemm_kernel<NT, TN>, row 15's second launch: both products' tiles
//   in one grid, a block's index picking its product. dx = dr @ w^T (NT:
//   dr [R, F] K-major, w [K, F] K-major as [N, k]; bf16 [R, K], 16 x 32 =
//   512 tiles) first, then dw = x^T @ dr (TN: x [R, K] and dr [R, F] both
//   read MN-major; fp32 [K, F], 64 x 8 = 512 tiles), so dw's tiles fill
//   dx's last partial wave. Each product's contraction (F or R, 32 k steps
//   at the main path's shape) lies in one block; db is a sum of dr outside
//   the kernels. One product alone (timed apart) runs on the same
//   instance with the other product's tile count zero.
//
// Every output element is summed over k in one order whatever rows a
// launch covers (the tile's k loop), so one launch over all rows keeps the
// TPU kernel's property that the fused rung equals the unfused one
// (:805-807). Partial tiles: TMA fills what lies past an operand's edge
// with zeros (contributing nothing), and the epilogue masks its stores;
// rows, columns and contraction are multiples of 16 (16-byte rows for
// TMA). Tiles run with the shorter side of the tile grid fastest, so a
// wave's blocks share the other side's operand panels in L2.
//
// Every mbarrier wait is bounded and leaves sm90.cuh's WaitRecord (row 14
// or 15) before it traps.
//
// Built by paddle_tpu_torch/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (paddle_tpu_torch/ops/pp_boundary.py). The tensor
// maps are encoded per call in the launch function and passed as a
// __grid_constant__ parameter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tile256;

constexpr int kNone = -1;                     // row 14: one product
constexpr int kAddThreads = 256;
constexpr int kErrUnsupported = -1;

// One product of a launch: out [M, N] = A @ B over a contraction of
// k_steps * kBK (zero filled past its end).
struct Product {
  CUtensorMap a;                    // A's map, boxes as load_a<MODE> reads
  CUtensorMap b;                    // B's map, boxes as load_b<MODE> reads
  void* out;                        // bf16 (NN, NT) or fp32 (TN), [M, N]
  const __nv_bfloat16* bias;        // NN: [N]
  const __nv_bfloat16* resid;       // NN: [M, N]
  int M, N, k_steps, tiles_m, tiles_n;
};

struct Launch {
  Product p[2];                     // a product of no tiles takes no block
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Block `id` of product p: its tile's k loop and epilogue.
template <int MODE>
__device__ __forceinline__ void gemm_tile(const Product& p, int id,
                                          uint8_t* smem, uint64_t* bars,
                                          WaitRecord* rec) {
  const uint32_t base = aligned_base(smem);
  uint8_t* const sm = smem + (base - smem_u32(smem));
  const Waiter wt{smem_u32(bars), rec, MODE == kNN ? 14 : 15};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool m_fast = p.tiles_m <= p.tiles_n;
  const int m0 = (m_fast ? id % p.tiles_m : id / p.tiles_n) * kBM;
  const int n0 = (m_fast ? id / p.tiles_m : id % p.tiles_n) * kBN;

  if (threadIdx.x == 0) init_ring(wt);
  __syncthreads();

  if (warp == kConsumers / 32) {                      // the producer
    if (lane == 0)
      produce(wt, base, p.k_steps, [&](uint32_t dst, uint32_t bar, int k) {
        load_a<MODE>(dst, &p.a, bar, m0, k);
        load_b<MODE>(dst, &p.b, bar, n0, k);
      });
    return;
  }

  // a consumer: warpgroup wg owns the tile's rows [64 wg, 64 wg + 64);
  // the epilogue stages the fp32 tile in the drained ring
  const int wg = warpgroup();
  float acc[128];
  consume<MODE>(acc, wt, base, p.k_steps, wg, lane);
  consumers_sync();
  float* tile = reinterpret_cast<float*>(sm);
  stage_tile(acc, tile, wg, warp, lane);
  consumers_sync();

  // each warp stores 16 rows, a row's 256 columns an instruction
  for (int r = 0; r < kBM / 8; ++r) {
    const int row = warp * (kBM / 8) + r;
    const int m = m0 + row;
    if (m >= p.M) break;
    const float* f = tile + row * kTileRow;
    const long long orow = static_cast<long long>(m) * p.N + n0;
    if constexpr (MODE == kTN) {                      // fp32, 4 a lane
      float* o = static_cast<float*>(p.out) + orow;
#pragma unroll
      for (int h = 0; h < kBN / 128; ++h) {
        const int col = 128 * h + 4 * lane;
        if (n0 + col < p.N)
          *reinterpret_cast<float4*>(o + col) =
              *reinterpret_cast<const float4*>(f + col);
      }
    } else {                                          // bf16, 8 a lane
      const int col = 8 * lane;
      if (n0 + col < p.N) {
        float v[8];
        *reinterpret_cast<float4*>(v) =
            *reinterpret_cast<const float4*>(f + col);
        *reinterpret_cast<float4*>(v + 4) =
            *reinterpret_cast<const float4*>(f + col + 4);
        if constexpr (MODE == kNN) {                  // y = r + (acc + b)
          float bb[8], rr[8];
          unpack8(*reinterpret_cast<const uint4*>(p.bias + n0 + col), bb);
          unpack8(*reinterpret_cast<const uint4*>(p.resid + orow + col), rr);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = rr[i] + (v[i] + bb[i]);
        }
        uint4 pk;
        pk.x = pack_bf16(v[0], v[1]);
        pk.y = pack_bf16(v[2], v[3]);
        pk.z = pack_bf16(v[4], v[5]);
        pk.w = pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                                  orow + col) = pk;
      }
    }
  }
}

// One launch: blocks [0, tiles of p[0]) run product p[0] in mode FIRST,
// the rest p[1] in mode SECOND (kNone: p[0] alone).
template <int FIRST, int SECOND>
__global__ void __launch_bounds__(kThreads, 1)
pp_gemm_kernel(const __grid_constant__ Launch l, WaitRecord* rec) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int first = l.p[0].tiles_m * l.p[0].tiles_n;
  if constexpr (SECOND == kNone) {
    gemm_tile<FIRST>(l.p[0], blockIdx.x, smem, bars, rec);
  } else {
    if (static_cast<int>(blockIdx.x) < first)
      gemm_tile<FIRST>(l.p[0], blockIdx.x, smem, bars, rec);
    else
      gemm_tile<SECOND>(l.p[1], blockIdx.x - first, smem, bars, rec);
  }
}

// dr = gy + gwire over n bf16 values, eight (16 bytes) a thread: each sum
// in fp32, rounded once to bf16
__global__ void __launch_bounds__(kAddThreads)
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

// Product of mode `mode` into out [M, N] over a contraction of Kc: a is
// A's storage ([M, Kc] K-major, or [Kc, M] for TN), b B's ([Kc, N], or
// [N, Kc] for NT). 0 or an encode code.
int product(Product* p, int mode, const void* a, const void* b, void* out,
            int M, int N, int Kc) {
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int rc = mode == kTN ? encode_2d(&p->a, bf16, 2, a, Kc, M, 64, kBK)
                       : encode_2d(&p->a, bf16, 2, a, M, Kc, 64, kBM);
  if (rc) return rc;
  rc = mode == kNT ? encode_2d(&p->b, bf16, 2, b, N, Kc, 64, kBN)
                   : encode_2d(&p->b, bf16, 2, b, Kc, N, 64, kBK);
  if (rc) return rc;
  p->out = out;
  p->bias = nullptr;
  p->resid = nullptr;
  p->M = M;
  p->N = N;
  p->k_steps = (Kc + kBK - 1) / kBK;
  p->tiles_m = (M + kBM - 1) / kBM;
  p->tiles_n = (N + kBN - 1) / kBN;
  return 0;
}

int tiles(const Product& p) { return p.tiles_m * p.tiles_n; }

template <int FIRST, int SECOND>
int launch(const Launch& l, int blocks, cudaStream_t stream) {
  auto kernel = pp_gemm_kernel<FIRST, SECOND>;
  static unsigned ready = 0;
  cudaError_t err = allow_smem(kernel, kSmemBytes, &ready);
  if (err != cudaSuccess) return err;
  WaitRecord* rec = nullptr;
  if ((err = record(&rec)) != cudaSuccess) return err;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(l, rec);
  return cudaGetLastError();
}

bool shape_ok(int R, int K, int F) {
  return R > 0 && K > 0 && F > 0 && R % 16 == 0 && K % 16 == 0 &&
         F % 16 == 0;
}

}  // namespace

// Row 14: y [R, F] = resid + (x @ w + bias) stored bf16, one launch on
// `stream`; x [R, K], w [K, F], resid [R, F] and y contiguous, bias [F];
// all bf16, 16-byte aligned; R, K, F multiples of 16. Returns 0, a
// cudaError_t code, or a negative code of pp_gemm_error_string.
extern "C" int pp_send_gemm_launch(const void* x, const void* w,
                                   const void* bias, const void* resid,
                                   void* y, int R, int K, int F,
                                   void* stream) {
  if (!shape_ok(R, K, F) || !x || !w || !bias || !resid || !y)
    return kErrUnsupported;
  Launch l = {};
  int rc = product(&l.p[0], kNN, x, w, y, R, F, K);
  if (rc) return rc;
  l.p[0].bias = static_cast<const __nv_bfloat16*>(bias);
  l.p[0].resid = static_cast<const __nv_bfloat16*>(resid);
  return launch<kNN, kNone>(l, tiles(l.p[0]),
                            static_cast<cudaStream_t>(stream));
}

// Row 15's products, one launch on `stream`: dx [R, K] = dr @ w^T (bf16)
// when which & 1, dw [K, F] = x^T @ dr (fp32) when which & 2 (3 on the
// main path; 1 or 2 time a product alone). dr [R, F], x [R, K],
// w [K, F], bf16, contiguous, 16-byte aligned; R, K, F multiples of 16.
// Returns as pp_send_gemm_launch.
extern "C" int pp_recv_gemm_launch(const void* dr, const void* x,
                                   const void* w, void* dx, void* dw, int R,
                                   int K, int F, int which, void* stream) {
  if (!shape_ok(R, K, F) || which < 1 || which > 3 || !dr || !x || !w ||
      ((which & 1) && !dx) || ((which & 2) && !dw))
    return kErrUnsupported;
  // a product not selected keeps no tiles: dw alone starts at block 0
  Launch l = {};
  int rc;
  if (((which & 1) && (rc = product(&l.p[0], kNT, dr, w, dx, R, K, F))) ||
      ((which & 2) && (rc = product(&l.p[1], kTN, x, dr, dw, K, F, R))))
    return rc;
  return launch<kNT, kTN>(l, tiles(l.p[0]) + tiles(l.p[1]),
                          static_cast<cudaStream_t>(stream));
}

// Row 15's elementwise part: out[n] = a + b, bf16, n a multiple of 8,
// every pointer 16-byte aligned (out may be a or b).
extern "C" int pp_add_launch(const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  if (n % 8) return kErrUnsupported;
  const long long n8 = n / 8;
  const long long want = (n8 + kAddThreads - 1) / kAddThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  pp_add_kernel<<<blocks, kAddThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<uint4*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}

// The mbarrier timeout record's 8 ints (code, row, block x, block y, warp,
// barrier, parity, step); all zero when no wait has timed out.
extern "C" void pp_gemm_wait_record(int* out) {
  const volatile int* r = reinterpret_cast<const volatile int*>(g_host_record);
  for (int i = 0; i < 8; ++i) out[i] = r ? r[i] : 0;
}

extern "C" const char* pp_gemm_error_string(int code) {
  switch (code) {
    case kErrUnsupported:
      return "unsupported shape, selection or missing operand";
    case kErrEntryPoint:
      return "cuTensorMapEncodeTiled not found through "
             "cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
