// Flash attention's dropout keep bits on the device: Philox4x32-10, the
// counterpart of dropout_keep (paddle_tpu/ops/pallas_kernels/
// flash_attention_bwd.py:40-54) and the device side of
// paddle_tpu_torch/ops/philox.py, whose plain version gives the same bits.
//
// A keep bit is a function of (key, b, h, i, j) only, never of a tile, so
// the forward, dQ and dK/dV kernels, which tile the (query, key) plane
// differently, regenerate the same mask:
//
//   words = Philox4x32-10((j >> 1, i >> 1, b*H + h, 0), (k0, k1))
//   keep(i, j) = words[2 * (i & 1) + (j & 1)] >= thr,  thr = floor(p 2^32)
//
// One Philox call covers a 2 x 2 block of (query i, key j). A wgmma
// m64nN accumulator fragment gives lane (g = lane / 4, t = lane % 4) of
// warp w rows 16 w + g and 16 w + g + 8 and columns 8 n + 2 t, + 1: the
// row pair (r, r ^ 1) of a block lies in lanes g and g ^ 1 (lane ^ 4), the
// column pair in one lane. keep4 lets each of those two lanes run one of
// the two calls its row slots need and trade half of the words by one
// shuffle each way, so a fragment of 4 elements costs half a call.
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// Philox4x32-10 of the counter (c0, c1, c2, 0) under the key (k0, k1)
__device__ __forceinline__ uint4 philox4x32(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t k0,
                                            uint32_t k1) {
  uint32_t x0 = c0, x1 = c1, x2 = c2, x3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * x0, hi0 = __umulhi(kM0, x0);
    const uint32_t lo1 = kM1 * x2, hi1 = __umulhi(kM1, x2);
    const uint32_t y0 = hi1 ^ x1 ^ k0, y2 = hi0 ^ x3 ^ k1;
    x0 = y0;
    x1 = lo1;
    x2 = y2;
    x3 = lo0;
  }
  return make_uint4(x0, x1, x2, x3);
}

// The dropout of one flash call: the key, the threshold and 1 / (1 - p).
struct Dropout {
  uint32_t k0, k1, thr;
  float inv_keep;
};

// Keep bits of the four elements of one n-block of this thread's wgmma
// fragment: bit e is element e = 2 * slot + c, at fragment row m0 + 8 slot
// (m0 the absolute index of this lane's first row) and column n0 + c (n0 =
// 8 n + 2 t, absolute). kQOnM: the fragment's rows are queries (forward,
// dQ); else keys (dK/dV: S^T). Every lane of the warp must call it.
template <bool kQOnM>
__device__ __forceinline__ uint32_t keep4(const Dropout& d, uint32_t bh,
                                          uint32_t m0, uint32_t n0) {
  const uint32_t p = m0 & 1;              // this lane's row parity
  const uint32_t m = m0 + 8 * p;          // the slot whose call it runs
  const uint4 x = kQOnM ? philox4x32(n0 >> 1, m >> 1, bh, d.k0, d.k1)
                        : philox4x32(m >> 1, n0 >> 1, bh, d.k0, d.k1);
  // word of row parity r and column c: 2 r + c (rows are queries) or
  // 2 c + r (rows are keys)
  auto word = [&](uint32_t r, uint32_t c) {
    const uint32_t w = kQOnM ? 2 * r + c : 2 * c + r;
    return w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
  };
  // the partner lane (row parity 1 - p) needs this call's words of its
  // parity, and ran the other slot's call, whose words of parity p come
  // back
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, word(1 - p, 0), 4);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, word(1 - p, 1), 4);
  const uint32_t own0 = word(p, 0), own1 = word(p, 1);
  const uint32_t s0c0 = p ? got0 : own0, s0c1 = p ? got1 : own1;
  const uint32_t s1c0 = p ? own0 : got0, s1c1 = p ? own1 : got1;
  return (s0c0 >= d.thr ? 1u : 0u) | (s0c1 >= d.thr ? 2u : 0u) |
         (s1c0 >= d.thr ? 4u : 0u) | (s1c1 >= d.thr ? 8u : 0u);
}

}  // namespace philox
