// The Gaussian weight noise of the port's Bayesian kernels, one definition
// for both: csrc/bayes_sample.cu (the sampler, kernel row 13) and
// csrc/bayes_matmul.cu (the fused sample-and-matmul, kernel row 12). A
// weight tile drawn by either is the same, bit for bit, so the matmul's
// backward can draw its forward's weights again with the sampler.
//
// The TPU seeds its on-core generator with seed + j for the 128-row weight
// tile j (bayeslms_tpu/ops/bayes_matmul.py `_sample_tile`), so a tile's
// noise can be drawn again from the seed alone. Hopper has no such
// generator; this header runs a counter-based one, Philox4x32-10 (Salmon et
// al., SC'11), keyed by (seed + tile, 0) in uint32 arithmetic (the sum
// wraps, as the TPU's int32 sum does) and counted by the element's offset in
// its tile: element e of tile j takes the words (x0, x1) of
// Philox(key, ctr = e / 2) when e is even and (x2, x3) when it is odd. So eps
// depends on (seed, tile, offset) only, never on the launch shape, and one
// Philox call serves two elements. eps comes by Box-Muller from two 24-bit
// uniforms, exactly the TPU kernel's arithmetic (`_normal_bits`):
//   u1 = (w1 >> 8) * 2^-24 + 1e-12,  u2 = (w2 >> 8) * 2^-24,
//   eps = sqrt(-2 log u1) * cos(2 pi u2),
// and a weight is mean + exp(lgstd) * eps. The bits are not the TPU's: the
// plain twin (ops/bayes_sample_cuda.py `uniforms_plain`) computes the same
// integers with torch int64 ops, and its uniforms equal these bit for bit.
//
// No fast-math: logf, cosf, expf and sqrtf are the accurate library
// versions, and the products and sums are __fmul_rn / __fadd_rn, so that
// nvcc contracts nothing into an FMA that the plain twin does not do.
//
// Compile-time faults for chip_smoke.py's planted-fault checks (never set
// by the port), seen by every kernel that includes this header:
// BAYES_SAMPLE_FAULT=1 drops the tile index from the key, =2 drops u1's
// 1e-12 offset, =3 takes a 23-bit u1 (w1 >> 9).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BAYES_SAMPLE_FAULT
#define BAYES_SAMPLE_FAULT 0
#endif

namespace bayes_philox {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr int TILE_ROWS = 128;  // the TPU kernel's weight tile

__device__ __forceinline__ uint4 philox4x32_10(uint32_t ctr, uint32_t k0,
                                                uint32_t k1) {
  uint32_t c0 = ctr, c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t lo0 = PHILOX_M0 * c0, hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo1 = PHILOX_M1 * c2, hi1 = __umulhi(PHILOX_M1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// the key of weight tile `tile` under `seed`
__device__ __forceinline__ uint32_t tile_key(uint32_t seed, long long tile) {
#if BAYES_SAMPLE_FAULT == 1
  (void)tile;
  return seed;
#else
  return seed + static_cast<uint32_t>(tile);
#endif
}

// the two uniforms of one element from its two words
__device__ __forceinline__ float2 uniforms(uint32_t w1, uint32_t w2) {
  const float scale = 5.9604644775390625e-8f;  // 2^-24
#if BAYES_SAMPLE_FAULT == 3
  const uint32_t b1 = w1 >> 9;
#else
  const uint32_t b1 = w1 >> 8;
#endif
  const uint32_t b2 = w2 >> 8;
#if BAYES_SAMPLE_FAULT == 2
  const float u1 = __fmul_rn(__uint2float_rn(b1), scale);
#else
  const float u1 = __fadd_rn(__fmul_rn(__uint2float_rn(b1), scale), 1e-12f);
#endif
  const float u2 = __fmul_rn(__uint2float_rn(b2), scale);
  return make_float2(u1, u2);
}

__device__ __forceinline__ float box_muller(float2 u) {
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u.x)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831855f, u.y)));
}

// mean + exp(lgstd) * eps, or exp(lgstd) * eps without a mean
__device__ __forceinline__ float weight(bool has_mean, float mean, float lg,
                                        float eps) {
  const float d = __fmul_rn(expf(lg), eps);
  return has_mean ? __fadd_rn(mean, d) : d;
}

// The uniforms of the element pair (2 p, 2 p + 1) of a weight matrix whose
// 128-row tiles hold tile_pairs = 128 K / 2 pairs each: ua for the even
// element, ub for the odd one.
__device__ __forceinline__ void pair_uniforms(uint32_t seed, long long p,
                                              long long tile_pairs,
                                              float2* ua, float2* ub) {
  const long long tile = p / tile_pairs;
  const uint32_t ctr = static_cast<uint32_t>(p - tile * tile_pairs);
  const uint4 x = philox4x32_10(ctr, tile_key(seed, tile), 0u);
  *ua = uniforms(x.x, x.y);
  *ub = uniforms(x.z, x.w);
}

}  // namespace bayes_philox
