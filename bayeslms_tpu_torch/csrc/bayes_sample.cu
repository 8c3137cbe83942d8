// Gaussian weight sampler for the Bayesian LSTM's gate slices, for sm_90a.
//
// Replaces bayeslms_tpu/ops/bayes_matmul.py `sample_weights` (the
// `_sample_kernel` body that it hands to pallas_call; public entry
// `sample_noise`). For a float32 (N, K) lgstd and an optional float32 mean:
//   out = mean + exp(lgstd) * eps,   eps ~ N(0, 1)
// with eps drawn by Box-Muller from two 24-bit uniforms, exactly the TPU
// kernel's arithmetic (`_normal_bits`):
//   u1 = (w1 >> 8) * 2^-24 + 1e-12,  u2 = (w2 >> 8) * 2^-24,
//   eps = sqrt(-2 log u1) * cos(2 pi u2).
//
// The generator. The TPU seeds its on-core generator with seed + j for the
// 128-row weight tile j, so a tile's noise can be drawn again from the seed
// alone. Hopper has no such generator; this kernel runs a counter-based one
// written here, Philox4x32-10 (Salmon et al., SC'11), keyed by
// (seed + tile, 0) in uint32 arithmetic (the sum wraps, as the TPU's int32
// sum does) and counted by the element's offset in its tile: element e of
// tile j takes the words (x0, x1) of Philox(key, ctr = e / 2) when e is even
// and (x2, x3) when it is odd. So eps depends on (seed, tile, offset) only,
// never on the launch shape, and one Philox call serves two elements. The
// bits are not the TPU's: the port's plain twin
// (ops/bayes_sample_cuda.py `sample_weights_plain`) computes the same
// integers with torch int64 ops, and its uniforms equal this kernel's bit
// for bit.
//
// No fast-math: logf, cosf, expf and sqrtf are the accurate library
// versions, and the products and sums are __fmul_rn / __fadd_rn, so that
// nvcc contracts nothing into an FMA that the plain twin does not do.
//
// Bound on the H100: memory. Each element reads its lgstd (and mean) and
// writes its sample, 8 bytes an element without a mean: 8 MiB for a
// (1,024, 1,024) slice, 2.5 us at 3.35 TB/s. Philox-10 is ~20 integer
// multiplies per pair, far below the card's integer rate at that size. The
// design: one thread per pair of elements, float2 loads and stores (the
// pair never straddles a tile, whose 128 K elements are an even count), a
// grid-stride loop. It keeps no state between launches and needs no
// scratch.
//
// Compile-time faults for chip_smoke.py's planted-fault checks (never set
// by the port): BAYES_SAMPLE_FAULT=1 drops the tile index from the key,
// =2 drops u1's 1e-12 offset, =3 takes a 23-bit u1 (w1 >> 9).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BAYES_SAMPLE_FAULT
#define BAYES_SAMPLE_FAULT 0
#endif

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;
constexpr int THREADS = 256;
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

__device__ __forceinline__ float sample(const float* mean, long long e,
                                        float lg, float eps) {
  const float d = __fmul_rn(expf(lg), eps);
  return mean ? __fadd_rn(mean[e], d) : d;
}

// pairs = N K / 2; tile_pairs = 128 K / 2. uni, when not null, receives
// (u1, u2) of every element: (N, K, 2) float32.
__global__ void __launch_bounds__(THREADS)
bayes_sample_kernel(const int* __restrict__ seed,
                    const float* __restrict__ mean,
                    const float* __restrict__ lgstd, float* __restrict__ out,
                    float* __restrict__ uni, long long pairs,
                    long long tile_pairs) {
  const uint32_t s = static_cast<uint32_t>(seed[0]);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       p < pairs; p += stride) {
    const long long tile = p / tile_pairs;
    const uint32_t ctr = static_cast<uint32_t>(p - tile * tile_pairs);
#if BAYES_SAMPLE_FAULT == 1
    const uint32_t key = s;
#else
    const uint32_t key = s + static_cast<uint32_t>(tile);
#endif
    const uint4 x = philox4x32_10(ctr, key, 0u);
    const float2 ua = uniforms(x.x, x.y);
    const float2 ub = uniforms(x.z, x.w);
    const float2 lg = reinterpret_cast<const float2*>(lgstd)[p];
    float2 o;
    o.x = sample(mean, 2 * p, lg.x, box_muller(ua));
    o.y = sample(mean, 2 * p + 1, lg.y, box_muller(ub));
    reinterpret_cast<float2*>(out)[p] = o;
    if (uni) {
      reinterpret_cast<float4*>(uni)[p] = make_float4(ua.x, ua.y, ub.x, ub.y);
    }
  }
}

}  // namespace

// seed: device int32 (1,); mean (N, K) fp32 or null (zero mean); lgstd,
// out (N, K) fp32; uni (N, K, 2) fp32 or null. n = N K must be even and the
// float arrays 8-byte aligned (16 for uni). Returns the launch error, or 0.
extern "C" int bayes_sample(const void* seed, const void* mean,
                            const void* lgstd, void* out, void* uni,
                            long long n, int K, void* stream) {
  if (n == 0) return 0;
  const long long pairs = n / 2;
  const long long tile_pairs = static_cast<long long>(TILE_ROWS) * K / 2;
  long long blocks = (pairs + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bayes_sample_kernel<<<static_cast<int>(blocks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<const float*>(mean),
      static_cast<const float*>(lgstd), static_cast<float*>(out),
      static_cast<float*>(uni), pairs, tile_pairs);
  return static_cast<int>(cudaGetLastError());
}
