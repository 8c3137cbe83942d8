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
// The generator and the Box-Muller arithmetic are in bayes_philox.cuh,
// shared with csrc/bayes_matmul.cu (kernel row 12), whose backward draws
// its forward's weights again with this kernel: the header says how eps
// depends on (seed, tile, offset) and why nothing is contracted into an
// FMA. The port's plain twin (ops/bayes_sample_cuda.py
// `sample_weights_plain`) computes the same integers with torch int64 ops,
// and its uniforms equal this kernel's bit for bit.
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
// The planted faults of chip_smoke.py (BAYES_SAMPLE_FAULT=1..3) are defined
// in the header.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"

namespace {

using namespace bayes_philox;

constexpr int THREADS = 256;

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
    float2 ua, ub;
    pair_uniforms(s, p, tile_pairs, &ua, &ub);
    const float2 lg = reinterpret_cast<const float2*>(lgstd)[p];
    const bool hm = mean != nullptr;
    float2 o;
    o.x = weight(hm, hm ? mean[2 * p] : 0.f, lg.x, box_muller(ua));
    o.y = weight(hm, hm ? mean[2 * p + 1] : 0.f, lg.y, box_muller(ub));
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
