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
// One launch draws a whole table of slices (up to MAX_SLICES): a training
// step of the Bayesian LSTM hands it every admitted gate slice at once
// (four (1,024, 1,024) slices at l_bayes_pos 3 with both layers), each
// with its own seed, read from one device int32 tensor that the step draws
// with one `torch.randint`. A slice is the one-slice table's draw under its
// seed, bit for bit: eps depends on (seed, tile, offset) alone.
//
// Bound on the H100: each element reads its lgstd (and mean) and writes
// its sample, 8 bytes an element without a mean: 33.6 MB for four (1,024,
// 1,024) slices, 10.0 us at 3.35 TB/s. But an element also issues half a
// Philox4x32-10 call and the accurate logf, cosf, expf and sqrtf, so the
// instruction issue may bound it instead: PERF.md (row 13) has the SASS
// count of this kernel and the issue bound it gives. The design: one
// thread per four elements (two Philox calls) with 16-byte loads and
// stores, a grid-stride loop over the slices' whole quads in table order;
// a slice whose N K % 4 == 2 ends in one pair, drawn after the loop by a
// thread of the first block, so that the loop's body is the one path every
// quad takes. A one-slice table (`sample_weights`, row 12's backward redraw
// of its forward's W) takes the kernel's ONE instantiation, which reads its
// seed once and searches no table. It keeps no state between launches and
// needs no scratch.
//
// The planted faults of chip_smoke.py (BAYES_SAMPLE_FAULT=1..3) are defined
// in the header.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"

namespace {

using namespace bayes_philox;

constexpr int THREADS = 256;
constexpr int MAX_SLICES = 8;

struct Slice {
  const float* lgstd;  // (N, K)
  const float* mean;   // (N, K) or null (zero mean)
  float* out;          // (N, K)
  float* uni;          // (N, K, 2) or null: each element's (u1, u2)
  long long n;         // N K, even
  long long tile_pairs;  // 128 K / 2: the element pairs of a 128-row tile
  long long first;       // the slice's first quad in the table's walk
  int seed;              // its seed's index in the seed tensor
};

struct SliceTable {
  Slice s[MAX_SLICES];
  int count;
  long long quads;  // every slice's whole quads: sum of floor(n / 4)
};

__device__ __forceinline__ float4 weights4(bool hm, float4 mn, float4 lg,
                                           const float2* u) {
  float4 o;
  o.x = weight(hm, mn.x, lg.x, box_muller(u[0]));
  o.y = weight(hm, mn.y, lg.y, box_muller(u[1]));
  o.z = weight(hm, mn.z, lg.z, box_muller(u[2]));
  o.w = weight(hm, mn.w, lg.w, box_muller(u[3]));
  return o;
}

__device__ __forceinline__ void pair_weights(uint32_t s, const Slice& sl,
                                             long long e) {
  float2 ua, ub;
  pair_uniforms(s, e / 2, sl.tile_pairs, &ua, &ub);
  const bool hm = sl.mean != nullptr;
  const float2 lg = *reinterpret_cast<const float2*>(sl.lgstd + e);
  float2 o;
  o.x = weight(hm, hm ? sl.mean[e] : 0.f, lg.x, box_muller(ua));
  o.y = weight(hm, hm ? sl.mean[e + 1] : 0.f, lg.y, box_muller(ub));
  *reinterpret_cast<float2*>(sl.out + e) = o;
  if (sl.uni)
    *reinterpret_cast<float4*>(sl.uni + 2 * e) =
        make_float4(ua.x, ua.y, ub.x, ub.y);
}

// ONE: the table holds one slice (its seed read once, no slice search)
template <bool ONE>
__global__ void __launch_bounds__(THREADS)
bayes_sample_kernel(const int* __restrict__ seeds,
                    const __grid_constant__ SliceTable tab) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const uint32_t s0 = ONE ? static_cast<uint32_t>(seeds[tab.s[0].seed]) : 0u;
  for (long long q = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       q < tab.quads; q += stride) {
    int i = 0;  // the quad's slice: the last whose first quad is <= q
    if (!ONE) {
#pragma unroll
      for (int k = 1; k < MAX_SLICES; ++k)
        if (k < tab.count && q >= tab.s[k].first) i = k;
    }
    const Slice& sl = tab.s[i];
    const uint32_t s = ONE ? s0 : static_cast<uint32_t>(seeds[sl.seed]);
    const long long e = 4 * (q - sl.first);  // the quad's first element
    const bool hm = sl.mean != nullptr;
    float2 u[4];
    pair_uniforms(s, e / 2, sl.tile_pairs, &u[0], &u[1]);
    pair_uniforms(s, e / 2 + 1, sl.tile_pairs, &u[2], &u[3]);
    const float4 lg = *reinterpret_cast<const float4*>(sl.lgstd + e);
    const float4 mn = hm ? *reinterpret_cast<const float4*>(sl.mean + e)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sl.out + e) = weights4(hm, mn, lg, u);
    if (sl.uni) {
      float4* w = reinterpret_cast<float4*>(sl.uni + 2 * e);
      w[0] = make_float4(u[0].x, u[0].y, u[1].x, u[1].y);
      w[1] = make_float4(u[2].x, u[2].y, u[3].x, u[3].y);
    }
  }
  // the last pair of each slice whose N K % 4 == 2, a thread each
  if (blockIdx.x == 0 && threadIdx.x < tab.count) {
    const Slice& sl = tab.s[threadIdx.x];
    if (sl.n % 4 != 0)
      pair_weights(static_cast<uint32_t>(seeds[sl.seed]), sl, sl.n - 2);
  }
}

}  // namespace

// Draws `count` slices (at most 8) in one launch. seeds: device int32 (S,);
// for slice i: lgstd[i], out[i] (n[i] = N K elements) fp32, mean[i] fp32 or
// null (zero mean), uni[i] (N K, 2) fp32 or null, K[i] its columns,
// seed[i] the index of its seed. n[i] must be even and the float arrays
// 16-byte aligned. Returns the launch error, or 0.
extern "C" int bayes_sample_slices(const void* seeds, int count,
                                   const void* const* lgstd,
                                   const void* const* mean,
                                   void* const* out, void* const* uni,
                                   const long long* n, const int* K,
                                   const int* seed, void* stream) {
  if (count < 0 || count > MAX_SLICES) return (int)cudaErrorInvalidValue;
  SliceTable tab = {};
  long long quads = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0 || n[i] % 2 != 0 || K[i] <= 0)
      return (int)cudaErrorInvalidValue;
    Slice& sl = tab.s[i];
    sl.lgstd = static_cast<const float*>(lgstd[i]);
    sl.mean = static_cast<const float*>(mean[i]);
    sl.out = static_cast<float*>(out[i]);
    sl.uni = static_cast<float*>(uni[i]);
    sl.n = n[i];
    sl.tile_pairs = static_cast<long long>(TILE_ROWS) * K[i] / 2;
    sl.first = quads;
    sl.seed = seed[i];
    quads += n[i] / 4;
  }
  tab.count = count;
  tab.quads = quads;
  if (count == 0) return 0;
  long long blocks = (quads + THREADS - 1) / THREADS;
  if (blocks == 0) blocks = 1;  // the slices' last pairs
  if (blocks > 132 * 16) blocks = 132 * 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seeds);
  if (count == 1)
    bayes_sample_kernel<true><<<static_cast<int>(blocks), THREADS, 0, st>>>(
        sd, tab);
  else
    bayes_sample_kernel<false><<<static_cast<int>(blocks), THREADS, 0, st>>>(
        sd, tab);
  return static_cast<int>(cudaGetLastError());
}
