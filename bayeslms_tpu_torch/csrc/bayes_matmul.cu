// Fused Gaussian sample-and-matmul forward, for sm_90a.
//
// Replaces bayeslms_tpu/ops/bayes_matmul.py `bayes_matmul`'s forward (the
// `_matmul_kernel` body that `_fwd_run` hands to pallas_call):
//   y (M, N) = x (M, K) . W^T,  W = mean + exp(lgstd) * eps  (N, K)
// in fp32 (x converted from its dtype, W and the dot in fp32, as the TPU
// kernel's dot), y in x's dtype. W is generated tile by tile from mean,
// lgstd and the seed and never reaches device memory. Its eps comes from
// bayes_philox.cuh, the generator of csrc/bayes_sample.cu (kernel row 13):
// the key is seed + the 128-row weight tile, the counter the element's
// offset in the tile, so every W this kernel multiplies equals the
// sampler's `sample_weights(mean, lgstd, seed)` bit for bit, and the
// backward (ops/bayes_matmul_cuda.py) draws it again with the sampler.
//
// Design: a block owns a 128 x 64 tile of y (64 weight rows: half a
// 128-row weight tile, so one key) and 256 threads, each an 8 x 4 patch in
// fp32 registers. It walks K in chunks of 16: it loads the x chunk into
// shared memory (transposed, fp32), generates the 64 x 16 W chunk there
// (one Philox call per pair of neighbouring K elements, two pairs a
// thread) and accumulates on the CUDA cores. Every block of a column of
// blocks generates its 64 weight rows again, as the TPU's (i, j) grid does.
//
// Bound on the H100 at the Bayesian FFN's linear2 (M = 3,200, K = 4,096,
// N = 512): 2 M N K = 13.4 GFLOP in fp32, 0.20 ms at the 67 TFLOP/s fp32
// peak, against 26 MB of x (bf16), mean and lgstd (fp32) and y: operations
// bound. The weight generation adds M / 128 = 25 draws of every weight
// (~25 x 2 M Philox-10 calls and Box-Mullers), of the order of the
// products; TF32 or bf16 tensor cores and a draw shared by the blocks of
// a column are the later redesign.
//
// The planted faults of chip_smoke.py (BAYES_SAMPLE_FAULT=1..3) are defined
// in the shared header and change this kernel's noise as the sampler's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace bayes_philox;

constexpr int BM = 128;  // rows of y (tokens) per block
constexpr int BN = 64;   // weight rows per block
constexpr int BK = 16;   // contraction chunk
constexpr int THREADS = 256;
constexpr int XP = BM + 4;  // fp32 pitch of the transposed x chunk
constexpr int WP = BN + 4;  // fp32 pitch of the transposed W chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// grid = (ceil(M / BM), N / BN); N a multiple of 128, K of 16.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bayes_matmul_kernel(const int* __restrict__ seed, const T* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ lgstd, T* __restrict__ y,
                    int M, int N, int K) {
  __shared__ __align__(16) float Xs[BK * XP];  // [k][m]
  __shared__ __align__(16) float Ws[BK * WP];  // [k][n]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tr = tid >> 4, tc = tid & 15;  // rows 8 tr .. +8, cols 4 tc .. +4
  const uint32_t s = static_cast<uint32_t>(seed[0]);
  const long long tile_pairs = static_cast<long long>(TILE_ROWS) * K / 2;

  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx - (idx / BK) * BK;
      const int m = m0 + r;
      Xs[kk * XP + r] =
          m < M ? to_f(x[static_cast<long long>(m) * K + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / 2 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int nl = idx / (BK / 2), kp = idx - (idx / (BK / 2)) * (BK / 2);
      const int kk = 2 * kp;
      const long long e = static_cast<long long>(n0 + nl) * K + k0 + kk;
      float2 ua, ub;
      pair_uniforms(s, e / 2, tile_pairs, &ua, &ub);
      const float2 mu = *reinterpret_cast<const float2*>(mean + e);
      const float2 lg = *reinterpret_cast<const float2*>(lgstd + e);
      Ws[kk * WP + nl] = weight(true, mu.x, lg.x, box_muller(ua));
      Ws[(kk + 1) * WP + nl] = weight(true, mu.y, lg.y, box_muller(ub));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk * XP + 8 * tr]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Xs[kk * XP + 8 * tr + 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk * WP + 4 * tc]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += av[a] * wv[c];
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int m = m0 + 8 * tr + a;
    if (m >= M) continue;
    T* yr = y + static_cast<long long>(m) * N + n0 + 4 * tc;
#pragma unroll
    for (int c = 0; c < 4; ++c) from_f(&yr[c], acc[a][c]);
  }
}

}  // namespace

// seed: device int32 (1,); x (M, K) bf16 (is_bf16 = 1) or fp32; mean,
// lgstd (N, K) fp32; y (M, N) of x's type; all contiguous. N a multiple of
// 128, K of 16. Returns the launch error, or 0.
extern "C" int bayes_matmul(const void* seed, const void* x, const void* mean,
                            const void* lgstd, void* y, int M, int N, int K,
                            int is_bf16, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (N % TILE_ROWS || K % BK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + BM - 1) / BM, N / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sd = static_cast<const int*>(seed);
  const float* mu = static_cast<const float*>(mean);
  const float* lg = static_cast<const float*>(lgstd);
  if (is_bf16) {
    bayes_matmul_kernel<bf16><<<grid, THREADS, 0, st>>>(
        sd, static_cast<const bf16*>(x), mu, lg, static_cast<bf16*>(y), M, N,
        K);
  } else {
    bayes_matmul_kernel<float><<<grid, THREADS, 0, st>>>(
        sd, static_cast<const float*>(x), mu, lg, static_cast<float*>(y), M,
        N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
