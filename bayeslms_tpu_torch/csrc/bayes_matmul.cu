// Fused Gaussian sample-and-matmul forward, for sm_90a.
//
// Replaces bayeslms_tpu/ops/bayes_matmul.py `bayes_matmul`'s forward (the
// `_matmul_kernel` body that `_fwd_run` hands to pallas_call):
//   y (M, N) = x (M, K) . W^T,  W = mean + exp(lgstd) * eps  (N, K)
// in fp32 (x converted from its dtype, W and the dot in fp32, as the TPU
// kernel's dot), y in x's dtype. W is generated from mean, lgstd and the
// seed ("simt": tile by tile, never in device memory; "split": once a
// call, as three bf16 pieces). Its eps comes from
// bayes_philox.cuh, the generator of csrc/bayes_sample.cu (kernel row 13):
// the key is seed + the 128-row weight tile, the counter the element's
// offset in the tile, so every W this kernel multiplies equals the
// sampler's `sample_weights(mean, lgstd, seed)` bit for bit, and the
// backward (ops/bayes_matmul_cuda.py) draws it again with the sampler.
//
// Two designs, picked by ops/bayes_matmul_cuda.py `_design(dtype, M, N, K)`
// (an explicit rule: the chosen design runs or raises).
//
// "split" (bf16 x: the Bayesian FFN's linear2 and the MHA's o_net), two
// launches a call.
//   (1) `bmm_draw_split` draws W once, with the stream above (the same key
//       and counter as the sampler, so the same W bit for bit), and writes
//       it as three bf16 pieces, W1 = bf16(W), W2 = bf16(W - W1),
//       W3 = bf16(W - W1 - W2), each (N, K): W = W1 + W2 + W3 exactly, since
//       each rounding leaves a remainder of at most 16, then 8, significant
//       bits and bf16 has fp32's exponent range. 12.6 MB at the FFN shape,
//       under L2's 50 MB; mean and lgstd (16.8 MB) are read once.
//   (2) `bmm_split_wgmma`: y = x W1^T + x W2^T + x W3^T on the tensor cores.
//       A bf16 x times a bf16 piece is exact in fp32, so the sum differs
//       from the fp32 dot only in the order and rounding of fp32 sums. A
//       CTA owns a 128 x 104 tile of y: two consumer warpgroups of 64 rows
//       and a producer warp that issues every operand load by TMA (128-byte
//       swizzle, mbarrier completion) into a ring of four 55 KB stages (a
//       64-deep chunk of x's 128 rows and of the three pieces' 104 rows).
//       Each chunk's product is one chain of twelve m64n104k16 steps from
//       zero, the pieces smallest first (W3, W2, W1), added in fp32
//       registers to nearest into the running sum (the tensor cores' own
//       fp32 sums truncate: rows 9-11's arithmetic, csrc/ce_train.cu
//       `score_tile`); y is rounded once to bf16. The three pieces share
//       that one truncating chain within a chunk, where a chain from zero
//       for each piece, added in registers, would round each piece's sum
//       to nearest: the chain adds at most a few units in the last place
//       of a chunk's fp32 sum (12 truncating adds of 64-deep sums), far
//       below y's bf16 rounding (2^-8 relative), and a second and third
//       accumulator (52 registers each) would not fit beside the running
//       sum at 240 registers. Measured (chip_smoke.py, NVIDIA H100 80GB
//       HBM3, 700.00 W): worst shares of its tolerance 0.935-0.952, the
//       CUDA-core fp32 design's 0.949-0.966 on the same calls. 104 columns
//       make the grid
//       5 x 25 = 125 CTAs at M = 3,200, N = 512, 0.95 of a wave on 132 SMs,
//       at the FFN's K = 4,096 and the MHA's K = 512 alike (128-column tiles
//       would be 100 CTAs, 0.76 of a wave).
// "simt" (fp32 x), `bayes_matmul_kernel`: a block owns a 128 x 64 tile of y
// (64 weight rows: half a 128-row weight tile, so one key) and 256 threads,
// each an 8 x 4 patch in fp32 registers. It walks K in chunks of 16: it
// loads the x chunk into shared memory (transposed, fp32), generates the
// 64 x 16 W chunk there (one Philox call per pair of neighbouring K
// elements, two pairs a thread) and accumulates on the CUDA cores. Every
// block of a column of blocks generates its 64 weight rows again, as the
// TPU's (i, j) grid does: M / 128 draws of every weight.
//
// Bound on the H100 at the Bayesian FFN's linear2 (M = 3,200, K = 4,096,
// N = 512), against 26 MB of x (bf16), mean and lgstd (fp32) and y (8 us
// at 3.35 TB/s): "simt", 2 M N K = 13.4 GFLOP in fp32, 0.200 ms at the 67
// TFLOP/s fp32 peak; "split", the same fp32-accurate function as three
// bf16 products, 3 x 2 M N K = 40.3 GFLOP, 0.041 ms at the 989 TFLOP/s
// bf16 peak. Both operations bound. Measured on an NVIDIA H100 80GB HBM3
// at 700.00 W (PERF.md, kernel table, row 12): chip_smoke.py "split" 0.137
// ms a call, "simt" 1.118 on the same call (the library's randn + exp +
// fp32 matmul 0.463).
//
// The planted faults of chip_smoke.py (BAYES_SAMPLE_FAULT=1..3) are defined
// in the shared header and change both designs' noise as the sampler's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"
#include "sm90.cuh"

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


// ---------------------------------------------------------- "split" design

// (1) W = mean + exp(lgstd) eps over `pairs` neighbouring element pairs,
// as bayes_sample_kernel draws it, into three bf16 pieces (3, N, K)
__global__ void __launch_bounds__(THREADS)
bmm_draw_split(const int* __restrict__ seed, const float* __restrict__ mean,
               const float* __restrict__ lgstd, bf16* __restrict__ pieces,
               long long pairs, long long tile_pairs) {
  const uint32_t s = static_cast<uint32_t>(seed[0]);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(pieces);
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       p < pairs; p += stride) {
    float2 ua, ub;
    pair_uniforms(s, p, tile_pairs, &ua, &ub);
    const float2 mu = reinterpret_cast<const float2*>(mean)[p];
    const float2 lg = reinterpret_cast<const float2*>(lgstd)[p];
    const float w[2] = {weight(true, mu.x, lg.x, box_muller(ua)),
                        weight(true, mu.y, lg.y, box_muller(ub))};
    bf16 hi[2], mid[2], lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hi[i] = __float2bfloat16(w[i]);
      const float r = __fsub_rn(w[i], __bfloat162float(hi[i]));
      mid[i] = __float2bfloat16(r);
      lo[i] = __float2bfloat16(__fsub_rn(r, __bfloat162float(mid[i])));
    }
    out[p] = __halves2bfloat162(hi[0], hi[1]);
    out[pairs + p] = __halves2bfloat162(mid[0], mid[1]);
    out[2 * pairs + p] = __halves2bfloat162(lo[0], lo[1]);
  }
}

constexpr int S_ROWS = 128;  // rows of y a tile: two warpgroups of 64
constexpr int S_COLS = 104;  // columns of y a tile (weight rows)
constexpr int S_K = 64;      // a chunk of K: one 128-byte row
constexpr int S_X_BYTES = S_ROWS * S_K * 2;  // 16 KB
constexpr int S_W_BYTES = S_COLS * S_K * 2;  // 13 KB: a piece's chunk
constexpr int S_STAGE = S_X_BYTES + 3 * S_W_BYTES;  // 55 KB
constexpr int S_NST = 4;  // ring stages
constexpr int S_THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int S_SMEM = 1024 + S_NST * S_STAGE + 2 * S_NST * 8;

struct SplitParams {
  CUtensorMap xmap;  // x (M, K) bf16, boxes of 64 columns x 128 rows
  CUtensorMap wmap;  // the pieces (3 N, K) bf16, boxes of 64 x 104 rows
  bf16* y;           // (M, N)
  int M, N, K;
};

// (2) One CTA: y's columns [104 x, +104) of rows [128 y, +128). A piece's
// box reaches past its N rows into the next piece's at the last column
// tile; those columns are never stored. Dynamic shared memory, 1 KB
// aligned: the ring (4 x 55 KB: x's chunk, then W1's, W2's, W3's), the
// barriers.
__global__ void __launch_bounds__(S_THREADS, 1)
bmm_split_wgmma(const __grid_constant__ SplitParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + S_NST * S_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S_NST + s); };
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * S_COLS, m0 = blockIdx.y * S_ROWS;
  const int nk = (p.K + S_K - 1) / S_K;

  if (tid == 0) {
    for (int s = 0; s < S_NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: one thread issues the loads in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect(full(st), S_STAGE);
        const uint32_t dst = ring + st * S_STAGE;
        tma_load(dst, &p.xmap, kc * S_K, m0, full(st));
        for (int i = 0; i < 3; ++i)
          tma_load(dst + S_X_BYTES + i * S_W_BYTES, &p.wmap, kc * S_K,
                   i * p.N + n0, full(st));
        if (++st == S_NST) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, +64) of the tile; a thread
  // rows rbase and rbase + 8, columns cbase + 8 g, + 1 (g < 13)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int rbase = 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  constexpr int CV = S_COLS / 2;  // a thread's values of a 64 x 104 tile
  float s[CV], c[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) s[i] = 0.f;
  int st = 0;
  uint32_t ph = 0;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(full(st), ph);
    const uint32_t a = ring + st * S_STAGE + wg * 64 * 128;
    fence_regs<CV>(c);
    wgmma_fence();
#pragma unroll
    for (int i = 2; i >= 0; --i) {
      const uint32_t b = ring + st * S_STAGE + S_X_BYTES + i * S_W_BYTES;
#pragma unroll
      for (int k = 0; k < S_K / 16; ++k)
        wgmma_n104(c, desc_k(a + 32 * k), desc_k(b + 32 * k),
                   i < 2 || k > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<CV>(c);
#pragma unroll
    for (int i = 0; i < CV; ++i) s[i] += c[i];
    if (t == 0) mbar_arrive(empty(st));
    if (++st == S_NST) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < CV; i += 2) {
    const int row = m0 + rbase + 8 * ((i >> 1) & 1);
    const int col = n0 + 8 * (i >> 2) + cbase;
    if (row < p.M && col < p.N)
      *reinterpret_cast<__nv_bfloat162*>(p.y + (size_t)row * p.N + col) =
          __floats2bfloat162_rn(s[i], s[i + 1]);
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

// The "split" design (see the header): seed device int32 (1,); x (M, K)
// bf16; mean, lgstd (N, K) fp32; pieces a (3, N, K) bf16 workspace; y
// (M, N) bf16; all contiguous, x 16-byte aligned. N a multiple of 128, K of
// 16. Returns the first launch error, or 0; -1 where the driver's
// cuTensorMapEncodeTiled is not found, -1000 - r where it refuses a
// descriptor with r.
extern "C" int bayes_matmul_split(const void* seed, const void* x,
                                  const void* mean, const void* lgstd,
                                  void* pieces, void* y, int M, int N, int K,
                                  void* stream) {
  if (N % TILE_ROWS || K % BK) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bmm_split_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pairs = static_cast<long long>(N) * K / 2;
  long long blocks = (pairs + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bmm_draw_split<<<static_cast<int>(blocks), THREADS, 0, st>>>(
      static_cast<const int*>(seed), static_cast<const float*>(mean),
      static_cast<const float*>(lgstd), static_cast<bf16*>(pieces), pairs,
      static_cast<long long>(TILE_ROWS) * K / 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  SplitParams prm = {};
  int r = encode_map(enc, &prm.xmap, x, M, K, S_ROWS);
  if (r == 0) r = encode_map(enc, &prm.wmap, pieces, 3 * N, K, S_COLS);
  if (r != 0) return -1000 - r;
  prm.y = static_cast<bf16*>(y);
  prm.M = M;
  prm.N = N;
  prm.K = K;
  bmm_split_wgmma<<<dim3((N + S_COLS - 1) / S_COLS, (M + S_ROWS - 1) / S_ROWS),
                    S_THREADS, S_SMEM, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
