// Fused tied-decoder cross-entropy for training: the forward with per-token
// statistics and the two backward kernels, for sm_90a.
//
// Replaces bayeslms_tpu/ops/ce_pallas.py `_fwd_stats_kernel` (pallas_call
// in `_run_fwd_stats`), `_bwd_dh_kernel` (`_run_bwd_dh`) and
// `_bwd_de_kernel` (`_run_bwd_de`), the custom VJP `fused_decode_ce_train`.
// With s_mv = h_m . E_v + b_v (bf16 products, fp32 accumulation):
//   forward:  ce_m = log sum_v exp(s_mv) - s_{m,t_m}, and the statistics
//             max_m = max_v s_mv, sumexp_m = sum_v exp(s_mv - max_m);
//   backward: p_mv = exp(s_mv - max_m) / sumexp_m,
//             d_mv = a_m p_mv + b_m [v = t_m]   (a = g, b = -g for the CE),
//             dh_m = sum_v d_mv E_v      (d rounded to bf16, bf16 E),
//             dE_v = sum_m d_mv h_m      (d rounded to bf16, bf16 h), fp32,
//             db_v = sum_m d_mv          (fp32 d).
// The (M, V) scores never reach device memory: every kernel recomputes its
// score tiles. All three compute a score tile with the same code
// (`score_tile`: the same tiling of D, the same order of products), so the
// backward's s_mv equal the forward's bit for bit and p <= 1.
//
// Differences from the TPU kernels: no padding of M to the token tile and
// none of V with a -1e30 bias; the kernels mask the ragged edges. The
// statistics and coefficients are (M,) vectors, not (M, 8) / (M, 16)
// broadcasts.
//
// Design. Tiles are BM = 64 tokens x BV = 64 vocabulary rows; 8 warps.
//   fwd stats (row 9): a block owns 64 tokens and walks the vocabulary,
//     folding each score tile into running max, sum-exp and target logit
//     (four threads a token), as ce_fwd.cu does at 128 x 128.
//   dh (row 10): the TPU keeps a (512, D) fp32 accumulator in VMEM; here a
//     (64, 1,024) fp32 accumulator would take 256 KB, more than the 227 KB
//     of shared memory a block has. So D is split: a block owns 64 tokens
//     x DS = 256 columns of dh and walks the vocabulary; for each vocabulary
//     tile it recomputes the full-D score tile, forms d in bf16 and adds
//     d (64 x 64) E_tile (64 x 256) into a register accumulator (wmma
//     fragments). Recompute factor D / DS = 4 on the score products.
//   dE/db (row 11): the same with the roles swapped: a block owns 64
//     vocabulary rows x DS columns of dE and walks the tokens (vocabulary
//     tiles outer, token tiles inner: no atomics); d^T h_tile on the tensor
//     cores. Only the blocks of the first D slice write db.
//
// Bound at the training shapes (M = 3,200, V = 49,152, D = 1,024), from
// the H100 SXM data sheet's 989 TFLOP/s bf16 and 3.35 TB/s (700 W):
// forward 2 M V D = 322 GFLOP, 0.33 ms; dh and dE each 4 M V D (the score
// products and the d products) = 644 GFLOP, 0.65 ms; the bytes (0.1 GB of
// E, 0.2 GB of fp32 dE) are a smaller bound. Operations bound. This first
// version loads its tiles synchronously through 64 x 64 wmma tiles and
// recomputes the score tiles 4 times in the backward: far from the bound
// (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 18.3, 25.3 and
// 21.8 ms; PERF.md). A wgmma/TMA pipeline with the d tile kept in
// registers is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // tokens per tile
constexpr int BV = 64;        // vocabulary rows per tile
constexpr int BK = 32;        // contraction chunk of the score products
constexpr int DS = 256;       // columns of D per backward block
constexpr int LDA = BK + 8;   // bf16 pitch of the h and E chunks
constexpr int LDS = BV + 4;   // fp32 pitch of the score tile
constexpr int LDD = BV + 8;   // bf16 pitch of the d tile (64 x 64)
constexpr int LDX = DS + 8;   // bf16 pitch of the second operand (64 x DS)
constexpr int LDT = 16 + 4;   // fp32 pitch of a warp's staging tile
constexpr int THREADS = 256;  // 8 warps

constexpr int SM_A = BM * LDA * 2;
constexpr int SM_B = BV * LDA * 2;
constexpr int SM_S = BM * LDS * 4;
constexpr int SM_D = BM * LDD * 2;
constexpr int SM_X = 64 * LDX * 2;
constexpr int SM_T = 8 * 16 * LDT * 4;
constexpr int SMEM_FWD = SM_A + SM_B + SM_S;
constexpr int SMEM_BWD = SM_A + SM_B + SM_S + SM_D + SM_X + SM_T + 64 * 4 * 4;

// Ss[r][c] = h[m0 + r] . E[v0 + c] over all D, for the 64 x 64 tile; rows
// past M and V read zeros. 8 warps of 16 x 32. Ends synchronised.
__device__ void score_tile(const bf16* __restrict__ h,
                           const bf16* __restrict__ emb, int m0, int v0,
                           int M, int V, int D, bf16* As, bf16* Bs,
                           float* Ss) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows [16 wr, 16 wr + 16)
  const int wc = warp & 1;   // columns [32 wc, 32 wc + 32)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < D; k0 += BK) {
    {
      const int r = tid / (BK / 8);  // 64 rows x 4 chunks = 256 threads
      const int c = (tid % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
      v = make_uint4(0u, 0u, 0u, 0u);
      if (v0 + r < V)
        v = *reinterpret_cast<const uint4*>(emb + (size_t)(v0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(Bs + r * LDA + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, Bs + (wc * 32 + j * 16) * LDA + ks, LDA);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Ss + (wr * 16) * LDS + wc * 32 + j * 16, acc[j],
                            LDS, wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
ce_stats_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                const float* __restrict__ bias, const int* __restrict__ tgt,
                float* __restrict__ ce, float* __restrict__ mx,
                float* __restrict__ se, int M, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + SM_A);
  float* Ss = reinterpret_cast<float*>(smem + SM_A + SM_B);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  // the four threads of a token: lanes 4k .. 4k+3 of one warp
  const int row = tid >> 2;
  const int part = tid & 3;
  const int m = m0 + row;
  const int target = m < M ? tgt[m] : -1;
  float run_max = -1e30f, run_sum = 0.f, run_tgt = 0.f;
  for (int v0 = 0; v0 < V; v0 += BV) {
    score_tile(h, emb, m0, v0, M, V, D, As, Bs, Ss);
    const float* srow = Ss + row * LDS + part * 16;
    const int vbase = v0 + part * 16;
    const int n = max(0, min(16, V - vbase));
    float tmax = -1e30f;
    for (int c = 0; c < n; ++c) tmax = fmaxf(tmax, srow[c] + bias[vbase + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float new_max = fmaxf(run_max, tmax);
    float s = 0.f, tl = 0.f;
    for (int c = 0; c < n; ++c) {
      const float x = srow[c] + bias[vbase + c];
      s += expf(x - new_max);
      if (vbase + c == target) tl = x;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    tl += __shfl_xor_sync(0xffffffffu, tl, 1);
    tl += __shfl_xor_sync(0xffffffffu, tl, 2);
    run_sum = run_sum * expf(run_max - new_max) + s;
    run_max = new_max;
    run_tgt += tl;
    // the next tile's score store waits behind score_tile's barriers, which
    // every thread reaches only after it has folded this tile
  }
  if (part == 0 && m < M) {
    ce[m] = logf(run_sum) + run_max - run_tgt;
    mx[m] = run_max;
    se[m] = run_sum;
  }
}

// DE = false: dh. A block owns tokens [64 bx, +64) x dh columns
//   [DS by, +DS) and walks the vocabulary tiles.
// DE = true: dE and db. A block owns vocabulary rows [64 bx, +64) x dE
//   columns [DS by, +DS) and walks the token tiles.
template <bool DE>
__global__ void __launch_bounds__(THREADS)
ce_grad_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
               const float* __restrict__ bias, const int* __restrict__ tgt,
               const float* __restrict__ mx, const float* __restrict__ se,
               const float* __restrict__ ca, const float* __restrict__ cb,
               void* __restrict__ out, float* __restrict__ db, int M, int V,
               int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + SM_A);
  float* Ss = reinterpret_cast<float*>(smem + SM_A + SM_B);
  bf16* Ds = reinterpret_cast<bf16*>(smem + SM_A + SM_B + SM_S);
  bf16* Xs = reinterpret_cast<bf16*>(smem + SM_A + SM_B + SM_S + SM_D);
  float* Ts = reinterpret_cast<float*>(smem + SM_A + SM_B + SM_S + SM_D + SM_X);
  float* Rs = Ts + 8 * 16 * LDT;  // db partials, 4 x 64

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 1;  // output rows [16 wr, 16 wr + 16)
  const int wc = warp & 1;   // output columns [128 wc, 128 wc + 128)
  const int own0 = blockIdx.x * 64;  // owned tokens (dh) or rows (dE)
  const int d0 = blockIdx.y * DS;
  const int n_own = DE ? V : M;
  const int n_walk = DE ? M : V;
  const bool write_db = DE && blockIdx.y == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);
  float db_part = 0.f;  // column tid % 64 of d, rows tid / 64 + 4 i

  for (int w0 = 0; w0 < n_walk; w0 += 64) {
    const int m0 = DE ? w0 : own0;
    const int v0 = DE ? own0 : w0;
    score_tile(h, emb, m0, v0, M, V, D, As, Bs, Ss);
    // d tile, row = token, column = vocabulary row
    for (int i = tid; i < BM * BV; i += THREADS) {
      const int r = i / BV;
      const int c = i % BV;
      const int m = m0 + r;
      const int v = v0 + c;
      float d = 0.f;
      if (m < M && v < V) {
        const float p = expf(Ss[r * LDS + c] + bias[v] - mx[m]) / se[m];
        d = ca[m] * p + (v == tgt[m] ? cb[m] : 0.f);
      }
      if (DE) db_part += d;
      Ds[r * LDD + c] = __float2bfloat16(d);
    }
    // second operand, 64 rows of the walked axis x DS columns:
    // E[v0 + k][d0 + :] for dh, h[m0 + k][d0 + :] for dE
    const bf16* src = DE ? h : emb;
    const int src0 = DE ? m0 : v0;
    for (int i = tid; i < 64 * (DS / 8); i += THREADS) {
      const int r = i / (DS / 8);
      const int c = (i % (DS / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src0 + r < n_walk)
        v = *reinterpret_cast<const uint4*>(src + (size_t)(src0 + r) * D + d0 + c);
      *reinterpret_cast<uint4*>(Xs + r * LDX + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16) {
      if constexpr (DE) {
        // A = d^T: element (vocabulary row, token) at Ds[token][row]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, Ds + ks * LDD + wr * 16, LDD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Xs + ks * LDX + wc * 128 + j * 16, LDX);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Ds + (wr * 16) * LDD + ks, LDD);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Xs + ks * LDX + wc * 128 + j * 16, LDX);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    // Ds and Xs are rewritten only after the next score_tile's barriers
  }

  // epilogue: each warp stages its fragments through shared memory and
  // writes the rows that exist
  float* Tw = Ts + warp * 16 * LDT;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(Tw, acc[j], LDT, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16;
      const int c = e % 16;
      const int row = own0 + wr * 16 + r;
      if (row < n_own) {
        const size_t o = (size_t)row * D + d0 + wc * 128 + j * 16 + c;
        if (DE)
          static_cast<float*>(out)[o] = Tw[r * LDT + c];
        else
          static_cast<bf16*>(out)[o] = __float2bfloat16(Tw[r * LDT + c]);
      }
    }
    __syncwarp();
  }
  if (write_db) {
    Rs[(tid / 64) * 64 + tid % 64] = db_part;
    __syncthreads();
    if (tid < 64 && own0 + tid < V)
      db[own0 + tid] = (Rs[tid] + Rs[64 + tid]) + (Rs[128 + tid] + Rs[192 + tid]);
  }
}

}  // namespace

// h (M, D) bf16, emb (V, D) bf16, bias (V) fp32, tgt (M) int32 -> ce, mx,
// se (M) fp32. Returns the launch error, or 0.
extern "C" int ce_train_fwd(const void* h, const void* emb, const void* bias,
                            const void* tgt, void* ce, void* mx, void* se,
                            int M, int V, int D, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  ce_stats_kernel<<<(M + BM - 1) / BM, THREADS, SMEM_FWD,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(ce), static_cast<float*>(mx),
      static_cast<float*>(se), M, V, D);
  return (int)cudaGetLastError();
}

// The backward kernels: as the forward, plus mx, se (M) fp32 from it and the
// coefficients a, b (M) fp32. which = 0: dh (M, D) bf16 into out (db
// unused); which = 1: dE (V, D) fp32 into out and db (V) fp32. D must be a
// multiple of DS = 256. Returns the launch error, or 0.
extern "C" int ce_train_bwd(int which, const void* h, const void* emb,
                            const void* bias, const void* tgt, const void* mx,
                            const void* se, const void* a, const void* b,
                            void* out, void* db, int M, int V, int D,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* hh = static_cast<const bf16*>(h);
  const bf16* ee = static_cast<const bf16*>(emb);
  const float* bb = static_cast<const float*>(bias);
  const int* tt = static_cast<const int*>(tgt);
  const float* m = static_cast<const float*>(mx);
  const float* s = static_cast<const float*>(se);
  const float* ca = static_cast<const float*>(a);
  const float* cb = static_cast<const float*>(b);
  float* dbf = static_cast<float*>(db);
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncSetAttribute(ce_grad_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BWD);
    if (err != cudaSuccess) return (int)err;
    if (M == 0) return 0;
    ce_grad_kernel<false><<<dim3((M + 63) / 64, D / DS), THREADS, SMEM_BWD,
                            st>>>(hh, ee, bb, tt, m, s, ca, cb, out, dbf, M,
                                  V, D);
  } else {
    err = cudaFuncSetAttribute(ce_grad_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BWD);
    if (err != cudaSuccess) return (int)err;
    if (V == 0) return 0;
    ce_grad_kernel<true><<<dim3((V + 63) / 64, D / DS), THREADS, SMEM_BWD,
                           st>>>(hh, ee, bb, tt, m, s, ca, cb, out, dbf, M, V,
                                 D);
  }
  return (int)cudaGetLastError();
}
