// Fused tied-decoder cross-entropy forward, for sm_90a.
//
// Replaces bayeslms_tpu/ops/ce_pallas.py `fused_decode_ce` (the `_kernel`
// body that `_run` hands to pallas_call). For each token m:
//   ce[m] = log sum_v exp(h_m . E_v + b_v) - (h_m . E_{t_m} + b_{t_m})
// with bf16 products, fp32 accumulation and an fp32 result. The (M, V)
// logits never reach device memory: each block keeps a running max and
// sum-exp per row while it walks the vocabulary.
//
// Differences from the TPU kernel: no (M, 8) broadcast of the targets, no
// padding of M to the token tile and no padding of V with a -1e30 bias. The
// kernel masks the ragged vocabulary edge and the ragged token edge itself
// and takes any M and V (D a multiple of 32).
//
// Design: a block owns BM = 128 tokens and walks the vocabulary in tiles of
// BV = 128 rows of E. For each vocabulary tile it accumulates the 128 x 128
// score tile on the tensor cores (wmma 16x16x16 bf16, fp32 accumulators;
// 8 warps of 32 x 64) over D in chunks of BK = 32, parks the tile in shared
// memory, and two threads per token fold it into that token's running max,
// sum-exp and target logit (picked up when the target falls in the tile).
//
// Where it runs: ops/ce_cuda.py `route` sends only the widths that are a
// multiple of 32 and not of 64 here. Every other scoring call (the LSTM's
// D = 1,024, the Transformer's 512) takes row 9's forward in
// csrc/ce_train.cu (wgmma fed by TMA, 64-deep chunks added to nearest,
// the vocabulary walk split across the card). This kernel's one wmma sum
// over all of D truncates as fault 1 of ROADMAP C found for rows 9-11
// (tools/ce_rounding_model.py models it).
//
// Bound on the H100 at the scoring shapes (M ~ 94k, V = 49,152, D = 1,024):
// 2 M V D ~ 9.5 TFLOP, about 9.6 ms at the 989 TFLOP/s bf16 peak, against
// 0.3 GB of h and E: operations bound. Each token tile re-reads all of E
// (100 MB, mostly from L2); this design loads its tiles synchronously and
// is far from the bound (110.5 ms at that call, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;       // tokens per block
constexpr int BV = 128;       // vocabulary rows per tile
constexpr int BK = 32;        // contraction chunk
constexpr int LDA = BK + 8;   // bf16 pitch of the h tile (16-byte rows)
constexpr int LDB = BK + 8;   // bf16 pitch of the E tile
constexpr int LDS = BV + 4;   // fp32 pitch of the score tile
constexpr int THREADS = 256;  // 8 warps: 4 row quarters x 2 column halves
constexpr int HALF = BV / 2;  // score columns each of a token's two threads folds

constexpr int SMEM = (BM * LDA + BV * LDB) * 2 + BM * LDS * 4;

__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
              const float* __restrict__ bias, const int* __restrict__ tgt,
              float* __restrict__ out, int M, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Ss = reinterpret_cast<float*>(Bs + BV * LDB);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows [32 wr, 32 wr + 32)
  const int wc = warp & 1;   // columns [64 wc, 64 wc + 64)
  const int m0 = blockIdx.x * BM;

  // the two threads of a token: lanes 2k and 2k+1 of one warp
  const int row = tid >> 1;
  const int half = tid & 1;
  const int m = m0 + row;
  const int target = m < M ? tgt[m] : -1;
  float run_max = -1e30f, run_sum = 0.f, run_tgt = 0.f;

  for (int v0 = 0; v0 < V; v0 += BV) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int i = tid; i < BM * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * D + k0 + c);
        *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
      }
      for (int i = tid; i < BV * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8);
        const int c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (v0 + r < V)
          v = *reinterpret_cast<const uint4*>(emb + (size_t)(v0 + r) * D + k0 + c);
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * LDA + ks, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (wc * 64 + j * 16) * LDB + ks, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + (wr * 32 + i * 16) * LDS + wc * 64 + j * 16,
                                acc[i][j], LDS, wmma::mem_row_major);
    __syncthreads();

    // online logsumexp over this tile; columns past V are skipped
    const float* srow = Ss + row * LDS + half * HALF;
    const int vbase = v0 + half * HALF;
    const int n = max(0, min(HALF, V - vbase));
    float tmax = -1e30f;
    for (int c = 0; c < n; ++c) tmax = fmaxf(tmax, srow[c] + bias[vbase + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float new_max = fmaxf(run_max, tmax);
    float se = 0.f, tl = 0.f;
    for (int c = 0; c < n; ++c) {
      const float x = srow[c] + bias[vbase + c];
      se += expf(x - new_max);
      if (vbase + c == target) tl = x;
    }
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    tl += __shfl_xor_sync(0xffffffffu, tl, 1);
    run_sum = run_sum * expf(run_max - new_max) + se;
    run_max = new_max;
    run_tgt += tl;
    // the next tile's score store waits behind the K loop's barriers, which
    // every thread reaches only after it has folded this tile
  }
  if (half == 0 && m < M) out[m] = logf(run_sum) + run_max - run_tgt;
}

}  // namespace

// h (M, D) bf16, emb (V, D) bf16, bias (V,) fp32, tgt (M,) int32 -> out (M,)
// fp32. Returns the launch error, or 0.
extern "C" int ce_fwd(const void* h, const void* emb, const void* bias,
                      const void* tgt, void* out, int M, int V, int D,
                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  ce_fwd_kernel<<<(M + BM - 1) / BM, THREADS, SMEM,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(out), M, V, D);
  return (int)cudaGetLastError();
}
