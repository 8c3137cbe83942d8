// The tile products of the single-layer recurrences with gradients, for
// sm_90a (bf16 operands through wmma 16x16x16, fp32 accumulators): the
// step's product h W^T over NG row groups of the recurrent weight, and the
// backward's dh = du W. csrc/lstm_train.cu takes them with NG = 4 (the
// gates, kernel rows 5-6), csrc/gp6_lstm.cu with NG = 4 too (the gate-6 GP
// unit's rows, 18-19), csrc/gp_lstm.cu with NG = 5 (the gates and the GP
// unit, rows 20-21). A block owns BM batch columns and BJ units of each
// group, so an elementwise epilogue of its own needs nothing from other
// blocks; tiles load synchronously through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;        // batch columns per block
constexpr int BJ = 32;        // units of each row group per block
constexpr int BK = 32;        // contraction chunk
constexpr int LDA = BK + 8;   // bf16 pitch of the A tile (16-byte rows)
constexpr int LDB = BK + 8;   // bf16 pitch of the weight tile

// the step's tile of NG row groups
template <int NG>
struct GateTile {
  static constexpr int BN = NG * BJ;      // weight rows per block
  static constexpr int LDG = BN + 4;      // fp32 pitch of the product tile
  static constexpr int THREADS = 64 * NG;  // 2 row halves x NG groups
  static constexpr int SMEM_AB = (BM * LDA + BN * LDB) * 2;
  static constexpr int SMEM_G = BM * LDG * 4;
  static constexpr int SMEM = SMEM_AB > SMEM_G ? SMEM_AB : SMEM_G;
};

// dh tile: BM columns x DJ units, contraction over the NG*H rows
constexpr int DJ = 32;
constexpr int LDW = DJ + 8;   // bf16 pitch of the weight tile
constexpr int LDO = DJ + 4;   // fp32 pitch of the output tile
constexpr int DH_THREADS = 128;  // 4 warps: 2 row halves x 2 column halves

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Gs[r][q*BJ + u] = sum_k a[b0 + r][k] W[q*H + j0 + u][k] over k < H and
// q < NG, for the block's BM x NG*BJ tile, with W (NG*H, H) row-major; rows
// past B read zeros. Run by GateTile<NG>::THREADS threads (two row halves x
// NG groups, a warp each). Ends synchronised.
template <int NG>
__device__ void gate_tile(const bf16* __restrict__ a,
                          const bf16* __restrict__ w, int b0, int j0, int B,
                          int H, unsigned char* smem) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Gs = reinterpret_cast<float*>(smem);  // reused after the K loop
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp / NG;  // rows [16 wr, 16 wr + 16)
  const int wq = warp % NG;  // row group q
  constexpr int BN = GateTile<NG>::BN;
  constexpr int LDG = GateTile<NG>::LDG;
  constexpr int THREADS = GateTile<NG>::THREADS;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + r < B)
        v = *reinterpret_cast<const uint4*>(a + (size_t)(b0 + r) * H + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
    }
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int n = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int row = (n / BJ) * H + j0 + (n % BJ);
      *reinterpret_cast<uint4*>(Bs + n * LDB + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)row * H + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], Bs + (wq * BJ + j * 16) * LDB + ks, LDB);
        wmma::mma_sync(acc[j], fa, fb[j], acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Gs + (wr * 16) * LDG + wq * BJ + j * 16, acc[j],
                            LDG, wmma::mem_row_major);
  __syncthreads();
}

// dh[b][k] = sum_n du_t[b][n] W[n][k] + (1 - keep) dh_tot over n < NG*H,
// for the block's BM columns x DJ units of dh (the reverse-time carry),
// updated in place; du_t (B, NG*H), W (NG*H, H) row-major. Run by
// DH_THREADS threads.
template <int NG>
__device__ void dh_tile(const bf16* __restrict__ du_t,
                        const bf16* __restrict__ w,
                        const uint8_t* __restrict__ mask_t,
                        const bf16* __restrict__ dy_t, float* __restrict__ dh,
                        int B, int H) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Ws[BK * LDW];
  __shared__ __align__(128) float Os[BM * LDO];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows [16 wr, 16 wr + 16)
  const int wc = warp & 1;   // units [16 wc, 16 wc + 16)
  const int b0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * DJ;
  const int G = NG * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int n0 = 0; n0 < G; n0 += BK) {
    for (int i = tid; i < BM * (BK / 8); i += DH_THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + r < B)
        v = *reinterpret_cast<const uint4*>(du_t + (size_t)(b0 + r) * G + n0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
    }
    for (int i = tid; i < BK * (DJ / 8); i += DH_THREADS) {
      const int n = i / (DJ / 8);
      const int c = (i % (DJ / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + n * LDW + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(n0 + n) * H + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDA + ks, LDA);
      wmma::load_matrix_sync(fb, Ws + ks * LDW + wc * 16, LDW);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(Os + (wr * 16) * LDO + wc * 16, acc, LDO,
                          wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * DJ; i += DH_THREADS) {
    const int r = i / DJ;
    const int u = i % DJ;
    const int b = b0 + r;
    if (b >= B) continue;
    const size_t e = (size_t)b * H + k0 + u;
    const float keep = (mask_t != nullptr && !mask_t[b]) ? 0.f : 1.f;
    const float dh_tot = dh[e] + __bfloat162float(dy_t[e]);
    dh[e] = Os[r * LDO + u] + (1.0f - keep) * dh_tot;
  }
}

}  // namespace
