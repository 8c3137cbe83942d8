// One LSTM layer's step on the tensor cores, for sm_90a (bf16 operands,
// fp32 accumulation, fp32 h/c state): the kernel of csrc/lstm2_fwd.cu (both
// layers of the 2-layer forward, kernel row 1) and csrc/lstm_fwd.cu (one
// layer, rows 3 and 4). Each source includes it and launches
// `lstm_step_kernel` from its own host loop, one launch a layer a step.
//
// A block owns BM batch columns and BJ hidden units and computes all four
// gate rows (q*H + j) of those units, so the cell update needs nothing from
// other blocks. The state lives in fp32 ping-pong buffers (read step t-1,
// write step t), so the reset gather, a read of another column's previous
// state, is free of races. The products run through wmma (16x16x16 bf16,
// fp32 accumulators); the A operand (the fp32 state, gathered) is rounded
// to bf16 on its way into shared memory, as the TPU kernels round h before
// their dot.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // batch columns per block
constexpr int BJ = 32;        // hidden units per block
constexpr int BN = 4 * BJ;    // gate rows per block (4 gates x BJ units)
constexpr int BK = 32;        // contraction chunk
constexpr int LDA = BK + 8;   // bf16 pitch of the A tile (16-byte rows)
constexpr int LDB = BK + 8;   // bf16 pitch of the weight tile
constexpr int LDG = BN + 4;   // fp32 pitch of the gate tile
constexpr int THREADS = 256;  // 8 warps: 2 row halves x 4 gates

constexpr int SMEM_AB = (BM * LDA + BN * LDB) * 2;
constexpr int SMEM_G = BM * LDG * 4;
constexpr int SMEM = SMEM_AB > SMEM_G ? SMEM_AB : SMEM_G;

// Column whose previous state column b starts this step from: its reset
// source on a reset step (-1 = zero state), else itself.
__device__ __forceinline__ int src_col(int b, const uint8_t* rst_t,
                                       const int* rsrc) {
  return (rst_t != nullptr && rst_t[b]) ? rsrc[b] : b;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One LSTM layer, one step. gates = a1 W1^T (+ a2 W2^T) (+ xg_t) + bias.
// a1 is gathered by the reset rule when gather1 is set (layer 1: a1 is its
// own previous h); a2, when given, is always gathered (layer 2's previous h,
// while its a1 is layer 1's h at this step). The cell update gathers h_prev
// and c_prev by the same rule.
__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const float* __restrict__ a1, int gather1,
                 const bf16* __restrict__ w1,
                 const float* __restrict__ a2, const bf16* __restrict__ w2,
                 const bf16* __restrict__ xg_t, const float* __restrict__ bias,
                 const float* __restrict__ h_prev,
                 const float* __restrict__ c_prev,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 bf16* __restrict__ y_out,
                 const uint8_t* __restrict__ mask_t,
                 const uint8_t* __restrict__ rst_t,
                 const int* __restrict__ rsrc, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Gs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 2;  // rows [32 wr, 32 wr + 32) of the tile
  const int wq = warp & 3;   // gate q of the tile
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int K = a2 != nullptr ? 2 * H : H;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool second = k0 >= H;
    const float* a = second ? a2 : a1;
    const bf16* w = second ? w2 : w1;
    const bool gather = second || gather1;
    const int kk = second ? k0 - H : k0;
    // A tile: BM state rows x BK, fp32 -> bf16
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      const int b = b0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B) {
        const int s = gather ? src_col(b, rst_t, rsrc) : b;
        if (s >= 0)
          v = *reinterpret_cast<const float4*>(a + (size_t)s * H + kk + c);
      }
      bf16* dst = As + r * LDA + c;
      dst[0] = __float2bfloat16(v.x);
      dst[1] = __float2bfloat16(v.y);
      dst[2] = __float2bfloat16(v.z);
      dst[3] = __float2bfloat16(v.w);
    }
    // weight tile: BN rows (gate q, unit j0 + u) x BK, torch (4H, H) layout
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int n = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int row = (n / BJ) * H + j0 + (n % BJ);
      *reinterpret_cast<uint4*>(Bs + n * LDB + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)row * H + kk + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wq * BJ + j * 16) * LDB + ks, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Gs + (wr * 32 + i * 16) * LDG + wq * BJ + j * 16,
                              acc[i][j], LDG, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    const int s = src_col(b, rst_t, rsrc);
    float hp = 0.f, cp = 0.f;
    if (s >= 0) {
      hp = h_prev[(size_t)s * H + j];
      cp = c_prev[(size_t)s * H + j];
    }
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = Gs[r * LDG + q * BJ + u] + bias[q * H + j];
      if (xg_t != nullptr)
        v += __bfloat162float(xg_t[(size_t)b * 4 * H + q * H + j]);
      g[q] = v;
    }
    float cn = sigmoidf(g[1]) * cp + sigmoidf(g[0]) * tanhf(g[2]);
    float hn = sigmoidf(g[3]) * tanhf(cn);
    if (mask_t != nullptr && !mask_t[b]) {
      hn = hp;
      cn = cp;
    }
    h_out[(size_t)b * H + j] = hn;
    c_out[(size_t)b * H + j] = cn;
    if (y_out != nullptr) y_out[(size_t)b * H + j] = __float2bfloat16(hn);
  }
}

}  // namespace
