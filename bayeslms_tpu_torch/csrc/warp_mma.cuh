// The warp-level tensor-core products of the port's persistent recurrences
// with gradients, csrc/lstm_train.cu (kernel rows 5-6) and
// csrc/lstm2_train.cu (row 8): mma.sync m16n8k16 (bf16 operands, fp32
// accumulators) on a batch of at most 32 rows (two m16 tiles, under
// wgmma's 64), A read from L2 straight into the fragments, B resident in
// shared memory, and each warp's partial tile stored for a sum over the
// warps in warp order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MMA_ROWS = 32;  // batch rows at most: two m16 row tiles

// d += a b over one k16 step: m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes of device memory through L2 only: the A operands are stored by
// other CTAs during the kernel
__device__ __forceinline__ uint4 ld_cg16(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The warp's share of acc[m][n] = sum_k A[16 m + r][k] Ws[8 n + c][k]: A
// (rows, K) bf16 row-major in device memory (rows past `rows` read as
// zeros), Ws (8 NT rows, K) bf16 in shared memory at pitch ldw. WARPS warps
// share the product; warp `warp` of them takes the 32-deep k ranges p =
// warp, warp + WARPS, ..., BATCH at once (their A loads in flight
// together). Lane (g, t) loads 8 consecutive k, [32 p + 8 t, +8), of A's
// rows g and g + 8 and of Ws' row g, and feeds values 0-3 to one k16 step
// and 4-7 to the next: slots 2t, 2t+1 take k 32 p + 8 t + 4 s + (0, 1) and
// slots 2t+8, 2t+9 take + (2, 3), the same k in A and B.
template <int NT, int BATCH, int WARPS>
__device__ __forceinline__ void warp_product(
    const __nv_bfloat16* __restrict__ a, int rows, int K,
    const __nv_bfloat16* ws, int ldw, int warp, int lane,
    float (&acc)[2][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int npairs = K / 32;
  for (int p0 = warp; p0 < npairs; p0 += WARPS * BATCH) {
    uint4 av[BATCH][2][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int p = p0 + WARPS * i;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + 8 * h + g;
          av[i][m][h] = (p < npairs && r < rows)
                            ? ld_cg16(a + (size_t)r * K + 32 * p + 8 * t)
                            : make_uint4(0u, 0u, 0u, 0u);
        }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int p = p0 + WARPS * i;
      if (p < npairs) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint4 bv = *reinterpret_cast<const uint4*>(
              ws + (size_t)(8 * n + g) * ldw + 32 * p + 8 * t);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma16816(acc[m][n], av[i][m][0].x, av[i][m][1].x, av[i][m][0].y,
                     av[i][m][1].y, bv.x, bv.y);
            mma16816(acc[m][n], av[i][m][0].z, av[i][m][1].z, av[i][m][0].w,
                     av[i][m][1].w, bv.z, bv.w);
          }
        }
      }
    }
  }
}

// The warp's partial tile into red[warp][32 rows][8 NT columns]
template <int NT>
__device__ __forceinline__ void store_partial(float* red,
                                              const float (&acc)[2][NT][4],
                                              int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* r = red + warp * MMA_ROWS * 8 * NT;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(r + (16 * m + 8 * h + g) * 8 * NT + 8 * n +
                                   2 * t) =
            make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
}

}  // namespace
