// The hoisted gate GEMM of the port's persistent recurrences with
// gradients, for sm_90a: csrc/lstm2_train.cu (kernel row 8's gate recompute
// `lstm2_gates_gemm`, row 7's input product `lstm2_input_gemm`),
// csrc/gp6_lstm.cu (row 19's `gp6_bwd_gemm`) and csrc/gp_lstm.cu (row 21's
// `gpg_bwd_gemm`), each through a `__global__` of its own name that calls
// `gates_gemm`, so that a profile tells the rows apart.
//
// A product that depends only on the forward's stored outputs, never on a
// carry, runs for all T steps at once as one (T B) x H x N GEMM with an
// fp32 output that is never rounded. A CTA owns a 128 x 128 tile of the
// output: two consumer warpgroups of 64 rows and a producer warp that
// issues every operand load by TMA (128-byte swizzle, mbarrier completion)
// into a ring of six 32 KB stages (a 64-deep chunk of the A operand's 128
// rows and of the weight's 128 rows). Each chunk's product is the tensor
// cores' (four m64n128k16 steps from zero), added in fp32 registers to
// nearest into the running sum: the arithmetic of rows 9-11
// (csrc/ce_train.cu `score_tile`; the tensor cores' own fp32 sums
// truncate). TMA fills the rows past T B with zeros.
//
// Two modes. Row 8's (q_only false, grid z = 2): layer 2 (z = 0:
// (h1d', W_ih2), then (h2p, W_hh2), added in the twin's order, plus b2)
// or layer 1 (z = 1: (h1p, W_hh1) added to xg1, plus b_hh1), N = 4H.
// q_only: the product a[1] w[1]^T alone, stored as it is with no addend or
// bias: row 7's Q = h1d W_ih2^T (N = 4H), row 19's hprev W'^T (N = 4H),
// row 21's hprev W5^T (N = 5H).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int GM = 128;  // rows (t, b) of a gate tile: two warpgroups of 64
constexpr int GN = 128;  // gate columns of a tile
constexpr int GK = 64;   // a chunk of the contraction: one 128-byte row
constexpr int G_A_BYTES = GM * GK * 2;            // 16 KB
constexpr int G_STAGE = G_A_BYTES + GN * GK * 2;  // 32 KB
constexpr int G_NST = 6;                          // ring stages
constexpr int G_THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int G_SMEM = 1024 + G_NST * G_STAGE + 2 * G_NST * 8;

struct GateParams {
  CUtensorMap a[3];  // row 8: h1p, h1d', h2p (T B, H) bf16, boxes of
                    // 64 x 128; q_only: a[1] alone
  CUtensorMap w[3];  // row 8: W_hh1, W_ih2, W_hh2 (4H, H) bf16, boxes of
                    // 64 x 128; q_only: w[1] (N, H) alone
  const __nv_bfloat16* xg1;  // (T B, 4H)
  const float* bhh1;
  const float* b2;
  float* g1;  // (T B, N) fp32 out
  float* g2;
  int M, H;
  int N;  // output columns: 4H, or w[1]'s rows
};

// s = the sum of nk 64-deep chunks of one (A, W) pair, the stage's 64 rows
// of A at a_off against its 128 rows of W: each chunk the tensor cores'
// four k16 steps from zero into c, added into s in fp32 registers.
__device__ __forceinline__ void gate_walk(float* s, float* c, uint32_t ring,
                                          uint32_t full0, uint32_t empty0,
                                          uint32_t a_off, int nk, bool leader,
                                          int& st, uint32_t& ph) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(full0 + 8 * st, ph);
    const uint32_t a = ring + st * G_STAGE + a_off;
    const uint32_t b = ring + st * G_STAGE + G_A_BYTES;
    fence_regs<64>(c);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < GK / 16; ++k)
      wgmma_n128(c, desc_k(a + 32 * k), desc_k(b + 32 * k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(c);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] += c[i];
    if (leader) mbar_arrive(empty0 + 8 * st);
    if (++st == G_NST) {
      st = 0;
      ph ^= 1;
    }
  }
}

// One CTA: output columns [128 x, +128) of rows [128 y, +128). Row 8's
// (q_only false): layer 2 (z = 0: (h1d', W_ih2), then (h2p, W_hh2)) or
// layer 1 (z = 1: (h1p, W_hh1)). q_only: a[1] w[1]^T alone, stored in g2 as
// it is, with no addend or bias. Dynamic shared memory at smem_raw,
// 1 KB aligned here: the ring (6 x 32 KB: A's chunk, then W's), the
// barriers.
__device__ __forceinline__ void gates_gemm(const GateParams& p, bool q_only,
                                           unsigned char* smem_raw) {
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + G_NST * G_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (G_NST + s); };
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const bool two = !q_only && blockIdx.z == 0;
  const int nk = (p.H + GK - 1) / GK;
  const int first = (q_only || two) ? 1 : 0;
  const int last = q_only ? 2 : (two ? 3 : 1);

  if (tid == 0) {
    for (int s = 0; s < G_NST; ++s) {
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
      for (int pair = first; pair < last; ++pair)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty(st), ph ^ 1);
          mbar_expect(full(st), G_STAGE);
          tma_load(ring + st * G_STAGE, &p.a[pair], kc * GK, m0, full(st));
          tma_load(ring + st * G_STAGE + G_A_BYTES, &p.w[pair], kc * GK, n0,
                   full(st));
          if (++st == G_NST) {
            st = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, +64) of the tile; a thread
  // rows rbase and rbase + 8, columns cbase + 8 g, + 1 (g < 16)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int rbase = 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  const int G = p.N;
  float s[64], c[64], x[64];
  int st = 0;
  uint32_t ph = 0;
  if (two)
    gate_walk(x, c, ring, full(0), empty(0), wg * 64 * 128, nk, t == 0, st,
              ph);
  gate_walk(s, c, ring, full(0), empty(0), wg * 64 * 128, nk, t == 0, st, ph);

  // the twin's order: (X2 + P2) + b2, (xg1 + P1) + b_hh1
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = m0 + rbase + 8 * ((i >> 1) & 1);
    const int col = n0 + 8 * (i >> 2) + cbase;
    if (row < p.M && col < G) {
      const size_t o = (size_t)row * G + col;
      float2 v;
      if (q_only) {
        v.x = s[i];
        v.y = s[i + 1];
        *reinterpret_cast<float2*>(p.g2 + o) = v;
      } else if (two) {
        v.x = (x[i] + s[i]) + p.b2[col];
        v.y = (x[i + 1] + s[i + 1]) + p.b2[col + 1];
        *reinterpret_cast<float2*>(p.g2 + o) = v;
      } else {
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(p.xg1 + o);
        v.x = (__low2float(xv) + s[i]) + p.bhh1[col];
        v.y = (__high2float(xv) + s[i + 1]) + p.bhh1[col + 1];
        *reinterpret_cast<float2*>(p.g1 + o) = v;
      }
    }
  }
}

}  // namespace
