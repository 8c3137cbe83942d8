// Causal multi-head self-attention for training, with dropout on the
// attention probabilities drawn inside the kernels, for sm_90a: the forward
// (kernel row 15) and the two backward kernels (rows 16 and 17).
//
// Replaces bayeslms_tpu/ops/attention_train_pallas.py `flash_attention_train`:
// `_fwd_kernel` (run by `_run_fwd`), `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (run by `_run_bwd`). For each batch column b, head h, query row r and key
// c <= r, with q, k, v the time-major projections and scale = d^-1/2:
//   s = (q_r scale) . k_c              fp32, q scaled in fp32
//   m_r = max_c s,  p = exp(s - m_r),  l_r = sum_c p      (before dropout)
//   o_r = sum_c round(z p) v_c / l_r                      row 15
//   P = p / l_r,  dP = z (dO_r . v_c),  dS = P (dP - delta_r)
//   dq_r = sum_c round(dS) k_c scale                      row 16
//   dv_c = sum_r round(z P) dO_r,  dk_c = sum_r round(dS) q_r scale   row 17
// with delta_r = rowsum(dO_r o_r) (the wrapper's one torch reduction, as JAX
// computes it outside its kernels), z in {0, 1/keep} the dropout draw, and
// round() the compute dtype (bf16, or none for fp32) at the TPU kernels'
// rounding points; every sum accumulates in fp32. The forward emits (m, l)
// per row, fp32 (B H, T), which the backward kernels read to rebuild P.
//
// Dropout. The TPU seeds its on-core generator per (q-block i, k-block j)
// tile with (seed, (bh ni + i) nj + j) at the block bq = bk = min(128,
// round_up(T, 8)) and keeps an element when its 24-bit uniform is below
// floor(keep 2^24). Hopper has no such generator: these kernels run the
// Philox4x32-10 of bayes_philox.cuh (`dropout_words`) keyed by (seed, that
// LOGICAL tile index) and counted by the element's offset e = (r mod bq) bq
// + (c mod bq) in its tile, word e % 4 of group e / 4, with the same 24-bit
// threshold. So a keep bit depends on (seed, bh, r, c) and T's block only,
// never on these kernels' own tiles: all three kernels, both designs and the
// plain twin (ops/attention_train_cuda.py) draw it again bit for bit. The
// seed is a device int32 read by the kernels (no host round trip). With
// `keep_out` set, each kernel also writes every keep bit it draws, (B H, T,
// T) uint8, for the checks against the twin.
//
// Two designs, chosen by the wrapper (ops/attention_train_cuda.py
// `_design`, counted apart in `design_launches`), neither a fallback of the
// other: all three rows on the tensor cores ("wgmma") for bf16 heads of d
// <= 128, d % 8 == 0, read through TMA (16-byte aligned views and strides);
// the fp32 CUDA-core kernels ("simt") for fp32, for d = 256 and for views
// TMA cannot describe (a 16-byte cp.async could not read those either:
// their rows are not 16-byte aligned).
//
// Bound on the H100 at the long-context step (B h = 32 x 8, T = 1,024,
// d = 64, bf16, dropout 0.2; H100 SXM data sheet, 989 TFLOP/s bf16, 3.35
// TB/s, 700 W): the causal products, 34 GFLOP forward (two), 52 in row 16
// (three) and 69 in row 17 (four), 0.035, 0.052 and 0.07 ms; the bytes (q,
// k, v, o, m, l; dO, delta, dq, dk, dv) ~0.04 ms each. Beside those, each
// causal element costs an exp (in all three) and a quarter of a
// Philox4x32-10 call (~40 32-bit multiplies): 1.3e8 elements a call, ~0.05
// ms of exp on the SFUs and ~0.1-0.2 ms of integer multiplies, which the
// tensor cores do not hide unless another warpgroup's products run
// meanwhile.
//
// wgmma design, row 15 (`attn_fwd_wgmma`). A CTA owns 128 query rows of one
// (b, h): two consumer warpgroups of 64 rows and a producer warp that loads
// q once and then streams key tiles of 128 through a ring (3-4 stages) by
// TMA. The TPU forward holds a (batch, head)'s whole K and V in VMEM per
// q-block and takes the row max in one pass; that does not fit an SM, and a
// running max (as row 14 keeps) would round z exp(s - m_running) instead of
// z exp(s - m). So the key tiles are walked twice: pass 1 takes the row max
// of S = q K^T (wgmma m64n128k16 over d's 64-column chunks, scaled by
// d^-1/2 in fp32 afterwards); pass 2 computes S again, p = exp(s - m) from
// the fragments, l += p, draws z and rounds z p to bf16 straight into the
// A fragments of P V (the m64nNk16 accumulator's layout is the bf16 A
// fragment's of the next product), so P never reaches shared memory; V is
// B, MN-major. Tiles above the diagonal are skipped, the CTAs ordered
// longest rows first so that the causal imbalance leaves no tail.
// wgmma design, row 17 (`attn_dkv_wgmma`). A CTA owns 128 keys; each
// consumer warpgroup 64 keys and their dK and dV (64 x d, fp32) in
// registers. It walks query tiles of 64 rows from the diagonal down, the
// producer streaming q and dO. Per tile and warpgroup: S = q K_w^T and dP =
// dO V_w^T with the queries as the M rows (the forward's fragment layout),
// P, z, dS from the fragments, round(z P) and round(dS) written as bf16 64
// x 64 tiles to the warpgroup's shared memory, then dV_w += (z P)^T dO and
// dK_w += dS^T q with the A operand read transposed (wgmma's transpose bit)
// and dO, q as B, MN-major. Computing S^T instead (keys as rows) would
// scatter each Philox group of four keys over four lane quads.
// wgmma design, row 16 (`attn_dq_wgmma`). A CTA owns 128 query rows, as row
// 15's, and keeps q and dO resident; the producer streams key tiles of K and
// V (128 keys, 64 at d = 128 for the registers), walked once from key 0 to
// the diagonal, since (m, l) come from row 15. Per tile and warpgroup: S = q
// K^T and dP = dO V^T with the queries as the M rows, P, z and dS from the
// fragments, round(dS) straight into the bf16 A fragments of dq += dS K (K
// as B, MN-major: row 15's P V), so dS never reaches shared memory; dq is
// scaled once at the end.
// All three: a lane pair of a fragment holds the four columns of one group of
// four keys for two rows; one lane draws the group of each row and they
// swap two words (`pair_words`): one Philox call a group. The element
// work, not the tensor cores, sets the pace (per element an exp, a
// quarter of a Philox call, the dropout and the rounding, on 8 consumer
// warps an SM): exp is __expf, the SFU's ex2.approx of x log2(e) (x = s -
// m <= 0; a few 2^-22 relative, then rounded to bf16 with z p), rows 16-17
// multiply by 1 / l instead of dividing, and tiles wholly below the
// diagonal and inside T (`FULL`) take a path without per-element tests
// (measured: rows 15 / 17 0.95 / 1.20 ms before these, 0.55 / 0.69 after,
// tools/attn_train_designs.py; PERF.md). A call with `keep_out` takes the
// tested path everywhere; s scale is rounded on its own (__fmul_rn, never
// fused into the exp's argument) so that both paths give the same outputs
// bit for bit, which the checks compare. The P V and dS K products are
// waited for together with the next tile's S. The scale:
// multiplied into S after the product, not into q before it; at d = 64 and
// 256 it is a power of two and the scores equal JAX's up to summation
// order, at d = 32 and 128 they may differ by an ulp of s. A score is one
// chain of d / 16 k16 steps in column order in all three kernels, so rows
// 16 and 17 rebuild P from the same scores row 15 normalised (chip_smoke.py
// prints |sum_c P - 1| for both against row 15's (m, l), from their debug
// sums). d <= 32 runs in one 64-column chunk, the columns past d TMA's
// zeros.
//
// simt design (rows 15-17). One block of 256 threads owns a tile of BR
// query rows (rows 15, 16) or key rows (row 17) of one (b, h), BR = 64 for
// d <= 64 and 32 for wider heads (shared memory: up to 223 KB at d = 256).
// Per partner tile it forms the BR x BR score (and dP) patches on the fp32
// CUDA cores, each thread a (BR/16)^2 patch with the operands transposed in
// shared memory, then folds them into per-row state (row 15: the row max,
// then the sum and the output accumulator, the same two passes; 16: dQ; 17:
// dK and dV accumulators, each thread a slice of one row's columns). d up to
// 256 (tile widths 32, 64, 128, 256; columns past d are zero). At 67 TFLOP/s
// fp32 these bound rows 15-17 near 0.8, 1.3 and 1.8 ms at the long step;
// the bf16 calls of the main path do not reach them.
//
// Differences from the TPU kernels beyond those: the TPU's dq and dkv grids
// visit every (q-block, k-block) pair; these kernels skip the tiles above
// the diagonal. Ragged T is masked here, not padded. q, k, v and dO are
// read in place through their (time, batch) strides, so the fused qkv
// projection's column views need no copy.
//
// Compile-time faults for chip_smoke.py's planted-fault checks (never set by
// the port): ATTN_TRAIN_FAULT=1 drops the k-block index from the dropout
// key, =2 masks the diagonal too (c < r); every kernel of both designs.

#include <cuda.h>  // CUtensorMap and its enums; the library links no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"
#include "sm90.cuh"

#ifndef ATTN_TRAIN_FAULT
#define ATTN_TRAIN_FAULT 0
#endif

typedef __nv_bfloat16 bf16;

namespace {

using bayes_philox::dropout_words;
using bayes_philox::word_of;

constexpr int THREADS = 256;
constexpr int PAD = 4;  // fp32 padding of the tiles' rows
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to the compute dtype and back: the TPU kernels' .astype(dtype)
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the tile geometry for head width DP
template <int DP>
struct Geo {
  static constexpr int BR = DP <= 64 ? 64 : 32;  // rows of a tile
  static constexpr int PS = BR / 16;             // side of a thread's patch
  static constexpr int TPR = THREADS / BR;       // threads of one row
  static constexpr int OC = DP / TPR;            // columns a thread keeps
  static constexpr int RC = BR / TPR;            // score columns a thread folds
  static constexpr int LD = BR + PAD;            // pitch of a transposed tile
  static constexpr int LDR = DP + PAD;           // pitch of a row-major tile
  static constexpr int LDS = BR + 1;             // pitch of a score tile
};

// PS consecutive floats of shared memory, 4 PS-byte aligned
template <int PS>
__device__ __forceinline__ void ld(const float* p, float (&r)[PS]) {
  if constexpr (PS == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  }
}

// (time, batch) strides in elements of the four time-major inputs
struct Strides {
  long long q_t, q_b, k_t, k_b, v_t, v_b, g_t, g_b;
};

struct Drop {
  const int* seed;   // device int32 (1,)
  uint32_t thresh;   // keep iff (word >> 8) < thresh
  float inv_keep;    // 1 / keep, fp32
  int bq;            // the TPU block: min(128, round_up(T, 8))
  int nb;            // ceil(T / bq)
  int on;            // rate > 0
  uint8_t* keep_out; // (B H, T, T) keep bits, or null
};

// the four words of the group of 4 keys col4 .. col4 + 3 (col4 % 4 == 0) of
// query row `row`: one logical tile (bq % 8 == 0), one Philox call
__device__ __forceinline__ uint4 group_words(uint32_t seed, const Drop& dr,
                                             int bh, int row, int col4) {
  const int li = row / dr.bq, lj = col4 / dr.bq;
#if ATTN_TRAIN_FAULT == 1
  const uint32_t tile = static_cast<uint32_t>(
      (static_cast<long long>(bh) * dr.nb + li) * dr.nb);
#else
  const uint32_t tile = static_cast<uint32_t>(
      (static_cast<long long>(bh) * dr.nb + li) * dr.nb + lj);
#endif
  const uint32_t e = static_cast<uint32_t>((row - li * dr.bq) * dr.bq +
                                           (col4 - lj * dr.bq));
  return dropout_words(seed, tile, e >> 2);
}

__device__ __forceinline__ bool causal(int col, int row) {
#if ATTN_TRAIN_FAULT == 2
  return col < row;
#else
  return col <= row;
#endif
}

// z of one element from its group's words: 1/keep or 0; records the bit
__device__ __forceinline__ float drop_z(const Drop& dr, uint4 w, int bh,
                                       int row, int col, int Tn) {
  const bool kept = (word_of(w, col & 3) >> 8) < dr.thresh;
  if (dr.keep_out)
    dr.keep_out[(static_cast<long long>(bh) * Tn + row) * Tn + col] = kept;
  return kept ? dr.inv_keep : 0.f;
}

// tile rows t0 .. t0 + BR of a (T, B, H d) input at (b, h), fp32, times
// `mul`: transposed into dst[j * LD + r] and/or row-major into
// dst_r[r * LDR + j]; zero past T and past d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(const T* base, long long st, int t0,
                                          int Tn, int d, float mul,
                                          float* dst_t, float* dst_r) {
  using G = Geo<DP>;
  for (int i = threadIdx.x; i < G::BR * DP; i += THREADS) {
    const int r = i / DP, j = i - (i / DP) * DP;
    const int t = t0 + r;
    float x = 0.f;
    if (t < Tn && j < d) x = to_f(base[t * st + j]) * mul;
    if (dst_t) dst_t[j * G::LD + r] = x;
    if (dst_r) dst_r[r * G::LDR + j] = x;
  }
}

// ---------------------------------------------------------------- row 15
template <int DP>
constexpr int fwd_smem() {
  using G = Geo<DP>;
  return (2 * DP * G::LD + G::BR * G::LDR + G::BR * G::LDS) * 4;
}

// the masked score tile S = (q scale) K^T of query rows q0 .. and keys
// k0 .. into Ss[BR][LDS]: each thread a PS x PS patch
template <int DP>
__device__ __forceinline__ void score_tile(const float* Qt, const float* Kt,
                                           float* Ss, int q0, int k0,
                                           int Tn) {
  using G = Geo<DP>;
  constexpr int PS = G::PS, LD = G::LD, LDS = G::LDS;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[PS][PS];
#pragma unroll
  for (int a = 0; a < PS; ++a)
#pragma unroll
    for (int c = 0; c < PS; ++c) s[a][c] = 0.f;
  for (int j = 0; j < DP; ++j) {
    float qa[PS], kc[PS];
    ld<PS>(&Qt[j * LD + PS * ty], qa);
    ld<PS>(&Kt[j * LD + PS * tx], kc);
#pragma unroll
    for (int a = 0; a < PS; ++a)
#pragma unroll
      for (int c = 0; c < PS; ++c) s[a][c] += qa[a] * kc[c];
  }
#pragma unroll
  for (int a = 0; a < PS; ++a) {
    const int r = q0 + PS * ty + a;
#pragma unroll
    for (int c = 0; c < PS; ++c) {
      const int col = k0 + PS * tx + c;
      const bool keep = causal(col, r) && col < Tn;
      Ss[(PS * ty + a) * LDS + PS * tx + c] = keep ? s[a][c] : NEG;
    }
  }
}

// grid (B H, ceil(T / BR)); o contiguous (T, B, H d); m, l (B H, T).
// Two passes over the key tiles, as the TPU kernel rounds: the row max
// first, then p = exp(s - m) against it, z p rounded, P V.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int Tn, int B, int H, int d, Strides st, float scale,
                      Drop dr) {
  using G = Geo<DP>;
  constexpr int BR = G::BR, TPR = G::TPR, OC = G::OC;
  constexpr int RC = G::RC, LD = G::LD, LDR = G::LDR, LDS = G::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [DP][LD], q * scale
  float* Kt = Qt + DP * LD;    // [DP][LD]
  float* Vs = Kt + DP * LD;    // [BR][LDR]
  float* Ss = Vs + BR * LDR;   // [BR][LDS]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.y * BR;
  const T* qb = q + b * st.q_b + static_cast<long long>(h) * d;
  const T* kb = k + b * st.k_b + static_cast<long long>(h) * d;
  const T* vb = v + b * st.v_b + static_cast<long long>(h) * d;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;

  load_tile<T, DP>(qb, st.q_t, q0, Tn, d, scale, Qt, nullptr);

  // row fold: TPR threads a row (adjacent lanes of one warp), RC columns
  // of the score tile each
  const int sr = tid / TPR, sq = tid % TPR;
  const int row = q0 + sr;
  float* srow = Ss + sr * LDS + sq * RC;
  const int k_end = min(Tn, q0 + BR);

  // pass 1: the row max over the key tiles up to the diagonal
  float m_row = NEG;
  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();  // the previous tile's Ss is consumed
    load_tile<T, DP>(kb, st.k_t, k0, Tn, d, 1.f, Kt, nullptr);
    __syncthreads();
    score_tile<DP>(Qt, Kt, Ss, q0, k0, Tn);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < RC; ++c) m_row = fmaxf(m_row, srow[c]);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));

  // pass 2: p = exp(s - m), its sum l, and round(z p) V
  float acc[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) acc[c] = 0.f;
  float psum = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();  // the previous tile's Ss and Vs are consumed
    load_tile<T, DP>(kb, st.k_t, k0, Tn, d, 1.f, Kt, nullptr);
    load_tile<T, DP>(vb, st.v_t, k0, Tn, d, 1.f, nullptr, Vs);
    __syncthreads();
    score_tile<DP>(Qt, Kt, Ss, q0, k0, Tn);
    __syncthreads();
#pragma unroll
    for (int c4 = 0; c4 < RC; c4 += 4) {
      const int col4 = k0 + sq * RC + c4;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      const bool draw = dr.on && row < Tn && col4 <= row && col4 < Tn;
      if (draw) w = group_words(seed, dr, bh, row, col4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = col4 + u;
        const float p = expf(srow[c4 + u] - m_row);
        psum += p;
        float pz = p;
        if (dr.on) {
          pz = 0.f;
          if (draw && col <= row && col < Tn)
            pz = p * drop_z(dr, w, bh, row, col, Tn);
        }
        srow[c4 + u] = rnd<T>(pz);
      }
    }
    __syncwarp();  // the row's TPR parts of z p are written

    const int kn = min(BR, Tn - k0);
    const float* prow = Ss + sr * LDS;
    for (int j = 0; j < kn; ++j) {
      const float p = prow[j];
      const float* vr = Vs + j * LDR + sq * OC;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[c] += p * vr[c];
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    psum += __shfl_xor_sync(0xffffffffu, psum, off);

  if (row < Tn) {
    const int ld_o = H * d;
    T* orow = o + (static_cast<long long>(row) * B + b) * ld_o +
              static_cast<long long>(h) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int j = sq * OC + c;
      if (j < d) from_f(&orow[j], acc[c] / psum);
    }
    if (sq == 0) {
      m_out[static_cast<long long>(bh) * Tn + row] = m_row;
      l_out[static_cast<long long>(bh) * Tn + row] = psum;
    }
  }
}

// ---------------------------------------------------------------- row 16
template <int DP>
constexpr int dq_smem() {
  using G = Geo<DP>;
  return (4 * DP * G::LD + G::BR * G::LDR + G::BR * G::LDS + 3 * G::BR) * 4;
}

// grid (B H, ceil(T / BR)); dq contiguous (T, B, H d)
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int Tn, int B, int H, int d, Strides st, float scale,
                     Drop dr) {
  using G = Geo<DP>;
  constexpr int BR = G::BR, PS = G::PS, TPR = G::TPR, OC = G::OC;
  constexpr int LD = G::LD, LDR = G::LDR, LDS = G::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [DP][LD], q * scale
  float* Gt = Qt + DP * LD;    // [DP][LD], dO
  float* Kt = Gt + DP * LD;    // [DP][LD]
  float* Vt = Kt + DP * LD;    // [DP][LD]
  float* Ks = Vt + DP * LD;    // [BR][LDR]
  float* Ss = Ks + BR * LDR;   // [BR][LDS], round(dS)
  float* Ms = Ss + BR * LDS;   // [BR] m, l, delta of the block's rows
  float* Ls = Ms + BR;
  float* Ds = Ls + BR;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.y * BR;
  const long long hd = static_cast<long long>(h) * d;
  const T* kb = k + b * st.k_b + hd;
  const T* vb = v + b * st.v_b + hd;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;

  load_tile<T, DP>(q + b * st.q_b + hd, st.q_t, q0, Tn, d, scale, Qt,
                   nullptr);
  load_tile<T, DP>(g + b * st.g_b + hd, st.g_t, q0, Tn, d, 1.f, Gt,
                   nullptr);
  for (int r = tid; r < BR; r += THREADS) {
    const int row = q0 + r;
    const long long at = static_cast<long long>(bh) * Tn + row;
    Ms[r] = row < Tn ? m[at] : 0.f;
    Ls[r] = row < Tn ? l[at] : 1.f;
    Ds[r] = row < Tn ? delta[at] : 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;
  const int sr = tid / TPR, sq = tid % TPR;
  float acc[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) acc[c] = 0.f;

  const int k_end = min(Tn, q0 + BR);
  for (int k0 = 0; k0 < k_end; k0 += BR) {
    __syncthreads();
    load_tile<T, DP>(kb, st.k_t, k0, Tn, d, 1.f, Kt, Ks);
    load_tile<T, DP>(vb, st.v_t, k0, Tn, d, 1.f, Vt, nullptr);
    __syncthreads();

    float s[PS][PS], dp[PS][PS];
#pragma unroll
    for (int a = 0; a < PS; ++a)
#pragma unroll
      for (int c = 0; c < PS; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int j = 0; j < DP; ++j) {
      float qa[PS], ga[PS], kc[PS], vc[PS];
      ld<PS>(&Qt[j * LD + PS * ty], qa);
      ld<PS>(&Gt[j * LD + PS * ty], ga);
      ld<PS>(&Kt[j * LD + PS * tx], kc);
      ld<PS>(&Vt[j * LD + PS * tx], vc);
#pragma unroll
      for (int a = 0; a < PS; ++a)
#pragma unroll
        for (int c = 0; c < PS; ++c) {
          s[a][c] += qa[a] * kc[c];
          dp[a][c] += ga[a] * vc[c];
        }
    }
#pragma unroll
    for (int a = 0; a < PS; ++a) {
      const int r = PS * ty + a;
      const int row = q0 + r;
      const int colp = k0 + PS * tx;  // PS keys in one group of 4
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      const bool draw = dr.on && row < Tn && colp <= row && colp < Tn;
      if (draw) w = group_words(seed, dr, bh, row, colp & ~3);
#pragma unroll
      for (int c = 0; c < PS; ++c) {
        const int col = colp + c;
        const bool keep = causal(col, row) && col < Tn && row < Tn;
        const float p = keep ? expf(s[a][c] - Ms[r]) / Ls[r] : 0.f;
        float dpv = dp[a][c];
        if (dr.on)
          dpv *= (draw && col <= row && col < Tn)
                     ? drop_z(dr, w, bh, row, col, Tn) : 0.f;
        Ss[r * LDS + PS * tx + c] = rnd<T>(p * (dpv - Ds[r]));
      }
    }
    __syncthreads();

    const int kn = min(BR, Tn - k0);
    const float* dsrow = Ss + sr * LDS;
    for (int j = 0; j < kn; ++j) {
      const float x = dsrow[j];
      const float* kr = Ks + j * LDR + sq * OC;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[c] += x * kr[c];
    }
  }

  const int row = q0 + sr;
  if (row < Tn) {
    T* orow = dq + (static_cast<long long>(row) * B + b) * (H * d) + hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int j = sq * OC + c;
      if (j < d) from_f(&orow[j], acc[c] * scale);
    }
  }
}

// ---------------------------------------------------------------- row 17
template <int DP>
constexpr int dkv_smem() {
  using G = Geo<DP>;
  return (4 * DP * G::LD + 2 * G::BR * G::LDR + 2 * G::BR * G::LDS +
          3 * G::BR) * 4;
}

// grid (B H, ceil(T / BR)) over key tiles; dk, dv contiguous (T, B, H d)
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_train_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ m,
                      const float* __restrict__ l,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Tn, int B, int H, int d,
                      Strides st, float scale, Drop dr) {
  using G = Geo<DP>;
  constexpr int BR = G::BR, PS = G::PS, TPR = G::TPR, OC = G::OC;
  constexpr int LD = G::LD, LDR = G::LDR, LDS = G::LDS;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [DP][LD], this block's keys
  float* Vt = Kt + DP * LD;    // [DP][LD]
  float* Qt = Vt + DP * LD;    // [DP][LD], q * scale
  float* Gt = Qt + DP * LD;    // [DP][LD], dO
  float* Qs = Gt + DP * LD;    // [BR][LDR], q
  float* Gs = Qs + BR * LDR;   // [BR][LDR], dO
  float* Pt = Gs + BR * LDR;   // [BR keys][LDS], round(z P)
  float* Dt = Pt + BR * LDS;   // [BR keys][LDS], round(dS)
  float* Ms = Dt + BR * LDS;   // [BR] m, l, delta of the q tile's rows
  float* Ls = Ms + BR;
  float* Ds = Ls + BR;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int c0 = blockIdx.y * BR;
  const long long hd = static_cast<long long>(h) * d;
  const T* qb = q + b * st.q_b + hd;
  const T* gb = g + b * st.g_b + hd;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;

  load_tile<T, DP>(k + b * st.k_b + hd, st.k_t, c0, Tn, d, 1.f, Kt,
                   nullptr);
  load_tile<T, DP>(v + b * st.v_b + hd, st.v_t, c0, Tn, d, 1.f, Vt,
                   nullptr);

  const int ty = tid >> 4, tx = tid & 15;  // patch: keys PS ty, queries PS tx
  const int sr = tid / TPR, sq = tid % TPR;
  float ak[OC], av[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) ak[c] = av[c] = 0.f;

  // query tiles from the diagonal one down (the tiles start at multiples
  // of BR, so the first holds row c0)
  for (int q0 = c0; q0 < Tn; q0 += BR) {
    __syncthreads();
    load_tile<T, DP>(qb, st.q_t, q0, Tn, d, scale, Qt, nullptr);
    load_tile<T, DP>(qb, st.q_t, q0, Tn, d, 1.f, nullptr, Qs);
    load_tile<T, DP>(gb, st.g_t, q0, Tn, d, 1.f, Gt, Gs);
    for (int r = tid; r < BR; r += THREADS) {
      const int row = q0 + r;
      const long long at = static_cast<long long>(bh) * Tn + row;
      Ms[r] = row < Tn ? m[at] : 0.f;
      Ls[r] = row < Tn ? l[at] : 1.f;
      Ds[r] = row < Tn ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[PS][PS], dp[PS][PS];  // [key][query]
#pragma unroll
    for (int a = 0; a < PS; ++a)
#pragma unroll
      for (int c = 0; c < PS; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int j = 0; j < DP; ++j) {
      float ka[PS], va[PS], qc[PS], gc[PS];
      ld<PS>(&Kt[j * LD + PS * ty], ka);
      ld<PS>(&Vt[j * LD + PS * ty], va);
      ld<PS>(&Qt[j * LD + PS * tx], qc);
      ld<PS>(&Gt[j * LD + PS * tx], gc);
#pragma unroll
      for (int a = 0; a < PS; ++a)
#pragma unroll
        for (int c = 0; c < PS; ++c) {
          s[a][c] += ka[a] * qc[c];
          dp[a][c] += va[a] * gc[c];
        }
    }
    const int colp = c0 + PS * ty;  // this thread's PS keys, one group of 4
#pragma unroll
    for (int c = 0; c < PS; ++c) {
      const int r = PS * tx + c;
      const int row = q0 + r;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      const bool draw = dr.on && row < Tn && colp <= row && colp < Tn;
      if (draw) w = group_words(seed, dr, bh, row, colp & ~3);
#pragma unroll
      for (int a = 0; a < PS; ++a) {
        const int col = colp + a;
        const bool keep = causal(col, row) && col < Tn && row < Tn;
        const float p = keep ? expf(s[a][c] - Ms[r]) / Ls[r] : 0.f;
        float pz = p, dpv = dp[a][c];
        if (dr.on) {
          const float z = (draw && col <= row && col < Tn)
                              ? drop_z(dr, w, bh, row, col, Tn) : 0.f;
          pz = p * z;
          dpv *= z;
        }
        Pt[(PS * ty + a) * LDS + r] = rnd<T>(pz);
        Dt[(PS * ty + a) * LDS + r] = rnd<T>(p * (dpv - Ds[r]));
      }
    }
    __syncthreads();

    const int rn = min(BR, Tn - q0);
    const float* prow = Pt + sr * LDS;
    const float* drow = Dt + sr * LDS;
    for (int r = 0; r < rn; ++r) {
      const float pz = prow[r], ds = drow[r];
      const float* gr = Gs + r * LDR + sq * OC;
      const float* qr = Qs + r * LDR + sq * OC;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        av[c] += pz * gr[c];
        ak[c] += ds * qr[c];
      }
    }
  }

  const int col = c0 + sr;
  if (col < Tn) {
    const long long at = (static_cast<long long>(col) * B + b) * (H * d) + hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int j = sq * OC + c;
      if (j < d) {
        from_f(&dk[at + j], ak[c] * scale);
        from_f(&dv[at + j], av[c]);
      }
    }
  }
}

// ============================================== rows 15, 16, 17 on wgmma
// The tensor-core design of the header: bf16 operands, d <= 128 in one or
// two chunks of 64 columns (NC), every operand load by TMA from a 4-D map of
// the (d, H, B, T) view, 128-byte swizzle, mbarrier completion.

constexpr int WG_THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int CH = 64;           // head columns of a chunk: a 128-byte row
constexpr int FQ = 128;          // query rows of a forward CTA
constexpr int FK = 128;          // keys of a forward tile
constexpr int BK = 128;          // keys of a dk/dv CTA
constexpr int BQ = 64;           // query rows of a dk/dv tile
constexpr int TILE16 = 64 * 64 * 2;  // 8 KB: a bf16 64 x 64 tile

// the forward's shared memory: q (NC chunks of 128 rows), then a ring of
// NST stages, each a key tile's K then V chunks, then the barriers
template <int NC>
struct FwdGeo {
  static constexpr int Q_BYTES = NC * FQ * 128;
  static constexpr int K_BYTES = NC * FK * 128;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int NST = NC == 1 ? 4 : 3;
  static constexpr int SMEM = 1024 + Q_BYTES + NST * STAGE + (1 + 2 * NST) * 8;
};

// dq's: the CTA's q and dO (NC chunks of 128 rows each), then a ring of NST
// stages, each a key tile's K then V chunks, then the barriers. Key tiles of
// KT = 128 at d <= 64 and 64 at d = 128, where the S and dP fragments of
// 128 keys (64 + 64 registers) beside dq's 64 would not fit 240 registers.
template <int NC>
struct DqGeo {
  static constexpr int KT = NC == 1 ? 128 : 64;
  static constexpr int Q_BYTES = NC * FQ * 128;
  static constexpr int K_BYTES = NC * KT * 128;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int NST = 4;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + NST * STAGE + (1 + 2 * NST) * 8;
};

// dk/dv's: the CTA's K and V (NC chunks of 128 rows each), a ring of NST
// stages, each a query tile's q then dO chunks, each warpgroup's round(z P)
// and round(dS) tiles, the barriers
template <int NC>
struct DkvGeo {
  static constexpr int KV_BYTES = NC * BK * 128;
  static constexpr int Q_BYTES = NC * BQ * 128;
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int NST = 4;
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + NST * STAGE + 4 * TILE16 + (1 + 2 * NST) * 8;
};

struct WgParams {
  CUtensorMap qmap, kmap, vmap, gmap;  // boxes of 64 columns x rows
  void* out0;         // o (row 15), dq (16) or dk (17), contiguous (T, B, H d)
  void* out1;         // dv (row 17)
  float* m;           // (B H, T): row 15 writes m and l, rows 16-17 read them
  float* l;
  const float* delta;
  float* psum;        // rows 16-17: sum_c P of each row added here, or null
  int T, B, H, d, BH, ntiles;
  float scale;
  Drop dr;
};

// the logical dropout tile of (q-block li, k-block lj) of batch-head bh
__device__ __forceinline__ uint32_t drop_tile(const Drop& dr, int bh, int li,
                                              int lj) {
#if ATTN_TRAIN_FAULT == 1
  (void)lj;
  return static_cast<uint32_t>((static_cast<long long>(bh) * dr.nb + li) *
                               dr.nb);
#else
  return static_cast<uint32_t>(
      (static_cast<long long>(bh) * dr.nb + li) * dr.nb + lj);
#endif
}

// The keep words of a thread's four elements of one group of four keys
// col4 .. col4 + 3 in a wgmma fragment: rows r_lo and r_hi = r_lo + 8, the
// lane's two columns (col4 + 2 (lane & 1), + 1). Lanes 2i and 2i + 1 hold
// the group's other two columns of the same rows: the even lane draws the
// group of r_lo, the odd lane that of r_hi, and each hands the other the
// two words it needs, so one Philox call serves the pair's eight elements.
// w[rs][e]: the word of row rs (0: r_lo, 1: r_hi), column col4 + 2 (lane &
// 1) + e. A group that lies above the diagonal (or past T) is not drawn;
// FULL: the caller knows that none does.
template <bool FULL>
__device__ __forceinline__ void pair_words(uint32_t seed, const Drop& dr,
                                           uint32_t tile, int li, int lj,
                                           int r_lo, int col4, int lane, int Tn,
                                           uint32_t (&w)[2][2]) {
  const bool odd = lane & 1;
  const int rd = odd ? r_lo + 8 : r_lo;
  uint4 g = make_uint4(0u, 0u, 0u, 0u);
  if (FULL || (rd < Tn && col4 <= rd)) {
    const uint32_t e = static_cast<uint32_t>((rd - li * dr.bq) * dr.bq +
                                             (col4 - lj * dr.bq));
    g = dropout_words(seed, tile, e >> 2);
  }
  const uint32_t sx = odd ? g.x : g.z, sy = odd ? g.y : g.w;
  const uint32_t rx = __shfl_xor_sync(0xffffffffu, sx, 1);
  const uint32_t ry = __shfl_xor_sync(0xffffffffu, sy, 1);
  w[0][0] = odd ? rx : g.x;
  w[0][1] = odd ? ry : g.y;
  w[1][0] = odd ? g.z : rx;
  w[1][1] = odd ? g.w : ry;
}

// z of a causal element (col <= row < T) from its word: 1/keep or 0; records
// the bit
__device__ __forceinline__ float keep_z(const Drop& dr, uint32_t word, int bh,
                                        int row, int col, int Tn) {
  const bool kept = (word >> 8) < dr.thresh;
  if (dr.keep_out)
    dr.keep_out[(static_cast<long long>(bh) * Tn + row) * Tn + col] = kept;
  return kept ? dr.inv_keep : 0.f;
}

// Row 15's pass 2 on one key tile's score fragment s (64 values a thread):
// p = exp(s scale - m), l += p, z from the pair's Philox words, round(z p)
// packed into the 32 A-fragment words pa of P V (word 2 j + rs: row r_lo +
// 8 rs, columns k0 + 8 j + cq, + 1, the m64k16 fragment's order). FULL:
// the tile lies below the diagonal, all its rows are < T and no keep bit
// is recorded, so no element needs a test.
template <bool FULL>
__device__ __forceinline__ void fwd_fold(const float* s, uint32_t* pa,
                                         float (&lsum)[2],
                                         const float (&mx)[2], float scale,
                                         const Drop& dr, uint32_t seed,
                                         uint32_t tile, int li, int lj,
                                         int bh, int r_lo, int k0, int cq,
                                         int lane, int Tn) {
  const uint32_t thr8 = dr.thresh << 8;  // (w >> 8) < thresh, as w < thr8
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
    if (dr.on)
      pair_words<FULL>(seed, dr, tile, li, lj, r_lo,
                       k0 + 8 * j + 4 * ((lane >> 1) & 1), lane, Tn, w);
    float pz[2][2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r_lo + 8 * rs;
        const int col = k0 + 8 * j + cq + e;
        // a masked score is NEG, as in the CUDA-core kernel: p = 0, or 1
        // in a row with no key (only under ATTN_TRAIN_FAULT=2), not 0 / 0
        float x = __fmul_rn(s[4 * j + 2 * rs + e], scale);  // see FULL
        if (!FULL && !causal(col, row)) x = NEG;
        const float pv = __expf(x - mx[rs]);  // see the header: exp
        lsum[rs] += pv;
        float v = pv;
        if (dr.on) {
          if (FULL)
            v = w[rs][e] < thr8 ? pv * dr.inv_keep : 0.f;
          else
            v = (row < Tn && col <= row)
                    ? pv * keep_z(dr, w[rs][e], bh, row, col, Tn)
                    : 0.f;
        }
        pz[rs][e] = v;
      }
    pa[2 * j] = pack_bf16(pz[0][0], pz[0][1]);
    pa[2 * j + 1] = pack_bf16(pz[1][0], pz[1][1]);
  }
}

// Row 17 on one query tile's fragments s, dp (32 values a thread; rows q0 +
// fr (+ 8), keys c0w + 8 j + cq (+ 1)): P = exp(s scale - m) / l, z, dS =
// P (z dP - delta), round(z P) and round(dS) into the warpgroup's tiles at
// pzt and dst (bf16, the swizzle, query rows x key columns); psum += P.
// FULL as for fwd_fold.
template <bool FULL>
__device__ __forceinline__ void dkv_fold(const float* s, const float* dp,
                                         uint32_t pzt, uint32_t dst,
                                         float (&psum)[2],
                                         const float (&mr)[2],
                                         const float (&il)[2],
                                         const float (&dl)[2], float scale,
                                         const Drop& dr, uint32_t seed,
                                         uint32_t tile, int li, int lj,
                                         int bh, int q0, int fr, int c0w,
                                         int cq, int lane, int Tn) {
  const uint32_t thr8 = dr.thresh << 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
    if (dr.on)
      pair_words<FULL>(seed, dr, tile, li, lj, q0 + fr,
                       c0w + 8 * j + 4 * ((lane >> 1) & 1), lane, Tn, w);
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = q0 + fr + 8 * rs;
      float pz[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0w + 8 * j + cq + e;
        const int i4 = 4 * j + 2 * rs + e;
        float pv = __expf(__fmul_rn(s[i4], scale) - mr[rs]) * il[rs];
        if (!FULL && !(causal(col, row) && row < Tn)) pv = 0.f;
        float pzv = pv, dpv = dp[i4];
        if (dr.on) {
          float z;
          if (FULL)
            z = w[rs][e] < thr8 ? dr.inv_keep : 0.f;
          else
            z = (row < Tn && col <= row)
                    ? keep_z(dr, w[rs][e], bh, row, col, Tn)
                    : 0.f;
          pzv = pv * z;
          dpv *= z;
        }
        psum[rs] += pv;
        pz[e] = pzv;
        ds[e] = pv * (dpv - dl[rs]);
      }
      const uint32_t off = swizzled(fr + 8 * rs, 8 * j + cq);
      asm volatile("st.shared.b32 [%0], %1;"
                   :: "r"(pzt + off), "r"(pack_bf16(pz[0], pz[1]))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;"
                   :: "r"(dst + off), "r"(pack_bf16(ds[0], ds[1]))
                   : "memory");
    }
  }
}

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both MN-major (A read transposed)
__device__ __forceinline__ void wgmma_tt_n64(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), A and B bf16 in shared
// memory, both MN-major (A read transposed)
__device__ __forceinline__ void wgmma_tt_n128(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Row 16 on one key tile's fragments s, dp (4 NJ values a thread; rows r_lo
// (+ 8), keys k0 + 8 j + cq (+ 1)): P = exp(s scale - m) / l, z, dS = P (z dP
// - delta), round(dS) packed into the 2 NJ A-fragment words da of dq += dS K
// (fwd_fold's order); psum += P. FULL as for fwd_fold.
template <bool FULL, int NJ>
__device__ __forceinline__ void dq_fold(const float* s, const float* dp,
                                        uint32_t* da, float (&psum)[2],
                                        const float (&mr)[2],
                                        const float (&il)[2],
                                        const float (&dl)[2], float scale,
                                        const Drop& dr, uint32_t seed,
                                        uint32_t tile, int li, int lj, int bh,
                                        int r_lo, int k0, int cq, int lane,
                                        int Tn) {
  const uint32_t thr8 = dr.thresh << 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
    if (dr.on)
      pair_words<FULL>(seed, dr, tile, li, lj, r_lo,
                       k0 + 8 * j + 4 * ((lane >> 1) & 1), lane, Tn, w);
    float ds[2][2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = r_lo + 8 * rs;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + cq + e;
        const int i4 = 4 * j + 2 * rs + e;
        float pv = __expf(__fmul_rn(s[i4], scale) - mr[rs]) * il[rs];
        if (!FULL && !(causal(col, row) && row < Tn)) pv = 0.f;
        float dpv = dp[i4];
        if (dr.on) {
          float z;
          if (FULL)
            z = w[rs][e] < thr8 ? dr.inv_keep : 0.f;
          else
            z = (row < Tn && col <= row)
                    ? keep_z(dr, w[rs][e], bh, row, col, Tn)
                    : 0.f;
          dpv *= z;
        }
        psum[rs] += pv;
        ds[rs][e] = pv * (dpv - dl[rs]);
      }
    }
    da[2 * j] = pack_bf16(ds[0][0], ds[0][1]);
    da[2 * j + 1] = pack_bf16(ds[1][0], ds[1][1]);
  }
}

// ---------------------------------------------------------- row 15, wgmma
// One CTA: query rows [128 qt, +128) of batch-head bh, the longest rows
// first (qt = ntiles - 1 - x / BH). Warpgroup w owns rows [64 w, +64); a
// thread rows r_lo and r_lo + 8 of each fragment, columns 8 j + 2 (lane &
// 3) + {0, 1}.
template <int NC>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_fwd_wgmma(const __grid_constant__ WgParams p) {
  using G = FwdGeo<NC>;
  constexpr int NO = NC * 32;  // output values a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + G::Q_BYTES;
  const uint32_t bars = ring + G::NST * G::STAGE;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (G::NST + s); };

  const int tid = threadIdx.x;
  const int qt = p.ntiles - 1 - static_cast<int>(blockIdx.x / p.BH);
  const int bh = static_cast<int>(blockIdx.x % p.BH);
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = qt * FQ;
  const int nkt = qt + 1;  // key tiles up to the diagonal
  const int Tn = p.T;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: q once, then the key tiles' K (pass 1), then K and V
    // (pass 2), in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      mbar_expect(qfull, G::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(qs + c * FQ * 128, &p.qmap, c * CH, h, b, q0, qfull);
      int st = 0;
      uint32_t ph = 0;
      for (int pass = 0; pass < 2; ++pass)
        for (int kt = 0; kt < nkt; ++kt) {
          mbar_wait(empty(st), ph ^ 1);
          const uint32_t s0 = ring + st * G::STAGE;
          mbar_expect(full(st), pass ? G::STAGE : G::K_BYTES);
          for (int c = 0; c < NC; ++c)
            tma_load_4d(s0 + c * FK * 128, &p.kmap, c * CH, h, b, kt * FK,
                        full(st));
          if (pass)
            for (int c = 0; c < NC; ++c)
              tma_load_4d(s0 + G::K_BYTES + c * FK * 128, &p.vmap, c * CH,
                          h, b, kt * FK, full(st));
          if (++st == G::NST) { st = 0; ph ^= 1; }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wgi = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int r_lo = q0 + 64 * wgi + 16 * (t >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t qa = qs + wgi * 64 * 128;
  const Drop& dr = p.dr;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;
  const int li = q0 / dr.bq;

  mbar_wait(qfull, 0);
  float s[64];
  int st = 0;
  uint32_t ph = 0;

  // pass 1: the row max over the key tiles up to the diagonal
  float mx[2] = {NEG, NEG};
  for (int kt = 0; kt < nkt; ++kt) {
    mbar_wait(full(st), ph);
    fence_regs<64>(s);
    wgmma_fence();
    issue_scores<NC, FK>(s, qa, FQ * 128, ring + st * G::STAGE, FK * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(s);
    if (t == 0) mbar_arrive(empty(st));
    if (++st == G::NST) { st = 0; ph ^= 1; }
    const int k0 = kt * FK;
    if (kt < qt) {  // below the diagonal: every key counts
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i] * p.scale);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int row = r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        if (causal(col, row))
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i] * p.scale);
      }
    }
  }
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(0xffffffffu, mx[rs], 1));
    mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(0xffffffffu, mx[rs], 2));
  }

  // pass 2: p = exp(s - m), its sum l, round(z p) straight into the A
  // fragments of P V
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float lsum[2] = {0.f, 0.f};
  uint32_t pa[32];  // 8 k16 steps x the 4 words of a fragment
  int prev = -1;
  for (int kt = 0; kt < nkt; ++kt) {
    mbar_wait(full(st), ph);
    const uint32_t kb = ring + st * G::STAGE;
    fence_regs<64>(s);
    wgmma_fence();
    issue_scores<NC, FK>(s, qa, FQ * 128, kb, FK * 128);
    wgmma_commit();
    // also completes the last tile's P V: its stage is free, pa rewritable
    wgmma_wait<0>();
    fence_regs<64>(s);
    fence_regs<NO>(o);
    fence_words<32>(pa);
    if (prev >= 0 && t == 0) mbar_arrive(empty(prev));
    const int k0 = kt * FK;
    const int lj = k0 / dr.bq;
    const uint32_t tile = drop_tile(dr, bh, li, lj);
    if (kt < qt && q0 + FQ <= Tn && !dr.keep_out)
      fwd_fold<true>(s, pa, lsum, mx, p.scale, dr, seed, tile, li, lj, bh,
                     r_lo, k0, cq, lane, Tn);
    else
      fwd_fold<false>(s, pa, lsum, mx, p.scale, dr, seed, tile, li, lj, bh,
                      r_lo, k0, cq, lane, Tn);
    fence_regs<NO>(o);
    fence_words<32>(pa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < FK / 16; ++ks) {
      const uint64_t dv = desc_mn_lbo(kb + G::K_BYTES + ks * 16 * 128,
                                      FK * 128);
      if constexpr (NC == 1)
        wgmma_rs_n64(o, pa + 4 * ks, dv);
      else
        wgmma_rs_n128(o, pa + 4 * ks, dv);
    }
    wgmma_commit();  // waited for with the next tile's S
    prev = st;
    if (++st == G::NST) { st = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<NO>(o);
  fence_words<32>(pa);

#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    lsum[rs] += __shfl_xor_sync(0xffffffffu, lsum[rs], 1);
    lsum[rs] += __shfl_xor_sync(0xffffffffu, lsum[rs], 2);
  }
  bf16* out = static_cast<bf16*>(p.out0);
  const long long ld = static_cast<long long>(p.H) * p.d;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int rs = (i >> 1) & 1;
    const int row = r_lo + 8 * rs;
    const int col = 8 * (i >> 2) + cq;
    if (row < Tn && col < p.d)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<long long>(row) * p.B + b) * ld +
          static_cast<long long>(h) * p.d + col) =
          __floats2bfloat162_rn(o[i] / lsum[rs], o[i + 1] / lsum[rs]);
  }
  if ((lane & 3) == 0)
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = r_lo + 8 * rs;
      if (row < Tn) {
        p.m[static_cast<long long>(bh) * Tn + row] = mx[rs];
        p.l[static_cast<long long>(bh) * Tn + row] = lsum[rs];
      }
    }
}

// ---------------------------------------------------------- row 17, wgmma
// One CTA: keys [128 kt, +128) of batch-head bh, the longest walks first
// (kt = x / BH); warpgroup w owns keys [64 w, +64) and their dK and dV
// (64 x 64 NC, fp32, in registers for the whole walk). It walks the query
// tiles of 64 rows from the one that holds its first key down to T. Per
// tile, queries are the M rows of S = q K_w^T and dP = dO V_w^T (the
// forward's fragment layout: a lane's two columns of a group of four keys);
// round(z P) and round(dS) go to the warpgroup's own 64 x 64 tiles in the
// swizzle, read back transposed (wgmma's transpose bit) as the A operands
// of dV += (z P)^T dO and dK += dS^T q, with dO and q the B operands,
// MN-major, from the same stage.
template <int NC>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_dkv_wgmma(const __grid_constant__ WgParams p) {
  using G = DkvGeo<NC>;
  constexpr int NO = NC * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ks = smem_u32(smem);
  const uint32_t vs = ks + G::KV_BYTES;
  const uint32_t ring = vs + G::KV_BYTES;
  const uint32_t tiles = ring + G::NST * G::STAGE;
  const uint32_t bars = tiles + 4 * TILE16;
  const uint32_t kvfull = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (G::NST + s); };

  const int tid = threadIdx.x;
  const int kt = static_cast<int>(blockIdx.x / p.BH);
  const int bh = static_cast<int>(blockIdx.x % p.BH);
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int c0 = kt * BK;
  const int Tn = p.T;
  const int nqt = (Tn - c0 + BQ - 1) / BQ;  // query tiles c0 + 64 i < T

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      mbar_expect(kvfull, 2 * G::KV_BYTES);
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(ks + c * BK * 128, &p.kmap, c * CH, h, b, c0, kvfull);
        tma_load_4d(vs + c * BK * 128, &p.vmap, c * CH, h, b, c0, kvfull);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int i = 0; i < nqt; ++i) {
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t s0 = ring + st * G::STAGE;
        mbar_expect(full(st), G::STAGE);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(s0 + c * BQ * 128, &p.qmap, c * CH, h, b, c0 + BQ * i,
                      full(st));
          tma_load_4d(s0 + G::Q_BYTES + c * BQ * 128, &p.gmap, c * CH, h, b,
                      c0 + BQ * i, full(st));
        }
        if (++st == G::NST) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wgi = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int c0w = c0 + 64 * wgi;            // this warpgroup's first key
  const int fr = 16 * (t >> 5) + (lane >> 2);  // a fragment's row r_lo
  const int cq = 2 * (lane & 3);
  const uint32_t kw = ks + wgi * 64 * 128, vw = vs + wgi * 64 * 128;
  const uint32_t pzt = tiles + 2 * wgi * TILE16, dst = pzt + TILE16;
  const Drop& dr = p.dr;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;
  const int lj = c0 / dr.bq;

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvfull, 0);
  int st = 0, prev = -1;
  uint32_t ph = 0;
  for (int i = 0; i < nqt; ++i) {
    const int q0 = c0 + BQ * i;
    mbar_wait(full(st), ph);
    if (q0 + BQ <= c0w) {
      // every row of the tile lies above this warpgroup's keys
      if (t == 0) mbar_arrive(empty(st));
      if (++st == G::NST) { st = 0; ph ^= 1; }
      continue;
    }
    const uint32_t qa = ring + st * G::STAGE, ga = qa + G::Q_BYTES;
    float s[32], dp[32];
    fence_regs<32>(s);
    fence_regs<32>(dp);
    wgmma_fence();
    issue_scores<NC, 64>(s, qa, BQ * 128, kw, BK * 128);
    issue_scores<NC, 64>(dp, ga, BQ * 128, vw, BK * 128);
    wgmma_commit();
    // the rows' statistics while the products run
    float mr[2], lr[2], dl[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      const int row = q0 + fr + 8 * rs;
      const long long at = static_cast<long long>(bh) * Tn + row;
      mr[rs] = row < Tn ? p.m[at] : 0.f;
      lr[rs] = row < Tn ? p.l[at] : 1.f;
      dl[rs] = row < Tn ? p.delta[at] : 0.f;
    }
    // also completes the last tile's dK, dV products: its stage is free
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    fence_regs<NO>(dk);
    fence_regs<NO>(dv);
    if (prev >= 0 && t == 0) mbar_arrive(empty(prev));

    const int li = q0 / dr.bq;
    const uint32_t tile = drop_tile(dr, bh, li, lj);
    const float il[2] = {1.f / lr[0], 1.f / lr[1]};
    float psum[2] = {0.f, 0.f};
    if (q0 >= c0w + 64 && q0 + BQ <= Tn && !dr.keep_out)
      dkv_fold<true>(s, dp, pzt, dst, psum, mr, il, dl, p.scale, dr, seed,
                     tile, li, lj, bh, q0, fr, c0w, cq, lane, Tn);
    else
      dkv_fold<false>(s, dp, pzt, dst, psum, mr, il, dl, p.scale, dr, seed,
                      tile, li, lj, bh, q0, fr, c0w, cq, lane, Tn);
    if (p.psum) {
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        float x = psum[rs];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int row = q0 + fr + 8 * rs;
        if ((lane & 3) == 0 && row < Tn)
          atomicAdd(p.psum + static_cast<long long>(bh) * Tn + row, x);
      }
    }
    // the tiles visible to wgmma (the async proxy) once the warpgroup has
    // written them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wgi, 128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BQ / 16; ++k) {
      const uint64_t dpz = desc_mn_lbo(pzt + k * 16 * 128, TILE16);
      const uint64_t dds = desc_mn_lbo(dst + k * 16 * 128, TILE16);
      const uint64_t dg = desc_mn_lbo(ga + k * 16 * 128, BQ * 128);
      const uint64_t dq = desc_mn_lbo(qa + k * 16 * 128, BQ * 128);
      if constexpr (NC == 1) {
        wgmma_tt_n64(dv, dpz, dg);
        wgmma_tt_n64(dk, dds, dq);
      } else {
        wgmma_tt_n128(dv, dpz, dg);
        wgmma_tt_n128(dk, dds, dq);
      }
    }
    wgmma_commit();
    prev = st;
    if (++st == G::NST) { st = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<NO>(dk);
  fence_regs<NO>(dv);

  bf16* dko = static_cast<bf16*>(p.out0);
  bf16* dvo = static_cast<bf16*>(p.out1);
  const long long ld = static_cast<long long>(p.H) * p.d;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int key = c0w + fr + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + cq;
    if (key < Tn && col < p.d) {
      const long long at = (static_cast<long long>(key) * p.B + b) * ld +
                           static_cast<long long>(h) * p.d + col;
      *reinterpret_cast<__nv_bfloat162*>(dko + at) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvo + at) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------- row 16, wgmma
// One CTA: query rows [128 qt, +128) of batch-head bh, the longest rows
// first (qt = ntiles - 1 - x / BH), as row 15's. Warpgroup w owns rows [64 w,
// +64) and their dq (64 x 64 NC, fp32, in registers). The producer loads q
// and dO once and streams the key tiles' K and V; the CTA walks them once,
// from key 0 to the diagonal, since (m, l) are row 15's. Per tile and
// warpgroup: S = q K^T and dP = dO V^T with the queries as the M rows (row
// 15's fragment layout, so the same lane-pair Philox calls), P, z and dS from
// the fragments, round(dS) packed straight into the A fragments of dq += dS
// K (row 15's P V: K the B operand, MN-major, from the same stage); dS never
// reaches shared memory. A warpgroup skips a tile whose keys all lie above
// its rows, and every tile when its rows lie past T. dq is scaled once, after
// the last tile.
template <int NC>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_dq_wgmma(const __grid_constant__ WgParams p) {
  using G = DqGeo<NC>;
  constexpr int KT = G::KT, NJ = KT / 8, NO = NC * 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qs = smem_u32(smem);
  const uint32_t gs = qs + G::Q_BYTES;
  const uint32_t ring = gs + G::Q_BYTES;
  const uint32_t bars = ring + G::NST * G::STAGE;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (G::NST + s); };

  const int tid = threadIdx.x;
  const int qt = p.ntiles - 1 - static_cast<int>(blockIdx.x / p.BH);
  const int bh = static_cast<int>(blockIdx.x % p.BH);
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = qt * FQ;
  const int Tn = p.T;
  const int nkt = (min(Tn, q0 + FQ) + KT - 1) / KT;  // up to the diagonal

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: q and dO once, then the key tiles' K and V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      mbar_expect(qfull, 2 * G::Q_BYTES);
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(qs + c * FQ * 128, &p.qmap, c * CH, h, b, q0, qfull);
        tma_load_4d(gs + c * FQ * 128, &p.gmap, c * CH, h, b, q0, qfull);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t s0 = ring + st * G::STAGE;
        mbar_expect(full(st), G::STAGE);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(s0 + c * KT * 128, &p.kmap, c * CH, h, b, kt * KT,
                      full(st));
          tma_load_4d(s0 + G::K_BYTES + c * KT * 128, &p.vmap, c * CH, h, b,
                      kt * KT, full(st));
        }
        if (++st == G::NST) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wgi = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int w0 = q0 + 64 * wgi;  // this warpgroup's first row
  const int r_lo = w0 + 16 * (t >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const uint32_t qa = qs + wgi * 64 * 128, ga = gs + wgi * 64 * 128;
  const Drop& dr = p.dr;
  const uint32_t seed = dr.on ? static_cast<uint32_t>(dr.seed[0]) : 0u;
  const int li = q0 / dr.bq;

  // the rows' statistics, once
  float mr[2], il[2], dl[2];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int row = r_lo + 8 * rs;
    const long long at = static_cast<long long>(bh) * Tn + row;
    mr[rs] = row < Tn ? p.m[at] : 0.f;
    il[rs] = row < Tn ? 1.f / p.l[at] : 1.f;
    dl[rs] = row < Tn ? p.delta[at] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  float psum[2] = {0.f, 0.f};
  uint32_t da[2 * NJ];  // KT / 16 k16 steps x the 4 words of a fragment
  mbar_wait(qfull, 0);
  int st = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * KT;
    mbar_wait(full(st), ph);
    if (k0 > w0 + 63 || w0 >= Tn) {
      // every key lies above this warpgroup's rows, or every row past T
      if (t == 0) mbar_arrive(empty(st));
      if (++st == G::NST) { st = 0; ph ^= 1; }
      continue;
    }
    const uint32_t kb = ring + st * G::STAGE;
    float s[4 * NJ], dp[4 * NJ];
    fence_regs<4 * NJ>(s);
    fence_regs<4 * NJ>(dp);
    wgmma_fence();
    issue_scores<NC, KT>(s, qa, FQ * 128, kb, KT * 128);
    issue_scores<NC, KT>(dp, ga, FQ * 128, kb + G::K_BYTES, KT * 128);
    wgmma_commit();
    // also completes the last tile's dq product: its stage is free, da
    // rewritable
    wgmma_wait<0>();
    fence_regs<4 * NJ>(s);
    fence_regs<4 * NJ>(dp);
    fence_regs<NO>(dq);
    fence_words<2 * NJ>(da);
    if (prev >= 0 && t == 0) mbar_arrive(empty(prev));
    const int lj = k0 / dr.bq;
    const uint32_t tile = drop_tile(dr, bh, li, lj);
    if (k0 + KT <= w0 + 1 && w0 + 64 <= Tn && !dr.keep_out)
      dq_fold<true, NJ>(s, dp, da, psum, mr, il, dl, p.scale, dr, seed, tile,
                        li, lj, bh, r_lo, k0, cq, lane, Tn);
    else
      dq_fold<false, NJ>(s, dp, da, psum, mr, il, dl, p.scale, dr, seed,
                         tile, li, lj, bh, r_lo, k0, cq, lane, Tn);
    fence_regs<NO>(dq);
    fence_words<2 * NJ>(da);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      const uint64_t dk = desc_mn_lbo(kb + ks * 16 * 128, KT * 128);
      if constexpr (NC == 1)
        wgmma_rs_n64(dq, da + 4 * ks, dk);
      else
        wgmma_rs_n128(dq, da + 4 * ks, dk);
    }
    wgmma_commit();  // waited for with the next tile's S
    prev = st;
    if (++st == G::NST) { st = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<NO>(dq);
  fence_words<2 * NJ>(da);

  if (p.psum) {
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      float x = psum[rs];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int row = r_lo + 8 * rs;
      if ((lane & 3) == 0 && row < Tn)
        p.psum[static_cast<long long>(bh) * Tn + row] += x;
    }
  }
  bf16* out = static_cast<bf16*>(p.out0);
  const long long ld = static_cast<long long>(p.H) * p.d;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int row = r_lo + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + cq;
    if (row < Tn && col < p.d)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<long long>(row) * p.B + b) * ld +
          static_cast<long long>(h) * p.d + col) =
          __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
  }
}

// ---------------------------------------------------------------- launch
template <typename K>
int prepare(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T, int DP>
int launch(int which, const void* q, const void* k, const void* v,
           const void* g, void* o, void* m, void* l, const void* delta,
           void* o2, int Tn, int B, int H, int d, const Strides& st,
           float scale, const Drop& dr, const int* plan,
           cudaStream_t stream) {
  dim3 grid(B * H, (Tn + Geo<DP>::BR - 1) / Geo<DP>::BR);
  if (plan != nullptr) {  // the wrapper's plan, on the kernel's geometry
    if (plan[4] != Geo<DP>::BR || plan[5] != Geo<DP>::BR ||
        plan[6] != THREADS)
      return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(plan[1], plan[2]);
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  int err = 0;
  if (which == 0) {
    auto kernel = attn_train_fwd_kernel<T, DP>;
    if ((err = prepare(kernel, fwd_smem<DP>()))) return err;
    kernel<<<grid, THREADS, fwd_smem<DP>(), stream>>>(
        qt, kt, vt, static_cast<T*>(o), static_cast<float*>(m),
        static_cast<float*>(l), Tn, B, H, d, st, scale, dr);
  } else if (which == 1) {
    auto kernel = attn_train_dq_kernel<T, DP>;
    if ((err = prepare(kernel, dq_smem<DP>()))) return err;
    kernel<<<grid, THREADS, dq_smem<DP>(), stream>>>(
        qt, kt, vt, gt, static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta),
        static_cast<T*>(o), Tn, B, H, d, st, scale, dr);
  } else {
    auto kernel = attn_train_dkv_kernel<T, DP>;
    if ((err = prepare(kernel, dkv_smem<DP>()))) return err;
    kernel<<<grid, THREADS, dkv_smem<DP>(), stream>>>(
        qt, kt, vt, gt, static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta),
        static_cast<T*>(o), static_cast<T*>(o2), Tn, B, H, d, st, scale, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int which, const void* q, const void* k, const void* v,
             const void* g, void* o, void* m, void* l, const void* delta,
             void* o2, int Tn, int B, int H, int d, const Strides& st,
             float scale, const Drop& dr, const int* plan, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                         st, scale, dr, plan, s);
  if (d <= 64)
    return launch<T, 64>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                         st, scale, dr, plan, s);
  if (d <= 128)
    return launch<T, 128>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H,
                          d, st, scale, dr, plan, s);
  return launch<T, 256>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                        st, scale, dr, plan, s);
}

template <int NC>
int launch_wgmma(int which, const WgParams& prm, int grid, cudaStream_t s) {
  int err = 0;
  if (which == 0) {
    auto kernel = attn_fwd_wgmma<NC>;
    if ((err = prepare(kernel, FwdGeo<NC>::SMEM))) return err;
    kernel<<<grid, WG_THREADS, FwdGeo<NC>::SMEM, s>>>(prm);
  } else if (which == 1) {
    auto kernel = attn_dq_wgmma<NC>;
    if ((err = prepare(kernel, DqGeo<NC>::SMEM))) return err;
    kernel<<<grid, WG_THREADS, DqGeo<NC>::SMEM, s>>>(prm);
  } else {
    auto kernel = attn_dkv_wgmma<NC>;
    if ((err = prepare(kernel, DkvGeo<NC>::SMEM))) return err;
    kernel<<<grid, WG_THREADS, DkvGeo<NC>::SMEM, s>>>(prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows 15 (which 0), 16 (1) and 17 (2) on the tensor cores: bf16, d <= 128,
// d % 8 == 0, 16-byte aligned views and strides (the wrapper's `_design`),
// on the wrapper's plan
int run_wgmma(int which, const void* q, const void* k, const void* v,
              const void* g, void* o, void* m, void* l, const void* delta,
              void* o2, void* psum, int Tn, int B, int H, int d,
              const long long* strides, float scale, const Drop& dr,
              const int* plan, cudaStream_t s) {
  // the rows a CTA's q (and dO) maps load and the keys of the K, V maps
  const int dq_keys = d <= CH ? DqGeo<1>::KT : DqGeo<2>::KT;
  const int rows = which == 2 ? BQ : FQ;
  const int keys = which == 0 ? FK : which == 1 ? dq_keys : BK;
  if (d > 128 || d % 8 || plan[2] != 1 || plan[4] != rows ||
      plan[5] != keys || plan[6] != WG_THREADS)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  WgParams prm = {};
  int r = encode_view(enc, &prm.qmap, q, Tn, B, H, d, strides[0],
                      strides[1], rows);
  if (r == 0)
    r = encode_view(enc, &prm.kmap, k, Tn, B, H, d, strides[2], strides[3],
                    keys);
  if (r == 0)
    r = encode_view(enc, &prm.vmap, v, Tn, B, H, d, strides[4], strides[5],
                    keys);
  if (r == 0 && which != 0)
    r = encode_view(enc, &prm.gmap, g, Tn, B, H, d, strides[6], strides[7],
                    rows);
  if (r != 0) return -1000 - r;
  prm.out0 = o;
  prm.out1 = o2;
  prm.m = static_cast<float*>(m);
  prm.l = static_cast<float*>(l);
  prm.delta = static_cast<const float*>(delta);
  prm.psum = static_cast<float*>(psum);
  prm.T = Tn;
  prm.B = B;
  prm.H = H;
  prm.d = d;
  prm.BH = B * H;
  prm.ntiles = plan[3];
  prm.scale = scale;
  prm.dr = dr;
  return d <= CH ? launch_wgmma<1>(which, prm, plan[1], s)
                 : launch_wgmma<2>(which, prm, plan[1], s);
}

int run(int which, const void* q, const void* k, const void* v,
        const void* g, void* o, void* m, void* l, const void* delta,
        void* o2, int Tn, int B, int H, int d, const long long* strides,
        float scale, const void* seed, unsigned thresh, float inv_keep,
        int bq, int dropout, void* keep_out, int is_bf16, const int* plan,
        void* psum, void* stream) {
  if (Tn == 0 || B == 0 || H == 0) return 0;
  const bool wgmma = plan != nullptr && plan[0] != 0;
  if (d <= 0 || d > 256 || bq <= 0 || bq % 8 || (wgmma && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Drop dr{static_cast<const int*>(seed), thresh, inv_keep, bq,
                (Tn + bq - 1) / bq, dropout,
                static_cast<uint8_t*>(keep_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma)
    return run_wgmma(which, q, k, v, g, o, m, l, delta, o2, psum, Tn, B, H,
                     d, strides, scale, dr, plan, s);
  return is_bf16
             ? dispatch<bf16>(which, q, k, v, g, o, m, l, delta, o2, Tn, B,
                              H, d, st, scale, dr, plan, s)
             : dispatch<float>(which, q, k, v, g, o, m, l, delta, o2, Tn, B,
                               H, d, st, scale, dr, plan, s);
}

}  // namespace

// Common arguments: q, k, v (and dO for the backward) are (T, B, H d) views
// of bf16 (is_bf16 = 1) or fp32 tensors with unit stride along the features;
// strides = {q_t, q_b, k_t, k_b, v_t, v_b, g_t, g_b} in elements (g = dO;
// ignored by the forward). Outputs are contiguous (T, B, H d) of the same
// type; m, l, delta fp32 (B H, T). seed: device int32 (1,); dropout = 0
// turns it off (rate 0); thresh = floor(keep 2^24), inv_keep = 1 / keep in
// fp32, bq = min(128, round_up(T, 8)). keep_out: null, or (B H, T, T)
// uint8 that receives every keep bit the kernel draws. d <= 256. plan: the
// wrapper's launch plan (`_fwd_plan`, `_dq_plan`, `_dkv_plan`), {design,
// grid x, grid y, tiles, rows, keys, threads}, design 1 the wgmma kernels
// (bf16, d <= 128, d % 8 == 0, 16-byte aligned views and strides) and 0 the
// CUDA-core ones; launched on its grid (and, for wgmma, its count of tiles)
// and refused unless its rows, keys and threads are the kernel's. psum
// (rows 16-17): null, or (B H, T) fp32 zeros to which the wgmma design adds
// sum_c P of every row it rebuilds from (m, l) (a debug output, as
// keep_out). Each returns the launch error, or 0; the wgmma design -1 where
// the driver's cuTensorMapEncodeTiled is not found, -1000 - r where it
// refuses a descriptor with r.

// row 15: o, m, l from q, k, v
extern "C" int attn_train_fwd(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int Tn, int B,
                              int H, int d, const long long* strides,
                              float scale, const void* seed, unsigned thresh,
                              float inv_keep, int bq, int dropout,
                              void* keep_out, int is_bf16, const int* plan,
                              void* stream) {
  return run(0, q, k, v, nullptr, o, m, l, nullptr, nullptr, Tn, B, H, d,
             strides, scale, seed, thresh, inv_keep, bq, dropout, keep_out,
             is_bf16, plan, nullptr, stream);
}

// row 16: dq from q, k, v, dO, m, l, delta
extern "C" int attn_train_dq(const void* q, const void* k, const void* v,
                             const void* g, const void* m, const void* l,
                             const void* delta, void* dq, int Tn, int B,
                             int H, int d, const long long* strides,
                             float scale, const void* seed, unsigned thresh,
                             float inv_keep, int bq, int dropout,
                             void* keep_out, int is_bf16, const int* plan,
                             void* psum, void* stream) {
  return run(1, q, k, v, g, dq, const_cast<void*>(m), const_cast<void*>(l),
             delta, nullptr, Tn, B, H, d, strides, scale, seed, thresh,
             inv_keep, bq, dropout, keep_out, is_bf16, plan, psum, stream);
}

// row 17: dk, dv from q, k, v, dO, m, l, delta
extern "C" int attn_train_dkv(const void* q, const void* k, const void* v,
                              const void* g, const void* m, const void* l,
                              const void* delta, void* dk, void* dv, int Tn,
                              int B, int H, int d, const long long* strides,
                              float scale, const void* seed, unsigned thresh,
                              float inv_keep, int bq, int dropout,
                              void* keep_out, int is_bf16, const int* plan,
                              void* psum, void* stream) {
  return run(2, q, k, v, g, dk, const_cast<void*>(m), const_cast<void*>(l),
             delta, dv, Tn, B, H, d, strides, scale, seed, thresh, inv_keep,
             bq, dropout, keep_out, is_bf16, plan, psum, stream);
}
