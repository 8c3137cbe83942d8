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
// never on these kernels' own 64- or 32-row tiles: all three kernels and the
// plain twin (ops/attention_train_cuda.py) draw it again bit for bit. The
// seed is a device int32 read by the kernels (no host round trip). With
// `keep_out` set, each kernel also writes every keep bit it draws, (B H, T,
// T) uint8, for the checks against the twin.
//
// Differences from the TPU kernels. The TPU forward holds a (batch, head)'s
// whole K and V in VMEM per q-block and takes the row max in one pass; at
// T = 8,192, d = 256 that is far beyond an SM's 227 KB. The forward here
// streams key tiles twice: the row max first, then p = exp(s - m) against
// it, so that it rounds z p to the compute dtype exactly where the TPU
// does (a running max, as row 14 keeps, would round z exp(s - m_running)
// instead), at the price of computing S twice. The TPU's dq and dkv grids
// visit every (q-block, k-block) pair; these kernels skip the tiles above
// the diagonal. Ragged T is masked here, not padded. q, k, v and dO are
// read in place through their (time, batch) strides, so the fused qkv
// projection's column views need no copy.
//
// Design: one block of 256 threads owns a tile of BR query rows (rows 15,
// 16) or key rows (row 17) of one (b, h), BR = 64 for d <= 64 and 32 for
// wider heads (shared memory: up to 223 KB at d = 256). Per partner tile it
// forms the BR x BR score (and dP) patches on the fp32 CUDA cores, each
// thread a (BR/16)^2 patch with the operands transposed in shared memory,
// then folds them into per-row state (row 15: the row max, then the sum
// and the output accumulator; 16: dQ; 17: dK and dV accumulators, each
// thread a slice of one row's columns). d up to 256 (tile widths 32, 64,
// 128, 256; columns past d are zero).
//
// Bound on the H100 at the long-context step (B h = 32 x 8, T = 1,024,
// d = 64, bf16): the causal work is 34 GFLOP forward (two products) and
// 120 GFLOP backward (seven), 0.035 and 0.12 ms at the bf16 tensor-core
// peak; the bytes (q, k, v, o, m, l; dO, delta, dq, dk, dv) ~0.04 ms each
// at 3.35 TB/s. These kernels do that work (and the forward's second S) on
// the fp32 CUDA cores (67 TFLOP/s peak), which bounds them at ~0.8 and
// ~1.8 ms; wmma/wgmma tiles in bf16 are the later redesign (ROADMAP.md
// queue B).
//
// Compile-time faults for chip_smoke.py's planted-fault checks (never set by
// the port): ATTN_TRAIN_FAULT=1 drops the k-block index from the dropout
// key, =2 masks the diagonal too (c < r).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bayes_philox.cuh"

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
           float scale, const Drop& dr, cudaStream_t stream) {
  const dim3 grid(B * H, (Tn + Geo<DP>::BR - 1) / Geo<DP>::BR);
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
             float scale, const Drop& dr, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                         st, scale, dr, s);
  if (d <= 64)
    return launch<T, 64>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                         st, scale, dr, s);
  if (d <= 128)
    return launch<T, 128>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H,
                          d, st, scale, dr, s);
  return launch<T, 256>(which, q, k, v, g, o, m, l, delta, o2, Tn, B, H, d,
                        st, scale, dr, s);
}

int run(int which, const void* q, const void* k, const void* v,
        const void* g, void* o, void* m, void* l, const void* delta,
        void* o2, int Tn, int B, int H, int d, const long long* strides,
        float scale, const void* seed, unsigned thresh, float inv_keep,
        int bq, int dropout, void* keep_out, int is_bf16, void* stream) {
  if (Tn == 0 || B == 0 || H == 0) return 0;
  if (d <= 0 || d > 256 || bq <= 0 || bq % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const Drop dr{static_cast<const int*>(seed), thresh, inv_keep, bq,
                (Tn + bq - 1) / bq, dropout,
                static_cast<uint8_t*>(keep_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch<bf16>(which, q, k, v, g, o, m, l, delta, o2, Tn, B,
                              H, d, st, scale, dr, s)
             : dispatch<float>(which, q, k, v, g, o, m, l, delta, o2, Tn, B,
                               H, d, st, scale, dr, s);
}

}  // namespace

// Common arguments: q, k, v (and dO for the backward) are (T, B, H d) views
// of bf16 (is_bf16 = 1) or fp32 tensors with unit stride along the features;
// strides = {q_t, q_b, k_t, k_b, v_t, v_b, g_t, g_b} in elements (g = dO;
// ignored by the forward). Outputs are contiguous (T, B, H d) of the same
// type; m, l, delta fp32 (B H, T). seed: device int32 (1,); dropout = 0
// turns it off (rate 0); thresh = floor(keep 2^24), inv_keep = 1 / keep in
// fp32, bq = min(128, round_up(T, 8)). keep_out: null, or (B H, T, T)
// uint8 that receives every keep bit the kernel draws. d <= 256. Each
// returns the launch error, or 0.

// row 15: o, m, l from q, k, v
extern "C" int attn_train_fwd(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int Tn, int B,
                              int H, int d, const long long* strides,
                              float scale, const void* seed, unsigned thresh,
                              float inv_keep, int bq, int dropout,
                              void* keep_out, int is_bf16, void* stream) {
  return run(0, q, k, v, nullptr, o, m, l, nullptr, nullptr, Tn, B, H, d,
             strides, scale, seed, thresh, inv_keep, bq, dropout, keep_out,
             is_bf16, stream);
}

// row 16: dq from q, k, v, dO, m, l, delta
extern "C" int attn_train_dq(const void* q, const void* k, const void* v,
                             const void* g, const void* m, const void* l,
                             const void* delta, void* dq, int Tn, int B,
                             int H, int d, const long long* strides,
                             float scale, const void* seed, unsigned thresh,
                             float inv_keep, int bq, int dropout,
                             void* keep_out, int is_bf16, void* stream) {
  return run(1, q, k, v, g, dq, const_cast<void*>(m), const_cast<void*>(l),
             delta, nullptr, Tn, B, H, d, strides, scale, seed, thresh,
             inv_keep, bq, dropout, keep_out, is_bf16, stream);
}

// row 17: dk, dv from q, k, v, dO, m, l, delta
extern "C" int attn_train_dkv(const void* q, const void* k, const void* v,
                              const void* g, const void* m, const void* l,
                              const void* delta, void* dk, void* dv, int Tn,
                              int B, int H, int d, const long long* strides,
                              float scale, const void* seed, unsigned thresh,
                              float inv_keep, int bq, int dropout,
                              void* keep_out, int is_bf16, void* stream) {
  return run(2, q, k, v, g, dk, const_cast<void*>(m), const_cast<void*>(l),
             delta, dv, Tn, B, H, d, strides, scale, seed, thresh, inv_keep,
             bq, dropout, keep_out, is_bf16, stream);
}
