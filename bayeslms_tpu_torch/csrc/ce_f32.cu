// Fused tied-decoder cross-entropy for scoring, float32 operands, for
// sm_90a: the float32 counterpart of kernel row 2.
//
// Replaces, for float32 operands, bayeslms_tpu/ops/ce_pallas.py
// `fused_decode_ce` (the `_kernel` body that `_run` hands to pallas_call).
// That kernel casts the table to h's dtype and dots in it, so at float32 it
// takes float32 products. For each token m:
//   ce[m] = log sum_v exp(h_m . E_v + b_v) - (h_m . E_{t_m} + b_{t_m}),
// float32 h (M, D), E (V, D), b (V), ce (M). The (M, V) logits never reach
// device memory. ops/ce_cuda.py sends float32 calls here and bf16 ones to
// row 9's forward (csrc/ce_train.cu) or csrc/ce_fwd.cu, which stay as they
// are. A target of -1 hits no word (its logit counts as 0).
//
// Arithmetic: float32 products on the CUDA cores, each logit one chain of
// FMAs over D in order (fp32), then + b. Not TF32: one TF32 pass keeps about
// three decimal digits of each operand; 3xTF32 would qualify at about 2.5x
// the CUDA cores' rate and is left to a redesign (the build with
// -DCE_F32_FAULT=1 rounds every operand to TF32 in one pass, chip_smoke.py's
// planted fault). The exponentials are expf, the log logf (not the fast
// intrinsics).
//
// Design: `ce_f32_split`, a classic register-tiled SGEMM whose epilogue
// folds each score tile away. A CTA of 256 threads owns 128 tokens and
// walks its part of the vocabulary in tiles of 128 words; the D loop stages
// 16-deep chunks of h and E k-major in shared memory, and a thread
// accumulates an 8 x 8 block of scores (rows 4 ty + i and 64 + 4 ty + i,
// columns 4 tx + j and 64 + 4 tx + j, each pair of four read as one
// float4). After each tile a thread adds the bias (-inf past V), takes its
// 8 columns' max per row, sums their exponentials against the new running
// max and adds that tile sum to its running sum-exp (one addition a tile
// into the running sum, not one an element), and picks up the target's
// logit where it holds the target's column. At the end the 16 threads that
// share a row (a half warp) merge their (max, sum-exp, target) by shuffles.
// The vocabulary walk is split into S parts (the grid's y) where the token
// tiles alone do not fill the card (ops/ce_cuda.py `f32_plan`); each part
// writes its (max, sum-exp, target logit) to a (3, S, M) workspace, and
// `ce_f32_merge` combines them per token in part order, as row 9's
// `ce_stats_merge` does: max = max_p max_p, sumexp = sum_p sumexp_p
// exp(max_p - max), ce = log sumexp + max - s_target. No atomics: two calls
// give the same bits.
//
// Bound on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s; NVIDIA
// data sheet, 700 W): 2 M V D flops. At the bench width (M = 90,279,
// V = 49,152, D = 1,024) 9.09 TFLOP, 135.6 ms, against 0.6 GB of h and E:
// operations bound; at the in-repo checkpoints' (V = 10,000, D = 256,
// M ~ 0.1 M) about 0.5 TFLOP, ~8 ms. Each token tile reads all of its part
// of E (from L2 where E fits it). Times: chip_smoke.py `f32 kernels`
// (PERF.md, row 2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CM = 128;        // tokens a CTA
constexpr int CV = 128;        // vocabulary rows a tile
constexpr int CK = 16;         // D columns a chunk
constexpr int CP = CM + 4;     // fp32 pitch of the k-major tiles
constexpr int CTHREADS = 256;  // 16 x 16 threads, 8 x 8 scores each

__device__ __forceinline__ float operand(float x) {
#ifdef CE_F32_FAULT
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  return x;
#endif
}

// index of a thread's i-th row (or column) of 8 in a 128-wide tile
__device__ __forceinline__ int half_index(int t, int i) {
  return (i < 4 ? 0 : 64) + 4 * t + (i & 3);
}

// Partials of tokens [128 x, 128 x + 128) over vocabulary tiles
// [y tpp, min((y + 1) tpp, ceil(V / 128))): ws (3, S, M) fp32 holds each
// part's max, sum-exp and target logit.
__global__ void __launch_bounds__(CTHREADS)
ce_f32_split(const float* __restrict__ h, const float* __restrict__ emb,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             float* __restrict__ ws, int M, int V, int D, int tpp) {
  __shared__ __align__(16) float Hs[CK * CP];
  __shared__ __align__(16) float Es[CK * CP];

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows half_index(ty, i)
  const int tx = tid & 15;  // columns half_index(tx, j)
  const int m0 = blockIdx.x * CM;
  const int part = blockIdx.y;
  const int S = gridDim.y;
  const int n_tiles = (V + CV - 1) / CV;
  const int vt0 = part * tpp;
  const int vt1 = min(vt0 + tpp, n_tiles);

  int t_row[8];
  float mx[8], se[8], tl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + half_index(ty, i);
    t_row[i] = m < M ? tgt[m] : -1;
    mx[i] = -INFINITY;
    se[i] = 0.f;
    tl[i] = 0.f;
  }

  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * CV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += CK) {
      // h and E chunks: 128 rows x 16 columns each, a row's 16 floats read
      // by 16 neighbouring threads
      for (int i = tid; i < CM * CK; i += CTHREADS) {
        const int r = i / CK, kk = i % CK, k = k0 + kk;
        const int m = m0 + r, v = v0 + r;
        Hs[kk * CP + r] =
            operand((m < M && k < D) ? h[(size_t)m * D + k] : 0.f);
        Es[kk * CP + r] =
            operand((v < V && k < D) ? emb[(size_t)v * D + k] : 0.f);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < CK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(Hs + kk * CP + 4 * ty);
        const float4 a1 =
            *reinterpret_cast<const float4*>(Hs + kk * CP + 64 + 4 * ty);
        const float4 e0 =
            *reinterpret_cast<const float4*>(Es + kk * CP + 4 * tx);
        const float4 e1 =
            *reinterpret_cast<const float4*>(Es + kk * CP + 64 + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold the tile: bias, the row max of the thread's 8 columns, the sum
    // of their exponentials against the new running max, the target
    float bv[8];
    int vc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vc[j] = v0 + half_index(tx, j);
      bv[j] = vc[j] < V ? bias[vc[j]] : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += bv[j];
        tmax = fmaxf(tmax, acc[i][j]);
        if (vc[j] == t_row[i]) tl[i] += acc[i][j];
      }
      if (tmax == -INFINITY) continue;  // all 8 columns past V
      const float nm = fmaxf(mx[i], tmax);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) ts += expf(acc[i][j] - nm);
      se[i] = (mx[i] == -INFINITY ? 0.f : se[i] * expf(mx[i] - nm)) + ts;
      mx[i] = nm;
    }
  }

  // merge the 16 threads of a row (a half warp: tid = 16 ty + tx)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[i], off, 16);
      const float os = __shfl_xor_sync(0xffffffffu, se[i], off, 16);
      const float ot = __shfl_xor_sync(0xffffffffu, tl[i], off, 16);
      const float nm = fmaxf(mx[i], om);
      const float a = mx[i] == -INFINITY ? 0.f : se[i] * expf(mx[i] - nm);
      const float b = om == -INFINITY ? 0.f : os * expf(om - nm);
      se[i] = a + b;
      mx[i] = nm;
      tl[i] += ot;
    }
  }
  if (tx == 0) {
    const size_t plane = (size_t)S * M;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + half_index(ty, i);
      if (m >= M) continue;
      const size_t o = (size_t)part * M + m;
      ws[o] = mx[i];
      ws[plane + o] = se[i];
      ws[2 * plane + o] = tl[i];
    }
  }
}

// ce of each token from its parts' partials, in part order (a part that
// met no word of the table holds max -inf and sum-exp 0)
__global__ void ce_f32_merge(const float* __restrict__ ws,
                             float* __restrict__ ce, int M, int S) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t plane = (size_t)S * M;
  float big = ws[m];
  for (int k = 1; k < S; ++k) big = fmaxf(big, ws[(size_t)k * M + m]);
  float sum = 0.f, tl = 0.f;
  for (int k = 0; k < S; ++k) {
    const size_t o = (size_t)k * M + m;
    if (ws[o] != -INFINITY) sum += ws[plane + o] * expf(ws[o] - big);
    tl += ws[2 * plane + o];
  }
  ce[m] = logf(sum) + big - tl;
}

}  // namespace

// h (M, D), emb (V, D), bias (V) fp32; tgt (M) int32; ws a (3, S, M) fp32
// workspace; out (M) fp32; tpp vocabulary tiles of 128 a part, S parts
// (ops/ce_cuda.py `f32_plan`). Two launches on the caller's stream.
// Returns the first launch error, or 0.
extern "C" int ce_f32(const void* h, const void* emb, const void* bias,
                      const void* tgt, void* ws, void* out, int M, int V,
                      int D, int S, int tpp, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + CM - 1) / CM, S);
  ce_f32_split<<<grid, CTHREADS, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(emb),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(ws), M, V, D, tpp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_f32_merge<<<(M + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), M, S);
  return (int)cudaGetLastError();
}
