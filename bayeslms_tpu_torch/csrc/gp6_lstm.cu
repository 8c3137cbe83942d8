// GP-LSTM gate-6 recurrence (the GP unit in place of the hidden
// projection), forward and backward, for sm_90a (bf16 operands, fp32
// accumulation, fp32 carries).
//
// Replaces bayeslms_tpu/ops/gp_lstm_pallas.py `_gp_fwd_kernel` (pallas_call
// in `_gp_fwd_run`) and `_gp_bwd_kernel` (`_gp_bwd_run`), the two halves of
// the custom VJP `gp6_scan_fused` behind `gp6_layer_fused`. With W' (4H, H)
// the drawn GP weight, b' (4H) its bias and coef (3, 4H) the mixture
// coefficients of the act set (sigmoid, tanh, relu), for t = 0..T-1:
//   pre   = h_{t-1} W'^T + b'          h rounded to bf16 for the product,
//                                      b' stored in bf16, widened to fp32
//   gates = xg[t] + sum_a coef[a] act_a(pre)     coef in fp32; NO second
//                                      bias: xg = x W_ih^T + b_ih carries
//                                      b_ih once (the gate-6 contract)
// then the standard cell, gate order [i, f, g, o]: c = f c + i g;
// h = o tanh(c); where mask[t, b] = 0 the column keeps its (h, c). ys[t] = h
// and cs[t] = c are stored in bf16; h and c are carried in fp32.
// Backward, t = T-1..0 (`_gp_bwd_kernel`, term for term): the step is
// recomputed from (xg[t], h_{t-1}, c_{t-1}) with h_{t-1} = ys[t-1] (h0 at
// t = 0) and c_{t-1} = cs[t-1] (c0), both bf16, then
//   dh_tot = dh + dy[t], dh' = keep dh_tot, dc' = keep dc,
//   do = dh' tanh(c), dc_c = dc' + dh' o (1 - tanh(c)^2),
//   di = dc_c g, df = dc_c c_{t-1}, dg = dc_c i, dc = dc_c f + (1-keep) dc,
//   du = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)]     (d xg = du)
//   dcoef[a] += sum over the batch of du act_a(pre), fp32 over the sweep;
//   dpre = du (coef[0] s(1-s) + coef[1] (1-tanh^2) + coef[2] [pre > 0]);
//   dux[t] = du and dupre[t] = dpre stored in bf16;
//   dh = dupre[t] W' + (1 - keep) dh_tot, the product on the bf16 dupre.
// Outside the kernels (the TPU package leaves them to XLA): dW' = dupre^T
// hprev, an fp32 product rounded to W's dtype; db' = sum dupre in fp32,
// rounded to bf16 (b' entered the custom VJP in bf16); d xg = dux.
//
// Design (rows 5-6's, csrc/lstm_train.cu, with a mixture epilogue; the tile
// functions of csrc/gate_tile.cuh at four row groups): the host functions
// loop over t and launch on the caller's stream. The forward is one launch
// a step: a block owns BM batch columns and BJ hidden units and computes
// the four rows (q*H + j) of them, so the mixture and the cell update need
// nothing from other blocks and h, c update in place; the product's A
// operand is the bf16 ys[t-1] (h0 at t = 0), the fp32 carry rounded as the
// TPU kernel rounds it. The backward is two launches a step, since dh_{t-1}
// contracts dupre_t over all 4H rows:
//   (a) `gp6_bwd_gates`: the forward's tile, recomputing the step, writes
//       dux_t and dupre_t, updates the fp32 dc carry in place and adds the
//       block's dcoef partial (each thread sums its rows, the block sums
//       its thread rows in a fixed order) to an fp32 accumulator of its
//       own, one per column block;
//   (b) `gp6_bwd_dh`: `dh_tile<4>` on dupre_t, as `lstm_bwd_dh` on du.
// After the sweep `gp6_dcoef_sum` adds the column blocks' accumulators in
// order: repeat calls give the same bits. Products run on the tensor cores
// through wmma (16x16x16 bf16, fp32 accumulators).
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 and 3.35 TB/s: forward 2 T B H 4H =
// 26.8 GFLOP, 0.027 ms (its ~48 MB, 0.014 ms); backward twice the
// operations, 0.054 ms (~107 MB, 0.032 ms). Operations bound, but both are
// far from it: the steps are dependent launches (100 forward, 200
// backward), each a small tile product loading its tiles synchronously on
// 32 blocks, so they are bound by latency, as rows 5-6 and 20-21 are. A
// persistent kernel with W' in the SMs' shared memory is the later
// redesign.
//
// Planted faults for the on-card check (chip_smoke.py), off by default:
// -DGP6_FAULT=1 drops the relu term from dpre; -DGP6_FAULT=2 drops the
// dcoef accumulation.

#include "gate_tile.cuh"

#ifndef GP6_FAULT
#define GP6_FAULT 0
#endif

namespace {

constexpr int NG = 4;  // the four gates
constexpr int THREADS = GateTile<NG>::THREADS;
constexpr int LDG = GateTile<NG>::LDG;
constexpr int SMEM = GateTile<NG>::SMEM;
constexpr int NACT = 3;           // sigmoid, tanh, relu
constexpr int RG = THREADS / BJ;  // thread rows: a thread keeps its unit u

// Step t's gate q of element (b, j) from the product tile row gs: the GP
// unit's pre-activation, its three acts and the gate pre-activation
// xg + sum_a coef[a] act_a(pre).
struct Mix {
  float pre, s, th, r, gate;
  __device__ __forceinline__ Mix(float acc, const bf16* __restrict__ bg,
                                 const float* __restrict__ coef,
                                 const bf16* __restrict__ xg_row, int n,
                                 int G) {
    pre = acc + __bfloat162float(bg[n]);
    s = sigmoidf(pre);
    th = tanhf(pre);
    r = fmaxf(pre, 0.0f);
    gate = __bfloat162float(xg_row[n]) +
           (coef[n] * s + coef[G + n] * th + coef[2 * G + n] * r);
  }
};

// One forward step. a = h_{t-1} in bf16 (h0 or ys[t-1]); h, c are the fp32
// carries, updated in place (each element by the one thread that owns it).
__global__ void __launch_bounds__(THREADS)
gp6_fwd_step(const bf16* __restrict__ a, const bf16* __restrict__ w,
             const bf16* __restrict__ xg_t, const bf16* __restrict__ bg,
             const float* __restrict__ coef,
             const uint8_t* __restrict__ mask_t, float* __restrict__ h,
             float* __restrict__ c, bf16* __restrict__ y_t,
             bf16* __restrict__ c_t, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  const int G = 4 * H;
  gate_tile<NG>(a, w, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    const bf16* xg_row = xg_t + (size_t)b * G;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = Mix(Gs[r * LDG + q * BJ + u], bg, coef, xg_row, q * H + j, G)
                 .gate;
    const size_t e = (size_t)b * H + j;
    float cn = sigmoidf(g[1]) * c[e] + sigmoidf(g[0]) * tanhf(g[2]);
    float hn = sigmoidf(g[3]) * tanhf(cn);
    if (mask_t != nullptr && !mask_t[b]) {
      hn = h[e];
      cn = c[e];
    }
    h[e] = hn;
    c[e] = cn;
    y_t[e] = __float2bfloat16(hn);
    c_t[e] = __float2bfloat16(cn);
  }
}

// Backward (a): recompute step t, write dux_t and dupre_t, update dc in
// place, add the block's dcoef partial to acc (NACT, 4H) of its column
// block.
__global__ void __launch_bounds__(THREADS)
gp6_bwd_gates(const bf16* __restrict__ hprev, const bf16* __restrict__ cprev,
              const bf16* __restrict__ w, const bf16* __restrict__ xg_t,
              const bf16* __restrict__ bg, const float* __restrict__ coef,
              const uint8_t* __restrict__ mask_t,
              const bf16* __restrict__ dy_t, const float* __restrict__ dh,
              float* __restrict__ dc, bf16* __restrict__ dux_t,
              bf16* __restrict__ dupre_t, float* __restrict__ dcoef_acc,
              int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  // a thread row's dcoef partial, per (act, gate, thread row, unit)
  __shared__ float Ps[NACT * NG * RG * BJ];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  const int G = 4 * H;
  gate_tile<NG>(hprev, w, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  float part[NACT][NG];
#pragma unroll
  for (int a = 0; a < NACT; ++a)
#pragma unroll
    for (int q = 0; q < NG; ++q) part[a][q] = 0.0f;
  // THREADS is a multiple of BJ: a thread's elements share its unit u
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    const bf16* xg_row = xg_t + (size_t)b * G;
    float pre[4], s[4], th[4], rl[4], g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Mix m(Gs[r * LDG + q * BJ + u], bg, coef, xg_row, q * H + j, G);
      pre[q] = m.pre;
      s[q] = m.s;
      th[q] = m.th;
      rl[q] = m.r;
      g[q] = m.gate;
    }
    const float ig = sigmoidf(g[0]);
    const float fg = sigmoidf(g[1]);
    const float gg = tanhf(g[2]);
    const float og = sigmoidf(g[3]);
    const size_t e = (size_t)b * H + j;
    const float cp = __bfloat162float(cprev[e]);
    const float tc = tanhf(fg * cp + ig * gg);
    const float keep = (mask_t != nullptr && !mask_t[b]) ? 0.f : 1.f;
    const float dh_tot = dh[e] + __bfloat162float(dy_t[e]);
    const float dhn = keep * dh_tot;
    const float dcn = keep * dc[e];
    const float d_o = dhn * tc;
    const float dcc = dcn + dhn * og * (1.0f - tc * tc);
    const float d_i = dcc * gg;
    const float d_f = dcc * cp;
    const float d_g = dcc * ig;
    dc[e] = dcc * fg + (1.0f - keep) * dc[e];
    const float du[4] = {d_i * ig * (1.0f - ig), d_f * fg * (1.0f - fg),
                         d_g * (1.0f - gg * gg), d_o * og * (1.0f - og)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * H + j;
      part[0][q] += du[q] * s[q];
      part[1][q] += du[q] * th[q];
      part[2][q] += du[q] * rl[q];
      const float relu_d = (GP6_FAULT == 1 || !(pre[q] > 0.0f)) ? 0.f : 1.f;
      const float dpre = du[q] * (coef[n] * s[q] * (1.0f - s[q]) +
                                  coef[G + n] * (1.0f - th[q] * th[q]) +
                                  coef[2 * G + n] * relu_d);
      dux_t[(size_t)b * G + n] = __float2bfloat16(du[q]);
      dupre_t[(size_t)b * G + n] = __float2bfloat16(dpre);
    }
  }
  const int rg = threadIdx.x / BJ;
  const int uu = threadIdx.x % BJ;
#pragma unroll
  for (int a = 0; a < NACT; ++a)
#pragma unroll
    for (int q = 0; q < NG; ++q)
      Ps[((a * NG + q) * RG + rg) * BJ + uu] = part[a][q];
  __syncthreads();
  if (GP6_FAULT == 2) return;
  for (int k = threadIdx.x; k < NACT * NG * BJ; k += THREADS) {
    const int a = k / (NG * BJ);
    const int q = (k / BJ) % NG;
    const int u = k % BJ;
    float sum = 0.0f;
    for (int p = 0; p < RG; ++p) sum += Ps[((a * NG + q) * RG + p) * BJ + u];
    dcoef_acc[((size_t)blockIdx.x * NACT + a) * G + q * H + j0 + u] += sum;
  }
}

// Backward (b): dh = dupre_t W' + (1 - keep) dh_tot, in place.
__global__ void __launch_bounds__(DH_THREADS)
gp6_bwd_dh(const bf16* __restrict__ dupre_t, const bf16* __restrict__ w,
           const uint8_t* __restrict__ mask_t, const bf16* __restrict__ dy_t,
           float* __restrict__ dh, int B, int H) {
  dh_tile<NG>(dupre_t, w, mask_t, dy_t, dh, B, H);
}

// dcoef[i] = sum over column blocks, in order, of acc[blk][i]
__global__ void gp6_dcoef_sum(const float* __restrict__ acc,
                              float* __restrict__ dcoef, int nblk, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += acc[(size_t)k * n + i];
  dcoef[i] = s;
}

}  // namespace

// Forward over the whole sequence. xg (T, B, 4H) bf16; w (4H, H) bf16, the
// drawn GP weight as stored; bg (4H) bf16; coef (3, 4H) fp32; mask (T, B)
// bytes or null; h0 (B, H) bf16; h, c (B, H) fp32 carries holding the
// initial state (the final state on return); ys, cs (T, B, H) bf16
// outputs. Returns the first launch error, or 0.
extern "C" int gp6_fwd(const void* xg, const void* w, const void* bg,
                       const void* coef, const void* mask, const void* h0,
                       void* h, void* c, void* ys, void* cs, int T, int B,
                       int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  bf16* y = static_cast<bf16*>(ys);
  bf16* cc = static_cast<bf16*>(cs);
  for (int t = 0; t < T; ++t) {
    const bf16* a = t == 0 ? static_cast<const bf16*>(h0) : y + (t - 1) * BH;
    gp6_fwd_step<<<grid, THREADS, 0, st>>>(
        a, static_cast<const bf16*>(w),
        static_cast<const bf16*>(xg) + (size_t)t * BH * 4,
        static_cast<const bf16*>(bg), static_cast<const float*>(coef),
        m != nullptr ? m + (size_t)t * B : nullptr, static_cast<float*>(h),
        static_cast<float*>(c), y + t * BH, cc + t * BH, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Backward over the whole sequence, t = T-1..0. The forward's inputs and
// outputs ys, cs, with c0 (B, H) and dy (T, B, H) bf16; dh, dc (B, H) fp32
// hold dhT, dcT on entry and dh0, dc0 on return; dux, dupre (T, B, 4H) bf16
// outputs; acc ((B + 31) / 32, 3, 4H) fp32, zeroed by the caller; dcoef
// (3, 4H) fp32 output. Returns the first launch error, or 0.
extern "C" int gp6_bwd(const void* xg, const void* w, const void* bg,
                       const void* coef, const void* mask, const void* h0,
                       const void* c0, const void* ys, const void* cs,
                       const void* dy, void* dh, void* dc, void* dux,
                       void* dupre, void* acc, void* dcoef, int T, int B,
                       int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_a((B + BM - 1) / BM, H / BJ);
  const dim3 grid_b((B + BM - 1) / BM, H / DJ);
  const size_t BH = (size_t)B * H;
  const bf16* wt = static_cast<const bf16*>(w);
  const bf16* x = static_cast<const bf16*>(xg);
  const bf16* y = static_cast<const bf16*>(ys);
  const bf16* cc = static_cast<const bf16*>(cs);
  const bf16* g = static_cast<const bf16*>(dy);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  bf16* ux = static_cast<bf16*>(dux);
  bf16* up = static_cast<bf16*>(dupre);
  for (int t = T - 1; t >= 0; --t) {
    const bf16* hp = t == 0 ? static_cast<const bf16*>(h0) : y + (t - 1) * BH;
    const bf16* cp = t == 0 ? static_cast<const bf16*>(c0) : cc + (t - 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    gp6_bwd_gates<<<grid_a, THREADS, 0, st>>>(
        hp, cp, wt, x + (size_t)t * BH * 4, static_cast<const bf16*>(bg),
        static_cast<const float*>(coef), m_t, g + t * BH,
        static_cast<const float*>(dh), static_cast<float*>(dc),
        ux + (size_t)t * BH * 4, up + (size_t)t * BH * 4,
        static_cast<float*>(acc), B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gp6_bwd_dh<<<grid_b, DH_THREADS, 0, st>>>(up + (size_t)t * BH * 4, wt,
                                              m_t, g + t * BH,
                                              static_cast<float*>(dh), B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = NACT * 4 * H;
  gp6_dcoef_sum<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(acc), static_cast<float*>(dcoef),
      (B + BM - 1) / BM, n);
  return (int)cudaGetLastError();
}
