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
// The forward runs in one of two designs, picked by ops/gp_lstm_cuda.py
// `_design_fwd(B, H, n_sm, T, row=18)` (an explicit rule: the chosen design
// runs or raises). Both take the step's mixture from `Mix` and the cell
// update from `gp6_cell`.
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, the shared memory within 227 KB: the training step, the `evaluate`
// windows), one cooperative launch a call, csrc/lstm_persist.cuh's
// recurrence (rows 4, 5, 7 and 20 take it too) with this row's cell,
// `gp6_fwd_persistent`: H / 8 CTAs of 512 threads, CTA c keeping W''s 4 x 8
// gate rows of its units [8c, 8c + 8) in shared memory (133,120 bytes with
// the 16 warps' 32 x 32 fp32 partial tiles at H = 1,024); a step the CTA's
// 32 product columns from the bf16 ys[t-1] (h0 at t = 0) by mma.sync
// m16n8k16, the mixture and the cell of its 32 x 8 (column, unit) pairs
// with h, c carried in registers, ys[t] and cs[t] stored, a grid barrier.
//
// "per_step" (the rest: B > 32, or H beyond what the SMs hold), one launch
// a step (rows 5-6's per-step design, csrc/lstm_train.cu, with a mixture
// epilogue; the tile functions of csrc/gate_tile.cuh at four row groups),
// `gp6_fwd_step`: the host function loops over t and launches on the
// caller's stream; a block owns BM batch columns and BJ hidden units and
// computes the four rows (q*H + j) of them, so the mixture and the cell
// update need nothing from other blocks and h, c update in place.
//
// In both the product's A operand is the bf16 ys[t-1] (h0 at t = 0), the
// fp32 carry rounded as the TPU kernel rounds it.
//
// The backward runs in one of two designs, picked by ops/gp_lstm_cuda.py
// `_design(B, H, n_sm, T, row=19)` (an explicit rule: the chosen design
// runs or raises).
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, the shared memory within 227 KB: the training shape), two launches
// a call, csrc/gp_persist.cuh's design (row 21's too): `gp6_bwd_gemm`,
// P = hprev W'^T for all T B rows (fp32, 52 MB at T 100, B 32, H 1,024),
// then `gp6_bwd_persistent`, one cooperative launch of H / 8 CTAs, each
// keeping its 4H x 8 column slice of W' in shared memory (82,432 bytes with
// the partial tiles at H = 1,024): step t's cell of its 8 units from
// pre = P[t] + b', then gates = xg[t] + sum_a coef[a] act_a(pre), the
// twin's order; dux[t] and dupre[t] stored, the dcoef terms summed over
// the batch and then over the steps in the CTA, which owns its units'
// 3 x 4 x 8 dcoef columns; a grid barrier; dh from all of dupre[t] (B x 4H)
// against the slice.
//
// "two_launch" (the rest: B > 32, or H beyond what the SMs hold), two
// launches a step, since dh_{t-1} contracts dupre_t over all 4H rows:
//   (a) `gp6_bwd_gates`: the forward's tile, recomputing the step, writes
//       dux_t and dupre_t, updates the fp32 dc carry in place and adds the
//       block's dcoef partial (each thread sums its rows, the block sums
//       its thread rows in a fixed order) to an fp32 accumulator of its
//       own, one per column block;
//   (b) `gp6_bwd_dh`: `dh_tile<4>` on dupre_t, as `lstm_bwd_dh` on du.
// After the sweep `gp6_dcoef_sum` adds the column blocks' accumulators in
// order: repeat calls give the same bits. Both designs take the step's
// gradients from `gp6_grads`. The per-step products run on the tensor
// cores through wmma (16x16x16 bf16, fp32 accumulators).
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 and 3.35 TB/s: forward 2 T B H 4H =
// 26.8 GFLOP, 0.027 ms (its ~48 MB, 0.014 ms); backward twice the
// operations, 0.054 ms (~107 MB, 0.032 ms). Operations bound, but all are
// far from it. The per-step forward and the two-launch backward are bound
// by the latency of dependent launches (100 forward, 200 backward), each a
// small tile product loading its tiles synchronously on 32 blocks: 4.8 ms
// a per-step forward call and 15.8 ms a two-launch backward call on an
// NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md). The persistent forward is
// bound by its T dependent steps: a barrier and each CTA's L2 read of
// h_{t-1} (64 KB at B = 32) a step. The persistent backward's GEMM is
// operations bound (26.8 GFLOP), its recurrence by its T dependent steps:
// a barrier and each CTA's L2 read of dupre[t] (256 KB) a step.
//
// Planted faults for the on-card check (chip_smoke.py), off by default:
// -DGP6_FAULT=1 drops the relu term from dpre and -DGP6_FAULT=2 drops the
// dcoef accumulation, in both designs; -DGP6_FAULT=3 has the persistent
// recurrence read P of step 0 at every step (the step's offset dropped),
// which only the hoisted design can get wrong; -DGP6_FAULT=4 has the
// persistent forward's product read h0 at every step, which only it can
// get wrong.

#ifndef GP6_FAULT
#define GP6_FAULT 0
#endif
#if GP6_FAULT == 3
#define GP_PERSIST_P_STEP(t, T) 0
#endif
#if GP6_FAULT == 4
#define LSTM_PERSIST_H0_ALWAYS 1
#endif

#include "gate_tile.cuh"
#include "gp_persist.cuh"

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
  Mix() = default;
  // from values: the product, b', the three coefficients and xg
  __device__ __forceinline__ Mix(float acc, float b, float c0, float c1,
                                 float c2, float x) {
    pre = acc + b;
    s = sigmoidf(pre);
    th = tanhf(pre);
    r = fmaxf(pre, 0.0f);
    gate = x + (c0 * s + c1 * th + c2 * r);
  }
  // from gate column n of b', coef (3, G) and the xg row
  __device__ __forceinline__ Mix(float acc, const bf16* __restrict__ bg,
                                 const float* __restrict__ coef,
                                 const bf16* __restrict__ xg_row, int n,
                                 int G)
      : Mix(acc, __bfloat162float(bg[n]), coef[n], coef[G + n],
            coef[2 * G + n], __bfloat162float(xg_row[n])) {}
};

// The cell update of one element from its four gate pre-activations g and
// c_{t-1} (both forward designs): cn = f c + i g, hn = o tanh(cn).
__device__ __forceinline__ void gp6_cell(const float (&g)[4], float c,
                                         float& cn, float& hn) {
  cn = sigmoidf(g[1]) * c + sigmoidf(g[0]) * tanhf(g[2]);
  hn = sigmoidf(g[3]) * tanhf(cn);
}

// The backward of one element from its four gates' mixtures m, the
// coefficients cf[a][q] of its gate columns and c_{t-1} (both designs): du
// (= dux) and dpre of each gate, the dcoef terms du act_a(pre) as
// part[a][q]; returns the new dc.
__device__ __forceinline__ float gp6_grads(const Mix (&m)[4],
                                           const float (&cf)[NACT][4],
                                           float cp, float keep, float dh_tot,
                                           float dc, float (&du)[4],
                                           float (&dpre)[4],
                                           float (&part)[NACT][4]) {
  const float ig = sigmoidf(m[0].gate);
  const float fg = sigmoidf(m[1].gate);
  const float gg = tanhf(m[2].gate);
  const float og = sigmoidf(m[3].gate);
  const GpCellGrad d = gp_cell_grad(ig, fg, gg, og, cp, keep, dh_tot, dc);
  du[0] = d.d_i * ig * (1.0f - ig);
  du[1] = d.d_f * fg * (1.0f - fg);
  du[2] = d.d_g * (1.0f - gg * gg);
  du[3] = d.d_o * og * (1.0f - og);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    part[0][q] = du[q] * m[q].s;
    part[1][q] = du[q] * m[q].th;
    part[2][q] = du[q] * m[q].r;
    const float relu_d = (GP6_FAULT == 1 || !(m[q].pre > 0.0f)) ? 0.f : 1.f;
    dpre[q] = du[q] * (cf[0][q] * m[q].s * (1.0f - m[q].s) +
                       cf[1][q] * (1.0f - m[q].th * m[q].th) +
                       cf[2][q] * relu_d);
  }
  return d.dc;
}

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
    float cn, hn;
    gp6_cell(g, c[e], cn, hn);
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
    Mix m[4];
    float cf[NACT][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m[q] = Mix(Gs[r * LDG + q * BJ + u], bg, coef, xg_row, q * H + j, G);
#pragma unroll
      for (int a = 0; a < NACT; ++a) cf[a][q] = coef[a * G + q * H + j];
    }
    const size_t e = (size_t)b * H + j;
    const float keep = (mask_t != nullptr && !mask_t[b]) ? 0.f : 1.f;
    float du[4], dpre[4], term[NACT][4];
    dc[e] = gp6_grads(m, cf, __bfloat162float(cprev[e]), keep,
                      dh[e] + __bfloat162float(dy_t[e]), dc[e], du, dpre,
                      term);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * H + j;
#pragma unroll
      for (int a = 0; a < NACT; ++a) part[a][q] += term[a][q];
      dux_t[(size_t)b * G + n] = __float2bfloat16(du[q]);
      dupre_t[(size_t)b * G + n] = __float2bfloat16(dpre[q]);
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

// -------------------------------------------- the persistent forward

// Row 18's cell for csrc/lstm_persist.cuh: the product's four groups are h
// W'^T's gate columns; b' and the three coefficients of the thread's
// unit's gate columns; xg[t]'s four columns a step.
struct Gp6FwdCell {
  static constexpr int NG = 4;
  struct Const {
    float b[4], cf[NACT][4];
  };
  struct In {
    float x[4];
  };
  __device__ static void load(const FwdPersistParams& p, int j, Const& k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      k.b[q] = __bfloat162float(p.bg[q * p.H + j]);
#pragma unroll
      for (int a = 0; a < NACT; ++a)
        k.cf[a][q] = p.coef[(a * 4 + q) * p.H + j];
    }
  }
  __device__ static void fetch(const FwdPersistParams& p, int t, int b, int j,
                               In& in) {
    const bf16* xr = static_cast<const bf16*>(p.x) +
                     ((size_t)t * p.B + b) * 4 * p.H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.x[q] = __bfloat162float(xr[q * p.H]);
  }
  __device__ static void update(const Const& k, const In& in,
                                const float (&s)[NG], float c, float& cn,
                                float& hn) {
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = Mix(s[q], k.b[q], k.cf[0][q], k.cf[1][q], k.cf[2][q], in.x[q])
                 .gate;
    gp6_cell(g, c, cn, hn);
  }
};

__global__ void __launch_bounds__(P_THREADS, 1)
gp6_fwd_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd_cell<Gp6FwdCell>(p, smem);
}

// ------------------------------------------- the persistent backward

// Row 19's cell for csrc/gp_persist.cuh: P's four groups are h W'^T's gate
// columns; dux[t] and dupre[t] are stored, dupre[t] is the dh product's
// operand.
struct Gp6Cell {
  static constexpr int NG = 4;
  static constexpr int NPART = NACT * 4;  // term 4a + q: dcoef[a][q H + j]
  static constexpr bool DCOEF = GP6_FAULT != 2;
  struct Const {
    float b[4], cf[NACT][4];
  };
  __device__ static void load(const GpBwdParams& p, int j, Const& k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      k.b[q] = __bfloat162float(p.bg[q * p.H + j]);
#pragma unroll
      for (int a = 0; a < NACT; ++a)
        k.cf[a][q] = p.coef[(a * 4 + q) * p.H + j];
    }
  }
  __device__ static float step(const GpBwdParams& p, const Const& k,
                               const GpIn<NG>& in, float dh_tot, float dc,
                               size_t row, int j, float (&part)[NPART]) {
    Mix m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[q] = Mix(in.p[q], k.b[q], k.cf[0][q], k.cf[1][q], k.cf[2][q],
                 in.x[q]);
    float du[4], dpre[4], term[NACT][4];
    const float dcn = gp6_grads(m, k.cf, in.cp, in.keep, dh_tot, dc, du,
                                dpre, term);
    const size_t o = row * 4 * p.H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int a = 0; a < NACT; ++a) part[a * 4 + q] = term[a][q];
      p.dux[o + q * p.H] = __float2bfloat16(du[q]);
      p.dop[o + q * p.H] = __float2bfloat16(dpre[q]);
    }
    return dcn;
  }
};

// (1) P = hprev W'^T for every step
__global__ void __launch_bounds__(G_THREADS, 1)
gp6_bwd_gemm(const __grid_constant__ GateParams p) {
  extern __shared__ unsigned char smem_raw[];
  gates_gemm(p, true, smem_raw);
}

// (2) the recurrence
__global__ void __launch_bounds__(P_THREADS, 1)
gp6_bwd_persistent(const __grid_constant__ GpBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  gp_bwd_persist<Gp6Cell>(p, smem);
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

// The persistent forward (csrc/lstm_persist.cuh): gp6_fwd's arguments
// plus bar, one zeroed unsigned int of device memory for the grid barrier.
// B must be at most 32 and H a multiple of 8; the grid is H / 8 CTAs of
// 512 threads, launched cooperatively, so a grid the card cannot hold at
// once is refused (cudaErrorCooperativeLaunchTooLarge). Returns the launch
// error, or 0.
extern "C" int gp6_fwd_persist(const void* xg, const void* w, const void* bg,
                               const void* coef, const void* mask,
                               const void* h0, void* h, void* c, void* ys,
                               void* cs, void* bar, int T, int B, int H,
                               void* stream) {
  FwdPersistParams prm = {};
  prm.x = xg;
  prm.w = static_cast<const bf16*>(w);
  prm.bg = static_cast<const bf16*>(bg);
  prm.coef = static_cast<const float*>(coef);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.h0 = static_cast<const bf16*>(h0);
  prm.h = static_cast<float*>(h);
  prm.c = static_cast<float*>(c);
  prm.ys = static_cast<bf16*>(ys);
  prm.cs = static_cast<bf16*>(cs);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  return (int)launch_persist_fwd(gp6_fwd_persistent, prm,
                                 static_cast<cudaStream_t>(stream), 4);
}

// The two-launch backward over the whole sequence, t = T-1..0. The
// forward's inputs and outputs ys, cs, with c0 (B, H) and dy (T, B, H) bf16;
// dh, dc (B, H) fp32 hold dhT, dcT on entry and dh0, dc0 on return; dux,
// dupre (T, B, 4H) bf16
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

// The persistent backward (csrc/gp_persist.cuh): gp6_bwd's arguments with
// hprev = [h0, ys[:-1]] (T B, H) bf16 in place of h0 and ys, without acc;
// P (T B, 4H) fp32 workspace and bar one zeroed unsigned int. B must be at
// most 32 and H a multiple of 8; a grid the card cannot hold at once is
// refused (cudaErrorCooperativeLaunchTooLarge). Returns the first launch
// error, -1 where cuTensorMapEncodeTiled is not found, -1000 - r where it
// refuses a descriptor with r, or 0.
extern "C" int gp6_bwd_persist(const void* xg, const void* w, const void* bg,
                               const void* coef, const void* mask,
                               const void* hprev, const void* c0,
                               const void* cs, const void* dy, void* dh,
                               void* dc, void* dux, void* dupre, void* dcoef,
                               void* P, void* bar, int T, int B, int H,
                               void* stream) {
  GpBwdParams prm = {};
  prm.w = static_cast<const bf16*>(w);
  prm.xg = static_cast<const bf16*>(xg);
  prm.bg = static_cast<const bf16*>(bg);
  prm.coef = static_cast<const float*>(coef);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.c0 = static_cast<const bf16*>(c0);
  prm.cs = static_cast<const bf16*>(cs);
  prm.dy = static_cast<const bf16*>(dy);
  prm.dh = static_cast<float*>(dh);
  prm.dc = static_cast<float*>(dc);
  prm.dux = static_cast<bf16*>(dux);
  prm.dop = static_cast<bf16*>(dupre);
  prm.dcoef = static_cast<float*>(dcoef);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  return launch_gp_bwd(gp6_bwd_gemm, gp6_bwd_persistent, 4, hprev,
                       static_cast<float*>(P), prm,
                       static_cast<cudaStream_t>(stream));
}
