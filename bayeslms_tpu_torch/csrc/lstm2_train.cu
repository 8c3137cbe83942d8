// Fused 2-layer LSTM recurrence for training, forward and backward, for
// sm_90a (bf16 operands, fp32 accumulation, fp32 carries).
//
// Replaces bayeslms_tpu/ops/lstm_pallas.py `_train2_fwd_kernel` (pallas_call
// in `_train2_fwd_run`) and `_train2_bwd_kernel` (`_train2_bwd_run`), the two
// halves of the custom VJP `lstm2_scan_fused`. Layer 1's input projection
// xg1 = x W_ih1^T + b_ih1 for the whole sequence is one GEMM outside; so are
// the weight gradients dW_hh1 = du1^T h1p, dW_ih2 = du2^T (ys1 dm),
// dW_hh2 = du2^T h2p and the bias sums. Layer 2's input projection runs
// here, a step at a time, as on the TPU.
//
// Forward, t = 0..T-1 (the TPU kernel's `_cell2_steps`):
//   layer 1: gates = (xg1[t] + h1_{t-1} W_hh1^T) + b_hh1, gate order
//     [i, f, g, o], h1_{t-1} rounded to bf16 for the product; c = f c + i g;
//     h = o tanh(c); where mask[t, b] = 0 the column keeps its (h, c);
//   h1d = h1 dm[t], h1 the fp32 carry, rounded to bf16 for the product;
//   layer 2: gates = (h1d W_ih2^T + h2_{t-1} W_hh2^T) + b2, the first
//     product in fp32 and not rounded, b2 = b_ih2 + b_hh2; the same cell
//     and mask.
//   ys1, cs1, ys2, cs2 [t] are stored in bf16; the states are carried in
//   fp32.
// Backward, t = T-1..0 (`_train2_bwd_kernel`, term for term):
//   layer 2's gates are recomputed from h1d' = ys1[t] dm[t] (the bf16 ys1,
//     not the forward's fp32 h1; rounded to bf16), h2_{t-1} = ys2[t-1]
//     (h02 at t = 0) and c2_{t-1} = cs2[t-1] (c02); its cell backward gives
//     du2[t] (bf16) and dc2, then dh2 = du2[t] W_hh2 + (1 - keep) dh2_tot;
//   inj = (du2[t] W_ih2) dm[t], the gradient reaching h1 through layer 2's
//     input, at the same t;
//   layer 1's cell backward with dy1[t] + inj in place of dy gives du1[t]
//     and dc1, then dh1 = du1[t] W_hh1 + (1 - keep) dh1_tot.
//   The cell backward, with dh_tot = dh + dy, dc_tot = dc,
//   dh' = keep dh_tot, dc' = keep dc_tot: do = dh' tanh(c),
//   dc_c = dc' + dh' o (1 - tanh(c)^2), di = dc_c g, df = dc_c c_{t-1},
//   dg = dc_c i, dc = dc_c f + (1 - keep) dc_tot,
//   du = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)] stored in bf16; the
//   dh products take that rounded du.
//
// The forward (row 7) runs in one of two designs, picked by
// ops/lstm2_train_cuda.py `_design(B, H, n_sm, T)` beside the backward's
// (its `fwd_design`; an explicit rule: the chosen design runs or raises).
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, both kernels' shared memory within 227 KB: the training shape),
// three launches a call, layer 2's input product hoisted out of its
// recurrence as the backward hoists its gate recompute:
//   (1) `lstm2_fwd_l1_persistent`: layer 1's recurrence, one cooperative
//       launch of H / 8 CTAs, each keeping its 4 x 8 gate rows of W_hh1
//       resident (row 5's step, csrc/lstm_persist.cuh), which also stores
//       h1d[t] = bf16(h1 dm[t]) from the fp32 h1 after the mask into a
//       (T, B, H) buffer;
//   (2) `lstm2_input_gemm`: Q = h1d W_ih2^T for all T B rows at once, fp32
//       (T B, 4H), never rounded (52 MB at the training shape): the
//       backward's GEMM (csrc/gates_gemm.cuh) with one product and no
//       addend or bias; TMA fills the rows past T B with zeros;
//   (3) `lstm2_fwd_l2_persistent`: layer 2's recurrence, the same step with
//       W_hh2's gate rows resident and Q[t] as its fp32 addend:
//       g2 = (Q[t] + h2_{t-1} W_hh2^T) + b2, the twin's order.
// One launch with both layers (layer 2 a step behind, as row 1) would need
// W_hh1's, W_ih2's and W_hh2's gate rows resident, 198 KB, which leaves no
// room for the warps' 64 KB of partial tiles.
//
// "per_step" (the rest): the host function loops over t and launches on
// the caller's stream, in the manner of csrc/lstm_train.cu's per-step
// designs, whose tiles it shares (csrc/gate_tile.cuh): two launches a
// step, layer 1's `GateTile<4>` (a block owns BM columns x BJ units and
// all four gate rows of them, so the cell update needs nothing from other
// blocks), which also writes h1d to a (B, H) bf16 buffer; then layer 2's
// tile, one contraction over K = 2H of [h1d | h2] against [W_ih2 | W_hh2]
// (`gate_tile2`).
//
// The backward (row 8) takes the (T B, H) bf16 operands h1p = [h01, ys1[:-1]],
// h1d' = bf16(ys1 dm) (`lstm2_h1d`, one elementwise launch) and
// h2p = [h02, ys2[:-1]], which the caller also needs for the weight
// gradients, and runs in one of two designs, picked by
// ops/lstm2_train_cuda.py `_design(B, H, n_sm, T)` (an explicit rule: the
// chosen design runs or raises).
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, the shared memory within 227 KB: the training shape), two launches
// a call.
//   (1) `lstm2_gates_gemm`: the gate recompute hoisted out of the
//       recurrence. Its three products depend only on the forward's stored
//       outputs, never on a backward carry, so they run for all T steps at
//       once as (T B) x H x 4H GEMMs: layer 1's gates
//       G1 = (xg1 + h1p W_hh1^T) + b_hh1 and layer 2's
//       G2 = (h1d' W_ih2^T + h2p W_hh2^T) + b2, both fp32 (T B, 4H), never
//       rounded (52 MB each at the training shape), in the GEMM of
//       csrc/gates_gemm.cuh (wgmma fed by TMA, a 128 x 128 output tile a
//       CTA, 64-deep chunks added to nearest in fp32 registers; rows 19 and
//       21 take it too). Layer 2's CTA walks h1d' against W_ih2 first,
//       keeps that sum, then h2p against W_hh2, and adds the two in the
//       twin's order; its CTAs (twice the walk) come first in the grid.
//       Grid (4H / 128, T B / 128, 2): 1,600 CTAs, 12 waves on 132 SMs, at
//       the training shape.
//   (2) `lstm2_bwd_persistent`: one cooperative launch of H / 8 CTAs of 512
//       threads for the recurrence. CTA c owns hidden units [8c, 8c + 8) of
//       both layers and keeps three transposed column slices (4H x 8, the
//       dh products' B operands) in shared memory, loaded once: W_hh2's and
//       W_ih2's side by side (16 rows) and W_hh1's, 3 x 66 KB at H =
//       1,024. Layer 2 runs one step ahead of layer 1. Iteration k = 0..T,
//       t = T - 1 - k:
//         (a) layer 2's cell backward at t (threads 0-255, one (column,
//             unit) pair each) and layer 1's at t + 1 (threads 256-511), the
//             gates read from G1 / G2, du stored in bf16, the fp32 dc carry
//             in the thread's registers;
//         a grid barrier: every CTA's du is stored before any CTA reads it;
//         (b) warps 0-7: from all of du2[t] (B x 4H, 256 KB from L2 straight
//             into the m16n8k16 fragments, csrc/warp_mma.cuh), the CTA's 8
//             dh2 columns and 8 inj columns, one A fragment against both
//             resident slices; warps 8-15: from all of du1[t + 1], its 8 dh1
//             columns. Each group's 8 partial tiles (16 KB and 8 KB: the
//             weights leave no room for row 6's 16 partials of every
//             product) are summed in warp order by the owning thread, which
//             adds (1 - keep) dh_tot; inj = (du2[t] W_ih2) dm[t] goes to
//             layer 1's thread of the same (column, unit).
//       Step (a) of the next iteration needs only the CTA's own units, so
//       one barrier an iteration suffices: T + 1 barriers, layer 2 alone in
//       the first iteration and layer 1 alone in the last. The next
//       iteration's gates, c_{t-1}, dy and mask are read during (b)'s
//       products. Shared memory 48 (4H + 32) + 24,576 bytes: 222,720 at
//       H = 1,024.
// "per_step" (the rest), `lstm2_train_bwd`: four launches a step,
// (a) layer 2's gates and du2; (b) one launch of 2 H / DJ column blocks,
// half contracting du2 with W_hh2 for dh2, half with W_ih2 for inj (fp32,
// (B, H)); (c) layer 1's gates and du1; (d) dh1. Stream order makes each
// launch see the one before it.
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 (700 W): forward three 2 T B H 4H
// products = 80.5 GFLOP, 0.081 ms; backward six, 0.163 ms. The per-step
// forward and backward are bound by the latency of dependent launches (200
// forward, 400 backward) on 32 blocks, not by either peak: 12.2-12.5 ms a
// per-step forward call. The persistent forward's two recurrences are
// bound by their T dependent steps each (a barrier and each CTA's L2 read
// of h_{t-1}), its GEMM (26.8 GFLOP) by operations: 1.60-1.62 ms a call
// between CUDA events, and in a traced fused step 1.33 ms of device time,
// each recurrence 0.63 and the GEMM 0.068 (40% of the bf16 peak)
// (chip_smoke.py, tools/lstm_fwd_designs.py, tools/port_train_profile.py
// --fused-lstm2 on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md). The
// persistent backward's GEMM is operations bound (80.5 GFLOP); its
// recurrence by its
// T + 1 dependent iterations: a barrier and each CTA's L2 reads of
// du2[t] and du1[t + 1] (512 KB). Measured on an NVIDIA H100 80GB HBM3 at
// 700.00 W (PERF.md, kernel table, row 8): chip_smoke.py 2.104 ms a
// persistent call (the per-step design 33.352 on the same call, cuDNN's
// 2-layer backward 9.544); in a traced fused training step
// (tools/port_train_profile.py --fused-lstm2) 1.71 ms of device time, the
// GEMM 0.252 (32% of the bf16 peak), the recurrence 1.442 (14.3 us an
// iteration) and h1d 0.016, against the per-step design's 32.8.
//
// Planted faults, for chip_smoke.py (-DLSTM2_TRAIN_FAULT=n): 1, the
// backward's recompute ignores the dropout mask (h1d' = ys1, in
// `lstm2_dropped`, which both designs take); 2, the injection into layer 1
// is dropped (inj = 0, in both designs); 3, the forward ignores the
// dropout mask (h1d = h1, in both designs: the persistent layer 1 stores
// that h1d for the input GEMM); 4, the persistent forward's layer 2 reads
// Q of the wrong step (t + 1, the last step Q[0]), which only a hoisted
// design can get wrong.

#ifndef LSTM2_TRAIN_FAULT
#define LSTM2_TRAIN_FAULT 0
#endif
#if LSTM2_TRAIN_FAULT == 3
#define LSTM_PERSIST_DROP(h, d) (h)
#elif LSTM2_TRAIN_FAULT == 4
#define LSTM_PERSIST_Q_STEP(t, T) ((t) + 1 < (T) ? (t) + 1 : 0)
#endif

#include "gate_tile.cuh"
#include "gates_gemm.cuh"
#include "grid_barrier.cuh"
#include "lstm_persist.cuh"
#include "sm90.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int NG = 4;  // the four gates
constexpr int THREADS = GateTile<NG>::THREADS;
constexpr int LDG = GateTile<NG>::LDG;
constexpr int SMEM = GateTile<NG>::SMEM;

// One cell step at element e from its gate pre-activations g; h, c the
// fp32 carries, kept where keep is false. Returns the new h.
__device__ __forceinline__ float cell_fwd(const float g[4], float* h,
                                          float* c, size_t e, bool keep) {
  float cn = sigmoidf(g[1]) * c[e] + sigmoidf(g[0]) * tanhf(g[2]);
  float hn = sigmoidf(g[3]) * tanhf(cn);
  if (!keep) {
    hn = h[e];
    cn = c[e];
  }
  h[e] = hn;
  c[e] = cn;
  return hn;
}

// The cell's backward at one element: writes du (four entries, stride H)
// in bf16 and returns the new dc.
__device__ __forceinline__ float cell_bwd(const float g[4], float cp,
                                          float keep, float dh_tot,
                                          float dc_tot, bf16* du, int H) {
  const float ig = sigmoidf(g[0]);
  const float fg = sigmoidf(g[1]);
  const float gg = tanhf(g[2]);
  const float og = sigmoidf(g[3]);
  const float tc = tanhf(fg * cp + ig * gg);
  const float dhn = keep * dh_tot;
  const float dcn = keep * dc_tot;
  const float d_o = dhn * tc;
  const float dcc = dcn + dhn * og * (1.0f - tc * tc);
  du[0] = __float2bfloat16(dcc * gg * ig * (1.0f - ig));
  du[H] = __float2bfloat16(dcc * cp * fg * (1.0f - fg));
  du[2 * H] = __float2bfloat16(dcc * ig * (1.0f - gg * gg));
  du[3 * H] = __float2bfloat16(d_o * og * (1.0f - og));
  return dcc * fg + (1.0f - keep) * dc_tot;
}

__device__ __forceinline__ bool kept(const uint8_t* mask_t, int b) {
  return mask_t == nullptr || mask_t[b] != 0;
}

// Forward, layer 1 at step t: a = h1_{t-1} in bf16 (h01 or ys1[t-1]); h, c
// the fp32 carries, updated in place; h1d = bf16(h dm_t) for layer 2.
__global__ void __launch_bounds__(THREADS)
lstm2_fwd_l1(const bf16* __restrict__ a, const bf16* __restrict__ w,
             const bf16* __restrict__ xg_t, const float* __restrict__ bias,
             const bf16* __restrict__ dm_t,
             const uint8_t* __restrict__ mask_t, float* __restrict__ h,
             float* __restrict__ c, bf16* __restrict__ y_t,
             bf16* __restrict__ c_t, bf16* __restrict__ h1d, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  gate_tile<NG>(a, w, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = (__bfloat162float(xg_t[(size_t)b * 4 * H + q * H + j]) +
              Gs[r * LDG + q * BJ + u]) + bias[q * H + j];
    const size_t e = (size_t)b * H + j;
    const float hn = cell_fwd(g, h, c, e, kept(mask_t, b));
    y_t[e] = __float2bfloat16(hn);
    c_t[e] = __float2bfloat16(c[e]);
#if LSTM2_TRAIN_FAULT == 3
    h1d[e] = __float2bfloat16(hn);
#else
    h1d[e] = __float2bfloat16(hn * __bfloat162float(dm_t[e]));
#endif
  }
}

// Forward, layer 2 at step t: gates = (h1d W_ih2^T + a W_hh2^T) + b2 with
// a = h2_{t-1} in bf16 (h02 or ys2[t-1]).
__global__ void __launch_bounds__(THREADS)
lstm2_fwd_l2(const bf16* __restrict__ h1d, const bf16* __restrict__ wih,
             const bf16* __restrict__ a, const bf16* __restrict__ whh,
             const float* __restrict__ bias,
             const uint8_t* __restrict__ mask_t, float* __restrict__ h,
             float* __restrict__ c, bf16* __restrict__ y_t,
             bf16* __restrict__ c_t, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  gate_tile2<NG>(h1d, wih, a, whh, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = Gs[r * LDG + q * BJ + u] + bias[q * H + j];
    const size_t e = (size_t)b * H + j;
    const float hn = cell_fwd(g, h, c, e, kept(mask_t, b));
    y_t[e] = __float2bfloat16(hn);
    c_t[e] = __float2bfloat16(c[e]);
  }
}

// Backward, once a call: out = bf16(ys1 dm) over all T B H elements.
__global__ void lstm2_dropped(const bf16* __restrict__ ys1,
                              const bf16* __restrict__ dm,
                              bf16* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
#if LSTM2_TRAIN_FAULT == 1
    out[i] = ys1[i];
#else
    out[i] = __float2bfloat16(__bfloat162float(ys1[i]) *
                              __bfloat162float(dm[i]));
#endif
  }
}

// Backward (a) and (c): recompute step t's gates of one layer, write du_t
// and update dc in place. Layer 2 (TWO): the product of [h1d | hprev]
// against [wih | w], no xg; layer 1: hprev W^T plus xg_t, and inj (fp32)
// added to dy_t.
template <bool TWO>
__global__ void __launch_bounds__(THREADS)
lstm2_bwd_gates(const bf16* __restrict__ h1d, const bf16* __restrict__ wih,
                const bf16* __restrict__ hprev,
                const bf16* __restrict__ cprev, const bf16* __restrict__ w,
                const bf16* __restrict__ xg_t, const float* __restrict__ bias,
                const uint8_t* __restrict__ mask_t,
                const bf16* __restrict__ dy_t, const float* __restrict__ inj,
                const float* __restrict__ dh, float* __restrict__ dc,
                bf16* __restrict__ du_t, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  if (TWO)
    gate_tile2<NG>(h1d, wih, hprev, w, b0, j0, B, H, smem);
  else
    gate_tile<NG>(hprev, w, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p = Gs[r * LDG + q * BJ + u];
      g[q] = (TWO ? p
                  : __bfloat162float(xg_t[(size_t)b * 4 * H + q * H + j]) + p) +
             bias[q * H + j];
    }
    const size_t e = (size_t)b * H + j;
    float dy = __bfloat162float(dy_t[e]);
    if (!TWO) dy += inj[e];
    dc[e] = cell_bwd(g, __bfloat162float(cprev[e]),
                     kept(mask_t, b) ? 1.f : 0.f, dh[e] + dy, dc[e],
                     du_t + (size_t)b * 4 * H + j, H);
  }
}

// Backward (b): blocks y < H/DJ update dh2 = du2_t W_hh2 + (1 - keep)
// dh2_tot in place; blocks y >= H/DJ write inj = (du2_t W_ih2) dm_t.
__global__ void __launch_bounds__(DH_THREADS)
lstm2_bwd_dh2(const bf16* __restrict__ du_t, const bf16* __restrict__ whh,
              const bf16* __restrict__ wih,
              const uint8_t* __restrict__ mask_t,
              const bf16* __restrict__ dy_t, const bf16* __restrict__ dm_t,
              float* __restrict__ dh, float* __restrict__ inj, int B, int H) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Ws[BK * LDW];
  __shared__ __align__(128) float Os[BM * LDO];
  const int nb = H / DJ;
  const bool to_h1 = blockIdx.y >= nb;
  const int b0 = blockIdx.x * BM;
  const int k0 = (blockIdx.y % nb) * DJ;
  dh_product<NG>(du_t, to_h1 ? wih : whh, b0, k0, B, H, As, Ws, Os);
  for (int i = threadIdx.x; i < BM * DJ; i += DH_THREADS) {
    const int r = i / DJ;
    const int u = i % DJ;
    const int b = b0 + r;
    if (b >= B) continue;
    const size_t e = (size_t)b * H + k0 + u;
    if (to_h1) {
#if LSTM2_TRAIN_FAULT == 2
      inj[e] = 0.f;
#else
      inj[e] = Os[r * LDO + u] * __bfloat162float(dm_t[e]);
#endif
    } else {
      const float keep = kept(mask_t, b) ? 1.f : 0.f;
      dh[e] = Os[r * LDO + u] +
              (1.0f - keep) * (dh[e] + __bfloat162float(dy_t[e]));
    }
  }
}

// Backward (d): dh1 = du1_t W_hh1 + (1 - keep) (dh1 + (dy1_t + inj)).
__global__ void __launch_bounds__(DH_THREADS)
lstm2_bwd_dh1(const bf16* __restrict__ du_t, const bf16* __restrict__ w,
              const uint8_t* __restrict__ mask_t,
              const bf16* __restrict__ dy_t, const float* __restrict__ inj,
              float* __restrict__ dh, int B, int H) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Ws[BK * LDW];
  __shared__ __align__(128) float Os[BM * LDO];
  const int b0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * DJ;
  dh_product<NG>(du_t, w, b0, k0, B, H, As, Ws, Os);
  for (int i = threadIdx.x; i < BM * DJ; i += DH_THREADS) {
    const int r = i / DJ;
    const int u = i % DJ;
    const int b = b0 + r;
    if (b >= B) continue;
    const size_t e = (size_t)b * H + k0 + u;
    const float keep = kept(mask_t, b) ? 1.f : 0.f;
    const float dh_tot = dh[e] + (__bfloat162float(dy_t[e]) + inj[e]);
    dh[e] = Os[r * LDO + u] + (1.0f - keep) * dh_tot;
  }
}

// ------------------------------------ the persistent backward, stage (1)

// csrc/gates_gemm.cuh's walk: G1 and G2 (row 8), and Q alone (row 7)
__global__ void __launch_bounds__(G_THREADS, 1)
lstm2_gates_gemm(const __grid_constant__ GateParams p) {
  extern __shared__ unsigned char smem_raw[];
  gates_gemm(p, false, smem_raw);
}

__global__ void __launch_bounds__(G_THREADS, 1)
lstm2_input_gemm(const __grid_constant__ GateParams p) {
  extern __shared__ unsigned char smem_raw[];
  gates_gemm(p, true, smem_raw);
}

// ------------------------------------------- the persistent forward's layers

// csrc/lstm_persist.cuh's recurrence: layer 1 on xg1, storing cs1 and
// h1d = bf16(h1 dm); layer 2 on the fp32 Q, storing cs2
__global__ void __launch_bounds__(P_THREADS, 1)
lstm2_fwd_l1_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd<false>(p, smem);
}

__global__ void __launch_bounds__(P_THREADS, 1)
lstm2_fwd_l2_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd<true>(p, smem);
}

// ------------------------------------ the persistent backward, stage (2)

// P_UNITS (hidden units a CTA owns, of both layers), P_WARPS, P_THREADS and
// P_PAD are csrc/lstm_persist.cuh's
constexpr int P_GROUP = 8;  // warps on each du: 0-7 du2, 8-15 du1

struct Bwd2Params {
  const float* g1;  // (T, B, 4H) the gate pre-activations from stage (1)
  const float* g2;
  const bf16* whh1;  // (4H, H)
  const bf16* wih2;
  const bf16* whh2;
  const uint8_t* mask;  // (T, B) or null
  const bf16* dm;       // (T, B, H)
  const bf16* c01;      // (B, H)
  const bf16* c02;
  const bf16* cs1;  // (T, B, H)
  const bf16* cs2;
  const bf16* dy1;
  const bf16* dy2;
  float* dh1;  // (B, H): dhT in, dh0 out
  float* dc1;
  float* dh2;
  float* dc2;
  bf16* du1;  // (T, B, 4H)
  bf16* du2;
  unsigned int* bar;  // the barrier's counter, zero on entry
  int T, B, H;
};

// Shared memory: the column slices (16 + 8 rows x (4H + P_PAD) bf16) and
// the two warp groups' partial tiles (8 x 32 x 16 and 8 x 32 x 8 fp32).
inline int bwd2_smem(int H) {
  return 24 * (4 * H + P_PAD) * 2 + P_GROUP * MMA_ROWS * (16 + 8) * 4;
}

// One thread's inputs of a cell step: the gate pre-activations, c_{s-1},
// dy_s and keep
struct CellIn {
  float g[4], cp, dy, keep;
};

__global__ void __launch_bounds__(P_THREADS, 1)
lstm2_bwd_persistent(const __grid_constant__ Bwd2Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, G = 4 * H, B = p.B, T = p.T;
  const int ldc = G + P_PAD;
  // rows n and 8 + n: W_hh2[:, j0 + n] and W_ih2[:, j0 + n]; then W_hh1's
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  bf16* w1s = w2s + 16 * ldc;
  float* red2 = reinterpret_cast<float*>(w1s + 8 * ldc);
  float* red1 = red2 + P_GROUP * MMA_ROWS * 16;
  const int j0 = blockIdx.x * P_UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int k = tid; k < G; k += P_THREADS) {
    const size_t o = (size_t)k * H + j0;
    const uint4 v2 = *reinterpret_cast<const uint4*>(p.whh2 + o);
    const uint4 vi = *reinterpret_cast<const uint4*>(p.wih2 + o);
    const uint4 v1 = *reinterpret_cast<const uint4*>(p.whh1 + o);
    const bf16* e2 = reinterpret_cast<const bf16*>(&v2);
    const bf16* ei = reinterpret_cast<const bf16*>(&vi);
    const bf16* e1 = reinterpret_cast<const bf16*>(&v1);
#pragma unroll
    for (int n = 0; n < P_UNITS; ++n) {
      w2s[n * ldc + k] = e2[n];
      w2s[(8 + n) * ldc + k] = ei[n];
      w1s[n * ldc + k] = e1[n];
    }
  }

  // threads 0-255 own layer 2's (column b, unit j), 256-511 layer 1's, and
  // that layer's fp32 carries
  const bool l2 = tid < 256;
  const int b = (tid & 255) >> 3, u = tid & 7, j = j0 + u;
  const bool own = b < B;
  const size_t BH = (size_t)B * H;
  const size_t e = (size_t)b * H + j;
  const float* gates = l2 ? p.g2 : p.g1;
  const bf16* cs = l2 ? p.cs2 : p.cs1;
  const bf16* c0 = l2 ? p.c02 : p.c01;
  const bf16* dyp = l2 ? p.dy2 : p.dy1;
  bf16* du = l2 ? p.du2 : p.du1;
  float* dhp = l2 ? p.dh2 : p.dh1;
  float* dcp = l2 ? p.dc2 : p.dc1;
  float dh = 0.f, dc = 0.f, carry = 0.f, inj = 0.f;
  if (own) {
    dh = dhp[e];
    dc = dcp[e];
  }
  // the step of this thread's layer at iteration k (layer 2 runs one ahead)
  auto step_of = [&](int k) { return l2 ? T - 1 - k : T - k; };
  auto fetch = [&](int k, CellIn& in) {
    const int s = step_of(k);
    if (!own || s < 0 || s >= T) return;
    const float* gr = gates + ((size_t)s * B + b) * G + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.g[q] = gr[q * H];
    in.cp = __bfloat162float(s == 0 ? c0[e] : cs[(s - 1) * BH + e]);
    in.dy = __bfloat162float(dyp[s * BH + e]);
    in.keep = (p.mask == nullptr || p.mask[(size_t)s * B + b]) ? 1.f : 0.f;
  };
  CellIn in;
  fetch(0, in);
  __syncthreads();

  unsigned int target = 0;
  for (int k = 0; k <= T; ++k) {
    const int t = T - 1 - k;  // layer 2's step; layer 1's is t + 1
    const int s = step_of(k);
    // (a) the cell's backward of this thread's layer at step s
    if (own && s >= 0 && s < T) {
      const float dh_tot = l2 ? dh + in.dy : dh + (in.dy + inj);
      dc = cell_bwd(in.g, in.cp, in.keep, dh_tot, dc,
                    du + ((size_t)s * B + b) * G + j, H);
      carry = (1.0f - in.keep) * dh_tot;
    }
    const float dmv = (own && !l2 && t >= 0)
                          ? __bfloat162float(p.dm[t * BH + e]) : 0.f;
    target += gridDim.x;
    grid_barrier(p.bar, target);

    // (b) the next iteration's inputs in flight during the products
    fetch(k + 1, in);
    if (warp < P_GROUP) {
      if (t >= 0) {
        float acc[2][2][4] = {};
        warp_product<2, 4, P_GROUP>(p.du2 + (size_t)t * B * G, B, G, w2s,
                                    ldc, warp, lane, acc);
        store_partial<2>(red2, acc, warp, lane);
      }
    } else if (t + 1 < T) {
      float acc[2][1][4] = {};
      warp_product<1, 4, P_GROUP>(p.du1 + (size_t)(t + 1) * B * G, B, G, w1s,
                                  ldc, warp - P_GROUP, lane, acc);
      store_partial<1>(red1, acc, warp - P_GROUP, lane);
    }
    __syncthreads();
    if (!own) continue;
    if (l2) {
      if (t >= 0) {  // dh2 = du2[t] W_hh2 + (1 - keep) dh2_tot
        float sum = 0.f;
        for (int w = 0; w < P_GROUP; ++w)
          sum += red2[(w * MMA_ROWS + b) * 16 + u];
        dh = sum + carry;
      }
      continue;
    }
    if (t >= 0) {  // inj = (du2[t] W_ih2) dm[t], for layer 1 at t
      float sum = 0.f;
      for (int w = 0; w < P_GROUP; ++w)
        sum += red2[(w * MMA_ROWS + b) * 16 + 8 + u];
#if LSTM2_TRAIN_FAULT == 2
      inj = 0.f;
#else
      inj = sum * dmv;
#endif
    }
    if (t + 1 < T) {  // dh1 = du1[t + 1] W_hh1 + (1 - keep) dh1_tot
      float sum = 0.f;
      for (int w = 0; w < P_GROUP; ++w)
        sum += red1[(w * MMA_ROWS + b) * 8 + u];
      dh = sum + carry;
    }
  }
  if (own) {
    dhp[e] = dh;
    dcp[e] = dc;
  }
}

typedef const bf16* cb;

}  // namespace

// Forward over the whole sequence. xg1 (T, B, 4H) bf16, dm (T, B, H) bf16,
// whh1, wih2, whh2 (4H, H) bf16, bhh1, b2 (4H) fp32, mask (T, B) bytes or
// null, h01, h02 (B, H) bf16; h1, c1, h2, c2 (B, H) fp32 carries holding the
// initial states (the final states on return); ys1, cs1, ys2, cs2 (T, B, H)
// bf16 outputs; h1d (B, H) bf16 workspace. Returns the first launch error,
// or 0.
extern "C" int lstm2_train_fwd(const void* xg1, const void* dm,
                               const void* whh1, const void* bhh1,
                               const void* wih2, const void* whh2,
                               const void* b2, const void* mask,
                               const void* h01, const void* h02, void* h1,
                               void* c1, void* h2, void* c2, void* ys1,
                               void* cs1, void* ys2, void* cs2, void* h1d,
                               int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  bf16* y1 = static_cast<bf16*>(ys1);
  bf16* y2 = static_cast<bf16*>(ys2);
  bf16* k1 = static_cast<bf16*>(cs1);
  bf16* k2 = static_cast<bf16*>(cs2);
  bf16* hd = static_cast<bf16*>(h1d);
  for (int t = 0; t < T; ++t) {
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    cb a1 = t == 0 ? static_cast<cb>(h01) : y1 + (t - 1) * BH;
    cb a2 = t == 0 ? static_cast<cb>(h02) : y2 + (t - 1) * BH;
    lstm2_fwd_l1<<<grid, THREADS, 0, st>>>(
        a1, static_cast<cb>(whh1), static_cast<cb>(xg1) + t * BH * 4,
        static_cast<const float*>(bhh1), static_cast<cb>(dm) + t * BH, m_t,
        static_cast<float*>(h1), static_cast<float*>(c1), y1 + t * BH,
        k1 + t * BH, hd, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm2_fwd_l2<<<grid, THREADS, 0, st>>>(
        hd, static_cast<cb>(wih2), a2, static_cast<cb>(whh2),
        static_cast<const float*>(b2), m_t, static_cast<float*>(h2),
        static_cast<float*>(c2), y2 + t * BH, k2 + t * BH, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The persistent forward (see the header): lstm2_train_fwd's arguments,
// with h1d (T, B, H) bf16 (every step's layer-2 input, kept for the input
// GEMM), q (T B, 4H) fp32 workspace and bar two zeroed unsigned ints (one
// grid barrier's counter a recurrence). B must be at most 32 and H a
// multiple of 8; a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge). Returns the first launch error, or
// 0; -1 where the driver's cuTensorMapEncodeTiled is not found, -1000 - r
// where it refuses a descriptor with r.
extern "C" int lstm2_train_fwd_persistent(
    const void* xg1, const void* dm, const void* whh1, const void* bhh1,
    const void* wih2, const void* whh2, const void* b2, const void* mask,
    const void* h01, const void* h02, void* h1, void* c1, void* h2, void* c2,
    void* ys1, void* cs1, void* ys2, void* cs2, void* h1d, void* q, void* bar,
    int T, int B, int H, void* stream) {
  if (B > MMA_ROWS || H % P_UNITS != 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_input_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (T == 0 || B == 0) return 0;
  const int M = T * B, G = 4 * H;
  unsigned int* bars = static_cast<unsigned int*>(bar);

  FwdPersistParams l1 = {};
  l1.x = xg1;
  l1.w = static_cast<cb>(whh1);
  l1.bias = static_cast<const float*>(bhh1);
  l1.mask = static_cast<const uint8_t*>(mask);
  l1.h0 = static_cast<cb>(h01);
  l1.h = static_cast<float*>(h1);
  l1.c = static_cast<float*>(c1);
  l1.ys = static_cast<bf16*>(ys1);
  l1.cs = static_cast<bf16*>(cs1);
  l1.dm = static_cast<cb>(dm);
  l1.hd = static_cast<bf16*>(h1d);
  l1.bar = bars;
  l1.T = T;
  l1.B = B;
  l1.H = H;
  err = launch_persist_fwd(lstm2_fwd_l1_persistent, l1, st);
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  GateParams gp = {};
  int r = encode_map(enc, &gp.a[1], h1d, M, H, GM);
  if (r == 0) r = encode_map(enc, &gp.w[1], wih2, G, H, GN);
  if (r != 0) return -1000 - r;
  gp.g2 = static_cast<float*>(q);
  gp.M = M;
  gp.H = H;
  gp.N = G;
  lstm2_input_gemm<<<dim3((G + GN - 1) / GN, (M + GM - 1) / GM, 1),
                     G_THREADS, G_SMEM, st>>>(gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  FwdPersistParams l2 = {};
  l2.x = q;
  l2.w = static_cast<cb>(whh2);
  l2.bias = static_cast<const float*>(b2);
  l2.mask = static_cast<const uint8_t*>(mask);
  l2.h0 = static_cast<cb>(h02);
  l2.h = static_cast<float*>(h2);
  l2.c = static_cast<float*>(c2);
  l2.ys = static_cast<bf16*>(ys2);
  l2.cs = static_cast<bf16*>(cs2);
  l2.bar = bars + 1;
  l2.T = T;
  l2.B = B;
  l2.H = H;
  return (int)launch_persist_fwd(lstm2_fwd_l2_persistent, l2, st);
}

// h1d' = bf16(ys1 dm) over n = T B H elements, the backward's layer-2 input
// (the caller also takes it for dW_ih2). Returns the launch error, or 0.
extern "C" int lstm2_h1d(const void* ys1, const void* dm, void* h1d,
                         long long n, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + 1023) / 1024 < 4096 ? (n + 1023) / 1024 : 4096;
  lstm2_dropped<<<(unsigned)blocks, 1024, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<cb>(ys1), static_cast<cb>(dm), static_cast<bf16*>(h1d),
      (size_t)n);
  return (int)cudaGetLastError();
}

// The per-step backward over the whole sequence, t = T-1..0. Inputs as the
// forward's, plus c01, c02 (B, H) bf16, the forward's outputs ys1, cs1,
// ys2, cs2, dy1, dy2 (T, B, H) bf16 and h1d (T, B, H) bf16 from
// `lstm2_h1d`; dh1, dc1, dh2, dc2 (B, H) fp32 hold dhT1, dcT1, dhT2, dcT2
// on entry and dh01, dc01, dh02, dc02 on return; du1, du2 (T, B, 4H) bf16
// outputs; workspace inj (B, H) fp32. Returns the first launch error, or 0.
extern "C" int lstm2_train_bwd(
    const void* xg1, const void* dm, const void* whh1, const void* bhh1,
    const void* wih2, const void* whh2, const void* b2, const void* mask,
    const void* h01, const void* c01, const void* h02, const void* c02,
    const void* ys1, const void* cs1, const void* ys2, const void* cs2,
    const void* dy1, const void* dy2, const void* h1d, void* dh1, void* dc1,
    void* dh2, void* dc2, void* du1, void* du2, void* inj, int T, int B,
    int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_g((B + BM - 1) / BM, H / BJ);
  const dim3 grid_h2((B + BM - 1) / BM, 2 * (H / DJ));
  const dim3 grid_h1((B + BM - 1) / BM, H / DJ);
  const size_t BH = (size_t)B * H;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cb y1 = static_cast<cb>(ys1);
  cb y2 = static_cast<cb>(ys2);
  cb k1 = static_cast<cb>(cs1);
  cb k2 = static_cast<cb>(cs2);
  cb hd = static_cast<cb>(h1d);
  bf16* u1 = static_cast<bf16*>(du1);
  bf16* u2 = static_cast<bf16*>(du2);
  float* in = static_cast<float*>(inj);
  cudaError_t err;
  for (int t = T - 1; t >= 0; --t) {
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    cb h1p = t == 0 ? static_cast<cb>(h01) : y1 + (t - 1) * BH;
    cb c1p = t == 0 ? static_cast<cb>(c01) : k1 + (t - 1) * BH;
    cb h2p = t == 0 ? static_cast<cb>(h02) : y2 + (t - 1) * BH;
    cb c2p = t == 0 ? static_cast<cb>(c02) : k2 + (t - 1) * BH;
    cb dy1_t = static_cast<cb>(dy1) + t * BH;
    cb dy2_t = static_cast<cb>(dy2) + t * BH;
    lstm2_bwd_gates<true><<<grid_g, THREADS, 0, st>>>(
        hd + t * BH, static_cast<cb>(wih2), h2p, c2p, static_cast<cb>(whh2),
        nullptr, static_cast<const float*>(b2), m_t, dy2_t, nullptr,
        static_cast<const float*>(dh2), static_cast<float*>(dc2),
        u2 + t * BH * 4, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm2_bwd_dh2<<<grid_h2, DH_THREADS, 0, st>>>(
        u2 + t * BH * 4, static_cast<cb>(whh2), static_cast<cb>(wih2), m_t,
        dy2_t, static_cast<cb>(dm) + t * BH, static_cast<float*>(dh2), in, B,
        H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm2_bwd_gates<false><<<grid_g, THREADS, 0, st>>>(
        nullptr, nullptr, h1p, c1p, static_cast<cb>(whh1),
        static_cast<cb>(xg1) + t * BH * 4, static_cast<const float*>(bhh1),
        m_t, dy1_t, in, static_cast<const float*>(dh1),
        static_cast<float*>(dc1), u1 + t * BH * 4, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm2_bwd_dh1<<<grid_h1, DH_THREADS, 0, st>>>(
        u1 + t * BH * 4, static_cast<cb>(whh1), m_t, dy1_t, in,
        static_cast<float*>(dh1), B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The persistent backward (see the header): stage (1) `lstm2_gates_gemm`
// into the fp32 workspaces g1, g2 (T B, 4H), then stage (2)
// `lstm2_bwd_persistent`, one cooperative launch of H / 8 CTAs of 512
// threads. xg1 (T, B, 4H), whh1, wih2, whh2 (4H, H), h1p, h1d, h2p (T B, H),
// dm, cs1, cs2, dy1, dy2 (T, B, H), c01, c02 (B, H), all bf16; bhh1, b2
// (4H) fp32; mask (T, B) bytes or null; dh1, dc1, dh2, dc2 (B, H) fp32 hold
// dhT1, dcT1, dhT2, dcT2 on entry and dh01, dc01, dh02, dc02 on return; du1,
// du2 (T, B, 4H) bf16 outputs; bar one zeroed unsigned int. B must be at
// most 32 and H a multiple of 8; a grid the card cannot hold at once is
// refused (cudaErrorCooperativeLaunchTooLarge). Returns the first launch
// error, or 0; -1 where the driver's cuTensorMapEncodeTiled is not found,
// -1000 - r where it refuses a descriptor with r.
extern "C" int lstm2_train_bwd_persistent(
    const void* xg1, const void* whh1, const void* bhh1, const void* wih2,
    const void* whh2, const void* b2, const void* mask, const void* dm,
    const void* h1p, const void* h1d, const void* h2p, const void* c01,
    const void* c02, const void* cs1, const void* cs2, const void* dy1,
    const void* dy2, void* dh1, void* dc1, void* dh2, void* dc2, void* du1,
    void* du2, void* g1, void* g2, void* bar, int T, int B, int H,
    void* stream) {
  if (B > MMA_ROWS || H % P_UNITS != 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_gates_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int smem = bwd2_smem(H);
  err = cudaFuncSetAttribute(lstm2_bwd_persistent,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (T == 0 || B == 0) return 0;
  const int M = T * B, G = 4 * H;

  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  GateParams gp = {};
  const void* as[3] = {h1p, h1d, h2p};
  const void* ws[3] = {whh1, wih2, whh2};
  for (int i = 0; i < 3; ++i) {
    int r = encode_map(enc, &gp.a[i], as[i], M, H, GM);
    if (r == 0) r = encode_map(enc, &gp.w[i], ws[i], G, H, GN);
    if (r != 0) return -1000 - r;
  }
  gp.xg1 = static_cast<cb>(xg1);
  gp.bhh1 = static_cast<const float*>(bhh1);
  gp.b2 = static_cast<const float*>(b2);
  gp.g1 = static_cast<float*>(g1);
  gp.g2 = static_cast<float*>(g2);
  gp.M = M;
  gp.H = H;
  gp.N = G;
  lstm2_gates_gemm<<<dim3((G + GN - 1) / GN, (M + GM - 1) / GM, 2),
                     G_THREADS, G_SMEM, st>>>(gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Bwd2Params prm;
  prm.g1 = static_cast<const float*>(g1);
  prm.g2 = static_cast<const float*>(g2);
  prm.whh1 = static_cast<cb>(whh1);
  prm.wih2 = static_cast<cb>(wih2);
  prm.whh2 = static_cast<cb>(whh2);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.dm = static_cast<cb>(dm);
  prm.c01 = static_cast<cb>(c01);
  prm.c02 = static_cast<cb>(c02);
  prm.cs1 = static_cast<cb>(cs1);
  prm.cs2 = static_cast<cb>(cs2);
  prm.dy1 = static_cast<cb>(dy1);
  prm.dy2 = static_cast<cb>(dy2);
  prm.dh1 = static_cast<float*>(dh1);
  prm.dc1 = static_cast<float*>(dc1);
  prm.dh2 = static_cast<float*>(dh2);
  prm.dc2 = static_cast<float*>(dc2);
  prm.du1 = static_cast<bf16*>(du1);
  prm.du2 = static_cast<bf16*>(du2);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm2_bwd_persistent), dim3(H / P_UNITS),
      dim3(P_THREADS), args, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
