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
// Design: the host functions loop over t and launch on the caller's stream,
// in the manner of csrc/lstm_train.cu (rows 5-6), whose tiles they share
// (csrc/gate_tile.cuh). The forward is two launches a step: layer 1's
// `GateTile<4>` (a block owns BM columns x BJ units and all four gate rows
// of them, so the cell update needs nothing from other blocks), which also
// writes h1d to a (B, H) bf16 buffer; then layer 2's tile, one contraction
// over K = 2H of [h1d | h2] against [W_ih2 | W_hh2] (`gate_tile2`). The
// backward is one elementwise launch for the whole sequence (h1d' for every
// t) and four a step: (a) layer 2's gates and du2; (b) one launch of
// 2 H / DJ column blocks, half contracting du2 with W_hh2 for dh2, half with
// W_ih2 for inj (fp32, (B, H)); (c) layer 1's gates and du1; (d) dh1. Stream
// order makes each launch see the one before it. A one-step skew (layer 1
// at t and layer 2 at t-1 in one launch) and a persistent kernel with the
// weights in shared memory are the later redesigns (ROADMAP.md B.4).
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 (700 W): forward three 2 T B H 4H
// products = 80.5 GFLOP, 0.081 ms; backward six, 0.163 ms. Like rows 5-6,
// both are bound by the latency of dependent launches (200 forward, 400
// backward) on 32 blocks, not by either peak.
//
// Planted faults, for chip_smoke.py (-DLSTM2_TRAIN_FAULT=n): 1, the
// backward's recompute ignores the dropout mask (h1d' = ys1); 2, the
// injection into layer 1 is dropped (inj = 0); 3, the forward ignores the
// dropout mask (h1d = h1).

#include "gate_tile.cuh"

#ifndef LSTM2_TRAIN_FAULT
#define LSTM2_TRAIN_FAULT 0
#endif

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

// Backward over the whole sequence, t = T-1..0. Inputs as the forward's,
// plus c01, c02 (B, H) bf16, the forward's outputs ys1, cs1, ys2, cs2 and
// dy1, dy2 (T, B, H) bf16; dh1, dc1, dh2, dc2 (B, H) fp32 hold dhT1, dcT1,
// dhT2, dcT2 on entry and dh01, dc01, dh02, dc02 on return; du1, du2
// (T, B, 4H) bf16 outputs; workspaces h1d (T, B, H) bf16 and inj (B, H)
// fp32. Returns the first launch error, or 0.
extern "C" int lstm2_train_bwd(
    const void* xg1, const void* dm, const void* whh1, const void* bhh1,
    const void* wih2, const void* whh2, const void* b2, const void* mask,
    const void* h01, const void* c01, const void* h02, const void* c02,
    const void* ys1, const void* cs1, const void* ys2, const void* cs2,
    const void* dy1, const void* dy2, void* dh1, void* dc1, void* dh2,
    void* dc2, void* du1, void* du2, void* h1d, void* inj, int T, int B,
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
  bf16* u1 = static_cast<bf16*>(du1);
  bf16* u2 = static_cast<bf16*>(du2);
  bf16* hd = static_cast<bf16*>(h1d);
  float* in = static_cast<float*>(inj);
  const size_t n = (size_t)T * BH;
  lstm2_dropped<<<(unsigned)((n + 1023) / 1024 < 4096 ? (n + 1023) / 1024
                                                      : 4096),
                  1024, 0, st>>>(y1, static_cast<cb>(dm), hd, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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
