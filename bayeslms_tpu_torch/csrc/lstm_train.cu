// Single-layer LSTM recurrence for training, forward and backward, for
// sm_90a (bf16 operands, fp32 accumulation, fp32 carries).
//
// Replaces bayeslms_tpu/ops/lstm_pallas.py `_train_fwd_kernel` (pallas_call
// in `_train_fwd_run`) and `_train_bwd_kernel` (`_train_bwd_run`), the two
// halves of the custom VJP `lstm_scan_fused`. xg = x W_ih^T + b_ih for the
// whole sequence is one GEMM outside; so are dW_hh = hprev^T du, db = sum du
// and everything that flows back through xg.
//
// Forward, t = 0..T-1 (the TPU kernel's `_cell_step`):
//   gates = (xg[t] + h_{t-1} W_hh^T) + b_hh, gate order [i, f, g, o], with
//   h_{t-1} rounded to bf16 for the product; c = f c + i g; h = o tanh(c);
//   where mask[t, b] = 0 the column keeps its (h, c). ys[t] = h and
//   cs[t] = c are stored in bf16; h and c are carried in fp32.
// Backward, t = T-1..0 (`_train_bwd_kernel`, term for term): the gates are
//   recomputed from (xg[t], h_{t-1}, c_{t-1}) with h_{t-1} = ys[t-1] (h0 at
//   t = 0) and c_{t-1} = cs[t-1] (c0) in bf16, then
//     dh_tot = dh + dy[t], dc_tot = dc, dh' = keep dh_tot, dc' = keep dc_tot,
//     do = dh' tanh(c), dc_c = dc' + dh' o (1 - tanh(c)^2),
//     di = dc_c g, df = dc_c c_{t-1}, dg = dc_c i,
//     dc = dc_c f + (1 - keep) dc_tot,
//     du[t] = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)] stored in bf16,
//     dh = du[t] W_hh + (1 - keep) dh_tot, the product on the bf16 du.
//
// Design: the host functions loop over t and launch on the caller's stream.
// The forward is one launch a step: a block owns BM batch columns and BJ
// hidden units and computes all four gate rows (q*H + j) of them, so the
// cell update needs nothing from other blocks and h, c update in place.
// The product's A operand is the bf16 ys[t-1] (equal to the fp32 carry
// rounded to bf16, as the TPU kernel rounds h before its dot), so no
// ping-pong buffers are needed. The backward is two launches a step, since
// dh_{t-1} = du_t W_hh contracts over all 4H gate rows and a block that owns
// a hidden slice cannot finish its dh slice from its own du:
//   (a) `lstm_bwd_gates`: the forward's tile, recomputing the gates, writes
//       du_t and updates the fp32 dc carry in place;
//   (b) `lstm_bwd_dh`: a block owns BM columns x 32 units of dh and
//       contracts du_t (B x 4H) with W_hh (4H x 32), then adds the
//       (1 - keep) dh_tot term, updating the fp32 dh carry in place.
// Stream order makes (b) see all of (a)'s du_t. Products run on the tensor
// cores through wmma (16x16x16 bf16, fp32 accumulators), in the tile
// functions of csrc/gate_tile.cuh (shared with csrc/gp_lstm.cu).
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 (700 W): forward 2 T B H 4H = 26.8
// GFLOP, 0.027 ms; backward twice that, 0.054 ms. Operations bound, but
// both are far from it: the steps are dependent launches (100 forward, 200
// backward), each a small tile product that loads its tiles synchronously
// on 32 blocks, so they are bound by latency. Measured by chip_smoke.py on
// an NVIDIA H100 80GB HBM3 at 700.00 W: 4.1 ms a forward call, 14.9 ms a
// backward call (PERF.md). A persistent kernel with W_hh in the SMs'
// shared memory and a grid barrier per step is the later redesign. At
// B = 32 the BM = 32 column tile is full; every block re-reads its W_hh
// rows from L2 (8 MB in all, resident in the 50 MB L2) each step.

#include "gate_tile.cuh"

namespace {

constexpr int NG = 4;  // the four gates
constexpr int THREADS = GateTile<NG>::THREADS;
constexpr int LDG = GateTile<NG>::LDG;
constexpr int SMEM = GateTile<NG>::SMEM;

// One forward step. a = h_{t-1} in bf16 (h0 or ys[t-1]); h, c are the fp32
// carries, updated in place (each element by the one thread that owns it).
__global__ void __launch_bounds__(THREADS)
lstm_fwd_step(const bf16* __restrict__ a, const bf16* __restrict__ w,
              const bf16* __restrict__ xg_t, const float* __restrict__ bias,
              const uint8_t* __restrict__ mask_t, float* __restrict__ h,
              float* __restrict__ c, bf16* __restrict__ y_t,
              bf16* __restrict__ c_t, int B, int H) {
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

// Backward (a): recompute step t's gates, write du_t, update dc in place.
__global__ void __launch_bounds__(THREADS)
lstm_bwd_gates(const bf16* __restrict__ hprev, const bf16* __restrict__ cprev,
               const bf16* __restrict__ w, const bf16* __restrict__ xg_t,
               const float* __restrict__ bias,
               const uint8_t* __restrict__ mask_t,
               const bf16* __restrict__ dy_t, const float* __restrict__ dh,
               float* __restrict__ dc, bf16* __restrict__ du_t, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
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
    for (int q = 0; q < 4; ++q)
      g[q] = (__bfloat162float(xg_t[(size_t)b * 4 * H + q * H + j]) +
              Gs[r * LDG + q * BJ + u]) + bias[q * H + j];
    const float ig = sigmoidf(g[0]);
    const float fg = sigmoidf(g[1]);
    const float gg = tanhf(g[2]);
    const float og = sigmoidf(g[3]);
    const size_t e = (size_t)b * H + j;
    const float cp = __bfloat162float(cprev[e]);
    const float tc = tanhf(fg * cp + ig * gg);
    const float keep = (mask_t != nullptr && !mask_t[b]) ? 0.f : 1.f;
    const float dh_tot = dh[e] + __bfloat162float(dy_t[e]);
    const float dc_tot = dc[e];
    const float dhn = keep * dh_tot;
    const float dcn = keep * dc_tot;
    const float d_o = dhn * tc;
    const float dcc = dcn + dhn * og * (1.0f - tc * tc);
    const float d_i = dcc * gg;
    const float d_f = dcc * cp;
    const float d_g = dcc * ig;
    dc[e] = dcc * fg + (1.0f - keep) * dc_tot;
    bf16* du = du_t + (size_t)b * 4 * H + j;
    du[0] = __float2bfloat16(d_i * ig * (1.0f - ig));
    du[H] = __float2bfloat16(d_f * fg * (1.0f - fg));
    du[2 * H] = __float2bfloat16(d_g * (1.0f - gg * gg));
    du[3 * H] = __float2bfloat16(d_o * og * (1.0f - og));
  }
}

// Backward (b): dh = du_t W_hh + (1 - keep) dh_tot, in place.
__global__ void __launch_bounds__(DH_THREADS)
lstm_bwd_dh(const bf16* __restrict__ du_t, const bf16* __restrict__ w,
            const uint8_t* __restrict__ mask_t,
            const bf16* __restrict__ dy_t, float* __restrict__ dh, int B,
            int H) {
  dh_tile<NG>(du_t, w, mask_t, dy_t, dh, B, H);
}

}  // namespace

// Forward over the whole sequence. xg (T, B, 4H) bf16, whh (4H, H) bf16,
// bhh (4H) fp32, mask (T, B) bytes or null, h0 (B, H) bf16; h, c (B, H) fp32
// carries holding the initial state (the final state on return); ys, cs
// (T, B, H) bf16 outputs. Returns the first launch error, or 0.
extern "C" int lstm_train_fwd(const void* xg, const void* whh,
                              const void* bhh, const void* mask,
                              const void* h0, void* h, void* c, void* ys,
                              void* cs, int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  const bf16* x = static_cast<const bf16*>(xg);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  bf16* y = static_cast<bf16*>(ys);
  bf16* cc = static_cast<bf16*>(cs);
  for (int t = 0; t < T; ++t) {
    const bf16* a = t == 0 ? static_cast<const bf16*>(h0) : y + (t - 1) * BH;
    lstm_fwd_step<<<grid, THREADS, 0, st>>>(
        a, static_cast<const bf16*>(whh), x + (size_t)t * BH * 4,
        static_cast<const float*>(bhh),
        m != nullptr ? m + (size_t)t * B : nullptr, static_cast<float*>(h),
        static_cast<float*>(c), y + t * BH, cc + t * BH, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Backward over the whole sequence, t = T-1..0. Inputs as the forward's,
// plus its outputs ys, cs, c0 (B, H) bf16 and dy (T, B, H) bf16; dh, dc
// (B, H) fp32 hold dhT, dcT on entry and dh0, dc0 on return; du (T, B, 4H)
// bf16 output. Returns the first launch error, or 0.
extern "C" int lstm_train_bwd(const void* xg, const void* whh,
                              const void* bhh, const void* mask,
                              const void* h0, const void* c0, const void* ys,
                              const void* cs, const void* dy, void* dh,
                              void* dc, void* du, int T, int B, int H,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_a((B + BM - 1) / BM, H / BJ);
  const dim3 grid_b((B + BM - 1) / BM, H / DJ);
  const size_t BH = (size_t)B * H;
  const bf16* w = static_cast<const bf16*>(whh);
  const bf16* x = static_cast<const bf16*>(xg);
  const bf16* y = static_cast<const bf16*>(ys);
  const bf16* cc = static_cast<const bf16*>(cs);
  const bf16* g = static_cast<const bf16*>(dy);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  bf16* u = static_cast<bf16*>(du);
  for (int t = T - 1; t >= 0; --t) {
    const bf16* hp = t == 0 ? static_cast<const bf16*>(h0) : y + (t - 1) * BH;
    const bf16* cp = t == 0 ? static_cast<const bf16*>(c0) : cc + (t - 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    lstm_bwd_gates<<<grid_a, THREADS, 0, st>>>(
        hp, cp, w, x + (size_t)t * BH * 4, static_cast<const float*>(bhh),
        m_t, g + t * BH, static_cast<const float*>(dh),
        static_cast<float*>(dc), u + (size_t)t * BH * 4, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm_bwd_dh<<<grid_b, DH_THREADS, 0, st>>>(
        u + (size_t)t * BH * 4, w, m_t, g + t * BH, static_cast<float*>(dh),
        B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
