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
// Forward (row 5), two designs, picked by ops/lstm_train_cuda.py `_design`
// beside the backward's (the same rule: the chosen design runs or raises).
//
// "persistent" (B <= 32, H / 8 CTAs no more than the card's SMs, its shared
// memory within 227 KB), kernel `lstm_fwd_persistent`: one cooperative
// launch for the whole sequence, the backward's step (a) without the
// gradients, in csrc/lstm_persist.cuh (rows 4 and 7 take it too). CTA c
// owns the 8 hidden units [8c, 8c + 8) and keeps its 4 x 8 gate rows of
// W_hh in shared memory (64 KB at H = 1,024). Step t: the
// CTA's 32 gate columns from h_{t-1} = ys[t-1] (h0 at t = 0), read from L2
// straight into the mma.sync m16n8k16 fragments by `warp_product`, the 16
// warps' partial tiles summed in shared memory in warp order; the cell
// update of its 32 x 8 (column, unit) pairs, one a thread, the fp32 carries
// in that thread's registers; ys[t] and cs[t] stored in bf16; a grid
// barrier, so that every CTA's ys[t] is stored before any CTA reads it: T -
// 1 barriers a call.
//
// "per_step" (the rest), kernel `lstm_fwd_step`: the host function loops
// over t and launches on the caller's stream, one launch a step: a block
// owns BM batch columns and BJ hidden units and computes all four gate rows
// (q*H + j) of them, so the cell update needs nothing from other blocks and
// h, c update in place. The product's A operand is the bf16 ys[t-1] (equal
// to the fp32 carry rounded to bf16, as the TPU kernel rounds h before its
// dot), so no ping-pong buffers are needed. Products run on the tensor
// cores through wmma (16x16x16 bf16, fp32 accumulators), in the tile
// functions of csrc/gate_tile.cuh (shared with csrc/gp_lstm.cu).
//
// Backward, two designs, picked by ops/lstm_train_cuda.py `_design(B, H)`
// (an explicit rule: the chosen design runs or raises).
//
// "persistent" (B <= 32, H / 8 CTAs no more than the card's SMs, its shared
// memory within 227 KB: the training shapes, B = 32 and H = 1,024), kernel
// `lstm_bwd_persistent`: one cooperative launch for the whole sequence.
// CTA c owns the 8 hidden units [8c, 8c + 8) and keeps two slices of W_hh
// in shared memory for the whole call, loaded once: its 4 x 8 gate rows
// (q H + 8c + u, the gate product's B operand, 64 KB at H = 1,024) and its
// 4H x 8 column slice, transposed (dh's B operand, 64 KB). Step t:
//   (a) the CTA's 32 gate columns from h_{t-1} = ys[t-1] (h0 at t = 0),
//       read from L2 straight into the tensor cores' A fragments; then the
//       cell's gradients of its 32 x 8 (column, unit) pairs, one a thread,
//       du_t's slice stored in bf16, and the dc carry (a register of that
//       thread) updated;
//   a grid barrier: every CTA's du_t is stored before any CTA reads it;
//   (b) the CTA's 8 dh columns from all of du_t (B x 4H bf16, 256 KB, from
//       L2 into the A fragments again) against its column slice, plus the
//       (1 - keep) dh_tot term; the dh carry is a register too.
// Step t-1's (a) needs dh only for the CTA's own units, which it has just
// computed, so one barrier a step suffices. Products: mma.sync m16n8k16
// (bf16, fp32 accumulators). wgmma wants 64-row tiles and B is 32 rows, and
// a CTA's product is (32 x 32) over K = H in (a) and (32 x 8) over K = 4H in
// (b): one m16n8k16 tile pair a k16 step, its 16 warps each taking every
// 16th 32-deep k range, their partial tiles summed in shared memory in
// warp order. A thread loads 16 bytes of a row (8 consecutive k) and feeds
// them to two k16 steps: the mma's k slots are matched to memory so that A
// and B read the same k in each slot, which only reorders the fp32 sum.
// The grid barrier is csrc/grid_barrier.cuh's counter, zeroed by the
// wrapper; the cooperative launch refuses a grid the card cannot hold at
// once, and the wrapper then raises: nothing falls back.
//
// "two-launch" (the rest: B > 32, or H beyond what the SMs' shared memory
// and count hold), kernels `lstm_bwd_gates` and `lstm_bwd_dh`, two launches a
// step, since dh_{t-1} = du_t W_hh contracts over all 4H gate rows and a
// block that owns a hidden slice cannot finish its dh slice from its own du:
//   (a) `lstm_bwd_gates`: the forward's tile, recomputing the gates, writes
//       du_t and updates the fp32 dc carry in place;
//   (b) `lstm_bwd_dh`: a block owns BM columns x 32 units of dh and
//       contracts du_t (B x 4H) with W_hh (4H x 32), then adds the
//       (1 - keep) dh_tot term, updating the fp32 dh carry in place.
// Stream order makes (b) see all of (a)'s du_t.
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16 (700 W): forward 2 T B H 4H = 26.8
// GFLOP, 0.027 ms; backward twice that, 0.054 ms. Operations bound, but
// both are far from it: the steps are dependent, each a small product.
// The per-step forward and the two-launch backward are bound by latency:
// 100 and 200 launches a call, each loading its tiles synchronously on 32
// blocks and re-reading its W_hh rows from L2; measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700.00 W: 4.1-4.4 ms a forward call,
// 14.3-14.8 ms a two-launch backward call (PERF.md). The persistent designs
// are bound by their 100 dependent steps: a barrier, and each CTA's L2
// reads of h_{t-1} (64 KB; the backward also du_t, 256 KB); measured the
// same way, the forward 0.71-0.85 ms a call (7-8.5 us a step; cuDNN's
// forward 2.2-3.4 ms), the backward 1.39-1.47 ms (14.7 us a step)
// (PERF.md).

#include "gate_tile.cuh"
#include "grid_barrier.cuh"
#include "lstm_persist.cuh"
#include "warp_mma.cuh"

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

// ------------------------------------------------- the persistent backward

struct PersistParams {
  const bf16* xg;     // (T, B, 4H)
  const bf16* w;      // W_hh (4H, H)
  const float* bias;  // b_hh (4H)
  const uint8_t* mask;  // (T, B) or null
  const bf16* h0;
  const bf16* c0;
  const bf16* ys;     // (T, B, H)
  const bf16* cs;
  const bf16* dy;
  float* dh;          // (B, H): dhT in, dh0 out
  float* dc;
  bf16* du;           // (T, B, 4H)
  unsigned int* bar;  // the barrier's counter, zero on entry
  int T, B, H;
};

// Shared memory: the gate rows (32 x (H + P_PAD)), the column slice (8 x
// (4H + P_PAD)), the warps' partial gate tiles (P_WARPS x 32 x 32 fp32) and
// partial dh tiles (P_WARPS x 32 x 8 fp32).
inline int persist_smem(int H) {
  return (32 * (H + P_PAD) + 8 * (4 * H + P_PAD)) * 2 +
         P_WARPS * P_ROWS * (32 + 8) * 4;
}

__global__ void __launch_bounds__(P_THREADS, 1)
lstm_bwd_persistent(const __grid_constant__ PersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, G = 4 * H, B = p.B;
  const int ldg = H + P_PAD, ldc = G + P_PAD;
  bf16* wg = reinterpret_cast<bf16*>(smem);  // row q 8 + u: W[q H + j0 + u]
  bf16* wc = wg + 32 * ldg;                  // row n: W[:, j0 + n]
  float* red_a = reinterpret_cast<float*>(wc + 8 * ldc);
  float* red_b = red_a + P_WARPS * P_ROWS * 32;
  const int j0 = blockIdx.x * P_UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < 32 * (H / 8); i += P_THREADS) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int row = (r >> 3) * H + j0 + (r & 7);
    *reinterpret_cast<uint4*>(wg + r * ldg + c) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)row * H + c);
  }
  for (int k = tid; k < G; k += P_THREADS) {
    const uint4 v = *reinterpret_cast<const uint4*>(p.w + (size_t)k * H + j0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int n = 0; n < P_UNITS; ++n) wc[n * ldc + k] = e[n];
  }

  // thread tid < 256 owns batch column b and unit j; its carries
  const int b = tid >> 3, j = j0 + (tid & 7);
  const int col = tid & 7;
  const bool own = tid < P_ROWS * P_UNITS && b < B;
  float dh = 0.f, dc = 0.f, carry = 0.f, bq[4];
  if (own) {
    dh = p.dh[(size_t)b * H + j];
    dc = p.dc[(size_t)b * H + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = p.bias[q * H + j];
  }
  __syncthreads();

  const size_t BH = (size_t)B * H;
  unsigned int target = 0;
  for (int t = p.T - 1; t >= 0; --t) {
    // (a) the gates: this step's elementwise inputs first, in flight
    // during the product
    float x[4] = {0.f, 0.f, 0.f, 0.f}, cp = 0.f, dyv = 0.f, keep = 1.f;
    if (own) {
      const bf16* xr = p.xg + ((size_t)t * B + b) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = __bfloat162float(xr[q * H]);
      cp = __bfloat162float(t == 0 ? p.c0[(size_t)b * H + j]
                                   : p.cs[(t - 1) * BH + (size_t)b * H + j]);
      dyv = __bfloat162float(p.dy[t * BH + (size_t)b * H + j]);
      if (p.mask != nullptr && !p.mask[(size_t)t * B + b]) keep = 0.f;
    }
    {
      float acc[2][4][4] = {};
      warp_product<4, 2, P_WARPS>(t == 0 ? p.h0 : p.ys + (t - 1) * BH, B,
                                  H, wg, ldg, warp, lane, acc);
      store_partial<4>(red_a, acc, warp, lane);
    }
    __syncthreads();
    if (own) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
        for (int w = 0; w < P_WARPS; ++w)
          s += red_a[(w * P_ROWS + b) * 32 + q * 8 + col];
        g[q] = (x[q] + s) + bq[q];
      }
      const float ig = sigmoidf(g[0]);
      const float fg = sigmoidf(g[1]);
      const float gg = tanhf(g[2]);
      const float og = sigmoidf(g[3]);
      const float tc = tanhf(fg * cp + ig * gg);
      const float dh_tot = dh + dyv;
      const float dc_tot = dc;
      const float dhn = keep * dh_tot;
      const float dcn = keep * dc_tot;
      const float d_o = dhn * tc;
      const float dcc = dcn + dhn * og * (1.0f - tc * tc);
      const float d_i = dcc * gg;
      const float d_f = dcc * cp;
      const float d_g = dcc * ig;
      dc = dcc * fg + (1.0f - keep) * dc_tot;
      carry = (1.0f - keep) * dh_tot;
      bf16* du = p.du + ((size_t)t * B + b) * G + j;
      du[0] = __float2bfloat16(d_i * ig * (1.0f - ig));
      du[H] = __float2bfloat16(d_f * fg * (1.0f - fg));
      du[2 * H] = __float2bfloat16(d_g * (1.0f - gg * gg));
      du[3 * H] = __float2bfloat16(d_o * og * (1.0f - og));
    }
    target += gridDim.x;
    grid_barrier(p.bar, target);

    // (b) dh = du_t W_hh + (1 - keep) dh_tot for the CTA's units
    {
      float acc[2][1][4] = {};
      warp_product<1, 4, P_WARPS>(p.du + (size_t)t * B * G, B, G, wc, ldc,
                                  warp, lane, acc);
      store_partial<1>(red_b, acc, warp, lane);
    }
    __syncthreads();
    if (own) {
      float s = 0.f;
      for (int w = 0; w < P_WARPS; ++w) s += red_b[(w * P_ROWS + b) * 8 + col];
      dh = s + carry;
    }
  }
  if (own) {
    p.dh[(size_t)b * H + j] = dh;
    p.dc[(size_t)b * H + j] = dc;
  }
}

// ------------------------------------------------- the persistent forward

// csrc/lstm_persist.cuh's recurrence with cs stored (row 5)
__global__ void __launch_bounds__(P_THREADS, 1)
lstm_fwd_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd<false>(p, smem);
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

// The persistent forward (see the header): lstm_train_fwd's arguments,
// plus bar, one zeroed unsigned int of device memory for the grid barrier.
// B must be at most 32 and H a multiple of 8; the grid is H / 8 CTAs of 512
// threads, launched cooperatively, so a grid the card cannot hold at once
// is refused (cudaErrorCooperativeLaunchTooLarge). Returns the launch
// error, or 0.
extern "C" int lstm_train_fwd_persistent(const void* xg, const void* whh,
                                         const void* bhh, const void* mask,
                                         const void* h0, void* h, void* c,
                                         void* ys, void* cs, void* bar, int T,
                                         int B, int H, void* stream) {
  FwdPersistParams prm = {};
  prm.x = xg;
  prm.w = static_cast<const bf16*>(whh);
  prm.bias = static_cast<const float*>(bhh);
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
  return (int)launch_persist_fwd(lstm_fwd_persistent, prm,
                                 static_cast<cudaStream_t>(stream));
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

// The persistent backward (see the header): the two-launch backward's
// arguments, plus bar, one zeroed unsigned int of device memory for the
// grid barrier. B must be at most 32 and H a multiple of 8; the grid is
// H / 8 CTAs of 512 threads, launched cooperatively, so a grid the card
// cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge).
// Returns the launch error, or 0.
extern "C" int lstm_train_bwd_persistent(
    const void* xg, const void* whh, const void* bhh, const void* mask,
    const void* h0, const void* c0, const void* ys, const void* cs,
    const void* dy, void* dh, void* dc, void* du, void* bar, int T, int B,
    int H, void* stream) {
  if (B > P_ROWS || H % P_UNITS != 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = persist_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  PersistParams prm;
  prm.xg = static_cast<const bf16*>(xg);
  prm.w = static_cast<const bf16*>(whh);
  prm.bias = static_cast<const float*>(bhh);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.h0 = static_cast<const bf16*>(h0);
  prm.c0 = static_cast<const bf16*>(c0);
  prm.ys = static_cast<const bf16*>(ys);
  prm.cs = static_cast<const bf16*>(cs);
  prm.dy = static_cast<const bf16*>(dy);
  prm.dh = static_cast<float*>(dh);
  prm.dc = static_cast<float*>(dc);
  prm.du = static_cast<bf16*>(du);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bwd_persistent), dim3(H / P_UNITS),
      dim3(P_THREADS), args, (size_t)smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
