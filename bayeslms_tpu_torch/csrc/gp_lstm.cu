// GP-LSTM gate-replacement recurrence (GP gates 1-4), forward and backward,
// for sm_90a (bf16 operands, fp32 accumulation, fp32 carries).
//
// Replaces bayeslms_tpu/ops/gp_lstm_pallas.py `_gpg_fwd_kernel`
// (pallas_call in `_make_gpg.fwd_run`) and `_gpg_bwd_kernel` (`bwd_run`),
// the two halves of the custom VJP behind `gpg_layer_fused`. One gate slice
// of the standard LSTM cell (gate GATE of [i, f, g, o]) is replaced by a GP
// unit over cat(x_t, h_{t-1}):
//   gates = (xg[t] + h W_hh^T) + b_ih      (b_ih added a second time: the
//                                          reference's quirk; b_hh unused)
//   pre   = gpx[t] + h w_h^T                (gpx = x w_x^T + b_gp, outside)
//   gp    = sum_a coef[a] act_a(pre)        (sigmoid, tanh, relu; gate 2:
//                                          sigmoid alone)
// with h rounded to bf16 for the product; W_hh (4H, H) and w_h (H, H) are
// one (5H, H) operand W5, so a step is one product h W5^T. The replaced
// gate takes gp in place of its activation; c = f c + i g; h = o tanh(c);
// where mask[t, b] = 0 the column keeps its (h, c). ys[t] = h and
// cs[t] = c are stored in bf16; h and c are carried in fp32.
// Backward, t = T-1..0 (`_gpg_bwd_kernel`, term for term): the step is
// recomputed from (xg[t], gpx[t], h_{t-1}, c_{t-1}) with h_{t-1} = ys[t-1]
// (h0 at t = 0) and c_{t-1} = cs[t-1] (c0) in bf16, then
//   dh_tot = dh + dy[t], dh' = keep dh_tot, dc' = keep dc,
//   do = dh' tanh(c), dc_c = dc' + dh' o (1 - tanh(c)^2),
//   di = dc_c g, df = dc_c c_{t-1}, dg = dc_c i, dc = dc_c f + (1-keep) dc,
//   du = [di i(1-i), df f(1-f), dg (1-g^2), do o(1-o)] with the replaced
//   gate's slice zeroed; dgp = its d (di, df, dg or do);
//   dcoef[a] += sum over the batch of dgp act_a(pre);
//   dpre = dgp sum_a coef[a] act_a'(pre);
//   du5[t] = [du, dpre] stored in bf16; dh = du5[t] W5 + (1 - keep) dh_tot,
//   the product on the bf16 du5.
// dW5 = du5^T hprev and db_ih = sum du5[:, :4H] are GEMMs and sums outside,
// as the TPU package leaves them to XLA.
//
// The forward runs in one of two designs, picked by ops/gp_lstm_cuda.py
// `_design_fwd(B, H, n_sm, T, row=20)` (an explicit rule: the chosen design
// runs or raises). Both take the step's cell from `Step` and `gpg_cell`.
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, the shared memory within 227 KB: the training step, the `evaluate`
// windows), one cooperative launch a call, csrc/lstm_persist.cuh's
// recurrence (rows 4, 5, 7 and 18 take it too) with this row's cell,
// `gpg_fwd_persistent`: H / 8 CTAs of 512 threads, CTA c keeping W5's 5 x 8
// rows of its units [8c, 8c + 8) in shared memory (84,480 bytes, 166,400
// with the 16 warps' 32 x 40 fp32 partial tiles, at H = 1,024); a step the
// CTA's 40 product columns from the bf16 ys[t-1] (h0 at t = 0) by mma.sync
// m16n8k16, the cell of its 32 x 8 (column, unit) pairs with h, c carried
// in registers, ys[t] and cs[t] stored, a grid barrier.
//
// "per_step" (the rest: B > 32, or H beyond what the SMs hold), one launch
// a step (the design of csrc/lstm_train.cu's per-step forward, with the
// tile functions of csrc/gate_tile.cuh taken at five row groups),
// `gpg_fwd_step`: the host function loops over t and launches on the
// caller's stream; a block owns BM batch columns and BJ hidden units and
// computes the five rows (q*H + j, q = 0..4) of them, so the cell update
// needs nothing from other blocks and h, c update in place.
//
// In both the product's A operand is the bf16 ys[t-1], the fp32 carry
// rounded as the TPU kernel rounds it.
//
// The backward runs in one of two designs, picked by ops/gp_lstm_cuda.py
// `_design(B, H, n_sm, T, row=21)` (an explicit rule: the chosen design
// runs or raises).
//
// "persistent" (B <= 32, H a multiple of 8, H / 8 CTAs no more than the
// SMs, the shared memory within 227 KB: the training shape), two launches
// a call, csrc/gp_persist.cuh's design (row 19's too): `gpg_bwd_gemm`,
// P = hprev W5^T for all T B rows (fp32, 65 MB at T 100, B 32, H 1,024),
// then `gpg_bwd_persistent`, one cooperative launch of H / 8 CTAs, each
// keeping its 5H x 8 column slice of W5 in shared memory (98,816 bytes
// with the partial tiles at H = 1,024): step t's cell of its 8 units from
// gates = (xg[t] + P[t][:, :4H]) + b_ih and pre = gpx[t] + P[t][:, 4H:],
// the twin's order; du5[t] stored, the dcoef terms summed over the batch
// and then over the steps in the CTA, which owns its units' dcoef columns;
// a grid barrier; dh from all of du5[t] (B x 5H) against the slice. The
// replaced gate's group of du5 is zero, and (b) contracts it all the same.
//
// "two_launch" (the rest: B > 32, or H beyond what the SMs hold), two
// launches a step, since dh_{t-1} contracts du5_t over all 5H rows:
//   (a) `gpg_bwd_gates`: the forward's tile, recomputing the step, writes
//       du5_t, updates the fp32 dc carry in place, and adds the block's
//       dcoef partial (its BM columns summed in a fixed order) to an fp32
//       accumulator of its own, one per column block;
//   (b) `gpg_bwd_dh`: a block owns BM columns x 32 units of dh and
//       contracts du5_t (B x 5H) with W5 (5H x 32), adding (1 - keep) dh_tot.
// After the sweep `gpg_dcoef_sum` adds the column blocks' accumulators in
// order: repeat calls give the same bits. Both designs take the step's
// gradients from `gpg_grads`. The kernels are specialised per (GATE, NACT):
// the replaced gate and the act set (NACT = 1: sigmoid; NACT = 3: sigmoid,
// tanh, relu). The per-step products run on the tensor cores through wmma
// (16x16x16 bf16, fp32 accumulators).
//
// Bound at the training shapes (T = 100, B = 32, H = 1,024), from the H100
// SXM data sheet's 989 TFLOP/s bf16: forward 2 T B H 5H = 33.6 GFLOP,
// 0.034 ms; backward twice that, 0.068 ms. Operations bound, but all are
// far from it. The per-step forward and the two-launch backward are bound
// by the latency of dependent launches (100 forward, 200 backward), each a
// small tile product loading its tiles synchronously on 32 blocks, as rows
// 5-6's per-step designs were: 4.5 ms a per-step forward call and 17.7 ms
// a two-launch backward call on an NVIDIA H100 80GB HBM3 at 700.00 W
// (PERF.md). The persistent forward is bound by its T dependent steps: a
// barrier and each CTA's L2 read of h_{t-1} (64 KB at B = 32) a step. The
// persistent backward's GEMM is operations bound (33.6 GFLOP), its
// recurrence by its T dependent steps: a barrier and each CTA's L2 read of
// du5[t] (320 KB) a step.
//
// Planted faults for the on-card check (chip_smoke.py), off by default:
// -DGP_LSTM_FAULT=1 leaves the replaced gate's slice of du5 unzeroed (the
// standard formula on gp) and -DGP_LSTM_FAULT=2 drops the dcoef
// accumulation, in both designs; -DGP_LSTM_FAULT=3 has the persistent
// recurrence read P of step 0 at every step (the step's offset dropped),
// which only the hoisted design can get wrong; -DGP_LSTM_FAULT=4 has the
// persistent forward's product read h0 at every step, which only it can
// get wrong.

#ifndef GP_LSTM_FAULT
#define GP_LSTM_FAULT 0
#endif
#if GP_LSTM_FAULT == 3
#define GP_PERSIST_P_STEP(t, T) 0
#endif
#if GP_LSTM_FAULT == 4
#define LSTM_PERSIST_H0_ALWAYS 1
#endif

#include "gate_tile.cuh"
#include "gp_persist.cuh"

namespace {

constexpr int NG = 5;  // row groups: the four gates and the GP unit
constexpr int THREADS = GateTile<NG>::THREADS;
constexpr int LDG = GateTile<NG>::LDG;
constexpr int SMEM = GateTile<NG>::SMEM;

constexpr int MAX_ACT = 3;

// act_a(v) for the act set of NACT (sigmoid; or sigmoid, tanh, relu)
__device__ __forceinline__ float act(int a, float v) {
  if (a == 0) return sigmoidf(v);
  if (a == 1) return tanhf(v);
  return fmaxf(v, 0.0f);
}

// act_a'(v) from v and av = act_a(v)
__device__ __forceinline__ float act_d(int a, float v, float av) {
  if (a == 0) return av * (1.0f - av);
  if (a == 1) return 1.0f - av * av;
  return v > 0.0f ? 1.0f : 0.0f;
}

// The step's activations of element (b, j) from the product tile row gs:
// gate pre-activations, the GP unit's pre-activation and its acts, and the
// four gate values with gate GATE replaced by the mixture.
template <int GATE, int NACT>
struct Step {
  float pre, av[MAX_ACT], gate[4];
  __device__ __forceinline__ Step(const float* gs, int u,
                                  const bf16* __restrict__ xg_row,
                                  const bf16* __restrict__ gpx_row,
                                  const float* __restrict__ bih,
                                  const float* __restrict__ coef, int j,
                                  int H) {
    float prod[5], x[4], b[4], cf[NACT];
#pragma unroll
    for (int q = 0; q < 5; ++q) prod[q] = gs[q * BJ + u];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = __bfloat162float(xg_row[q * H + j]);
      b[q] = bih[q * H + j];
    }
#pragma unroll
    for (int a = 0; a < NACT; ++a) cf[a] = coef[a * H + j];
    init(prod, x, __bfloat162float(gpx_row[j]), b, cf);
  }
  // the same from values: the five products (gate rows, then the GP row),
  // xg's four columns, gpx, b_ih's four columns and the unit's coef
  __device__ __forceinline__ Step(const float (&prod)[5], const float (&x)[4],
                                  float gx, const float (&bih)[4],
                                  const float (&coef)[NACT]) {
    init(prod, x, gx, bih, coef);
  }
  __device__ __forceinline__ void init(const float (&prod)[5],
                                       const float (&x)[4], float gx,
                                       const float (&bih)[4],
                                       const float (&coef)[NACT]) {
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = (x[q] + prod[q]) + bih[q];
    pre = gx + prod[4];
    float gp = 0.0f;
#pragma unroll
    for (int a = 0; a < NACT; ++a) {
      av[a] = act(a, pre);
      gp += coef[a] * av[a];
    }
    gate[0] = GATE == 1 ? gp : sigmoidf(g[0]);
    gate[1] = GATE == 2 ? gp : sigmoidf(g[1]);
    gate[2] = GATE == 3 ? gp : tanhf(g[2]);
    gate[3] = GATE == 4 ? gp : sigmoidf(g[3]);
  }
};

// The cell update of one element from its step s and c_{t-1} (both
// forward designs): cn = f c + i g, hn = o tanh(cn).
template <int GATE, int NACT>
__device__ __forceinline__ void gpg_cell(const Step<GATE, NACT>& s, float c,
                                         float& cn, float& hn) {
  cn = s.gate[1] * c + s.gate[0] * s.gate[2];
  hn = s.gate[3] * tanhf(cn);
}

// The backward of one element from its step s, the unit's coef and
// c_{t-1} (both designs): du5's five entries d5 (the replaced gate's slice
// zeroed), the dcoef terms dgp act_a(pre) as part[a]; returns the new dc.
template <int GATE, int NACT>
__device__ __forceinline__ float gpg_grads(const Step<GATE, NACT>& s,
                                           const float (&coef)[NACT],
                                           float cp, float keep, float dh_tot,
                                           float dc, float (&d5)[5],
                                           float (&part)[NACT]) {
  const float ig = s.gate[0], fg = s.gate[1], gg = s.gate[2], og = s.gate[3];
  const GpCellGrad d = gp_cell_grad(ig, fg, gg, og, cp, keep, dh_tot, dc);
  const bool zero_gp = GP_LSTM_FAULT != 1;
  d5[0] = (GATE == 1 && zero_gp) ? 0.f : d.d_i * ig * (1.0f - ig);
  d5[1] = (GATE == 2 && zero_gp) ? 0.f : d.d_f * fg * (1.0f - fg);
  d5[2] = (GATE == 3 && zero_gp) ? 0.f : d.d_g * (1.0f - gg * gg);
  d5[3] = (GATE == 4 && zero_gp) ? 0.f : d.d_o * og * (1.0f - og);
  const float dgp = GATE == 1 ? d.d_i : GATE == 2 ? d.d_f
                  : GATE == 3 ? d.d_g : d.d_o;
  float dmix = 0.0f;
#pragma unroll
  for (int a = 0; a < NACT; ++a) {
    part[a] = dgp * s.av[a];
    dmix += coef[a] * act_d(a, s.pre, s.av[a]);
  }
  d5[4] = dgp * dmix;
  return d.dc;
}

// One forward step. a = h_{t-1} in bf16 (h0 or ys[t-1]); h, c are the fp32
// carries, updated in place (each element by the one thread that owns it).
template <int GATE, int NACT>
__global__ void __launch_bounds__(THREADS)
gpg_fwd_step(const bf16* __restrict__ a, const bf16* __restrict__ w5,
             const bf16* __restrict__ xg_t, const bf16* __restrict__ gpx_t,
             const float* __restrict__ bih, const float* __restrict__ coef,
             const uint8_t* __restrict__ mask_t, float* __restrict__ h,
             float* __restrict__ c, bf16* __restrict__ y_t,
             bf16* __restrict__ c_t, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  gate_tile<NG>(a, w5, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) continue;
    const Step<GATE, NACT> s(Gs + r * LDG, u, xg_t + (size_t)b * 4 * H,
                             gpx_t + (size_t)b * H, bih, coef, j, H);
    const size_t e = (size_t)b * H + j;
    float cn, hn;
    gpg_cell(s, c[e], cn, hn);
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

// Backward (a): recompute step t, write du5_t, update dc in place, add the
// block's dcoef partial to acc (NACT, H) of its column block.
template <int GATE, int NACT>
__global__ void __launch_bounds__(THREADS)
gpg_bwd_gates(const bf16* __restrict__ hprev, const bf16* __restrict__ cprev,
              const bf16* __restrict__ w5, const bf16* __restrict__ xg_t,
              const bf16* __restrict__ gpx_t, const float* __restrict__ bih,
              const float* __restrict__ coef,
              const uint8_t* __restrict__ mask_t,
              const bf16* __restrict__ dy_t, const float* __restrict__ dh,
              float* __restrict__ dc, bf16* __restrict__ du5_t,
              float* __restrict__ dcoef_acc, int B, int H) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float Ps[NACT * BM * BJ];  // dgp act_a(pre), per (a, r, u)
  const int b0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  gate_tile<NG>(hprev, w5, b0, j0, B, H, smem);
  const float* Gs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BJ; i += THREADS) {
    const int r = i / BJ;
    const int u = i % BJ;
    const int b = b0 + r;
    const int j = j0 + u;
    if (b >= B) {
#pragma unroll
      for (int a = 0; a < NACT; ++a) Ps[(a * BM + r) * BJ + u] = 0.0f;
      continue;
    }
    const Step<GATE, NACT> s(Gs + r * LDG, u, xg_t + (size_t)b * 4 * H,
                             gpx_t + (size_t)b * H, bih, coef, j, H);
    const size_t e = (size_t)b * H + j;
    const float keep = (mask_t != nullptr && !mask_t[b]) ? 0.f : 1.f;
    float cf[NACT], d5[5], part[NACT];
#pragma unroll
    for (int a = 0; a < NACT; ++a) cf[a] = coef[a * H + j];
    dc[e] = gpg_grads(s, cf, __bfloat162float(cprev[e]), keep,
                      dh[e] + __bfloat162float(dy_t[e]), dc[e], d5, part);
#pragma unroll
    for (int a = 0; a < NACT; ++a) Ps[(a * BM + r) * BJ + u] = part[a];
    bf16* o = du5_t + (size_t)b * 5 * H + j;
#pragma unroll
    for (int q = 0; q < 5; ++q) o[q * H] = __float2bfloat16(d5[q]);
  }
  __syncthreads();
  if (GP_LSTM_FAULT != 2 && threadIdx.x < NACT * BJ) {
    const int a = threadIdx.x / BJ;
    const int u = threadIdx.x % BJ;
    float sum = 0.0f;
    for (int r = 0; r < BM; ++r) sum += Ps[(a * BM + r) * BJ + u];
    dcoef_acc[((size_t)blockIdx.x * NACT + a) * H + j0 + u] += sum;
  }
}

// Backward (b): dh = du5_t W5 + (1 - keep) dh_tot, in place.
__global__ void __launch_bounds__(DH_THREADS)
gpg_bwd_dh(const bf16* __restrict__ du5_t, const bf16* __restrict__ w5,
           const uint8_t* __restrict__ mask_t, const bf16* __restrict__ dy_t,
           float* __restrict__ dh, int B, int H) {
  dh_tile<NG>(du5_t, w5, mask_t, dy_t, dh, B, H);
}

// dcoef[a][j] = sum over column blocks, in order, of acc[blk][a][j]
__global__ void gpg_dcoef_sum(const float* __restrict__ acc,
                              float* __restrict__ dcoef, int nblk, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += acc[(size_t)k * n + i];
  dcoef[i] = s;
}

// -------------------------------------------- the persistent forward

// Row 20's cell for csrc/lstm_persist.cuh: the product's five groups are h
// W5^T's columns (the gates', then the GP unit's); b_ih and coef of the
// thread's unit; xg[t]'s four columns and gpx[t] a step.
template <int GATE, int NACT>
struct GpgFwdCell {
  static constexpr int NG = 5;
  struct Const {
    float bih[4], coef[NACT];
  };
  struct In {
    float x[4], gx;
  };
  __device__ static void load(const FwdPersistParams& p, int j, Const& k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) k.bih[q] = p.bias[q * p.H + j];
#pragma unroll
    for (int a = 0; a < NACT; ++a) k.coef[a] = p.coef[a * p.H + j];
  }
  __device__ static void fetch(const FwdPersistParams& p, int t, int b, int j,
                               In& in) {
    const size_t r = (size_t)t * p.B + b;
    const bf16* xr = static_cast<const bf16*>(p.x) + r * 4 * p.H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.x[q] = __bfloat162float(xr[q * p.H]);
    in.gx = __bfloat162float(p.gpx[r * p.H + j]);
  }
  __device__ static void update(const Const& k, const In& in,
                                const float (&s)[NG], float c, float& cn,
                                float& hn) {
    const Step<GATE, NACT> st(s, in.x, in.gx, k.bih, k.coef);
    gpg_cell(st, c, cn, hn);
  }
};

template <int GATE, int NACT>
__global__ void __launch_bounds__(P_THREADS, 1)
gpg_fwd_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd_cell<GpgFwdCell<GATE, NACT>>(p, smem);
}

template <int GATE, int NACT>
int fwd_persist(const FwdPersistParams& prm, cudaStream_t st) {
  return (int)launch_persist_fwd(gpg_fwd_persistent<GATE, NACT>, prm, st, 5);
}

// ------------------------------------------- the persistent backward

// Row 21's cell for csrc/gp_persist.cuh: P's five groups are h W5^T's
// columns (the gates', then the GP unit's); du5[t] is both the output and
// the dh product's operand.
template <int GATE, int NACT>
struct GpgCell {
  static constexpr int NG = 5;
  static constexpr int NPART = NACT;  // term a: dcoef[a][j]
  static constexpr bool DCOEF = GP_LSTM_FAULT != 2;
  struct Const {
    float bih[4], coef[NACT];
  };
  __device__ static void load(const GpBwdParams& p, int j, Const& k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) k.bih[q] = p.bih[q * p.H + j];
#pragma unroll
    for (int a = 0; a < NACT; ++a) k.coef[a] = p.coef[a * p.H + j];
  }
  __device__ static float step(const GpBwdParams& p, const Const& k,
                               const GpIn<NG>& in, float dh_tot, float dc,
                               size_t row, int j, float (&part)[NPART]) {
    const Step<GATE, NACT> s(in.p, in.x, in.gx, k.bih, k.coef);
    float d5[5];
    const float dcn =
        gpg_grads(s, k.coef, in.cp, in.keep, dh_tot, dc, d5, part);
    bf16* o = p.dop + row * 5 * p.H + j;
#pragma unroll
    for (int q = 0; q < 5; ++q) o[q * p.H] = __float2bfloat16(d5[q]);
    return dcn;
  }
};

// (1) P = hprev W5^T for every step
__global__ void __launch_bounds__(G_THREADS, 1)
gpg_bwd_gemm(const __grid_constant__ GateParams p) {
  extern __shared__ unsigned char smem_raw[];
  gates_gemm(p, true, smem_raw);
}

// (2) the recurrence
template <int GATE, int NACT>
__global__ void __launch_bounds__(P_THREADS, 1)
gpg_bwd_persistent(const __grid_constant__ GpBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  gp_bwd_persist<GpgCell<GATE, NACT>>(p, smem);
}

template <int GATE, int NACT>
int bwd_persist(const void* hprev, float* P, const GpBwdParams& prm,
                cudaStream_t st) {
  return launch_gp_bwd(gpg_bwd_gemm, gpg_bwd_persistent<GATE, NACT>, 5,
                       hprev, P, prm, st);
}

template <int GATE, int NACT>
int fwd_seq(const bf16* xg, const bf16* gpx, const bf16* w5,
            const float* bih, const float* coef, const uint8_t* m,
            const bf16* h0, float* h, float* c, bf16* y, bf16* cs, int T,
            int B, int H, cudaStream_t st) {
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const bf16* a = t == 0 ? h0 : y + (t - 1) * BH;
    gpg_fwd_step<GATE, NACT><<<grid, THREADS, 0, st>>>(
        a, w5, xg + (size_t)t * BH * 4, gpx + (size_t)t * BH, bih, coef,
        m != nullptr ? m + (size_t)t * B : nullptr, h, c, y + t * BH,
        cs + t * BH, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int GATE, int NACT>
int bwd_seq(const bf16* xg, const bf16* gpx, const bf16* w5,
            const float* bih, const float* coef, const uint8_t* m,
            const bf16* h0, const bf16* c0, const bf16* y, const bf16* cc,
            const bf16* g, float* dh, float* dc, bf16* du5, float* acc,
            int T, int B, int H, cudaStream_t st) {
  const dim3 grid_a((B + BM - 1) / BM, H / BJ);
  const dim3 grid_b((B + BM - 1) / BM, H / DJ);
  const size_t BH = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    const bf16* hp = t == 0 ? h0 : y + (t - 1) * BH;
    const bf16* cp = t == 0 ? c0 : cc + (t - 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    gpg_bwd_gates<GATE, NACT><<<grid_a, THREADS, 0, st>>>(
        hp, cp, w5, xg + (size_t)t * BH * 4, gpx + (size_t)t * BH, bih, coef,
        m_t, g + t * BH, dh, dc, du5 + (size_t)t * BH * 5, acc, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gpg_bwd_dh<<<grid_b, DH_THREADS, 0, st>>>(du5 + (size_t)t * BH * 5, w5,
                                              m_t, g + t * BH, dh, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// the (GATE, NACT) instance of F, or -1 for a pair there is none of
#define GPG_DISPATCH(F, ...)                                            \
  switch (gate * 10 + nact) {                                           \
    case 11: return F<1, 1>(__VA_ARGS__);                               \
    case 13: return F<1, 3>(__VA_ARGS__);                               \
    case 21: return F<2, 1>(__VA_ARGS__);                               \
    case 23: return F<2, 3>(__VA_ARGS__);                               \
    case 31: return F<3, 1>(__VA_ARGS__);                               \
    case 33: return F<3, 3>(__VA_ARGS__);                               \
    case 41: return F<4, 1>(__VA_ARGS__);                               \
    case 43: return F<4, 3>(__VA_ARGS__);                               \
    default: return -1;                                                 \
  }

}  // namespace

// Forward over the whole sequence. xg (T, B, 4H) and gpx (T, B, H) bf16;
// w5 (5H, H) bf16, W_hh's rows then w_h's; bih (4H) fp32; coef (nact, H)
// fp32; mask (T, B) bytes or null; h0 (B, H) bf16; h, c (B, H) fp32 carries
// holding the initial state (the final state on return); ys, cs (T, B, H)
// bf16 outputs. gate 1-4, nact 1 or 3. Returns the first launch error, -1
// for an unknown (gate, nact), or 0.
extern "C" int gpg_fwd(const void* xg, const void* gpx, const void* w5,
                       const void* bih, const void* coef, const void* mask,
                       const void* h0, void* h, void* c, void* ys, void* cs,
                       int T, int B, int H, int gate, int nact,
                       void* stream) {
  GPG_DISPATCH(fwd_seq, static_cast<const bf16*>(xg),
               static_cast<const bf16*>(gpx), static_cast<const bf16*>(w5),
               static_cast<const float*>(bih),
               static_cast<const float*>(coef),
               static_cast<const uint8_t*>(mask),
               static_cast<const bf16*>(h0), static_cast<float*>(h),
               static_cast<float*>(c), static_cast<bf16*>(ys),
               static_cast<bf16*>(cs), T, B, H,
               static_cast<cudaStream_t>(stream))
}

// The persistent forward (csrc/lstm_persist.cuh): gpg_fwd's arguments
// plus bar, one zeroed unsigned int of device memory for the grid barrier.
// B must be at most 32 and H a multiple of 8; the grid is H / 8 CTAs of
// 512 threads, launched cooperatively, so a grid the card cannot hold at
// once is refused (cudaErrorCooperativeLaunchTooLarge). Returns the launch
// error, -1 for an unknown (gate, nact), or 0.
extern "C" int gpg_fwd_persist(const void* xg, const void* gpx,
                               const void* w5, const void* bih,
                               const void* coef, const void* mask,
                               const void* h0, void* h, void* c, void* ys,
                               void* cs, void* bar, int T, int B, int H,
                               int gate, int nact, void* stream) {
  FwdPersistParams prm = {};
  prm.x = xg;
  prm.gpx = static_cast<const bf16*>(gpx);
  prm.w = static_cast<const bf16*>(w5);
  prm.bias = static_cast<const float*>(bih);
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
  GPG_DISPATCH(fwd_persist, prm, static_cast<cudaStream_t>(stream))
}

// The two-launch backward over the whole sequence, t = T-1..0. The
// forward's inputs and outputs ys, cs, with c0 (B, H) and dy (T, B, H) bf16;
// dh, dc (B, H) fp32 hold dhT, dcT on entry and dh0, dc0 on return; du5
// (T, B, 5H) bf16
// output; acc ((B + 31) / 32, nact, H) fp32, zeroed by the caller; dcoef
// (nact, H) fp32 output. Returns the first launch error, -1 for an unknown
// (gate, nact), or 0.
extern "C" int gpg_bwd(const void* xg, const void* gpx, const void* w5,
                       const void* bih, const void* coef, const void* mask,
                       const void* h0, const void* c0, const void* ys,
                       const void* cs, const void* dy, void* dh, void* dc,
                       void* du5, void* acc, void* dcoef, int T, int B, int H,
                       int gate, int nact, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = [&]() -> int {
    GPG_DISPATCH(bwd_seq, static_cast<const bf16*>(xg),
                 static_cast<const bf16*>(gpx), static_cast<const bf16*>(w5),
                 static_cast<const float*>(bih),
                 static_cast<const float*>(coef),
                 static_cast<const uint8_t*>(mask),
                 static_cast<const bf16*>(h0), static_cast<const bf16*>(c0),
                 static_cast<const bf16*>(ys), static_cast<const bf16*>(cs),
                 static_cast<const bf16*>(dy), static_cast<float*>(dh),
                 static_cast<float*>(dc), static_cast<bf16*>(du5),
                 static_cast<float*>(acc), T, B, H, st)
  }();
  if (err != 0) return err;
  const int n = nact * H;
  gpg_dcoef_sum<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(acc), static_cast<float*>(dcoef),
      (B + BM - 1) / BM, n);
  return (int)cudaGetLastError();
}

// The persistent backward (csrc/gp_persist.cuh): gpg_bwd's arguments with
// hprev = [h0, ys[:-1]] (T B, H) bf16 in place of h0 and ys, without acc;
// P (T B, 5H) fp32 workspace and bar one zeroed unsigned int. B must be at
// most 32 and H a multiple of 8; a grid the card cannot hold at once is
// refused (cudaErrorCooperativeLaunchTooLarge). Returns the first launch
// error, -1 for an unknown (gate, nact) or where cuTensorMapEncodeTiled
// is not found, -1000 - r where it refuses a descriptor with r, or 0.
extern "C" int gpg_bwd_persist(const void* xg, const void* gpx,
                               const void* w5, const void* bih,
                               const void* coef, const void* mask,
                               const void* hprev, const void* c0,
                               const void* cs, const void* dy, void* dh,
                               void* dc, void* du5, void* dcoef, void* P,
                               void* bar, int T, int B, int H, int gate,
                               int nact, void* stream) {
  GpBwdParams prm = {};
  prm.w = static_cast<const bf16*>(w5);
  prm.xg = static_cast<const bf16*>(xg);
  prm.gpx = static_cast<const bf16*>(gpx);
  prm.bih = static_cast<const float*>(bih);
  prm.coef = static_cast<const float*>(coef);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.c0 = static_cast<const bf16*>(c0);
  prm.cs = static_cast<const bf16*>(cs);
  prm.dy = static_cast<const bf16*>(dy);
  prm.dh = static_cast<float*>(dh);
  prm.dc = static_cast<float*>(dc);
  prm.dop = static_cast<bf16*>(du5);
  prm.dcoef = static_cast<float*>(dcoef);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(P);
  GPG_DISPATCH(bwd_persist, hprev, p, prm, st)
}
