// The persistent backward of the GP-LSTM's training recurrences, for sm_90a
// (bf16 operands, fp32 accumulation, fp32 carries): kernel row 19
// (csrc/gp6_lstm.cu, the gate-6 unit) and row 21 (csrc/gp_lstm.cu, gates
// 1-4), each through `__global__`s of its own names (`gp6_bwd_gemm` and
// `gp6_bwd_persistent`, `gpg_bwd_gemm` and `gpg_bwd_persistent`) that
// call `gates_gemm` and `gp_bwd_persist` with the row's cell, a struct of
// its step's arithmetic, so that a profile tells the rows apart.
//
// Two launches a call.
//   (1) The product on h_{t-1} depends only on the forward's stored ys,
//       never on a backward carry, so it leaves the recurrence: one GEMM
//       for all T B rows, P = hprev W^T, fp32 (T B, NG H), never rounded,
//       with hprev = [h0, ys[:-1]] (T B, H) bf16 and W the row's recurrent
//       weight (W' (4H, H), NG = 4; W5 = [W_hh; w_h] (5H, H), NG = 5): the
//       q_only walk of csrc/gates_gemm.cuh (wgmma fed by TMA, 64-deep chunks
//       added to nearest in fp32 registers), 52 MB (row 19) and 65 MB (row
//       21) at T 100, B 32, H 1,024.
//   (2) One cooperative launch of H / 8 CTAs of 512 threads for the
//       recurrence. CTA c owns the hidden units [8c, 8c + 8) and keeps W's
//       column slice (NG H x 8, transposed: dh's B operand) in shared memory
//       for the whole call, loaded once. Step t = T-1..0:
//       (a) thread b 8 + u (b < B) takes element (b, 8c + u): the row's
//           cell (its header gives the terms) from P[t]'s columns of the
//           unit, the bf16 xg[t] (and row 21's gpx[t]), c_{t-1} = cs[t-1]
//           (c0 at t = 0), dy[t] and the mask; stores the row's outputs in
//           bf16 and keeps the dc carry in a register. Its dcoef terms go to
//           shared memory, and the thread that owns a dcoef entry of the
//           CTA's units sums them over the batch (b = 0, 1, ..) and adds
//           that to its fp32 total: the sum over the batch, then over the
//           steps, as the twin sums. The CTA owns its units' dcoef columns,
//           so no other CTA adds to them and repeat calls give the same bits.
//       a grid barrier (csrc/grid_barrier.cuh): every CTA's outputs of step
//           t are stored before any CTA reads them;
//       (b) the CTA's 8 dh columns from all of the step's dh operand (row
//           19: dupre[t], B x 4H; row 21: du5[t], B x 5H; bf16, from L2
//           straight into the mma.sync m16n8k16 fragments, csrc/warp_mma.cuh)
//           against the slice, the 16 warps' partial tiles summed in warp
//           order by the owning thread, which adds (1 - keep) dh_tot; the
//           next step's inputs are read meanwhile.
//       Step t - 1's (a) needs dh only for the CTA's own units, so one
//       barrier a step suffices. Row 21's replaced gate has its group of
//       du5 exactly zero; (b) contracts it all the same (adding exact zeros
//       changes no fp32 sum), so both designs take the same product.
// Shared memory: the slice, 8 x (NG H + P_PAD) bf16, and the warps' partial
// dh tiles, 16 x 32 x 8 fp32, which (a)'s dcoef terms reuse: 82,432 bytes
// (row 19) and 98,816 (row 21) at H = 1,024.
//
// The grid barrier's counter is zeroed by the wrapper; the cooperative
// launch refuses a grid the card cannot hold at once, and the wrapper then
// raises: nothing falls back.
//
// Planted fault (each row's source defines it before it includes this
// header): GP_PERSIST_P_STEP(t, T), the step of P that step t reads.

#pragma once

#include "gate_tile.cuh"
#include "gates_gemm.cuh"
#include "grid_barrier.cuh"
#include "lstm_persist.cuh"
#include "warp_mma.cuh"

#ifndef GP_PERSIST_P_STEP
#define GP_PERSIST_P_STEP(t, T) (t)
#endif

namespace {

// The arguments of both rows' recurrences; a row reads the fields its cell
// names.
struct GpBwdParams {
  const float* P;       // (T B, NG H) fp32: hprev W^T for every step
  const bf16* w;        // (NG H, H): W' (row 19) or W5 (row 21)
  const bf16* xg;       // (T, B, 4H)
  const bf16* gpx;      // (T, B, H), row 21; null for row 19
  const float* bih;     // (4H) fp32, row 21
  const bf16* bg;       // (4H) bf16, row 19
  const float* coef;    // (nact, H) row 21, (3, 4H) row 19
  const uint8_t* mask;  // (T, B) or null
  const bf16* c0;       // (B, H)
  const bf16* cs;       // (T, B, H)
  const bf16* dy;       // (T, B, H)
  float* dh;            // (B, H): dhT in, dh0 out
  float* dc;            // (B, H): dcT in, dc0 out
  bf16* dop;            // the dh product's operand (T, B, NG H): du5
                        // (row 21) or dupre (row 19)
  bf16* dux;            // (T, B, 4H), row 19
  float* dcoef;         // the dcoef output, written whole
  unsigned int* bar;    // the barrier's counter, zero on entry
  int T, B, H;
};

// One element's inputs of a step
template <int NG>
struct GpIn {
  float p[NG];  // P's columns q H + j, q < NG
  float x[4];   // xg's columns q H + j
  float gx;     // gpx (row 21)
  float cp, dy, keep;
};

// The cell's backward shared by both rows, term for term as the rows'
// headers give it, from the gate values [i, f, g, o] and c_{t-1}:
// dh' = keep dh_tot, dc' = keep dc, do = dh' tanh(c),
// dc_c = dc' + dh' o (1 - tanh(c)^2), di = dc_c g, df = dc_c c_{t-1},
// dg = dc_c i and the new dc = dc_c f + (1 - keep) dc.
struct GpCellGrad {
  float d_i, d_f, d_g, d_o, dc;
};

__device__ __forceinline__ GpCellGrad gp_cell_grad(float ig, float fg,
                                                   float gg, float og,
                                                   float cp, float keep,
                                                   float dh_tot, float dc) {
  const float tc = tanhf(fg * cp + ig * gg);
  const float dhn = keep * dh_tot;
  const float dcn = keep * dc;
  const float d_o = dhn * tc;
  const float dcc = dcn + dhn * og * (1.0f - tc * tc);
  return {dcc * gg, dcc * cp, dcc * ig, d_o, dcc * fg + (1.0f - keep) * dc};
}

// Shared memory of a CTA, bytes: the column slice and the partial tiles
inline int gp_persist_smem(int NG, int H) {
  return P_UNITS * (NG * H + P_PAD) * 2 + P_WARPS * P_ROWS * P_UNITS * 4;
}

// The whole recurrence (2), run by every thread of a `__global__` of
// P_THREADS threads with gp_persist_smem(Cell::NG, H) bytes of dynamic
// shared memory at `smem`. Cell gives NG, NPART (the dcoef terms of an
// element; term c goes to dcoef[c H + j]), DCOEF (false in the planted
// fault "dcoef dropped"), Const and load (a thread's constants of unit j)
// and step (the cell at one element: stores its outputs, returns the new
// dc).
template <class Cell>
__device__ __forceinline__ void gp_bwd_persist(const GpBwdParams& p,
                                               unsigned char* smem) {
  constexpr int NG = Cell::NG;
  constexpr int NPART = Cell::NPART;
  const int H = p.H, K = NG * H, B = p.B, T = p.T;
  const int ldc = K + P_PAD;
  bf16* wc = reinterpret_cast<bf16*>(smem);  // row n: W[:, j0 + n]
  float* red = reinterpret_cast<float*>(wc + P_UNITS * ldc);
  const int j0 = blockIdx.x * P_UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int k = tid; k < K; k += P_THREADS) {
    const uint4 v = *reinterpret_cast<const uint4*>(p.w + (size_t)k * H + j0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int n = 0; n < P_UNITS; ++n) wc[n * ldc + k] = e[n];
  }

  // thread tid < 256 owns batch column b and unit j, and its carries;
  // thread tid < NPART x 8 the dcoef term tid / 8 of unit j0 + tid % 8
  const int b = tid >> 3, j = j0 + (tid & 7);
  const bool own = tid < P_ROWS * P_UNITS && b < B;
  const size_t BH = (size_t)B * H;
  const size_t e = (size_t)b * H + j;
  typename Cell::Const kc;
  float dh = 0.f, dc = 0.f, carry = 0.f, total = 0.f;
  if (own) {
    dh = p.dh[e];
    dc = p.dc[e];
    Cell::load(p, j, kc);
  }
  GpIn<NG> in;
  auto fetch = [&](int s) {
    if (!own || s < 0) return;
    const size_t r = (size_t)s * B + b;
    const float* pr =
        p.P + ((size_t)GP_PERSIST_P_STEP(s, T) * B + b) * K + j;
#pragma unroll
    for (int q = 0; q < NG; ++q) in.p[q] = pr[q * H];
    const bf16* xr = p.xg + r * 4 * H + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.x[q] = __bfloat162float(xr[q * H]);
    in.gx = p.gpx != nullptr ? __bfloat162float(p.gpx[r * H + j]) : 0.f;
    in.cp = __bfloat162float(s == 0 ? p.c0[e] : p.cs[(s - 1) * BH + e]);
    in.dy = __bfloat162float(p.dy[s * BH + e]);
    in.keep = (p.mask == nullptr || p.mask[r]) ? 1.f : 0.f;
  };
  fetch(T - 1);
  __syncthreads();

  unsigned int target = 0;
  for (int t = T - 1; t >= 0; --t) {
    // (a) the cell's backward of the CTA's elements; their dcoef terms
    if (own) {
      float part[NPART];
      const float dh_tot = dh + in.dy;
      dc = Cell::step(p, kc, in, dh_tot, dc, (size_t)t * B + b, j, part);
      carry = (1.0f - in.keep) * dh_tot;
#pragma unroll
      for (int c = 0; c < NPART; ++c) red[c * P_ROWS * P_UNITS + tid] = part[c];
    }
    __syncthreads();
    if (tid < NPART * P_UNITS) {
      const int c = tid >> 3, u = tid & 7;
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb) s += red[(c * P_ROWS + bb) * P_UNITS + u];
      if (Cell::DCOEF) total += s;
    }
    target += gridDim.x;
    grid_barrier(p.bar, target);

    // (b) dh = (dh operand)_t W + (1 - keep) dh_tot for the CTA's units
    fetch(t - 1);
    {
      float acc[2][1][4] = {};
      warp_product<1, 4, P_WARPS>(p.dop + (size_t)t * B * K, B, K, wc, ldc,
                                  warp, lane, acc);
      store_partial<1>(red, acc, warp, lane);
    }
    __syncthreads();
    if (own) {
      float s = 0.f;
      for (int w = 0; w < P_WARPS; ++w)
        s += red[(w * P_ROWS + b) * P_UNITS + (tid & 7)];
      dh = s + carry;
    }
    __syncthreads();  // the partial tiles are read: (a) may reuse them
  }
  if (own) {
    p.dh[e] = dh;
    p.dc[e] = dc;
  }
  if (tid < NPART * P_UNITS)
    p.dcoef[(size_t)(tid >> 3) * H + j0 + (tid & 7)] = total;
}

// Launches stage (1), `gemm` (a `__global__` running gates_gemm's q_only
// walk) into P, and stage (2), `kernel` (a `__global__` running
// gp_bwd_persist), cooperatively on H / 8 CTAs of P_THREADS threads. hprev
// (T B, H) bf16; prm's other fields as GpBwdParams says. B must be at most
// 32 and H a positive multiple of 8. Returns the first launch error, or 0;
// -1 where cuTensorMapEncodeTiled is not found, -1000 - r where it
// refuses a descriptor with r.
template <typename Gemm, typename Kernel>
int launch_gp_bwd(Gemm gemm, Kernel kernel, int NG, const void* hprev,
                  float* P, GpBwdParams prm, cudaStream_t stream) {
  const int T = prm.T, B = prm.B, H = prm.H;
  if (B > P_ROWS || H % P_UNITS != 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = gp_persist_smem(NG, H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int M = T * B, N = NG * H;
  if (M > 0) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return -1;
    GateParams gp = {};
    int r = encode_map(enc, &gp.a[1], hprev, M, H, GM);
    if (r == 0) r = encode_map(enc, &gp.w[1], prm.w, N, H, GN);
    if (r != 0) return -1000 - r;
    gp.g2 = P;
    gp.M = M;
    gp.H = H;
    gp.N = N;
    void* gargs[] = {&gp};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(gemm),
                           dim3((N + GN - 1) / GN, (M + GM - 1) / GM, 1),
                           dim3(G_THREADS), gargs, (size_t)G_SMEM, stream);
    if (err != cudaSuccess) return (int)err;
  }
  prm.P = P;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(H / P_UNITS), dim3(P_THREADS), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
