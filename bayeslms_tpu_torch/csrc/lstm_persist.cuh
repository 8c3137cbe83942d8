// The persistent forward recurrence of the port's single-layer steps, for
// sm_90a (bf16 operands, fp32 accumulation, fp32 carries): kernel row 5's
// design (csrc/lstm_train.cu), taken by row 4 (csrc/lstm_fwd.cu), by both
// layers of row 7 (csrc/lstm2_train.cu) and by the GP-LSTM's forwards,
// rows 20 (csrc/gp_lstm.cu, gates 1-4) and 18 (csrc/gp6_lstm.cu, gate 6),
// each through a `__global__` of its own name that calls `persist_fwd`
// with its row's cell, so that a profile tells the rows apart.
//
// One cooperative launch for the whole sequence, H / 8 CTAs of 512
// threads. CTA c owns the 8 hidden units [8c, 8c + 8) and keeps its NG x 8
// rows of the recurrent weight in shared memory, row q 8 + u the weight's
// row q H + 8c + u: W_hh's four gate groups (NG = 4: rows 4, 5, 7), W5 =
// [W_hh; w_h]'s five (NG = 5: row 20) or W''s four (row 18); 66 KB and
// 84 KB at H = 1,024. Step t: the CTA's 8 NG product columns from h_{t-1}
// = ys[t-1] (h0 at t = 0), read from L2 straight into the mma.sync
// m16n8k16 fragments by `warp_product`, the 16 warps' partial tiles summed
// in shared memory in warp order; the cell update of its 32 x 8 (column,
// unit) pairs, one a thread, the fp32 carries in that thread's registers,
// by the row's cell (`Cell::update`, from the NG sums s):
//   LSTM (rows 4, 5, 7): gates = (x[t] + s) + b_hh, gate order [i, f, g, o];
//     c = f c + i g; h = o tanh(c);
//   rows 20 and 18: the per-step kernels' own cell code (their headers);
// where mask[t, b] = 0 the column keeps its (h, c); ys[t] = bf16(h)
// stored, and where asked cs[t] = bf16(c) and hd[t] = bf16(h dm[t]) (row
// 7's layer-2 input, from the fp32 h after the mask); then a grid barrier,
// so that every CTA's ys[t] is stored before any CTA reads it: T - 1
// barriers a call. The LSTM's addend x is bf16 (xg = x W_ih^T + b_ih: rows
// 4, 5 and row 7's layer 1) or fp32 (row 7's layer 2: Q = h1d W_ih2^T for
// all steps, hoisted into one GEMM, never rounded).
//
// The grid barrier is csrc/grid_barrier.cuh's counter, zeroed by the
// wrapper; the cooperative launch refuses a grid the card cannot hold at
// once (cudaErrorCooperativeLaunchTooLarge), and the wrapper then raises:
// nothing falls back.
//
// Planted faults (the row's source defines these before it includes this
// header): LSTM_PERSIST_Q_STEP(t, T), the step of the fp32 addend that
// step t reads, and LSTM_PERSIST_DROP(h, d), the dropped h (row 7);
// LSTM_PERSIST_H0_ALWAYS = 1 has every step's product read h0 in place of
// ys[t-1] (rows 18 and 20).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"
#include "warp_mma.cuh"

#ifndef LSTM_PERSIST_Q_STEP
#define LSTM_PERSIST_Q_STEP(t, T) (t)
#endif
#ifndef LSTM_PERSIST_DROP
#define LSTM_PERSIST_DROP(h, d) ((h) * (d))
#endif
#ifndef LSTM_PERSIST_H0_ALWAYS
#define LSTM_PERSIST_H0_ALWAYS 0
#endif

namespace {

constexpr int P_UNITS = 8;        // hidden units a CTA owns
constexpr int P_ROWS = MMA_ROWS;  // batch columns at most: two m16 tiles
constexpr int P_WARPS = 16;
constexpr int P_THREADS = 32 * P_WARPS;
// bf16 padding of a shared weight row: 64 bytes, so that the 8 rows a
// quarter warp reads (16 bytes each, 4 a row) fall in distinct banks
constexpr int P_PAD = 32;

// The arguments of every row's recurrence; a row reads the fields its cell
// names.
struct FwdPersistParams {
  const void* x;        // (T, B, 4H): bf16, or fp32 where XF32
  const __nv_bfloat16* w;     // (NG H, H): W_hh, W5 (row 20) or W' (row 18)
  const float* bias;    // (4H) fp32: b_hh, or b_ih (row 20)
  const __nv_bfloat16* gpx;   // (T, B, H), row 20
  const __nv_bfloat16* bg;    // (4H) bf16 b', row 18
  const float* coef;    // (nact, H) row 20, (3, 4H) row 18
  const uint8_t* mask;  // (T, B) or null
  const __nv_bfloat16* h0;    // (B, H): h_{-1} in bf16
  float* h;             // (B, H) fp32 carries: the initial state in, the
  float* c;             // final state out
  __nv_bfloat16* ys;    // (T, B, H)
  __nv_bfloat16* cs;    // (T, B, H), or null: not stored
  const __nv_bfloat16* dm;  // (T, B, H) with hd
  __nv_bfloat16* hd;    // (T, B, H) bf16(h dm), or null: not stored
  unsigned int* bar;    // the barrier's counter, zero on entry
  int T, B, H;
};

// Shared memory: the weight's rows (8 NG x (H + P_PAD) bf16) and the
// warps' partial product tiles (P_WARPS x 32 x 8 NG fp32)
inline int fwd_persist_smem(int H, int NG = 4) {
  return 8 * NG * (H + P_PAD) * 2 + P_WARPS * P_ROWS * 8 * NG * 4;
}

__device__ __forceinline__ float persist_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The LSTM's cell (rows 4, 5, 7): the bias b_hh of the thread's unit; the
// step's addend x, bf16 or (XF32) fp32.
template <bool XF32>
struct LstmFwdCell {
  static constexpr int NG = 4;
  struct Const {
    float b[4];
  };
  struct In {
    float x[4];
  };
  __device__ static void load(const FwdPersistParams& p, int j, Const& k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) k.b[q] = p.bias[q * p.H + j];
  }
  __device__ static void fetch(const FwdPersistParams& p, int t, int b, int j,
                               In& in) {
    const int G = 4 * p.H;
    if (XF32) {
      const size_t tq = (size_t)LSTM_PERSIST_Q_STEP(t, p.T);
      const float* xr =
          static_cast<const float*>(p.x) + (tq * p.B + b) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.x[q] = xr[q * p.H];
    } else {
      const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(p.x) +
                                ((size_t)t * p.B + b) * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) in.x[q] = __bfloat162float(xr[q * p.H]);
    }
  }
  __device__ static void update(const Const& k, const In& in,
                                const float (&s)[NG], float c, float& cn,
                                float& hn) {
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = (in.x[q] + s[q]) + k.b[q];
    cn = persist_sigmoid(g[1]) * c + persist_sigmoid(g[0]) * tanhf(g[2]);
    hn = persist_sigmoid(g[3]) * tanhf(cn);
  }
};

// The whole recurrence, run by every thread of a `__global__` of
// P_THREADS threads with fwd_persist_smem(H, Cell::NG) bytes of dynamic
// shared memory at `smem`. Cell gives NG (the weight's row groups), Const
// and load (a thread's constants of unit j), In and fetch (a step's
// elementwise inputs of column b, unit j) and update (the new c and h from
// the NG product sums, the inputs and the old c).
template <class Cell>
__device__ __forceinline__ void persist_fwd_cell(const FwdPersistParams& p,
                                                 unsigned char* smem) {
  typedef __nv_bfloat16 bf16;
  constexpr int NG = Cell::NG;
  constexpr int NR = 8 * NG;  // the CTA's weight rows and product columns
  const int H = p.H, B = p.B;
  const int ldg = H + P_PAD;
  bf16* wg = reinterpret_cast<bf16*>(smem);  // row q 8 + u: W[q H + j0 + u]
  float* red = reinterpret_cast<float*>(wg + NR * ldg);
  const int j0 = blockIdx.x * P_UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < NR * (H / 8); i += P_THREADS) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int row = (r >> 3) * H + j0 + (r & 7);
    *reinterpret_cast<uint4*>(wg + r * ldg + c) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)row * H + c);
  }

  // thread tid < 256 owns batch column b and unit j; its carries
  const int b = tid >> 3, j = j0 + (tid & 7);
  const int col = tid & 7;
  const bool own = tid < P_ROWS * P_UNITS && b < B;
  float h = 0.f, c = 0.f;
  typename Cell::Const kc;
  if (own) {
    h = p.h[(size_t)b * H + j];
    c = p.c[(size_t)b * H + j];
    Cell::load(p, j, kc);
  }
  __syncthreads();

  const size_t BH = (size_t)B * H;
  unsigned int target = 0;
  for (int t = 0; t < p.T; ++t) {
    // this step's elementwise inputs first, in flight during the product
    typename Cell::In in;
    float d = 0.f;
    bool keep = true;
    if (own) {
      Cell::fetch(p, t, b, j, in);
      keep = p.mask == nullptr || p.mask[(size_t)t * B + b];
      if (p.hd != nullptr)
        d = __bfloat162float(p.dm[t * BH + (size_t)b * H + j]);
    }
    {
      float acc[2][NG][4] = {};
      warp_product<NG, 2, P_WARPS>(
          (t == 0 || LSTM_PERSIST_H0_ALWAYS) ? p.h0 : p.ys + (t - 1) * BH, B,
          H, wg, ldg, warp, lane, acc);
      store_partial<NG>(red, acc, warp, lane);
    }
    __syncthreads();
    if (own) {
      float s[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        s[q] = 0.f;
        for (int w = 0; w < P_WARPS; ++w)
          s[q] += red[(w * P_ROWS + b) * NR + q * 8 + col];
      }
      float cn, hn;
      Cell::update(kc, in, s, c, cn, hn);
      if (keep) {
        h = hn;
        c = cn;
      }
      const size_t e = t * BH + (size_t)b * H + j;
      p.ys[e] = __float2bfloat16(h);
      if (p.cs != nullptr) p.cs[e] = __float2bfloat16(c);
      if (p.hd != nullptr)
        p.hd[e] = __float2bfloat16(LSTM_PERSIST_DROP(h, d));
    }
    if (t + 1 < p.T) {
      target += gridDim.x;
      grid_barrier(p.bar, target);
    }
  }
  if (own) {
    p.h[(size_t)b * H + j] = h;
    p.c[(size_t)b * H + j] = c;
  }
}

// The LSTM's recurrence (rows 4, 5, 7)
template <bool XF32>
__device__ __forceinline__ void persist_fwd(const FwdPersistParams& p,
                                            unsigned char* smem) {
  persist_fwd_cell<LstmFwdCell<XF32>>(p, smem);
}

// Launches `kernel` (a `__global__` that runs persist_fwd_cell with a cell
// of NG row groups) cooperatively on H / 8 CTAs of P_THREADS threads. B
// must be at most 32 and H a positive multiple of 8 (the wrappers take
// multiples of 32: `warp_product`'s 32-deep k ranges). Returns the launch
// error, or 0.
template <typename Kernel>
cudaError_t launch_persist_fwd(Kernel kernel, const FwdPersistParams& prm,
                               cudaStream_t stream, int NG = 4) {
  if (prm.B > P_ROWS || prm.H % P_UNITS != 0 || prm.H <= 0)
    return cudaErrorInvalidValue;
  if (prm.T == 0) return cudaSuccess;
  const int smem = fwd_persist_smem(prm.H, NG);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  FwdPersistParams arg = prm;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(prm.H / P_UNITS), dim3(P_THREADS),
                                    args, (size_t)smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
