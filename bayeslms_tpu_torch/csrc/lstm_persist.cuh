// The persistent forward recurrence of the port's single-layer steps, for
// sm_90a (bf16 operands, fp32 accumulation, fp32 carries): kernel row 5's
// design (csrc/lstm_train.cu), taken by row 4 (csrc/lstm_fwd.cu) and by
// both layers of row 7 (csrc/lstm2_train.cu), each through a `__global__`
// of its own name that calls `persist_fwd`, so that a profile tells the
// rows apart.
//
// One cooperative launch for the whole sequence, H / 8 CTAs of 512
// threads. CTA c owns the 8 hidden units [8c, 8c + 8) and keeps its 4 x 8
// gate rows of W_hh in shared memory (66 KB at H = 1,024). Step t: the
// CTA's 32 gate columns from h_{t-1} = ys[t-1] (h0 at t = 0), read from L2
// straight into the mma.sync m16n8k16 fragments by `warp_product`, the 16
// warps' partial tiles summed in shared memory in warp order; the cell
// update of its 32 x 8 (column, unit) pairs, one a thread, the fp32
// carries in that thread's registers:
//   gates = (x[t] + h_{t-1} W_hh^T) + b_hh, gate order [i, f, g, o];
//   c = f c + i g; h = o tanh(c); where mask[t, b] = 0 the column keeps
//   its (h, c);
// ys[t] = bf16(h) stored, and where asked cs[t] = bf16(c) and
// hd[t] = bf16(h dm[t]) (row 7's layer-2 input, from the fp32 h after the
// mask); then a grid barrier, so that every CTA's ys[t] is stored before
// any CTA reads it: T - 1 barriers a call. The addend x is bf16 (xg = x
// W_ih^T + b_ih: rows 4, 5 and row 7's layer 1) or fp32 (row 7's layer 2:
// Q = h1d W_ih2^T for all steps, hoisted into one GEMM, never rounded).
//
// The grid barrier is csrc/grid_barrier.cuh's counter, zeroed by the
// wrapper; the cooperative launch refuses a grid the card cannot hold at
// once (cudaErrorCooperativeLaunchTooLarge), and the wrapper then raises:
// nothing falls back.
//
// Planted faults of row 7 (csrc/lstm2_train.cu defines these before it
// includes this header): LSTM_PERSIST_Q_STEP(t, T), the step of the fp32
// addend that step t reads; LSTM_PERSIST_DROP(h, d), the dropped h.

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

namespace {

constexpr int P_UNITS = 8;        // hidden units a CTA owns
constexpr int P_ROWS = MMA_ROWS;  // batch columns at most: two m16 tiles
constexpr int P_WARPS = 16;
constexpr int P_THREADS = 32 * P_WARPS;
// bf16 padding of a shared weight row: 64 bytes, so that the 8 rows a
// quarter warp reads (16 bytes each, 4 a row) fall in distinct banks
constexpr int P_PAD = 32;

struct FwdPersistParams {
  const void* x;        // (T, B, 4H): bf16, or fp32 where XF32
  const __nv_bfloat16* w;     // W_hh (4H, H)
  const float* bias;    // b_hh (4H)
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

// Shared memory: the gate rows (32 x (H + P_PAD)) and the warps' partial
// gate tiles (P_WARPS x 32 x 32 fp32).
inline int fwd_persist_smem(int H) {
  return 32 * (H + P_PAD) * 2 + P_WARPS * P_ROWS * 32 * 4;
}

__device__ __forceinline__ float persist_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The whole recurrence, run by every thread of a `__global__` of
// P_THREADS threads with fwd_persist_smem(H) bytes of dynamic shared
// memory at `smem`.
template <bool XF32>
__device__ __forceinline__ void persist_fwd(const FwdPersistParams& p,
                                            unsigned char* smem) {
  typedef __nv_bfloat16 bf16;
  const int H = p.H, G = 4 * H, B = p.B;
  const int ldg = H + P_PAD;
  bf16* wg = reinterpret_cast<bf16*>(smem);  // row q 8 + u: W[q H + j0 + u]
  float* red = reinterpret_cast<float*>(wg + 32 * ldg);
  const int j0 = blockIdx.x * P_UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < 32 * (H / 8); i += P_THREADS) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int row = (r >> 3) * H + j0 + (r & 7);
    *reinterpret_cast<uint4*>(wg + r * ldg + c) =
        *reinterpret_cast<const uint4*>(p.w + (size_t)row * H + c);
  }

  // thread tid < 256 owns batch column b and unit j; its carries
  const int b = tid >> 3, j = j0 + (tid & 7);
  const int col = tid & 7;
  const bool own = tid < P_ROWS * P_UNITS && b < B;
  float h = 0.f, c = 0.f, bq[4];
  if (own) {
    h = p.h[(size_t)b * H + j];
    c = p.c[(size_t)b * H + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = p.bias[q * H + j];
  }
  __syncthreads();

  const size_t BH = (size_t)B * H;
  unsigned int target = 0;
  for (int t = 0; t < p.T; ++t) {
    // this step's elementwise inputs first, in flight during the product
    float x[4] = {0.f, 0.f, 0.f, 0.f}, d = 0.f;
    bool keep = true;
    if (own) {
      if (XF32) {
        const size_t tq = (size_t)LSTM_PERSIST_Q_STEP(t, p.T);
        const float* xr =
            static_cast<const float*>(p.x) + (tq * B + b) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = xr[q * H];
      } else {
        const bf16* xr =
            static_cast<const bf16*>(p.x) + ((size_t)t * B + b) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = __bfloat162float(xr[q * H]);
      }
      keep = p.mask == nullptr || p.mask[(size_t)t * B + b];
      if (p.hd != nullptr)
        d = __bfloat162float(p.dm[t * BH + (size_t)b * H + j]);
    }
    {
      float acc[2][4][4] = {};
      warp_product<4, 2, P_WARPS>(t == 0 ? p.h0 : p.ys + (t - 1) * BH, B,
                                  H, wg, ldg, warp, lane, acc);
      store_partial<4>(red, acc, warp, lane);
    }
    __syncthreads();
    if (own) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
        for (int w = 0; w < P_WARPS; ++w)
          s += red[(w * P_ROWS + b) * 32 + q * 8 + col];
        g[q] = (x[q] + s) + bq[q];
      }
      const float cn =
          persist_sigmoid(g[1]) * c + persist_sigmoid(g[0]) * tanhf(g[2]);
      const float hn = persist_sigmoid(g[3]) * tanhf(cn);
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

// Launches `kernel` (a `__global__` that runs persist_fwd) cooperatively on
// H / 8 CTAs of P_THREADS threads. B must be at most 32 and H a positive
// multiple of 8. Returns the launch error, or 0.
template <typename Kernel>
cudaError_t launch_persist_fwd(Kernel kernel, const FwdPersistParams& prm,
                               cudaStream_t stream) {
  if (prm.B > P_ROWS || prm.H % P_UNITS != 0 || prm.H <= 0)
    return cudaErrorInvalidValue;
  if (prm.T == 0) return cudaSuccess;
  const int smem = fwd_persist_smem(prm.H);
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
