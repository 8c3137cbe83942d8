// Single-layer LSTM forward with a step mask and, optionally, packed
// carry-over resets, for sm_90a (bf16 operands, fp32 accumulation and fp32
// h/c carries).
//
// Replaces bayeslms_tpu/ops/lstm_pallas.py `lstm_layer_pallas`: the
// `_kernel_reset` body that `_run_reset` hands to pallas_call (resets) and
// the `_kernel` body of `_run` (no resets). What it computes, for
// t = 0..T-1:
//   1. (resets only) columns b with reset[t, b] = 1 take the state (h and c)
//      of column reset_src[b]; reset_src[b] = -1 gives a zero state;
//   2. gates = xg[t] + h W_hh^T + b_hh, gate order [i, f, g, o], with h
//      rounded to bf16 for the product; c = f c + i g; h = o tanh(c);
//   3. where mask[t, b] = 0 the column keeps the state it started the step
//      with (after step 1);
//   4. ys[t] = h in bf16.
// xg = x W_ih^T + b_ih for the whole sequence is one GEMM outside.
//
// Differences from the TPU kernel, on purpose:
//   - The TPU kernel keeps W_hh (8 MB in bf16 at H = 1,024) resident in
//     VMEM; the persistent design below splits it across the CTAs' shared
//     memory, the per-step design re-reads it from L2 every step.
//   - The reset is a gather by reset_src on the fp32 state, not the (B, B)
//     selection product `pmat @ s.astype(bf16)`: the TPU kernel rounds h and
//     c to bf16 at every reset, this kernel does not (as the JAX scan path
//     and this port's 2-layer kernel, csrc/lstm2_fwd.cu).
//   - Mask and reset are (T, B) bytes, not the TPU's (T, B, 8) broadcast.
//
// Two designs, picked by ops/lstm_cuda.py `_design_fwd(T, B, H, n_sm,
// resets)` (an explicit rule: the chosen design runs or raises).
//
// "persistent" (no resets, B <= 32, H a multiple of 8, H / 8 CTAs no more
// than the card's SMs, the shared memory within 227 KB: `evaluate`'s calls,
// B = 20 and H = 1,024), kernel `lstm_layer_persistent`: row 5's persistent
// forward (csrc/lstm_persist.cuh) without the cs store, on the fp32 state
// in and out. One cooperative launch of H / 8 CTAs of 512 threads; CTA c
// owns units [8c, 8c + 8) and keeps its 4 x 8 gate rows of W_hh resident
// in shared memory (66 KB at H = 1,024; 130 KB with the 16 warps' partial
// tiles); each step's A operand is ys[t-1] (bf16(h0) at t = 0), read from
// L2 straight into the m16n8k16 fragments; the fp32 carries live in the
// owning thread's registers; one grid barrier a step. Its sum is the
// twin's, (xg + h W_hh^T) + b_hh.
//
// "per_step" (the rest: resets, as row 3's packed-carry scoring pass at
// B = 600, or B > 32): the host function loops over t and launches one
// kernel a step on the caller's stream: `lstm_step_kernel` of
// csrc/lstm_step.cuh, the step of the 2-layer forward (csrc/lstm2_fwd.cu)
// with no second product, the layer's own previous h gathered as its A
// operand. Its header says how a block tiles the step; h and c live in fp32
// ping-pong buffers, so the reset gather is free of races. It adds the
// bias to the product before xg.
//
// Bound on the H100 (989 TFLOP/s bf16): 2 B H 4H flops a step. At the
// packed-carry scoring shape (B = 600, H = 1,024) 5.0 GFLOP a step, 5 us,
// against 8 MB of W_hh a step (2.5 us from device memory): operations
// bound. At `evaluate`'s (B = 20) the step is 0.17 GFLOP, 16.8 GFLOP a
// call: 0.017 ms, operations bound (the call's bytes, xg 16 MB and W_hh
// 8 MB once, take 0.0075 ms). The per-step design loads its tiles
// synchronously, one launch a step, re-reading W_hh from L2 every step:
// 4.70-5.25 ms a call at `evaluate`'s shape on an NVIDIA H100 80GB HBM3 at
// 700.00 W. The persistent design reads W_hh once and is bound by its T
// dependent steps, a barrier and each CTA's L2 read of h_{t-1} (40 KB at
// B = 20): 0.70-0.78 ms a call, 7-8 us a step (chip_smoke.py,
// tools/lstm_fwd_designs.py; cuDNN's forward 2.07-2.98; PERF.md).

#include "lstm_step.cuh"
#include "lstm_persist.cuh"

namespace {

// csrc/lstm_persist.cuh's recurrence without cs (row 4)
__global__ void __launch_bounds__(P_THREADS, 1)
lstm_layer_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd<false>(p, smem);
}

}  // namespace

// Runs the whole sequence. xg (T, B, 4H) bf16; whh (4H, H) bf16; bhh (4H)
// fp32; mask and reset (T, B) bytes or null (reset and rsrc go together;
// rsrc (B) int32, -1 = zero state); h, c (2, B, H) fp32 ping-pong buffers
// whose slot 0 holds the initial state (the final state is in slot T % 2);
// ys (T, B, H) bf16 output. Returns the first launch error, or 0.
extern "C" int lstm_fwd(const void* xg, const void* whh, const void* bhh,
                        const void* mask, const void* reset, const void* rsrc,
                        void* h, void* c, void* ys, int T, int B, int H,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  const bf16* x = static_cast<const bf16*>(xg);
  const bf16* w = static_cast<const bf16*>(whh);
  const float* bias = static_cast<const float*>(bhh);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* r = static_cast<const uint8_t*>(reset);
  const int* rs = static_cast<const int*>(rsrc);
  float* hf = static_cast<float*>(h);
  float* cf = static_cast<float*>(c);
  bf16* y = static_cast<bf16*>(ys);
  for (int t = 0; t < T; ++t) {
    const size_t p = (size_t)(t & 1) * BH;
    const size_t n = (size_t)((t & 1) ^ 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    const bf16* xg_t = x + (size_t)t * B * 4 * H;
    lstm_step_kernel<<<grid, THREADS, 0, st>>>(
        hf + p, 1, w, nullptr, nullptr, xg_t, bias, hf + p, cf + p, hf + n,
        cf + n, y + t * BH, m_t, r != nullptr ? r + (size_t)t * B : nullptr,
        rs, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The persistent design (see the header), no resets: xg (T, B, 4H) bf16;
// whh (4H, H) bf16; bhh (4H) fp32; mask (T, B) bytes or null; h0 (B, H) the
// initial h in bf16 (the first step's product operand); h, c (B, H) fp32
// carries holding the initial state (the final state on return); ys
// (T, B, H) bf16 output; bar one zeroed unsigned int of device memory for
// the grid barrier. B must be at most 32 and H a multiple of 8; the grid
// is H / 8 CTAs of 512 threads, launched cooperatively, so a grid the card
// cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge).
// Returns the launch error, or 0.
extern "C" int lstm_fwd_persistent(const void* xg, const void* whh,
                                   const void* bhh, const void* mask,
                                   const void* h0, void* h, void* c, void* ys,
                                   void* bar, int T, int B, int H,
                                   void* stream) {
  FwdPersistParams prm = {};
  prm.x = xg;
  prm.w = static_cast<const bf16*>(whh);
  prm.bias = static_cast<const float*>(bhh);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.h0 = static_cast<const bf16*>(h0);
  prm.h = static_cast<float*>(h);
  prm.c = static_cast<float*>(c);
  prm.ys = static_cast<bf16*>(ys);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  return (int)launch_persist_fwd(lstm_layer_persistent, prm,
                                 static_cast<cudaStream_t>(stream));
}
