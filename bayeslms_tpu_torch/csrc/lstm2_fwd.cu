// Fused 2-layer LSTM forward with step masks and packed carry-over resets,
// for sm_90a (bf16 operands, fp32 accumulation and fp32 h/c carries).
//
// Replaces bayeslms_tpu/ops/lstm_pallas.py `lstm2_layer_pallas` (the
// `_kernel2` / `_kernel2_reset` bodies that `_run2` hands to pallas_call).
// What it computes, for t = 0..T-1:
//   1. columns b with reset[t, b] = 1 take the state of column reset_src[b]
//      (both layers, h and c); reset_src[b] = -1 gives a zero state;
//   2. layer 1: gates = xg1[t] + h1 W_hh1^T + b_hh1, gate order [i, f, g, o];
//   3. layer 2: gates = h1_t W_ih2^T + h2 W_hh2^T + (b_ih2 + b_hh2);
//   4. where step_mask[t, b] = 0 both layers keep their previous (h, c);
//   5. ys2[t] = h2 in bf16.
// xg1 = x W_ih1^T + b_ih1 for the whole sequence is one GEMM outside.
//
// Differences from the TPU kernel, on purpose:
//   - The TPU kernel keeps W_hh1, W_ih2 and W_hh2 (24 MB in bf16 at H=1024)
//     resident in VMEM. No SM holds that, so here every step re-reads the
//     weights from L2 (50 MB on the H100, so the 24 MB stay resident there).
//   - The reset is a gather by reset_src on fp32 state, not the (B, B)
//     selection product `pmat @ s.astype(bf16)`: the TPU kernel rounds h and
//     c to bf16 at every reset, this kernel does not (as the JAX scan path).
//   - Mask and reset are (T, B) bytes, not the TPU's (T, B, 8) broadcast.
//
// Design: the host function loops over t and launches one kernel per layer per
// step on the caller's stream; the kernel, `lstm_step_kernel`, is in
// csrc/lstm_step.cuh, shared with the one-layer forward (csrc/lstm_fwd.cu). A
// block owns BM batch columns and BJ hidden units and computes all four gate
// rows (q*H + j) of those units, so the cell update needs nothing from other
// blocks. h and c live in fp32 ping-pong buffers (read step t-1, write step
// t), so the reset gather (a read of another column's previous state) is free
// of races. The products run on the tensor cores through wmma (16x16x16 bf16,
// fp32 accumulators); the A operand (the fp32 state, gathered) is rounded to
// bf16 on its way into shared memory, as the TPU kernel rounds h before its
// dot.
//
// Bound on the H100 at the scoring shapes (T=256, B=600, H=1024): 3 products
// of (B x H)(H x 4H) per step, 15.1 GFLOP per step, about 15 us at the
// 989 TFLOP/s bf16 peak, against 24 MB of weights per step (7 us from device
// memory, less from L2): operations bound. This first version loads its tiles
// synchronously and is far from that bound; a persistent kernel with the
// weights split across the SMs' shared memory is the later redesign.

#include "lstm_step.cuh"

// Runs the whole sequence. h1, c1, h2, c2 are (2, B, H) fp32 ping-pong
// buffers whose slot 0 holds the initial state; the final state is in slot
// T % 2. mask and reset are (T, B) bytes or null (reset and rsrc go
// together). Returns the first launch error, or 0.
extern "C" int lstm2_fwd(const void* xg1, const void* whh1, const void* bhh1,
                         const void* wih2, const void* whh2, const void* b2,
                         const void* mask, const void* reset,
                         const void* rsrc, void* h1, void* c1, void* h2,
                         void* c2, void* ys, int T, int B, int H,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, H / BJ);
  const size_t BH = (size_t)B * H;
  const bf16* xg = static_cast<const bf16*>(xg1);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* r = static_cast<const uint8_t*>(reset);
  const int* rs = static_cast<const int*>(rsrc);
  float* h1f = static_cast<float*>(h1);
  float* c1f = static_cast<float*>(c1);
  float* h2f = static_cast<float*>(h2);
  float* c2f = static_cast<float*>(c2);
  bf16* y = static_cast<bf16*>(ys);
  for (int t = 0; t < T; ++t) {
    const size_t p = (size_t)(t & 1) * BH;
    const size_t n = (size_t)((t & 1) ^ 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    const uint8_t* r_t = r != nullptr ? r + (size_t)t * B : nullptr;
    lstm_step_kernel<<<grid, THREADS, 0, st>>>(
        h1f + p, 1, static_cast<const bf16*>(whh1), nullptr, nullptr,
        xg + (size_t)t * B * 4 * H, static_cast<const float*>(bhh1), h1f + p,
        c1f + p, h1f + n, c1f + n, nullptr, m_t, r_t, rs, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm_step_kernel<<<grid, THREADS, 0, st>>>(
        h1f + n, 0, static_cast<const bf16*>(wih2), h2f + p,
        static_cast<const bf16*>(whh2), nullptr,
        static_cast<const float*>(b2), h2f + p, c2f + p, h2f + n, c2f + n,
        y + (size_t)t * BH, m_t, r_t, rs, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
