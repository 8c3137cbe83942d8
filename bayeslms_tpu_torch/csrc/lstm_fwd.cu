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
//     VMEM; here every step re-reads it from L2 (50 MB on the H100).
//   - The reset is a gather by reset_src on the fp32 state, not the (B, B)
//     selection product `pmat @ s.astype(bf16)`: the TPU kernel rounds h and
//     c to bf16 at every reset, this kernel does not (as the JAX scan path
//     and this port's 2-layer kernel, csrc/lstm2_fwd.cu).
//   - Mask and reset are (T, B) bytes, not the TPU's (T, B, 8) broadcast.
//
// Design: the host function loops over t and launches one kernel a step on
// the caller's stream: `lstm_step_kernel` of csrc/lstm_step.cuh, the step
// of the 2-layer forward (csrc/lstm2_fwd.cu) with no second product, the
// layer's own previous h gathered as its A operand. Its header says how a
// block tiles the step; h and c live in fp32 ping-pong buffers, so the
// reset gather is free of races.
//
// Bound on the H100 (989 TFLOP/s bf16): 2 B H 4H flops a step. At the
// packed-carry scoring shape (B = 600, H = 1,024) 5.0 GFLOP a step, 5 us,
// against 8 MB of W_hh a step (2.5 us from device memory): operations
// bound. At `evaluate`'s (B = 20) the step is 0.17 GFLOP and the W_hh read
// bounds it. This first version loads its tiles synchronously, one launch a
// step, and is far from either bound; a persistent kernel with W_hh split
// across the SMs' shared memory is the later redesign.

#include "lstm_step.cuh"

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
