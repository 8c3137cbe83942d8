// Float32 LSTM forward recurrences with step masks and packed carry-over
// resets, for sm_90a: the float32 counterparts of kernel rows 1, 3 and 4.
//
// Replaces, for float32 operands, bayeslms_tpu/ops/lstm_pallas.py
// `lstm2_layer_pallas` (the `_kernel2` / `_kernel2_reset` bodies that
// `_run2` hands to pallas_call: row 1) and `lstm_layer_pallas` (`_kernel_reset`
// with resets, row 3; `_kernel` without, row 4). Those kernels take their
// operand dtype from their inputs: `_cell_step` dots h, cast to the
// weights' dtype, against the weights, so at float32 they dot unrounded h
// against float32 weights. ops/lstm_cuda.py sends float32 calls here and
// bf16 ones to csrc/lstm2_fwd.cu and csrc/lstm_fwd.cu, which stay as they
// are. What a step computes is theirs:
//   1. columns b with reset[t, b] = 1 take the fp32 (h, c) of column
//      reset_src[b] (-1: zeros); each layer, h and c;
//   2. gates = a1 W1^T (+ a2 W2^T) (+ xg_t) + bias, gate order [i, f, g, o];
//      layer 1 (and the one-layer forward): a1 = its own gathered h_{t-1},
//      W1 = W_hh, xg_t = x_t W_ih^T + b_ih; row 1's layer 2: a1 = h1_t (layer
//      1's output at the step), W1 = W_ih2, a2 = its gathered h2_{t-1},
//      W2 = W_hh2, bias = b_ih2 + b_hh2;
//   3. the cell; where step_mask[t, b] = 0 the column keeps its gathered
//      (h, c);
//   4. ys[t] = h (layer 2's for row 1), float32.
//
// Arithmetic: float32 products on the CUDA cores, each gate's sum over k
// one chain of FMAs in k order, accumulated in fp32; bias and xg added
// after. The TPU kernel's float32 dot and its CPU interpret run are exact
// float32 products, so the products here are float32-faithful. One TF32
// pass on the tensor cores keeps about three decimal digits of each operand
// (a 10-bit mantissa) and does not qualify; 3xTF32 (big = tf32(a), small =
// tf32(a - big), three products summed in fp32) would, at about 165 TFLOP/s
// effective against the CUDA cores' 67, and is left to a redesign: a simple
// kernel that is right comes first (the build with -DLSTM_F32_FAULT=1 rounds
// every operand to TF32 in one pass, chip_smoke.py's planted fault).
//
// Design: `lstm_step_f32`, one launch a layer a step from the host loops at
// the end (rows 1, 3 and 4 share it, as the bf16 per-step design shares
// csrc/lstm_step.cuh). A block of 128 threads owns 32 batch columns and 16
// hidden units with all four gate rows of each unit; a thread holds 4
// columns x the 4 gates of one unit in 16 fp32 registers, so each cell
// update runs from the registers of one thread and nothing crosses blocks
// within a step. Tiles of 32 k columns of the (gathered) state and of the
// block's 64 weight rows pass through shared memory k-major (the weight
// rows in (unit, gate) order), each k step read as two float4 per thread.
// h and c live in fp32 ping-pong buffers (read step t-1, write step t), so
// the reset gather, a read of another column's previous state, is free of
// races. Any H and B: the ragged edges are masked.
//
// Bound on the H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s; NVIDIA
// data sheet, 700 W): 2 B H 4H flops a layer a step (row 1's layer 2 twice
// that). At the in-repo checkpoints' packed-carry call (B = 600, H = 256)
// 0.31 + 0.63 GFLOP a step, 14 us, against 0.5 + 1 MB of W read from L2:
// operations bound. At `evaluate`'s (B = 20, H = 256) 0.03 GFLOP a step,
// 0.5 us: the launch and the step's dependent latency set the pace there.
// Times: chip_smoke.py `f32 kernels` (PERF.md, rows 1, 3, 4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FM = 32;         // batch columns a block
constexpr int FU = 16;         // hidden units a block
constexpr int FN = 4 * FU;     // weight rows a block (4 gates x FU units)
constexpr int FK = 32;         // k columns a tile
constexpr int FPA = FM + 4;    // fp32 pitch of the k-major state tile
constexpr int FPW = FN + 4;    // fp32 pitch of the k-major weight tile
constexpr int FTHREADS = 128;  // 8 column quads x 16 units

// An operand on its way into shared memory: unchanged, or, in the
// planted-fault build, rounded to TF32 (one TF32 pass).
__device__ __forceinline__ float operand(float x) {
#ifdef LSTM_F32_FAULT
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  return x;
#endif
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One LSTM layer, one step (see the header). gather1 set: a1 is the
// layer's own previous h, gathered by the reset rule; a2, when given, is
// always gathered. h_prev, c_prev are gathered for the cell by the same
// rule. y_out may be null.
__global__ void __launch_bounds__(FTHREADS)
lstm_step_f32(const float* __restrict__ a1, int gather1,
              const float* __restrict__ w1, const float* __restrict__ a2,
              const float* __restrict__ w2, const float* __restrict__ xg_t,
              const float* __restrict__ bias,
              const float* __restrict__ h_prev,
              const float* __restrict__ c_prev, float* __restrict__ h_out,
              float* __restrict__ c_out, float* __restrict__ y_out,
              const uint8_t* __restrict__ mask_t,
              const uint8_t* __restrict__ rst_t,
              const int* __restrict__ rsrc, int B, int H) {
  __shared__ __align__(16) float As[FK * FPA];
  __shared__ __align__(16) float Ws[FK * FPW];
  __shared__ int own[FM];  // the block's columns, -1 past B
  __shared__ int src[FM];  // their gathered source columns, -1 = zeros

  const int tid = threadIdx.x;
  const int tq = tid >> 4;  // columns 4 tq .. 4 tq + 3 of the block
  const int tu = tid & 15;  // unit j0 + tu
  const int b0 = blockIdx.x * FM;
  const int j0 = blockIdx.y * FU;
  if (tid < FM) {
    const int b = b0 + tid;
    own[tid] = b < B ? b : -1;
    src[tid] = b >= B ? -1 : (rst_t != nullptr && rst_t[b]) ? rsrc[b] : b;
  }
  __syncthreads();

  float acc[4][4];  // [column][gate]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  const int parts = a2 != nullptr ? 2 : 1;
  for (int part = 0; part < parts; ++part) {
    const float* a = part ? a2 : a1;
    const float* w = part ? w2 : w1;
    const int* rows = (part || gather1) ? src : own;
    for (int k0 = 0; k0 < H; k0 += FK) {
      // state tile: FM columns x FK, a warp reading one row's 32 k
      for (int i = tid; i < FM * FK; i += FTHREADS) {
        const int r = i / FK, kk = i % FK, k = k0 + kk;
        const int s = rows[r];
        const float v = (s >= 0 && k < H) ? a[(size_t)s * H + k] : 0.f;
        As[kk * FPA + r] = operand(v);
      }
      // weight tile: row n = 4 u + q is W's row q H + j0 + u
      for (int i = tid; i < FN * FK; i += FTHREADS) {
        const int n = i / FK, kk = i % FK, k = k0 + kk;
        const int j = j0 + (n >> 2);
        const float v = (j < H && k < H)
                            ? w[((size_t)(n & 3) * H + j) * H + k] : 0.f;
        Ws[kk * FPW + n] = operand(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FK; ++kk) {
        const float4 av =
            *reinterpret_cast<const float4*>(As + kk * FPA + 4 * tq);
        const float4 wv =
            *reinterpret_cast<const float4*>(Ws + kk * FPW + 4 * tu);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ar[r], wr[q], acc[r][q]);
      }
      __syncthreads();
    }
  }

  const int j = j0 + tu;
  if (j >= H) return;
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = bias[q * H + j];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int col = 4 * tq + r;
    const int b = own[col];
    if (b < 0) continue;
    const int s = src[col];
    float hp = 0.f, cp = 0.f;
    if (s >= 0) {
      hp = h_prev[(size_t)s * H + j];
      cp = c_prev[(size_t)s * H + j];
    }
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = acc[r][q] + bq[q];
      if (xg_t != nullptr) v += xg_t[(size_t)b * 4 * H + q * H + j];
      g[q] = v;
    }
    float cn = sigmoid_f32(g[1]) * cp + sigmoid_f32(g[0]) * tanhf(g[2]);
    float hn = sigmoid_f32(g[3]) * tanhf(cn);
    if (mask_t != nullptr && !mask_t[b]) {
      hn = hp;
      cn = cp;
    }
    h_out[(size_t)b * H + j] = hn;
    c_out[(size_t)b * H + j] = cn;
    if (y_out != nullptr) y_out[(size_t)b * H + j] = hn;
  }
}

dim3 step_grid(int B, int H) {
  return dim3((B + FM - 1) / FM, (H + FU - 1) / FU);
}

}  // namespace

// Row 1 at float32: both layers over the whole sequence, two launches a
// step. xg1 (T, B, 4H) fp32; whh1, wih2, whh2 (4H, H) fp32; bhh1, b2 (4H)
// fp32; mask and reset (T, B) bytes or null (reset and rsrc go together;
// rsrc (B) int32, -1 = zero state); h1, c1, h2, c2 (2, B, H) fp32
// ping-pong buffers whose slot 0 holds the initial state (the final state
// is in slot T % 2); ys (T, B, H) fp32. Returns the first launch error, or
// 0.
extern "C" int lstm2_fwd_f32(const void* xg1, const void* whh1,
                             const void* bhh1, const void* wih2,
                             const void* whh2, const void* b2,
                             const void* mask, const void* reset,
                             const void* rsrc, void* h1, void* c1, void* h2,
                             void* c2, void* ys, int T, int B, int H,
                             void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = step_grid(B, H);
  const size_t BH = (size_t)B * H;
  const float* xg = static_cast<const float*>(xg1);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* r = static_cast<const uint8_t*>(reset);
  const int* rs = static_cast<const int*>(rsrc);
  float* h1f = static_cast<float*>(h1);
  float* c1f = static_cast<float*>(c1);
  float* h2f = static_cast<float*>(h2);
  float* c2f = static_cast<float*>(c2);
  float* y = static_cast<float*>(ys);
  for (int t = 0; t < T; ++t) {
    const size_t p = (size_t)(t & 1) * BH;
    const size_t n = (size_t)((t & 1) ^ 1) * BH;
    const uint8_t* m_t = m != nullptr ? m + (size_t)t * B : nullptr;
    const uint8_t* r_t = r != nullptr ? r + (size_t)t * B : nullptr;
    lstm_step_f32<<<grid, FTHREADS, 0, st>>>(
        h1f + p, 1, static_cast<const float*>(whh1), nullptr, nullptr,
        xg + (size_t)t * B * 4 * H, static_cast<const float*>(bhh1), h1f + p,
        c1f + p, h1f + n, c1f + n, nullptr, m_t, r_t, rs, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lstm_step_f32<<<grid, FTHREADS, 0, st>>>(
        h1f + n, 0, static_cast<const float*>(wih2), h2f + p,
        static_cast<const float*>(whh2), nullptr,
        static_cast<const float*>(b2), h2f + p, c2f + p, h2f + n, c2f + n,
        y + (size_t)t * BH, m_t, r_t, rs, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Rows 3 (reset non-null) and 4 at float32: one layer over the whole
// sequence, one launch a step. xg (T, B, 4H) fp32; whh (4H, H) fp32; bhh
// (4H) fp32; mask, reset, rsrc as above; h, c (2, B, H) fp32 ping-pong
// buffers whose slot 0 holds the initial state (the final state is in slot
// T % 2); ys (T, B, H) fp32. Returns the first launch error, or 0.
extern "C" int lstm_fwd_f32(const void* xg, const void* whh, const void* bhh,
                            const void* mask, const void* reset,
                            const void* rsrc, void* h, void* c, void* ys,
                            int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = step_grid(B, H);
  const size_t BH = (size_t)B * H;
  const float* x = static_cast<const float*>(xg);
  const float* w = static_cast<const float*>(whh);
  const float* bias = static_cast<const float*>(bhh);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* r = static_cast<const uint8_t*>(reset);
  const int* rs = static_cast<const int*>(rsrc);
  float* hf = static_cast<float*>(h);
  float* cf = static_cast<float*>(c);
  float* y = static_cast<float*>(ys);
  for (int t = 0; t < T; ++t) {
    const size_t p = (size_t)(t & 1) * BH;
    const size_t n = (size_t)((t & 1) ^ 1) * BH;
    lstm_step_f32<<<grid, FTHREADS, 0, st>>>(
        hf + p, 1, w, nullptr, nullptr, x + (size_t)t * B * 4 * H, bias,
        hf + p, cf + p, hf + n, cf + n, y + (size_t)t * BH,
        m != nullptr ? m + (size_t)t * B : nullptr,
        r != nullptr ? r + (size_t)t * B : nullptr, rs, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
