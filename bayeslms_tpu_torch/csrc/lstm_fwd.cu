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
//     VMEM; the persistent and streamed designs below split it across the
//     CTAs' shared memory, the per-step design re-reads it from L2 every
//     step.
//   - The reset is a gather by reset_src on the fp32 state, not the (B, B)
//     selection product `pmat @ s.astype(bf16)`: the TPU kernel rounds h and
//     c to bf16 at every reset, this kernel does not (as the JAX scan path
//     and this port's 2-layer kernel, csrc/lstm2_fwd.cu).
//   - Mask and reset are (T, B) bytes, not the TPU's (T, B, 8) broadcast.
//
// Three designs, picked by ops/lstm_cuda.py `_design_fwd(T, B, H, n_sm,
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
// "streamed" (every call with resets, as row 3's packed-carry scoring pass
// at B = 600, and B > 32 without resets; H a multiple of 64, H / U CTAs no
// more than the SMs, the rows and two rings of two stages within 227 KB),
// kernel `lstm_layer_stream` at U = 8 units a CTA: row 1's design
// (csrc/lstm2_fwd.cu) for one layer, on csrc/lstm_stream.cuh. One
// cooperative launch of H / U CTAs of 288 threads; CTA c owns units
// [U c, U c + U) and keeps their 4 x U gate rows of W_hh resident (one
// wgmma B operand of 4U rows, K-major in the 128-byte swizzle: 64 KB at
// H = 1,024). Phase t: the producer warp streams the m64 x 64 tiles of
// ys[t-1] (bf16(h0) in front: the raw h, before any gather) by TMA into
// two rings of 8 KB stages in the rest of the shared memory, one for each
// consumer warpgroup, which takes alternate m tiles on wgmma m64n(4U)k16
// (row 1's warpgroups share one ring and take turns waiting on it); a
// thread runs the cells of its own (row, unit) pairs
// from its accumulators, (xg + p) + b_hh as the twin sums, and stores the
// product rows of the columns that reset columns take (`marks`) to a
// scratch; after a CTA barrier the reset columns' cells run from the
// scratch and their gathered fp32 carries, a column a thread. T phases,
// T - 1 grid barriers; the fp32 carries in a (2, B, H) ping-pong in device
// memory, each CTA's own units only.
//
// "per_step" (the rest: H not a multiple of 64 with resets or B > 32, or
// more CTAs than SMs), the host function loops over t and launches one
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
// 4.70-5.25 ms a call at `evaluate`'s shape and 33.5-34.5 ms at the
// scoring pass's on an NVIDIA H100 80GB HBM3 at 700.00 W. The persistent
// design reads W_hh once and is bound by its T dependent steps, a barrier
// and each CTA's L2 read of h_{t-1} (40 KB at B = 20): 0.70-0.78 ms a
// call, 7-8 us a step (chip_smoke.py, tools/lstm_fwd_designs.py; cuDNN's
// forward 2.07-2.98; PERF.md). The streamed design reads W_hh once too;
// each CTA streams all of h_{t-1} (1.2 MB at B = 600) a step: 11.38-11.42
// ms a call at the pass's shape with two rings of 8 stages, ~44 us a step,
// against the per-step design's 33.9-34.1 (tools/lstm_fwd_designs.py,
// NVIDIA H100 80GB HBM3 at 700.00 W). One ring shared as row 1 shares it
// took 12.7-13.3 ms at 4 to 20 stages; U = 16 (64 CTAs, half the L2
// traffic, m64n64k16) 16.9-18.1: both were deleted (PERF.md, row 3).

#include "lstm_step.cuh"
#include "lstm_persist.cuh"
#include "lstm_stream.cuh"

namespace {

// csrc/lstm_persist.cuh's recurrence without cs (row 4)
__global__ void __launch_bounds__(P_THREADS, 1)
lstm_layer_persistent(const __grid_constant__ FwdPersistParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  persist_fwd<false>(p, smem);
}

// The streamed design's units a CTA: a thread's cells of a batch row are
// one unit pair u0, u0 + 1 of the eight, the product's n8 block of each gate
constexpr int U = 8;

// The streamed design's dynamic shared memory at width H with nst ring
// stages: 1 KB of alignment, the resident rows (4U rows of 128 bytes a
// 64-column chunk), the ring, the biases of the CTA's 4U gate rows, the
// ring's barriers.
int stream_smem(int H, int nst) {
  return 1024 + (H / S_KC) * 4 * U * S_KC * 2 + nst * S_STAGE + 4 * U * 4 +
         2 * nst * 8;
}

struct StreamParams {
  CUtensorMap ymap;  // (T + 1, B, H) bf16: bf16(h0), then ys (step s at s + 1)
  const bf16* xg;    // (T, B, 4H)
  const bf16* whh;   // (4H, H)
  const float* bhh;  // (4H)
  const uint8_t* mask;   // (T, B) or null
  const uint8_t* reset;  // (T, B) or null, with rsrc
  const int* rsrc;
  const uint8_t* marks;  // (T, B), with reset: column s is a reset source
  float* h;  // (2, B, H) fp32 carries: step s in slot s & 1, the initial
  float* c;  // state in slot 1
  bf16* y;   // ymap's buffer
  float* prod;  // (CTAs, B, 4U) fp32: each CTA's product rows
  unsigned int* bar;  // the grid barrier's counter, zero on entry
  int T, B, H, nst;
};

// What a consumer thread's cells of one batch row need besides the
// product, loaded before it: whether the row's source at the step is the
// row itself (own), whether another row takes the row's state at the step
// (a source: its product rows go to the scratch), the mask, and for an own
// row its unit pair's previous state and xg of each gate.
struct StreamCell {
  bool on, own, src, keep;
  uint32_t x[4];
  float2 h, c;
};

__device__ __forceinline__ void stream_inputs(const StreamParams& p,
                                              StreamCell& in, int t, int row,
                                              int j) {
  const int B = p.B, H = p.H;
  in.on = row < B;
  if (!in.on) return;
  const size_t BH = (size_t)B * H, e = (size_t)row * H + j;
  in.own = s_src(p.reset, p.rsrc, B, t, row) == row;
  in.src = p.marks != nullptr && p.marks[(size_t)t * B + row];
  in.keep = p.mask == nullptr || p.mask[(size_t)t * B + row];
  if (in.own) {
    const size_t prev = (size_t)((t + 1) & 1) * BH;  // step t - 1
    const bf16* x = p.xg + ((size_t)t * B + row) * 4 * H + j;
    in.h = *reinterpret_cast<const float2*>(p.h + prev + e);
    in.c = *reinterpret_cast<const float2*>(p.c + prev + e);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      in.x[q] = *reinterpret_cast<const uint32_t*>(x + (size_t)q * H);
  }
}

// A consumer thread's cells of one batch row for units j, j + 1 from its
// accumulators: acc[4 q] (+ 1) the product's n8 block of gate q (acc
// already offset to the row's half); bias[q U] (+ 1) (offset to the
// thread's unit pair). The product rows another column needs go to the
// scratch, the own row's cells run here.
__device__ __forceinline__ void stream_outputs(const StreamParams& p,
                                               const StreamCell& in, int t,
                                               int row, int j,
                                               const float* acc,
                                               const float* bias,
                                               float* prod) {
  if (!in.on) return;
  const int B = p.B, H = p.H;
  const size_t BH = (size_t)B * H, e = (size_t)row * H + j;
  if (in.src) {
    float* o = prod + (size_t)row * 4 * U + (j & 7);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float2*>(o + q * U) =
          make_float2(acc[4 * q], acc[4 * q + 1]);
  }
  if (!in.own) return;
  const size_t cur = (size_t)(t & 1) * BH;
  float hs[2] = {in.h.x, in.h.y}, cs[2] = {in.c.x, in.c.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float gt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gt[q] = (bf(in.x[q], k) + acc[4 * q + k]) + bias[q * U + k];
    s_cell(gt, hs[k], cs[k], in.keep);
  }
  *reinterpret_cast<float2*>(p.h + cur + e) = make_float2(hs[0], hs[1]);
  *reinterpret_cast<float2*>(p.c + cur + e) = make_float2(cs[0], cs[1]);
  *reinterpret_cast<uint32_t*>(p.y + (size_t)(t + 1) * BH + e) =
      pack_bf16(hs[0], hs[1]);
}

__global__ void __launch_bounds__(S_THREADS, 1)
lstm_layer_stream(const __grid_constant__ StreamParams p) {
  constexpr int N = 4 * U;  // the resident B operand's rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int H = p.H, B = p.B, T = p.T, nst = p.nst;
  const int nk = H / S_KC, mt = (B + S_MT - 1) / S_MT;
  const int w_bytes = nk * N * S_KC * 2;
  float* bias = reinterpret_cast<float*>(smem + w_bytes + nst * S_STAGE);
  const uint32_t w = smem_u32(smem), ring = w + w_bytes;
  const uint32_t bars = smem_u32(bias + N);  // full[s], then empty[s]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * U;
  // each consumer warpgroup its own ring of ns stages (ring r at ring +
  // r ns S_STAGE, its barriers at bars + 16 ns r), so that the two take
  // their m tiles at once, with no relay between them (row 1's one ring
  // orders their waits: 7-11% slower here, PERF.md)
  const int ns = nst / 2;

  // the resident rows: row n = q U + u is W_hh's gate row q H + j0 + u;
  // K-major, 64-column chunks of N rows x 128 bytes in the swizzle
  for (int i = tid; i < N * (H / 8); i += S_THREADS) {
    const int n = i / (H / 8), k = (i % (H / 8)) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        p.whh + (size_t)((n / U) * H + j0 + n % U) * H + k);
    *reinterpret_cast<uint4*>(smem + (k / S_KC) * N * 128 +
                              swizzled(n, k % S_KC)) = v;
  }
  if (tid < N) bias[tid] = p.bhh[(tid / U) * H + j0 + tid % U];
  if (tid == 0)
    for (int r = 0; r < 2; ++r) s_init_ring(bars + 16 * ns * r, ns);
  // the rows were stored by the generic proxy; wgmma reads them through
  // the async one
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const size_t BH = (size_t)B * H;
  float* prod = p.prod + (size_t)blockIdx.x * B * N;
  uint32_t g0[2] = {0, 0};  // each ring's tiles before this phase
  unsigned int target = 0;
  for (int t = 0; t < T; ++t) {
    if (warp == S_PRODUCER) {
      if (lane == 0) {
        // this phase's tiles, the raw h of step t - 1 (ys slot t): m tiles
        // 2i and 2i + 1 chunk by chunk, each into its warpgroup's ring
        asm volatile("fence.proxy.async.global;" ::: "memory");
        int st[2];
        uint32_t ph[2];
        for (int r = 0; r < 2; ++r) {
          st[r] = g0[r] % ns;
          ph[r] = (g0[r] / ns) & 1;
        }
        for (int m = 0; m < mt; m += 2)
          for (int c = 0; c < nk; ++c)
            for (int r = 0; r < 2 && m + r < mt; ++r)
              s_load_tile(ring + r * ns * S_STAGE, bars + 16 * ns * r, ns,
                          st[r], ph[r], &p.ymap, c, m + r, t);
      }
      __syncwarp();
    } else {
      // warpgroup wg takes the m tiles wg, wg + 2, ... from its ring. A
      // thread's rows 16 (warp % 4) + lane / 4 (+ 8) of its m tiles and
      // units u0, u0 + 1 (columns u0, u0 + 1 of each gate's n8 block)
      const int wg = warp >> 2;
      const bool leader = (tid & 127) == 0;
      const int rbase = 16 * (warp & 3) + (lane >> 2), u0 = 2 * (lane & 3);
      for (int m = wg; m < mt; m += 2) {
        StreamCell in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stream_inputs(p, in[h], t, m * S_MT + rbase + 8 * h, j0 + u0);
        float acc[N / 2];
        s_product<N>(acc, ring + wg * ns * S_STAGE, w, nk,
                     bars + 16 * ns * wg, ns, leader, g0[wg] + (m / 2) * nk,
                     -1, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stream_outputs(p, in[h], t, m * S_MT + rbase + 8 * h, j0 + u0,
                         acc + 2 * h, bias + u0, prod);
      }
    }
    g0[0] += ((mt + 1) / 2) * nk;
    g0[1] += (mt / 2) * nk;
    __syncthreads();

    // the cells whose source is another column (a reset; -1: a zero state),
    // a batch column a thread, from the product rows the owners stored
    for (int b = tid; b < B; b += S_THREADS) {
      const int s = s_src(p.reset, p.rsrc, B, t, b);
      if (s == b) continue;
      const bool keep = p.mask == nullptr || p.mask[(size_t)t * B + b];
      const size_t prev = (size_t)((t + 1) & 1) * BH;  // step t - 1
      const size_t cur = (size_t)(t & 1) * BH;
      float pre[N], hp[U], cp[U];
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        load8(pre + 8 * i, prod + (size_t)s * N + 8 * i, s >= 0);
      load8(hp, p.h + prev + (size_t)s * H + j0, s >= 0);
      load8(cp, p.c + prev + (size_t)s * H + j0, s >= 0);
      const bf16* x = p.xg + ((size_t)t * B + b) * 4 * H + j0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)q * H);
        const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < U; ++u)
          pre[q * U + u] = bf(xw[u >> 1], u & 1) + pre[q * U + u];
      }
      s_cells<U>(pre, bias, hp, cp, keep,
                 p.y + (size_t)(t + 1) * BH + (size_t)b * H + j0);
      store8(p.h + cur + (size_t)b * H + j0, hp);
      store8(p.c + cur + (size_t)b * H + j0, cp);
    }
    // the bf16 states just stored are read by TMA (the async proxy)
    asm volatile("fence.proxy.async.global;" ::: "memory");
    if (t + 1 < T) {
      target += gridDim.x;
      grid_barrier(p.bar, target);
    }
  }
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

// The streamed design (see the header): xg (T, B, 4H) bf16; whh (4H, H)
// bf16; bhh (4H) fp32; mask, reset (T, B) bytes or null (reset and rsrc
// go together; rsrc (B) int32, -1 = zero state); marks (T, B) bytes with
// reset, marks[t, s] set where a column resets to column s at step t (null
// without); h, c (2, B, H) fp32 with the initial state in slot 1 (the
// final state in slot (T - 1) & 1); ys (T + 1, B, H) bf16 with bf16(h0) in
// slot 0 (step s written to slot s + 1); prod an (H / 8, B, 32) fp32
// scratch; bar one zeroed unsigned int; nst the rings' stages (even, two
// rings of nst / 2). The launch is cooperative. Returns the launch error
// (the card's refusal of a grid it cannot hold at once among them), or 0;
// -1 where the driver's cuTensorMapEncodeTiled is not found, -1000 - r
// where it refuses a descriptor with r.
extern "C" int lstm_fwd_stream(const void* xg, const void* whh,
                               const void* bhh, const void* mask,
                               const void* reset, const void* rsrc,
                               const void* marks, void* h, void* c, void* ys,
                               void* prod, void* bar, int T, int B, int H,
                               int nst, void* stream) {
  if (B <= 0 || H <= 0 || H % S_KC != 0 || nst < 4 || nst % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const void* fn = reinterpret_cast<const void*>(lstm_layer_stream);
  const int smem = stream_smem(H, nst);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  StreamParams prm = {};
  const int r = encode_states(enc, &prm.ymap, ys, T + 1, B, H);
  if (r != 0) return -1000 - r;
  prm.xg = static_cast<const bf16*>(xg);
  prm.whh = static_cast<const bf16*>(whh);
  prm.bhh = static_cast<const float*>(bhh);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.reset = static_cast<const uint8_t*>(reset);
  prm.rsrc = static_cast<const int*>(rsrc);
  prm.marks = static_cast<const uint8_t*>(marks);
  prm.h = static_cast<float*>(h);
  prm.c = static_cast<float*>(c);
  prm.y = static_cast<bf16*>(ys);
  prm.prod = static_cast<float*>(prod);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  prm.nst = nst;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(fn, dim3(H / U), dim3(S_THREADS), args,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
