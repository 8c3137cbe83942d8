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
//     resident in one core's VMEM. No SM holds that: the persistent design
//     splits them over the SMs' shared memory; the per-step design re-reads
//     them from L2 every step.
//   - The reset is a gather by reset_src on fp32 state, not the (B, B)
//     selection product `pmat @ s.astype(bf16)`: the TPU kernel rounds h and
//     c to bf16 at every reset, this kernel does not (as the JAX scan path).
//   - Mask and reset are (T, B) bytes, not the TPU's (T, B, 8) broadcast.
//
// Bound on the H100 at the scoring shapes (T=256, B=600, H=1024): 3 products
// of (B x H)(H x 4H) per step, 15.1 GFLOP per step, about 15 us at the
// 989 TFLOP/s bf16 peak (H100 SXM data sheet, 700 W), 3.9 ms a call:
// operations bound. Two designs, picked by ops/lstm_cuda.py `_design` (an
// explicit rule: the chosen design runs or raises).
//
// "persistent" (H a multiple of 64, H / 8 CTAs no more than the SMs, the
// weights and a ring of at least two stages within a CTA's 227 KB: H <=
// 1,024 on the H100), kernel `lstm2_persistent`, one launch a call:
//   - CTA c owns the hidden units [8c, 8c + 8) of both layers and keeps its
//     4 x 8 gate rows of W_hh1, W_ih2 and W_hh2 in shared memory for the
//     whole call (192 KB at H = 1,024), K-major in TMA's 128-byte swizzle:
//     W_hh1's and W_ih2's rows as one 64-row wgmma B operand, W_hh2's as a
//     32-row one.
//   - The reset gather is moved behind the products: a row of gather(h) W^T
//     is the product row of the source column, so the products run on the
//     raw (un-gathered) bf16 states and the CTA, which owns every batch
//     column of its units, gathers product rows and fp32 carries itself.
//     Nothing crosses CTAs but the raw bf16 h1 (a (2, B, H) ping-pong) and
//     ys itself (h2 of step s is the product's operand two phases on).
//   - A one-step skew: phase t runs layer 1 at step t and layer 2 at step
//     t - 1, whose inputs (h1 of step t - 1, h2 of step t - 2) were both
//     stored before the last grid barrier: T + 1 phases, T barriers.
//   - Phase t: a producer warp streams the m64 x 64 tiles of h1_{t-1} and
//     h2_{t-2} by TMA through a ring of 8 KB stages in the shared memory
//     left over (four at H = 1,024); two consumer warpgroups take alternate
//     m tiles and multiply each by the resident rows on wgmma (m64n64k16
//     for h1: layer 1's recurrence and layer 2's input in one product;
//     m64n32k16 for h2), fp32 accumulators. A thread then runs, from its
//     accumulators, the cells of its (batch row, unit) pairs whose source
//     at the step is the row itself (xg1, the carries and the mask loaded
//     before the products), and stores h1 raw in bf16 (the next phase's
//     operand), ys and the fp32 carries; while one warpgroup runs its
//     cells, the other's tiles stream. The product rows of the columns that
//     others take at the step (`marks`, from the wrapper) go to a scratch in
//     device memory, and after a CTA barrier the cells of the reset columns
//     run from there, a column a thread, with their gathered carries; then a
//     grid barrier (csrc/grid_barrier.cuh).
//   - The launch is cooperative: a grid the card cannot hold at once is
//     refused, and the wrapper raises.
//   - The producer's ring, the wgmma products, the cells and the grid
//     barrier are csrc/lstm_stream.cuh's, which row 3's streamed design
//     (csrc/lstm_fwd.cu) takes too.
//   - Cost, measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00
//     W (PERF.md, row 1): 22.2 ms at the scoring call (the per-step design
//     105.0 ms in the same run; 25.4 and 105.5 in another), 1.69 ms at an
//     evaluate window (the per-step design 13.4; cuDNN's 2-layer forward
//     5.8). Each CTA streams 2.46 MB of bf16 state a step through 32 KB of
//     ring, ~30 GB/s an SM: the ring's bytes in flight over L2's latency set
//     the pace, not the 3.9 ms of operations. Clusters of 2 CTAs
//     multicasting each tile by TMA were tried: they read L2 half as often
//     but ran 2.8-3.4x slower (PERF.md), since every stage then waits on
//     both CTAs' consumers and each SM still takes in every byte. The design
//     takes single CTAs.
//
// "per_step" (the rest, such as H = 96 or 2,048), kernel `lstm_step_kernel`
// of csrc/lstm_step.cuh, shared with the one-layer forward (csrc/
// lstm_fwd.cu): the host function loops over t and launches one kernel per
// layer per step on the caller's stream. A block owns BM batch columns and
// BJ hidden units and computes all four gate rows (q*H + j) of those units,
// so the cell update needs nothing from other blocks. h and c live in fp32
// ping-pong buffers (read step t-1, write step t), so the reset gather (a
// read of another column's previous state) is free of races. The products
// run on the tensor cores through wmma (16x16x16 bf16, fp32 accumulators);
// the A operand (the fp32 state, gathered) is rounded to bf16 on its way
// into shared memory, as the TPU kernel rounds h before its dot. It loads
// its tiles synchronously, 2T launches a call: 105.4 ms at the scoring
// shapes on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md).

#include "lstm_stream.cuh"

namespace {

constexpr int Q_UNITS = 8;            // hidden units a CTA owns, both layers
constexpr int Q_NA = 64;              // rows of h1's B: W_hh1's, W_ih2's
constexpr int Q_NB = 32;              // rows of h2's B: W_hh2's
constexpr int Q_PC = Q_NA + Q_NB;     // fp32 product columns of a batch row

// Dynamic shared memory at width H with nst ring stages: 1 KB of
// alignment, the resident rows (12 KB a 64-column chunk), the ring, the
// biases of the CTA's 64 gate rows, the barriers.
int q_smem(int H, int nst) {
  return 1024 + (H / S_KC) * (Q_NA + Q_NB) * S_KC * 2 + nst * S_STAGE +
         2 * 32 * 4 + 2 * nst * 8;
}

struct QParams {
  CUtensorMap r1map;  // (2, B, H) bf16: raw h1 of step s in slot s & 1
  CUtensorMap ymap;   // (T + 1, B, H) bf16: h02, then ys (step s at s + 1)
  const bf16* xg;     // (T, B, 4H)
  const bf16* whh1;
  const bf16* wih2;
  const bf16* whh2;
  const float* bhh1;
  const float* b2;
  const uint8_t* mask;   // (T, B) or null
  const uint8_t* reset;  // (T, B) or null, with rsrc
  const int* rsrc;
  const uint8_t* marks;  // (T, B), with reset: column s is a reset source
  float* h1;  // (2, B, H) fp32 carries: step s in slot s & 1, the
  float* c1;  // initial state in slot 1
  float* h2;
  float* c2;
  bf16* r1;          // r1map's buffer
  bf16* y;           // ymap's buffer
  float* prod;       // (CTAs, B, Q_PC) fp32: each CTA's product rows
  unsigned int* bar;  // the grid barrier's counter, zero on entry
  int T, B, H, nst;
};

// The source column of b at a step: its reset source where the step resets
// it (-1: a zero state), else b.
__device__ __forceinline__ int q_src(const QParams& p, int step, int b) {
  return s_src(p.reset, p.rsrc, p.B, step, b);
}

// What a consumer thread's cells of one batch row need besides the
// products, loaded before them: per layer whether the row's source at the
// step is the row itself (own), whether another row takes the row's state
// at the step (a source: its product rows go to the scratch), the mask,
// and for an own row its two units' previous state and (layer 1) xg1.
struct QCell {
  bool on, own1, src1, keep1, own2, src2, keep2;
  uint32_t x[4];
  float2 h1, c1, h2, c2;
};

__device__ __forceinline__ void q_cell_inputs(const QParams& p, QCell& in,
                                              int t, int row, int j) {
  const int B = p.B, H = p.H;
  in.on = row < B;
  if (!in.on) return;
  const size_t BH = (size_t)B * H, e = (size_t)row * H + j;
  if (t < p.T) {  // layer 1 at step t: the state of step t - 1
    in.own1 = q_src(p, t, row) == row;
    in.src1 = p.marks != nullptr && p.marks[(size_t)t * B + row];
    in.keep1 = p.mask == nullptr || p.mask[(size_t)t * B + row];
    if (in.own1) {
      const size_t prev = (size_t)((t + 1) & 1) * BH;
      in.h1 = *reinterpret_cast<const float2*>(p.h1 + prev + e);
      in.c1 = *reinterpret_cast<const float2*>(p.c1 + prev + e);
      const bf16* x = p.xg + ((size_t)t * B + row) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        in.x[q] = *reinterpret_cast<const uint32_t*>(x + (size_t)q * H);
    }
  }
  if (t >= 1) {  // layer 2 at step t - 1: the state of step t - 2
    in.own2 = q_src(p, t - 1, row) == row;
    in.src2 = p.marks != nullptr && p.marks[(size_t)(t - 1) * B + row];
    in.keep2 = p.mask == nullptr || p.mask[(size_t)(t - 1) * B + row];
    if (in.own2) {
      const size_t prev = (size_t)(t & 1) * BH;
      in.h2 = *reinterpret_cast<const float2*>(p.h2 + prev + e);
      in.c2 = *reinterpret_cast<const float2*>(p.c2 + prev + e);
    }
  }
}

// A consumer thread's cells of one batch row for units j, j + 1 from its
// accumulators: pa[4 n] (+ 1) the h1 product's n8 block n (layer 1's raw
// gate q = n < 4, layer 2's input gate n - 4), pb[4 q] (+ 1) the h2
// product's (layer 2's raw gate q); bias[q 8] (+ 1) layer 1's, bias[32 +
// q 8] layer 2's. The product rows another column needs go to the
// scratch, the own rows' cells run here.
__device__ __forceinline__ void q_cell_outputs(const QParams& p,
                                               const QCell& in, int t,
                                               int row, int j,
                                               const float* pa,
                                               const float* pb,
                                               const float* bias,
                                               float* prod) {
  if (!in.on) return;
  const int B = p.B, H = p.H, u0 = j & 7;
  const size_t BH = (size_t)B * H, e = (size_t)row * H + j;
  float* o = prod + (size_t)row * Q_PC + u0;
  if (t < p.T) {
    if (in.src1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(o + 8 * q) =
            make_float2(pa[4 * q], pa[4 * q + 1]);
    }
    if (in.own1) {
      float hs[2] = {in.h1.x, in.h1.y}, cs[2] = {in.c1.x, in.c1.y};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g[q] = (bf(in.x[q], k) + pa[4 * q + k]) + bias[8 * q + k];
        s_cell(g, hs[k], cs[k], in.keep1);
      }
      const size_t cur = (size_t)(t & 1) * BH;
      *reinterpret_cast<float2*>(p.h1 + cur + e) = make_float2(hs[0], hs[1]);
      *reinterpret_cast<float2*>(p.c1 + cur + e) = make_float2(cs[0], cs[1]);
      *reinterpret_cast<uint32_t*>(p.r1 + cur + e) = pack_bf16(hs[0], hs[1]);
    }
  }
  if (t >= 1) {
    if (in.src2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(o + Q_NA + 8 * q) =
            make_float2(pb[4 * q], pb[4 * q + 1]);
    }
    if (!in.own2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float2*>(o + 32 + 8 * q) =
            make_float2(pa[16 + 4 * q], pa[16 + 4 * q + 1]);
    } else {
      float hs[2] = {in.h2.x, in.h2.y}, cs[2] = {in.c2.x, in.c2.y};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g[q] = (pa[16 + 4 * q + k] + pb[4 * q + k]) + bias[32 + 8 * q + k];
        s_cell(g, hs[k], cs[k], in.keep2);
      }
      const size_t cur = (size_t)((t + 1) & 1) * BH;
      *reinterpret_cast<float2*>(p.h2 + cur + e) = make_float2(hs[0], hs[1]);
      *reinterpret_cast<float2*>(p.c2 + cur + e) = make_float2(cs[0], cs[1]);
      *reinterpret_cast<uint32_t*>(p.y + (size_t)t * BH + e) =
          pack_bf16(hs[0], hs[1]);
    }
  }
}

__global__ void __launch_bounds__(S_THREADS, 1)
lstm2_persistent(const __grid_constant__ QParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int H = p.H, B = p.B, T = p.T, nst = p.nst;
  const int nk = H / S_KC, mt = (B + S_MT - 1) / S_MT;
  const int wa_bytes = nk * Q_NA * S_KC * 2, wb_bytes = nk * Q_NB * S_KC * 2;
  float* bias = reinterpret_cast<float*>(smem + wa_bytes + wb_bytes +
                                         nst * S_STAGE);
  const uint32_t wa = smem_u32(smem), wb = wa + wa_bytes;
  const uint32_t ring = wb + wb_bytes;
  const uint32_t bars = smem_u32(bias + 64);  // full[s], then empty[s]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * Q_UNITS;

  // the resident rows: row n < 64 of A's operand is W_hh1's (n < 32) or
  // W_ih2's gate row (n % 32 / 8) H + j0 + n % 8, row n of B's W_hh2's;
  // K-major, 64-column chunks of N rows x 128 bytes in the swizzle
  for (int i = tid; i < (Q_NA + Q_NB) * (H / 8); i += S_THREADS) {
    const int n = i / (H / 8), k = (i % (H / 8)) * 8;
    const bf16* w = n < 32 ? p.whh1 : n < 64 ? p.wih2 : p.whh2;
    const int m = n & 31;
    const uint4 v = *reinterpret_cast<const uint4*>(
        w + (size_t)((m >> 3) * H + j0 + (m & 7)) * H + k);
    const int off = n < 64 ? (k / S_KC) * Q_NA * 128 + swizzled(n, k % S_KC)
                           : wa_bytes + (k / S_KC) * Q_NB * 128 +
                                 swizzled(n - 64, k % S_KC);
    *reinterpret_cast<uint4*>(smem + off) = v;
  }
  if (tid < 64) {
    const int m = tid & 31;
    bias[tid] = (tid < 32 ? p.bhh1 : p.b2)[(m >> 3) * H + j0 + (m & 7)];
  }
  if (tid == 0) s_init_ring(bars, nst);
  // the rows were stored by the generic proxy; wgmma reads them through
  // the async one
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const size_t BH = (size_t)B * H;
  float* prod = p.prod + (size_t)blockIdx.x * B * Q_PC;
  uint32_t g0 = 0;  // the ring's tiles before this phase
  unsigned int target = 0;
  for (int t = 0; t <= T; ++t) {
    const bool l1 = t < T, l2 = t >= 1;  // layer 1 at t, layer 2 at t - 1
    const int per_m = nk * (l2 ? 2 : 1);  // tiles of an m tile
    if (warp == S_PRODUCER) {
      if (lane == 0) {
        // this phase's tiles in order: per m tile, h1 of step t - 1 (slot
        // (t + 1) & 1), then h2 of step t - 2 (ys slot t - 1)
        asm volatile("fence.proxy.async.global;" ::: "memory");
        int st = g0 % nst;
        uint32_t ph = (g0 / nst) & 1;
        for (int m = 0; m < mt; ++m)
          for (int op = 0; op < (l2 ? 2 : 1); ++op)
            for (int c = 0; c < nk; ++c)
              s_load_tile(ring, bars, nst, st, ph, op ? &p.ymap : &p.r1map,
                          c, m, op ? t - 1 : (t + 1) & 1);
      }
      __syncwarp();
    } else {
      // warpgroup wg takes the m tiles wg, wg + 2, ...: while one runs its
      // cells, the other's tiles stream. A thread's rows 16 (warp % 4) +
      // lane / 4 (+ 8) of its m tiles and units u0, u0 + 1 (columns 8 j +
      // u0 of each product's n8 block j): the cells of those (row, unit)
      // pairs whose source is the row itself run here, from the
      // accumulators; the rest after all m tiles
      const int wg = warp >> 2;
      const bool leader = (tid & 127) == 0;
      const int rbase = 16 * (warp & 3) + (lane >> 2), u0 = 2 * (lane & 3);
      // the relay (see q_product): named barrier 1 + wg is this
      // warpgroup's turn, once the other has seen all its tiles land
      for (int m = wg; m < mt; m += 2) {
        QCell in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          q_cell_inputs(p, in[h], t, m * S_MT + rbase + 8 * h, j0 + u0);
        float pa[32], pb[16];
        const uint32_t g = g0 + m * per_m;
        const int at = m + 1 < mt ? per_m - 1 : -1;
        if (m >= 1) named_sync(1 + wg, 256);
        s_product<Q_NA>(pa, ring, wa, nk, bars, nst, leader, g,
                            at < nk ? at : -1, 2 - wg);
        if (l2)
          s_product<Q_NB>(pb, ring, wb, nk, bars, nst, leader, g + nk,
                              at >= nk ? at - nk : -1, 2 - wg);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          q_cell_outputs(p, in[h], t, m * S_MT + rbase + 8 * h, j0 + u0,
                         pa + 2 * h, pb + 2 * h, bias + u0, prod);
      }
    }
    g0 += mt * per_m;
    __syncthreads();

    // the cells whose source is another column (a reset; -1: a zero state),
    // a batch column a thread, from the product rows the owners stored:
    // layer 1 at step t, layer 2 at step t - 1
    for (int b = tid; b < B; b += S_THREADS) {
      if (l1) {
        const int s = q_src(p, t, b);
        if (s != b) {
          const bool keep = p.mask == nullptr || p.mask[(size_t)t * B + b];
          const size_t prev = (size_t)((t + 1) & 1) * BH;  // step t - 1
          const size_t cur = (size_t)(t & 1) * BH;
          float pre[32], hp[8], cp[8];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            load8(pre + 8 * q, prod + (size_t)s * Q_PC + 8 * q, s >= 0);
          load8(hp, p.h1 + prev + (size_t)s * H + j0, s >= 0);
          load8(cp, p.c1 + prev + (size_t)s * H + j0, s >= 0);
          const bf16* x = p.xg + ((size_t)t * B + b) * 4 * H + j0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)q * H);
            const uint32_t xw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 8; ++u)
              pre[q * 8 + u] = bf(xw[u >> 1], u & 1) + pre[q * 8 + u];
          }
          s_cells<Q_UNITS>(pre, bias, hp, cp, keep,
                           p.r1 + cur + (size_t)b * H + j0);
          store8(p.h1 + cur + (size_t)b * H + j0, hp);
          store8(p.c1 + cur + (size_t)b * H + j0, cp);
        }
      }
      if (l2) {
        const int step = t - 1;
        const int s = q_src(p, step, b);
        if (s != b) {
          const bool keep = p.mask == nullptr || p.mask[(size_t)step * B + b];
          const size_t prev = (size_t)(t & 1) * BH;  // step t - 2
          const size_t cur = (size_t)((t + 1) & 1) * BH;
          float pre[32], rec[32], hp[8], cp[8];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            load8(pre + 8 * q, prod + (size_t)b * Q_PC + 32 + 8 * q, true);
            load8(rec + 8 * q, prod + (size_t)s * Q_PC + Q_NA + 8 * q,
                  s >= 0);
          }
          load8(hp, p.h2 + prev + (size_t)s * H + j0, s >= 0);
          load8(cp, p.c2 + prev + (size_t)s * H + j0, s >= 0);
#pragma unroll
          for (int i = 0; i < 32; ++i) pre[i] += rec[i];
          s_cells<Q_UNITS>(pre, bias + 32, hp, cp, keep,
                  p.y + (size_t)t * BH + (size_t)b * H + j0);
          store8(p.h2 + cur + (size_t)b * H + j0, hp);
          store8(p.c2 + cur + (size_t)b * H + j0, cp);
        }
      }
    }
    // the bf16 states just stored are read by TMA (the async proxy)
    asm volatile("fence.proxy.async.global;" ::: "memory");
    if (t < T) {
      target += gridDim.x;
      grid_barrier(p.bar, target);
    }
  }
}

bool q_valid(int B, int H, int nst) {
  return B > 0 && H > 0 && H % S_KC == 0 && nst >= 2;
}

}  // namespace

// The per-step design: runs the whole sequence. h1, c1, h2, c2 are (2, B, H)
// fp32 ping-pong buffers whose slot 0 holds the initial state; the final
// state is in slot T % 2. mask and reset are (T, B) bytes or null (reset
// and rsrc go together). Returns the first launch error, or 0.
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

// The persistent design (see the header). The per-step design's inputs;
// marks (T, B) bytes with reset, marks[t, s] set where a column resets to
// column s at step t (null without); h1, c1, h2, c2 (2, B, H) fp32 with the initial state in slot 1 (the final
// state in slot (T - 1) & 1); r1 (2, B, H) bf16 with bf16(h01) in slot 1;
// ys (T + 1, B, H) bf16 with bf16(h02) in slot 0 (step s written to slot
// s + 1); prod an (H / 8, B, 96) fp32 scratch; bar one zeroed unsigned int;
// nst the ring's stages. The launch is cooperative. Returns the launch
// error (the card's refusal of a grid it cannot hold at once among them),
// or 0; -1 where the driver's cuTensorMapEncodeTiled is not found, -1000 - r
// where it refuses a descriptor with r.
extern "C" int lstm2_fwd_persistent(
    const void* xg1, const void* whh1, const void* bhh1, const void* wih2,
    const void* whh2, const void* b2, const void* mask, const void* reset,
    const void* rsrc, const void* marks, void* h1, void* c1, void* h2,
    void* c2, void* r1, void* ys, void* prod, void* bar, int T, int B, int H,
    int nst, void* stream) {
  if (!q_valid(B, H, nst)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int smem = q_smem(H, nst);
  cudaError_t err = cudaFuncSetAttribute(
      lstm2_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  QParams prm = {};
  int r = encode_states(enc, &prm.r1map, r1, 2, B, H);
  if (r == 0) r = encode_states(enc, &prm.ymap, ys, T + 1, B, H);
  if (r != 0) return -1000 - r;
  prm.xg = static_cast<const bf16*>(xg1);
  prm.whh1 = static_cast<const bf16*>(whh1);
  prm.wih2 = static_cast<const bf16*>(wih2);
  prm.whh2 = static_cast<const bf16*>(whh2);
  prm.bhh1 = static_cast<const float*>(bhh1);
  prm.b2 = static_cast<const float*>(b2);
  prm.mask = static_cast<const uint8_t*>(mask);
  prm.reset = static_cast<const uint8_t*>(reset);
  prm.rsrc = static_cast<const int*>(rsrc);
  prm.marks = static_cast<const uint8_t*>(marks);
  prm.h1 = static_cast<float*>(h1);
  prm.c1 = static_cast<float*>(c1);
  prm.h2 = static_cast<float*>(h2);
  prm.c2 = static_cast<float*>(c2);
  prm.r1 = static_cast<bf16*>(r1);
  prm.y = static_cast<bf16*>(ys);
  prm.prod = static_cast<float*>(prod);
  prm.bar = static_cast<unsigned int*>(bar);
  prm.T = T;
  prm.B = B;
  prm.H = H;
  prm.nst = nst;
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm2_persistent), dim3(H / Q_UNITS),
      dim3(S_THREADS), args, (size_t)smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
