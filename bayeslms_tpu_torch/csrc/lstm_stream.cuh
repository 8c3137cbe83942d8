// The streamed persistent recurrence of the port's scoring forwards, for
// sm_90a (bf16 operands, fp32 accumulation, fp32 carries): what kernel row
// 1 (csrc/lstm2_fwd.cu `lstm2_persistent`, both layers) and row 3
// (csrc/lstm_fwd.cu `lstm_layer_stream`, one layer with packed resets)
// share. Each source includes it and writes its own `__global__`, so that a
// profile tells the rows apart.
//
// The design, for B batch columns at width H (a multiple of 64):
//   - One cooperative launch; each CTA owns U hidden units and keeps their
//     4 x U gate rows of each recurrent matrix in shared memory for the
//     whole call, K-major in TMA's 128-byte swizzle (64-column chunks of N
//     rows x 128 bytes): the wgmma B operands.
//   - A phase: a producer warp (`S_PRODUCER`) streams the m64 x 64 bf16
//     tiles of the raw (un-gathered) states by TMA (`s_load_tile`) through
//     8 KB stages (`S_STAGE`) in the shared memory left over: one ring
//     that the two consumer warpgroups take turns on (row 1), or a ring
//     for each (row 3); the warpgroups take alternate m tiles and multiply
//     each by the resident rows on wgmma (`s_product`: m64nNk16, fp32
//     accumulators), releasing every stage to the producer once its
//     products are done.
//   - A thread then runs, from its accumulators, the cells (`s_cell`) of
//     its (batch row, unit) pairs whose source at the step is the row
//     itself; the product rows of the columns that others take at the step
//     (a reset: `marks`, from the wrapper) go to a scratch in device memory,
//     and after a CTA barrier the reset columns' cells run from there, a
//     column a thread (`s_cells`), on their gathered fp32 carries. A row of
//     gather(h) W^T is the product row of the source column, so the
//     products never see the gather: the CTA, which owns every batch column
//     of its units, gathers product rows and carries itself.
//   - A grid barrier (csrc/grid_barrier.cuh) after the phase's stores: the
//     next phase's TMA reads what every CTA stored (through the async
//     proxy, after `fence.proxy.async.global`).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"
#include "lstm_step.cuh"
#include "sm90.cuh"

namespace {

constexpr int S_KC = 64;                  // k columns of a chunk (128 bytes)
constexpr int S_MT = 64;                  // batch rows of an m tile
constexpr int S_STAGE = S_MT * S_KC * 2;  // 8 KB, one A tile
constexpr int S_THREADS = 288;  // two consumer warpgroups, a producer warp
constexpr int S_PRODUCER = 8;   // the producer's warp

__device__ __forceinline__ float bf(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// The source column of b at a step: its reset source where the step resets
// it (-1: a zero state), else b. reset (T, B) bytes or null.
__device__ __forceinline__ int s_src(const uint8_t* reset, const int* rsrc,
                                     int B, int step, int b) {
  return (reset != nullptr && reset[(size_t)step * B + b]) ? rsrc[b] : b;
}

// 8 consecutive floats at p, or zeros where `on` is false
__device__ __forceinline__ void load8(float* v, const float* p, bool on) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (on) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One LSTM cell from its gate pre-activations [i, f, g, o] (bias added);
// hp, cp the previous state in, the new one out (kept where !keep)
__device__ __forceinline__ void s_cell(const float* g, float& hp, float& cp,
                                       bool keep) {
  const float cn = sigmoidf(g[1]) * cp + sigmoidf(g[0]) * tanhf(g[2]);
  const float hn = sigmoidf(g[3]) * tanhf(cn);
  if (keep) {
    hp = hn;
    cp = cn;
  }
}

// One layer's cells of a batch column for a CTA's U units (a multiple of 8)
// at one step: pre[q U + u] the gates' pre-activations without the bias;
// hp, cp the gathered previous state (in: read, out: the new state); keep
// the mask. Writes the new state's bf16 h to out (U values).
template <int U>
__device__ __forceinline__ void s_cells(const float* pre, const float* bias,
                                        float* hp, float* cp, bool keep,
                                        bf16* out) {
  uint32_t w[U / 2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = pre[q * U + u] + bias[q * U + u];
    s_cell(g, hp[u], cp[u], keep);
    if (u & 1) w[u >> 1] = pack_bf16(hp[u - 1], hp[u]);
  }
#pragma unroll
  for (int i = 0; i < U / 8; ++i)
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// The ring's barriers at `bars`: full[s] (the tile landed), then empty[s]
// (its products are done), one arrival each. Thread 0 calls it.
__device__ __forceinline__ void s_init_ring(uint32_t bars, int nst) {
  for (int s = 0; s < nst; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (nst + s), 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer's next tile: waits for stage st to be released, then loads
// the m64 x 64 box at (chunk c, m tile m, slot) of `map` into it; st and ph
// move on to the next stage.
__device__ __forceinline__ void s_load_tile(uint32_t ring, uint32_t bars,
                                            int nst, int& st, uint32_t& ph,
                                            const CUtensorMap* map, int c,
                                            int m, int slot) {
  mbar_wait(bars + 8 * (nst + st), ph ^ 1);
  mbar_expect(bars + 8 * st, S_STAGE);
  tma_load_3d(ring + st * S_STAGE, map, c * S_KC, m * S_MT, slot,
              bars + 8 * st);
  if (++st == nst) {
    st = 0;
    ph ^= 1;
  }
}

// The consumer warpgroup's product of one m tile with one resident operand:
// acc (64 x N) = A (64 x H, nk chunks streamed through the ring) W^T, W the
// N resident rows at w. Releases each stage to the producer once its
// products are done.
//   Where the two consumer warpgroups take alternate m tiles from one ring
// (row 1), a stage's full barrier tells their tiles apart only by the
// parity of their round, so a warpgroup may wait for tile g only once the
// tiles of the round before have landed (TMA may complete them out of
// order): the warpgroup before it in the ring arrives at named barrier
// `relay` once it has seen its last tile, chunk `relay_at`, land (-1:
// none, as on a ring of the warpgroup's own, row 3's).
template <int N>
__device__ __forceinline__ void s_product(float* acc, uint32_t ring,
                                          uint32_t w, int nk, uint32_t bars,
                                          int nst, bool leader, uint32_t g,
                                          int relay_at, int relay) {
  // the ring's stage and phase of tile g, the g-th since the launch
  int st = g % nst;
  uint32_t ph = (g / nst) & 1;
  auto release = [&](int s) {
    if (leader) mbar_arrive(bars + 8 * (nst + s));
  };
  int prev = -1;
  fence_regs<N / 2>(acc);
  for (int c = 0; c < nk; ++c) {
    mbar_wait(bars + 8 * st, ph);
    if (c == relay_at)
      asm volatile("bar.arrive %0, 256;" :: "r"(relay) : "memory");
    const uint32_t a = ring + st * S_STAGE;
    const uint32_t b = w + c * N * 128;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < S_KC / 16; ++k) {
      if (N == 64)
        wgmma_n64(acc, desc_k(a + 32 * k), desc_k(b + 32 * k), (c | k) > 0);
      else
        wgmma_n32(acc, desc_k(a + 32 * k), desc_k(b + 32 * k), (c | k) > 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(prev);
    }
    prev = st;
    if (++st == nst) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  release(prev);
}

// (slots, B, H) bf16 states as a 3-D map (H, B, slots) in boxes of 64
// columns x 64 batch rows of one slot, 128-byte swizzle, zeros past B
int encode_states(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int slots, int B, int H) {
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)B,
                              (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)B * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)S_KC, (cuuint32_t)S_MT, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
