// Causal multi-head self-attention forward, for sm_90a.
//
// Replaces bayeslms_tpu/ops/attention_pallas.py `causal_attention_pallas`
// (the `_kernel` body that `_run` hands to pallas_call). For each batch
// column b, head h and query row r:
//   s_c = (q_r d^-1/2) . k_c  for c <= r,  -1e30 for c > r
//   o_r = sum_c softmax(s)_c v_c
// with q scaled in fp32, an fp32 softmax and P kept at fp32 precision for
// P . V, as the TPU kernel keeps it: P is never rounded to bf16 alone. The
// output is in the input dtype (bf16 or fp32).
//
// Differences from the TPU kernel: the TPU block holds the whole K and V of
// its (batch x head) row in VMEM; at T = 8,192 and d = 64 those are 2 MiB,
// far more than an SM's 227 KB of shared memory. These kernels stream K and
// V through shared memory in tiles of 64 keys with a running max and sum
// per query row (the same function, summed in another order: there is no
// dropout, and nothing is rounded against the max), and skip the key tiles
// that lie wholly above the diagonal. They read q, k and v in the model's
// time-major layout through their strides (element (t, b, h, j) at t st + b
// sb + h d + j), so the qkv projection's column slices need no copy and no
// (B h, T, d) transpose, and mask the ragged edges of T themselves: no
// padding of T to the query tile.
//
// Two designs, chosen by the wrapper (ops/attention_cuda.py `_design`,
// counted apart in `design_launches`), neither a fallback of the other:
// "wgmma" (tensor cores, TMA) for bf16 heads of d <= 128, d % 8 == 0, with
// 16-byte aligned views and strides; "simt" (the fp32 CUDA cores) for fp32,
// for d = 256 and for views TMA cannot describe.
//
// wgmma design (`attention_fwd_wgmma`). A CTA owns 64 query rows of one
// (b, h): one consumer warpgroup and a producer warp that loads q once by
// TMA (a 4-D map (d, H, B, T) of the view, 64-column boxes, 128-byte
// swizzle) and streams key tiles of 64 keys (K then V) through a ring of 2-3
// stages. 64-row CTAs (not row 15's 128) fill the SMs at the shapes that
// call it: T = 100, B h = 20 x 8 gives 320 CTAs on 132 SMs, two or three
// resident each; the Transformer-XL memory builds (B = 1, 8 heads, T 32-128)
// give 8-16. Per tile: S = q K^T on bf16 wgmma (m64n64k16 over d's 64-column
// chunks), scaled by d^-1/2 in fp32 after the product; the row's running
// max and sum and the rescaled output accumulator in registers; p =
// exp(s - m) in fp32, split P_hi = bf16(p), P_lo = bf16(p - P_hi), and both
// halves go straight from the score fragment's registers into the A
// fragments of two products o += P_hi V + P_lo V into the same fp32
// accumulator (V the B operand, MN-major). P's error is then <= 2^-16 of p
// (bf16's half ulp, 2^-8, of the residual, itself <= 2^-8 of p), far below
// the output's own bf16 rounding (2^-9 to 2^-8); P rounded to bf16 alone
// would move o by up to 2^-8 before that rounding, and a TF32 P V cannot
// read V MN-major (wgmma's .tf32 takes both operands K-major). Masked scores stay -1e30 before the exp, as in the
// CUDA-core kernel. The CTAs run longest rows first. __expf (the SFU's
// ex2.approx, a few 2^-22 relative) serves both the row max's rescale and
// p.
//
// simt design (`attention_fwd_kernel`): a block owns 64 query rows of one
// (b, h) and 256 threads. Per key tile it forms the 64 x 64 score tile in
// fp32 on the CUDA cores (each thread a 4 x 4 patch, q and k transposed in
// shared memory), parks it in shared memory, and four threads per query row
// fold it into the row's running max m and sum l, turn it into p =
// exp(s - m) and update their quarter of the row's output accumulator o =
// alpha o + p V in registers. d up to 256 (any multiple of 8); the tile
// widths are a template of 32, 64, 128 or 256 columns, and columns past d
// are zero.
//
// Bound on the H100 (H100 SXM data sheet, 989 TFLOP/s bf16, 3.35 TB/s, 700
// W). At the eval shape (B h = 20 x 8, T = 100, d = 64) the causal products
// are ~T^2 d B h (2 x 0.5 x 2) ~ 0.2 GFLOP and the bytes 4 x 160 x 100 x
// 64 x 2 = 8 MB: 2.5 us of memory, which a launch and the CTAs' serial
// chain of TMA loads, products and the fold (a few us) exceed. At T = 4,096
// the wgmma design executes three products (S, P_hi V, P_lo V; the
// diagonal tiles' masked halves too), 1.5x the bound's two, and an exp a
// score on 4 warps a CTA; the CUDA-core design is bound by its fp32
// arithmetic at 67 TFLOP/s.
//
// Compile-time fault for chip_smoke.py's planted-fault check (never set by
// the port): ATTENTION_FAULT=1 masks the diagonal too (c >= r), so a row
// no longer attends to itself; both designs.

#include <cuda.h>  // CUtensorMap and its enums; the library links no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

#ifndef ATTENTION_FAULT
#define ATTENTION_FAULT 0
#endif

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;
constexpr int PAD = 4;        // fp32 padding of the transposed tiles' rows
constexpr int LDS = BKV + 1;  // fp32 pitch of the score tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool causal(int col, int row) {
#if ATTENTION_FAULT == 1
  return col < row;
#else
  return col <= row;
#endif
}

template <int DP>
constexpr int smem_bytes() {
  // q^T, k^T (DP x 64 each, padded rows), v (64 x DP, padded), scores
  return (2 * DP * (BQ + PAD) + BKV * (DP + PAD) + BQ * LDS) * 4;
}

// q, k, v: element (t, b, h, j) at base + t st + b sb + h d + j; o is
// contiguous (T, B, H d). grid = (B H, ceil(T / BQ)).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Tn,
                     int B, int H, int d, long long sq_t, long long sq_b,
                     long long sk_t, long long sk_b, long long sv_t,
                     long long sv_b, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [DP][BQ + PAD]
  float* Kt = Qt + DP * (BQ + PAD);      // [DP][BKV + PAD]
  float* Vs = Kt + DP * (BKV + PAD);     // [BKV][DP + PAD]
  float* Ss = Vs + BKV * (DP + PAD);     // [BQ][LDS]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.y * BQ;
  const T* qb = q + b * sq_b + static_cast<long long>(h) * d;
  const T* kb = k + b * sk_b + static_cast<long long>(h) * d;
  const T* vb = v + b * sv_b + static_cast<long long>(h) * d;

  // q tile, scaled in fp32, transposed: Qt[j][r]
  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, j = i - (i / DP) * DP;
    const int t = q0 + r;
    float x = 0.f;
    if (t < Tn && j < d) x = to_f(qb[t * sq_t + j]) * scale;
    Qt[j * (BQ + PAD) + r] = x;
  }

  // score patch: rows 4 ty .. +4, keys 4 tx .. +4
  const int ty = tid >> 4, tx = tid & 15;
  // softmax and output: row sr, output columns [sq DP/4, (sq + 1) DP/4)
  const int sr = tid >> 2, sq = tid & 3;
  constexpr int OC = DP / 4;
  float acc[OC];
#pragma unroll
  for (int c = 0; c < OC; ++c) acc[c] = 0.f;
  float m_run = NEG, l_run = 0.f;
  const int row = q0 + sr;

  // key tiles up to and including the diagonal one
  const int k_end = min(Tn, q0 + BQ);
  for (int k0 = 0; k0 < k_end; k0 += BKV) {
    __syncthreads();  // the previous tile's Ss and Vs are consumed
    for (int i = tid; i < BKV * DP; i += THREADS) {
      const int c = i / DP, j = i - (i / DP) * DP;
      const int t = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < Tn && j < d) {
        kx = to_f(kb[t * sk_t + j]);
        vx = to_f(vb[t * sv_t + j]);
      }
      Kt[j * (BKV + PAD) + c] = kx;
      Vs[c * (DP + PAD) + j] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int j = 0; j < DP; ++j) {
      const float4 qa = *reinterpret_cast<const float4*>(
          &Qt[j * (BQ + PAD) + 4 * ty]);
      const float4 kc = *reinterpret_cast<const float4*>(
          &Kt[j * (BKV + PAD) + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] += qv[a] * kv[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + 4 * tx + c;
        const bool keep = causal(col, r) && col < Tn;
        Ss[(4 * ty + a) * LDS + 4 * tx + c] = keep ? s[a][c] : NEG;
      }
    }
    __syncthreads();

    // the row's running max and sum over this tile (four threads a row,
    // lanes 4 sr .. 4 sr + 3 of one warp)
    float* srow = Ss + sr * LDS;
    float tmax = NEG;
#pragma unroll
    for (int c = 0; c < BKV / 4; ++c) tmax = fmaxf(tmax, srow[sq * (BKV / 4) + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < BKV / 4; ++c) {
      float* e = &srow[sq * (BKV / 4) + c];
      const float p = expf(*e - m_new);
      *e = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncwarp();  // the row's four quarters of p are written

    const int kn = min(BKV, Tn - k0);
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[c] *= alpha;
    for (int j = 0; j < kn; ++j) {
      const float p = srow[j];
      const float* vr = Vs + j * (DP + PAD) + sq * OC;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[c] += p * vr[c];
    }
  }

  if (row < Tn) {
    const float inv = 1.0f / l_run;
    const int ld = H * d;
    T* orow = o + (static_cast<long long>(row) * B + b) * ld +
              static_cast<long long>(h) * d;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int j = sq * OC + c;
      if (j < d) from_f(&orow[j], acc[c] * inv);
    }
  }
}

// ---------------------------------------------------------------- wgmma
constexpr int WQ = 64;            // query rows of a CTA: one warpgroup
constexpr int WK = 64;            // keys of a tile
constexpr int WG_THREADS = 160;   // the consumer warpgroup and a producer warp

// shared memory: q (NC chunks of 64 rows), a ring of NST stages, each a key
// tile's K then V chunks, the barriers; 57 KB at d <= 64, 81 KB at d = 128
template <int NC>
struct WgGeo {
  static constexpr int Q_BYTES = NC * WQ * 128;
  static constexpr int K_BYTES = NC * WK * 128;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int NST = NC == 1 ? 3 : 2;
  static constexpr int SMEM = 1024 + Q_BYTES + NST * STAGE + (1 + 2 * NST) * 8;
};

struct WgParams {
  CUtensorMap qmap, kmap, vmap;  // boxes of 64 columns x 64 times
  bf16* o;                       // contiguous (T, B, H d)
  int T, B, H, d, BH, ntiles;
  float scale;
};

// One CTA: query rows [64 qt, +64) of batch-head bh, the longest rows first
// (qt = ntiles - 1 - x / BH), walking key tiles 0 .. qt. A thread holds rows
// r_lo and r_lo + 8 of each fragment, columns 8 j + 2 (lane & 3) + {0, 1}.
template <int NC>
__global__ void __launch_bounds__(WG_THREADS, 2)
attention_fwd_wgmma(const __grid_constant__ WgParams p) {
  using G = WgGeo<NC>;
  constexpr int NO = NC * 32;  // output values a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + G::Q_BYTES;
  const uint32_t bars = ring + G::NST * G::STAGE;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (G::NST + s); };

  const int tid = threadIdx.x;
  const int qt = p.ntiles - 1 - static_cast<int>(blockIdx.x / p.BH);
  const int bh = static_cast<int>(blockIdx.x % p.BH);
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int q0 = qt * WQ;
  const int nkt = qt + 1;  // key tiles up to the diagonal (WK == WQ)
  const int Tn = p.T;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < G::NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // producer: q once, then the key tiles' K and V
    if (tid == 128) {
      mbar_expect(qfull, G::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(qs + c * WQ * 128, &p.qmap, c * 64, h, b, q0, qfull);
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t s0 = ring + st * G::STAGE;
        mbar_expect(full(st), G::STAGE);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(s0 + c * WK * 128, &p.kmap, c * 64, h, b, kt * WK,
                      full(st));
          tma_load_4d(s0 + G::K_BYTES + c * WK * 128, &p.vmap, c * 64, h, b,
                      kt * WK, full(st));
        }
        if (++st == G::NST) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int r_lo = q0 + 16 * (tid >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);

  mbar_wait(qfull, 0);
  float s[32], o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float mx[2] = {NEG, NEG}, lsum[2] = {0.f, 0.f};
  uint32_t hi[16], lo[16];  // 4 k16 steps x the 4 words of a fragment
  int st = 0, prev = -1;
  uint32_t ph = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    mbar_wait(full(st), ph);
    const uint32_t kb = ring + st * G::STAGE;
    fence_regs<32>(s);
    wgmma_fence();
    issue_scores<NC, WK>(s, qs, WQ * 128, kb, WK * 128);
    wgmma_commit();
    // also completes the last tile's P V: its stage is free, hi and lo
    // rewritable
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<NO>(o);
    fence_words<16>(hi);
    fence_words<16>(lo);
    if (prev >= 0 && tid == 0) mbar_arrive(empty(prev));
    const int k0 = kt * WK;
    // the scaled scores, masked outside a tile below the diagonal whose rows
    // lie inside T, and the tile's row max
    const bool inside = kt < qt && q0 + WQ <= Tn;
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rs = (i >> 1) & 1;
      float x = __fmul_rn(s[i], p.scale);
      if (!inside) {
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        if (!(causal(col, r_lo + 8 * rs) && col < Tn)) x = NEG;
      }
      s[i] = x;
      tmax[rs] = fmaxf(tmax[rs], x);
    }
    float alpha[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      tmax[rs] = fmaxf(tmax[rs], __shfl_xor_sync(0xffffffffu, tmax[rs], 1));
      tmax[rs] = fmaxf(tmax[rs], __shfl_xor_sync(0xffffffffu, tmax[rs], 2));
      const float mnew = fmaxf(mx[rs], tmax[rs]);
      alpha[rs] = __expf(mx[rs] - mnew);
      mx[rs] = mnew;
      lsum[rs] *= alpha[rs];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    // p = exp(s - m) in fp32, its sum, and its bf16 halves straight into the
    // A fragments (word 2 j + rs: row r_lo + 8 rs, columns k0 + 8 j + cq, + 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        const float p0 = __expf(s[4 * j + 2 * rs] - mx[rs]);
        const float p1 = __expf(s[4 * j + 2 * rs + 1] - mx[rs]);
        lsum[rs] += p0 + p1;
        const __nv_bfloat162 ph2 = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(ph2);
        hi[2 * j + rs] = *reinterpret_cast<const uint32_t*>(&ph2);
        lo[2 * j + rs] = pack_bf16(p0 - back.x, p1 - back.y);
      }
    fence_regs<NO>(o);
    fence_words<16>(hi);
    fence_words<16>(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      const uint64_t dv = desc_mn_lbo(kb + G::K_BYTES + ks * 16 * 128,
                                      WK * 128);
      if constexpr (NC == 1) {
        wgmma_rs_n64(o, hi + 4 * ks, dv);
        wgmma_rs_n64(o, lo + 4 * ks, dv);
      } else {
        wgmma_rs_n128(o, hi + 4 * ks, dv);
        wgmma_rs_n128(o, lo + 4 * ks, dv);
      }
    }
    wgmma_commit();  // waited for with the next tile's S
    prev = st;
    if (++st == G::NST) { st = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs<NO>(o);
  fence_words<16>(hi);
  fence_words<16>(lo);

#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    lsum[rs] += __shfl_xor_sync(0xffffffffu, lsum[rs], 1);
    lsum[rs] += __shfl_xor_sync(0xffffffffu, lsum[rs], 2);
  }
  const long long ld = static_cast<long long>(p.H) * p.d;
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int rs = (i >> 1) & 1;
    const int row = r_lo + 8 * rs;
    const int col = 8 * (i >> 2) + cq;
    const float inv = 1.0f / lsum[rs];
    if (row < Tn && col < p.d)
      *reinterpret_cast<__nv_bfloat162*>(
          p.o + (static_cast<long long>(row) * p.B + b) * ld +
          static_cast<long long>(h) * p.d + col) =
          __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
  }
}

// ---------------------------------------------------------------- launch
// plan: {design, grid x, grid y, tiles, rows, keys, threads}
template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int Tn,
           int B, int H, int d, const long long* strides, float scale,
           const int* plan, cudaStream_t stream) {
  if (plan[4] != BQ || plan[5] != BKV || plan[6] != THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes<DP>();
  auto kernel = attention_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(plan[1], plan[2]);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tn, B, H, d, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int Tn,
             int B, int H, int d, const long long* strides, float scale,
             const int* plan, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, Tn, B, H, d, strides, scale, plan, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, Tn, B, H, d, strides, scale, plan, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, Tn, B, H, d, strides, scale, plan, s);
  return launch<T, 256>(q, k, v, o, Tn, B, H, d, strides, scale, plan, s);
}

template <int NC>
int launch_wgmma(const WgParams& prm, int grid, cudaStream_t s) {
  auto kernel = attention_fwd_wgmma<NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgGeo<NC>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, WG_THREADS, WgGeo<NC>::SMEM, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core design: bf16, d <= 128, d % 8 == 0, 16-byte aligned views
// and strides (the wrapper's `_design`), on the wrapper's plan
int run_wgmma(const void* q, const void* k, const void* v, void* o, int Tn,
              int B, int H, int d, const long long* strides, float scale,
              const int* plan, cudaStream_t s) {
  if (d > 128 || d % 8 || plan[2] != 1 || plan[4] != WQ || plan[5] != WK ||
      plan[6] != WG_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  WgParams prm = {};
  int r = encode_view(enc, &prm.qmap, q, Tn, B, H, d, strides[0], strides[1],
                      WQ);
  if (r == 0)
    r = encode_view(enc, &prm.kmap, k, Tn, B, H, d, strides[2], strides[3],
                    WK);
  if (r == 0)
    r = encode_view(enc, &prm.vmap, v, Tn, B, H, d, strides[4], strides[5],
                    WK);
  if (r != 0) return -1000 - r;
  prm.o = static_cast<bf16*>(o);
  prm.T = Tn;
  prm.B = B;
  prm.H = H;
  prm.d = d;
  prm.BH = B * H;
  prm.ntiles = plan[3];
  prm.scale = scale;
  return d <= 64 ? launch_wgmma<1>(prm, plan[1], s)
                 : launch_wgmma<2>(prm, plan[1], s);
}

}  // namespace

// q, k, v: (T, B, H d) views of bf16 (is_bf16 = 1) or fp32 tensors with
// unit stride along the features; strides = {q_t, q_b, k_t, k_b, v_t, v_b}
// in elements. o: contiguous (T, B, H d) of the same type. d <= 256. plan:
// the wrapper's launch plan (`_plan`), {design, grid x, grid y, tiles, rows,
// keys, threads}, design 1 the wgmma kernel (bf16, d <= 128, d % 8 == 0,
// 16-byte aligned views and strides) and 0 the CUDA-core one; launched on
// its grid (and, for wgmma, its count of tiles) and refused unless its
// rows, keys and threads are the kernel's. Returns the launch error, or 0;
// the wgmma design -1 where the driver's cuTensorMapEncodeTiled is not
// found, -1000 - r where it refuses a descriptor with r.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int Tn, int B, int H, int d,
                             const long long* strides, float scale,
                             int is_bf16, const int* plan, void* stream) {
  if (Tn == 0 || B == 0 || H == 0) return 0;
  const bool wgmma = plan[0] != 0;
  if (d <= 0 || d > 256 || (wgmma && !is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma)
    return run_wgmma(q, k, v, o, Tn, B, H, d, strides, scale, plan, s);
  return is_bf16
             ? dispatch<bf16>(q, k, v, o, Tn, B, H, d, strides, scale, plan, s)
             : dispatch<float>(q, k, v, o, Tn, B, H, d, strides, scale, plan,
                               s);
}
