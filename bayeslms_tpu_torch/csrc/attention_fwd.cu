// Causal multi-head self-attention forward, for sm_90a.
//
// Replaces bayeslms_tpu/ops/attention_pallas.py `causal_attention_pallas`
// (the `_kernel` body that `_run` hands to pallas_call). For each batch
// column b, head h and query row r:
//   s_c = (q_r d^-1/2) . k_c  for c <= r,  -1e30 for c > r
//   o_r = sum_c softmax(s)_c v_c
// with q scaled in fp32, an fp32 softmax and P kept in fp32 for P . V, as
// the TPU kernel keeps it: P is never rounded to bf16. The output is in the
// input dtype (bf16 or fp32).
//
// Differences from the TPU kernel: the TPU block holds the whole K and V of
// its (batch x head) row in VMEM; at T = 8,192 and d = 64 those are 2 MiB,
// far more than an SM's 227 KB of shared memory. This kernel streams K and V
// through shared memory in tiles of 64 keys with a running max and sum per
// query row (the same function, summed in another order), and skips the key
// tiles that lie wholly above the diagonal. It reads q, k and v in the
// model's time-major layout through their strides (element (t, b, h, j) at
// t st + b sb + h d + j), so the qkv projection's column slices need no
// copy and no (B h, T, d) transpose, and it masks the ragged edges of T
// itself: no padding of T to the query tile.
//
// Design: a block owns 64 query rows of one (b, h) and 256 threads. Per key
// tile it forms the 64 x 64 score tile in fp32 on the CUDA cores (each
// thread a 4 x 4 patch, q and k transposed in shared memory), parks it in
// shared memory, and four threads per query row fold it into the row's
// running max m and sum l, turn it into p = exp(s - m) and update their
// quarter of the row's output accumulator o = alpha o + p V in registers.
// d up to 256 (any multiple of 8); the tile widths are a template of 32, 64,
// 128 or 256 columns, and columns past d are zero.
//
// Bound on the H100 at the eval shape (B h = 20 x 8, T = 100, d = 64): the
// causal work is ~T^2 d B h (2 x 0.5 x 2 products) ~ 0.2 GFLOP and the
// bytes 4 x 160 x 100 x 64 x 2 = 8 MB: 2.5 us of memory, a few us of fp32
// arithmetic (67 TFLOP/s). At long T the kernel is bound by its fp32
// arithmetic, far from the tensor cores' 989 TFLOP/s bf16; wmma/wgmma for
// S = Q K^T (P in fp32 kept, or rounded for a tensor-core P V) is the
// later redesign.
//
// Compile-time fault for chip_smoke.py's planted-fault check (never set by
// the port): ATTENTION_FAULT=1 masks the diagonal too (c >= r), so a row
// no longer attends to itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
#if ATTENTION_FAULT == 1
        const bool keep = col < r && col < Tn;
#else
        const bool keep = col <= r && col < Tn;
#endif
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

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int Tn,
           int B, int H, int d, const long long* strides, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  auto kernel = attention_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Tn + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tn, B, H, d, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int Tn,
             int B, int H, int d, const long long* strides, float scale,
             cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, Tn, B, H, d, strides, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, Tn, B, H, d, strides, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, Tn, B, H, d, strides, scale, stream);
  return launch<T, 256>(q, k, v, o, Tn, B, H, d, strides, scale, stream);
}

}  // namespace

// q, k, v: (T, B, H d) views of bf16 (is_bf16 = 1) or fp32 tensors with
// unit stride along the features; strides = {q_t, q_b, k_t, k_b, v_t, v_b}
// in elements. o: contiguous (T, B, H d) of the same type. d <= 256.
// Returns the launch error, or 0.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int Tn, int B, int H, int d,
                             const long long* strides, float scale,
                             int is_bf16, void* stream) {
  if (Tn == 0 || B == 0 || H == 0) return 0;
  if (d <= 0 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(q, k, v, o, Tn, B, H, d, strides, scale, s)
                 : dispatch<float>(q, k, v, o, Tn, B, H, d, strides, scale, s);
}
