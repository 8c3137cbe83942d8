// Fused tied-decoder cross-entropy for training: the forward with per-token
// statistics and the two backward kernels, for sm_90a.
//
// Replaces bayeslms_tpu/ops/ce_pallas.py `_fwd_stats_kernel` (pallas_call
// in `_run_fwd_stats`, :291), `_bwd_dh_kernel` (`_run_bwd_dh`, :320) and
// `_bwd_de_kernel` (`_run_bwd_de`, :344), the custom VJP
// `fused_decode_ce_train`. With s_mv = h_m . E_v + b_v (bf16 products, fp32
// accumulation):
//   forward:  ce_m = log sum_v exp(s_mv) - s_{m,t_m}, and the statistics
//             max_m = max_v s_mv, sumexp_m = sum_v exp(s_mv - max_m);
//   backward: p_mv = exp(s_mv - max_m) / sumexp_m,
//             d_mv = a_m p_mv + b_m [v = t_m]   (a = g, b = -g for the CE),
//             dh_m = sum_v d_mv E_v      (d rounded to bf16, bf16 E),
//             dE_v = sum_m d_mv h_m      (d rounded to bf16, bf16 h), fp32,
//             db_v = sum_m d_mv          (fp32 d).
// The (M, V) scores never reach device memory: every kernel recomputes its
// score tiles. The forward (`score_tile`, wmma: mma.sync m16n8k16) and the
// backward (wgmma m64n64k16) both let the tensor cores accumulate a score
// over all of D in k16 steps in D's order, and on the H100 the two give
// the same bits: at V = 1, where d = a (p - 1), the backward's d is 0
// exactly, as the twin's (tests/test_torch_port_cuda.py, D = 256 to
// 2,304). So p <= 1 and d agrees with the forward's max and sum-exp. PTX
// does not promise that equality. The backward keeps the forward's order
// on purpose: summing 64-deep parts in fp32 instead rounds less, but leaves
// p off the forward's statistics by the forward's own rounding, which
// moved db at the long step's M = 32,768 past its float64 tolerance in
// chip_smoke.py.
//
// Differences from the TPU kernels: no padding of M to the token tile and
// none of V with a -1e30 bias; the kernels mask the ragged edges. The
// statistics and coefficients are (M,) vectors, not (M, 8) / (M, 16)
// broadcasts.
//
// Forward (row 9, `ce_stats_kernel`): tiles of BM = 64 tokens x BV = 64
// vocabulary rows, 8 warps; a block owns 64 tokens and walks the
// vocabulary, folding each score tile into running max, sum-exp and target
// logit (four threads a token), as ce_fwd.cu does at 128 x 128. Bound: 2 M
// V D = 322 GFLOP, 0.33 ms at (M 3,200, V 49,152, D 1,024), operations; it
// takes 18.3 ms there (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): 50 blocks on 132 SMs, synchronous wmma (ROADMAP B.1).
//
// Backward (rows 10 and 11, `ce_bwd_kernel<DE>`). One template serves both:
// an "own" operand X indexes the output rows and a "walked" operand W the
// contraction of the d product (dh: X = h, W = E; dE: X = E, W = h). A score
// tile S[i][j] = X[own0 + i] . W[w0 + j] (128 x 64) is then d (dh) or d^T
// (dE), the A operand of out[own0 + i][slice] += d[i][j] W[w0 + j][slice].
//   Bound (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s at 700 W): the
//   score products 2 M V D and the d products 2 M V D, 4 M V D = 644 GFLOP
//   or 0.651 ms at (M 3,200, V 49,152, D 1,024); the bytes (0.1 GB of E,
//   0.2 GB of fp32 dE) are a smaller bound. Operations bound. Measured
//   (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): 1.86 ms
//   (dh) and 2.05 ms (dE, db) there, 0.35 and 0.32 of the bound.
//   Design. A (128 x D) fp32 output tile does not fit a CTA, so D is cut
//   into C = D / 256 slices, one a CTA, and the C CTAs of a thread-block
//   cluster share each score tile instead of each recomputing it: the
//   cluster walks W in groups of C tiles of 64 rows; in each group rank r
//   computes score tile r over the full K = D, forms d in registers, rounds
//   it to bf16 into its shared memory in the swizzled layout wgmma reads,
//   and pushes it to every peer (cp.async.bulk shared::cta ->
//   shared::cluster, completing on the peer's mbarrier); every rank then
//   multiplies the group's C d tiles by its own 256 columns of W. Each
//   score is computed once: 2 M V D + 2 M V D = 4 M V D executed, the
//   bound's count, for D <= 2,048 (C <= 8, the portable cluster); past that
//   ceil(D / 2,048) clusters share an output tile, each computing its own
//   score tiles ((2 ceil(D / 2,048) + 2) M V D). A slot is overwritten
//   only after every peer has said (a remote mbarrier arrive) that it has
//   read it.
//   Each CTA: a producer warp issues every operand load by TMA (128-byte
//   swizzle, mbarrier completion) into a ring of 32 KB stages, in the order
//   the two consumer warpgroups (64 output rows each) take them: a score
//   chunk (128 x 64 of X, 64 x 64 of W) or a d-product tile (64 x 256 of W,
//   MN-major, read through the descriptor's transpose bit, not copied).
//   The consumers run wgmma m64n64k16 (scores) and m64n256k16 (the 64 x 256
//   fp32 output slice, in registers for the whole walk); setmaxnreg gives
//   them 240 registers and the producer 24. The d epilogue works on the
//   score fragments: max, 1/sumexp, a, b and the target of the tile's rows
//   or columns loaded once a tile, the bias once a column; no fp32 score
//   tile in shared memory and no division per element.
//   dh (row 10): the vocabulary walk of a token tile can be split into S
//   parts (`_bwd_plan` in ops/ce_train_cuda.py picks S from the SMs and the
//   clusters the card holds); the parts write fp32 partials to an (S, M, D)
//   workspace, and `ce_dh_reduce` sums them in a fixed order and rounds
//   once to bf16. No atomics: two runs give the same bits.
//   dE (row 11): no split (V / 128 tiles fill the card); db is each CTA's
//   column sums of its fp32 d tiles, summed over the cluster's ranks in
//   rank order through distributed shared memory, written by rank 0.
//   The TMA descriptors come from cuTensorMapEncodeTiled, a driver-API
//   function this library does not link: it is found at run time through
//   cudaGetDriverEntryPoint.

#include <cuda.h>  // CUtensorMap and its enums; the library links no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // tokens per tile
constexpr int BV = 64;        // vocabulary rows per tile
constexpr int BK = 32;        // contraction chunk of the score products
constexpr int LDA = BK + 8;   // bf16 pitch of the h and E chunks
constexpr int LDS = BV + 4;   // fp32 pitch of the score tile
constexpr int THREADS = 256;  // 8 warps

constexpr int SM_A = BM * LDA * 2;
constexpr int SM_B = BV * LDA * 2;
constexpr int SM_S = BM * LDS * 4;
constexpr int SMEM_FWD = SM_A + SM_B + SM_S;

// Ss[r][c] = h[m0 + r] . E[v0 + c] over all D, for the 64 x 64 tile; rows
// past M and V read zeros. 8 warps of 16 x 32. Ends synchronised.
__device__ void score_tile(const bf16* __restrict__ h,
                           const bf16* __restrict__ emb, int m0, int v0,
                           int M, int V, int D, bf16* As, bf16* Bs,
                           float* Ss) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows [16 wr, 16 wr + 16)
  const int wc = warp & 1;   // columns [32 wc, 32 wc + 32)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < D; k0 += BK) {
    {
      const int r = tid / (BK / 8);  // 64 rows x 4 chunks = 256 threads
      const int c = (tid % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(h + (size_t)(m0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
      v = make_uint4(0u, 0u, 0u, 0u);
      if (v0 + r < V)
        v = *reinterpret_cast<const uint4*>(emb + (size_t)(v0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(Bs + r * LDA + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, Bs + (wc * 32 + j * 16) * LDA + ks, LDA);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Ss + (wr * 16) * LDS + wc * 32 + j * 16, acc[j],
                            LDS, wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
ce_stats_kernel(const bf16* __restrict__ h, const bf16* __restrict__ emb,
                const float* __restrict__ bias, const int* __restrict__ tgt,
                float* __restrict__ ce, float* __restrict__ mx,
                float* __restrict__ se, int M, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + SM_A);
  float* Ss = reinterpret_cast<float*>(smem + SM_A + SM_B);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  // the four threads of a token: lanes 4k .. 4k+3 of one warp
  const int row = tid >> 2;
  const int part = tid & 3;
  const int m = m0 + row;
  const int target = m < M ? tgt[m] : -1;
  float run_max = -1e30f, run_sum = 0.f, run_tgt = 0.f;
  for (int v0 = 0; v0 < V; v0 += BV) {
    score_tile(h, emb, m0, v0, M, V, D, As, Bs, Ss);
    const float* srow = Ss + row * LDS + part * 16;
    const int vbase = v0 + part * 16;
    const int n = max(0, min(16, V - vbase));
    float tmax = -1e30f;
    for (int c = 0; c < n; ++c) tmax = fmaxf(tmax, srow[c] + bias[vbase + c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float new_max = fmaxf(run_max, tmax);
    float s = 0.f, tl = 0.f;
    for (int c = 0; c < n; ++c) {
      const float x = srow[c] + bias[vbase + c];
      s += expf(x - new_max);
      if (vbase + c == target) tl = x;
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    tl += __shfl_xor_sync(0xffffffffu, tl, 1);
    tl += __shfl_xor_sync(0xffffffffu, tl, 2);
    run_sum = run_sum * expf(run_max - new_max) + s;
    run_max = new_max;
    run_tgt += tl;
    // the next tile's score store waits behind score_tile's barriers, which
    // every thread reaches only after it has folded this tile
  }
  if (part == 0 && m < M) {
    ce[m] = logf(run_sum) + run_max - run_tgt;
    mx[m] = run_max;
    se[m] = run_sum;
  }
}

// ------------------------------------------------------------------ backward

constexpr int OWN = 128;    // output rows of a tile: two consumer warpgroups
constexpr int WALK = 64;    // walked rows of a score tile
constexpr int KC = 64;      // D columns of a score chunk: one 128-byte row
constexpr int SLICE = 256;  // output columns a CTA owns
constexpr int MAX_C = 8;    // the portable cluster size
constexpr int MAX_NST = 6;  // ring stages at most
constexpr int X_BYTES = OWN * KC * 2;    // 16 KB: a chunk of X
constexpr int W_BYTES = WALK * KC * 2;   // 8 KB: a chunk of W
constexpr int STAGE = WALK * SLICE * 2;  // 32 KB: a d-product tile of W
constexpr int DTILE = OWN * WALK * 2;    // 16 KB: a bf16 d tile
constexpr int VEC = 5 * WALK;  // a warpgroup's staged per-column values
constexpr int BWD_THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int SMEM_LIMIT = 232448;

struct BwdParams {
  CUtensorMap xmap;  // X (n_own, D) bf16, boxes of 64 columns x 128 rows
  CUtensorMap wmap;  // W (n_walk, D) bf16, boxes of 64 columns x 64 rows
  const float* bias;
  const int* tgt;
  const float* mx;
  const float* se;
  const float* ca;
  const float* cb;
  void* out;  // dh (M, D) bf16, or dE (V, D) fp32
  float* ws;  // dh partials (splits, M, D) fp32, where splits > 1
  float* db;  // (V) fp32, dE only
  int M, D, n_own, n_walk;
  int C, n_slices, n_groups, splits, nst;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// the address of `a`'s counterpart in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(peer(bar, rank)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// the same, acquiring what peers released at cluster scope
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at (c0 columns, c1 rows) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// `bytes` at src to the same offset in CTA `rank`, completing on that CTA's
// barrier at the offset of `bar`
__device__ __forceinline__ void push_peer(uint32_t src, uint32_t bytes,
                                          uint32_t bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(peer(src, rank)), "r"(src), "r"(bytes), "r"(peer(bar, rank))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of r across the asynchronous
// products that read and write it
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma descriptors of tiles in TMA's 128-byte swizzle (rows of 128 bytes,
// the 16-byte chunks of row r XOR-ed with r % 8, 8-row atoms of 1 KB).
// K-major (X, W chunks and the d tiles): 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// MN-major B of the d product (K = 64 walked rows x N = 256 columns, four
// 64-column boxes of 8 KB): the next 64 columns 8 KB on, the next 8 rows of
// K 1,024 bytes on.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}


// byte offset of bf16 element (row, col) in a swizzled tile of 64 columns
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A and B bf16 in shared memory
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16) B (16 x 256), A and B bf16 in shared memory
__device__ __forceinline__ void wgmma_n256_tb(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// One CTA: rank r of a cluster of C owns output rows [128 y, +128) x
// columns [256 slice, +256), slice = (x / C) C + r, and walks the groups
// [g0, g1) of split z (group j: walked tiles j C .. j C + C - 1). The
// layout of its dynamic shared memory, 1 KB aligned: the ring (nst x 32
// KB), the d slots (C x 16 KB; slot c holds rank c's tile of the group),
// two warpgroups' staged column values, the db partials, the barriers.
template <bool DE>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ce_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int C = p.C, nst = p.nst;
  float* vecs = reinterpret_cast<float*>(smem + nst * STAGE + C * DTILE);
  float* sdb = vecs + 2 * VEC;
  const uint32_t ring = smem_u32(smem);
  const uint32_t slots = ring + nst * STAGE;
  const uint32_t bars = smem_u32(sdb + OWN);
  // full[s], empty[s] guard ring stage s; dfull[c] slot c's arrival; dfree
  // counts the peers' releases of this CTA's tile
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_NST + s); };
  auto dfull = [&](int c) { return bars + 8 * (2 * MAX_NST + c); };
  const uint32_t dfree = bars + 8 * (2 * MAX_NST + MAX_C);

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int rank = (int)cluster_rank();
  const int slice = (blockIdx.x / C) * C + rank;
  const bool has_slice = slice < p.n_slices;
  const int own0 = blockIdx.y * OWN;
  const int split = blockIdx.z;
  const int g0 = (int)((long long)split * p.n_groups / p.splits);
  const int g1 = (int)((long long)(split + 1) * p.n_groups / p.splits);
  const int n_wt = (p.n_walk + WALK - 1) / WALK;
  const int nk = p.D / KC;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    for (int c = 0; c < C; ++c) mbar_init(dfull(c), 1);
    mbar_init(dfree, C > 1 ? 2 * (C - 1) : 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid >= 256) {
    // producer: one thread issues the loads in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int j = g0; j < g1; ++j) {
        const int ts = j * C + rank;
        if (ts < n_wt) {
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(empty(st), ph ^ 1);
            mbar_expect(full(st), X_BYTES + W_BYTES);
            tma_load(ring + st * STAGE, &p.xmap, kc * KC, own0, full(st));
            tma_load(ring + st * STAGE + X_BYTES, &p.wmap, kc * KC,
                     ts * WALK, full(st));
            if (++st == nst) { st = 0; ph ^= 1; }
          }
        }
        if (has_slice) {
          for (int c = 0; c < C && j * C + c < n_wt; ++c) {
            mbar_wait(empty(st), ph ^ 1);
            mbar_expect(full(st), STAGE);
            for (int q = 0; q < SLICE / KC; ++q)
              tma_load(ring + st * STAGE + q * W_BYTES, &p.wmap,
                       slice * SLICE + q * KC, (j * C + c) * WALK, full(st));
            if (++st == nst) { st = 0; ph ^= 1; }
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();
    if (DE) cluster_sync();
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, +64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  // the thread's rows of a fragment: rbase, rbase + 8; its columns cbase +
  // 8 n, + 1
  const int rbase = 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  float* vec = vecs + wg * VEC;

  // the values of the thread's own rows, once
  float rbias[2], rmx[2], rinv[2], ra[2], rb[2];
  int rt[2];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int row = own0 + rbase + 8 * rs;
    const bool ok = row < p.n_own;
    if (DE) {
      rbias[rs] = ok ? p.bias[row] : -inf;
    } else {
      rmx[rs] = ok ? p.mx[row] : inf;
      rinv[rs] = ok ? 1.0f / p.se[row] : 0.f;
      ra[rs] = ok ? p.ca[row] : 0.f;
      rb[rs] = ok ? p.cb[row] : 0.f;
      rt[rs] = ok ? p.tgt[row] : -1;
    }
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float dbsum[2] = {0.f, 0.f};
  int st = 0;
  uint32_t ph = 0;
  const uint32_t myslot = slots + rank * DTILE;

  for (int j = g0; j < g1; ++j) {
    const int ts = j * C + rank;
    if (ts < n_wt) {
      // the walked rows' values: the bias (dh) or the token's statistics,
      // coefficients and target (dE)
      if (t < WALK) {
        const int w = ts * WALK + t;
        const bool ok = w < p.n_walk;
        if (DE) {
          vec[t] = ok ? p.mx[w] : inf;
          vec[WALK + t] = ok ? 1.0f / p.se[w] : 0.f;
          vec[2 * WALK + t] = ok ? p.ca[w] : 0.f;
          vec[3 * WALK + t] = ok ? p.cb[w] : 0.f;
          vec[4 * WALK + t] = __int_as_float(ok ? p.tgt[w] : -1);
        } else {
          vec[t] = ok ? p.bias[w] : -inf;
        }
      }
      named_sync(2 + wg, 128);

      // the score tile, the tensor cores accumulating over all of D in
      // k16 steps in D's order, as the forward's mma.sync does: the scores
      // come out as the forward's (see the header)
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      int prev = -1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(full(st), ph);
        const uint32_t base = ring + st * STAGE;
        fence_regs<32>(s);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          wgmma_n64(s, desc_k(base + wg * 64 * 128 + 32 * k),
                    desc_k(base + X_BYTES + 32 * k));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<32>(s);
        if (prev >= 0 && t == 0) mbar_arrive(empty(prev));
        prev = st;
        if (++st == nst) { st = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs<32>(s);
      if (t == 0) mbar_arrive(empty(prev));

      // the slot is free once every peer has read the last group's tile
      if (C > 1 && j > g0) mbar_wait_cluster(dfree, (j - g0 - 1) & 1);
      // d from the fragments, rounded to bf16 into this rank's slot
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int rs = (i >> 1) & 1;
        const int col = (i >> 2) * 8 + cbase;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          if (DE) {
            const float pr = expf(s[i + e] + rbias[rs] - vec[c]) *
                             vec[WALK + c];
            const bool hit = __float_as_int(vec[4 * WALK + c]) ==
                             own0 + rbase + 8 * rs;
            d[e] = vec[2 * WALK + c] * pr + (hit ? vec[3 * WALK + c] : 0.f);
            dbsum[rs] += d[e];
          } else {
            const float pr = expf(s[i + e] + vec[c] - rmx[rs]) * rinv[rs];
            d[e] = ra[rs] * pr + (ts * WALK + c == rt[rs] ? rb[rs] : 0.f);
          }
        }
        const __nv_bfloat162 pk = __floats2bfloat162_rn(d[0], d[1]);
        asm volatile("st.shared.b32 [%0], %1;"
                     :: "r"(myslot + swizzled(rbase + 8 * rs, col)),
                        "r"(*reinterpret_cast<const uint32_t*>(&pk))
                     : "memory");
      }
      // visible to the async proxy (wgmma here, the bulk copies) once both
      // warpgroups have written
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, 256);
      if (tid == 0)
        for (int c = 0; c < C; ++c)
          if (c != rank) push_peer(myslot, DTILE, dfull(rank), c);
    }

    // the d product over the group's tiles, in the producer's order
    if (tid == 0)
      for (int c = 0; c < C && j * C + c < n_wt; ++c)
        if (c != rank) mbar_expect(dfull(c), DTILE);
    int prev = -1;
    for (int c = 0; c < C && j * C + c < n_wt; ++c) {
      if (c != rank) mbar_wait(dfull(c), (j - g0) & 1);
      if (has_slice) {
        mbar_wait(full(st), ph);
        const uint32_t a = slots + c * DTILE + wg * 64 * 128;
        const uint32_t b = ring + st * STAGE;
        fence_regs<128>(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < WALK / 16; ++k)
          wgmma_n256_tb(acc, desc_k(a + 32 * k), desc_mn(b + 16 * 128 * k));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<128>(acc);
        if (prev >= 0 && t == 0) mbar_arrive(empty(prev));
        prev = st;
        if (++st == nst) { st = 0; ph ^= 1; }
      }
    }
    if (prev >= 0) {
      wgmma_wait<0>();
      fence_regs<128>(acc);
      if (t == 0) mbar_arrive(empty(prev));
    }
    // this warpgroup has read the peers' tiles of the group (every thread
    // past its waits on them, so that no wait misses a phase)
    if (C > 1 && j + 1 < g1) {
      named_sync(2 + wg, 128);
      if (t == 0)
        for (int c = 0; c < C; ++c)
          if (c != rank) mbar_arrive_peer(dfree, c);
    }
  }

  if (has_slice) {
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = own0 + rbase + 8 * ((i >> 1) & 1);
      const int col = slice * SLICE + (i >> 2) * 8 + cbase;
      if (row < p.n_own) {
        const size_t o = (size_t)row * p.D + col;
        if (DE)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(acc[i], acc[i + 1]);
        else if (p.splits > 1)
          *reinterpret_cast<float2*>(p.ws + (size_t)split * p.M * p.D + o) =
              make_float2(acc[i], acc[i + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
  }
  if (DE) {
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      float v = dbsum[rs];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) sdb[rbase + 8 * rs] = v;
    }
  }
  cluster_sync();
  if (DE) {
    // db: the ranks' sums in rank order, by rank 0 of the first cluster of
    // slices (the others computed the same tiles)
    if (rank == 0 && (int)blockIdx.x < C && tid < OWN &&
        own0 + tid < p.n_own) {
      float v = 0.f;
      for (int c = 0; c < C; ++c) {
        float x;
        asm volatile("ld.shared::cluster.f32 %0, [%1];"
                     : "=f"(x) : "r"(peer(smem_u32(sdb + tid), c))
                     : "memory");
        v += x;
      }
      p.db[own0 + tid] = v;
    }
    cluster_sync();
  }
}

// dh = the splits' partials summed in order, rounded once; n = M D
__global__ void ce_dh_reduce(const float* __restrict__ ws,
                             bf16* __restrict__ out, int splits, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < splits; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(ws + k * n + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
  o[0] = __floats2bfloat162_rn(s.x, s.y);
  o[1] = __floats2bfloat162_rn(s.z, s.w);
}

// C, clusters of slices G, ring stages and dynamic shared memory at width D
struct BwdShape {
  int C, G, nst, smem;
};

BwdShape bwd_shape(int D) {
  BwdShape s;
  const int slices = D / SLICE;
  s.G = (slices + MAX_C - 1) / MAX_C;
  s.C = (slices + s.G - 1) / s.G;
  const int fixed = 1024 + s.C * DTILE + (2 * VEC + OWN) * 4 +
                    (2 * MAX_NST + MAX_C + 1) * 8;
  s.nst = (SMEM_LIMIT - fixed) / STAGE;
  if (s.nst > MAX_NST) s.nst = MAX_NST;
  s.smem = fixed + s.nst * STAGE;
  return s;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (rows, D) bf16 row-major tensor in boxes of 64 columns x box_rows rows,
// 128-byte swizzle, zeros past the edges
int encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
               int D, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

const void* bwd_kernel(int which) {
  return which ? reinterpret_cast<const void*>(ce_bwd_kernel<true>)
               : reinterpret_cast<const void*>(ce_bwd_kernel<false>);
}

cudaLaunchConfig_t bwd_config(const BwdShape& s, dim3 grid,
                              cudaLaunchAttribute* attr, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = s.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// h (M, D) bf16, emb (V, D) bf16, bias (V) fp32, tgt (M) int32 -> ce, mx,
// se (M) fp32. Returns the launch error, or 0.
extern "C" int ce_train_fwd(const void* h, const void* emb, const void* bias,
                            const void* tgt, void* ce, void* mx, void* se,
                            int M, int V, int D, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  ce_stats_kernel<<<(M + BM - 1) / BM, THREADS, SMEM_FWD,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(emb),
      static_cast<const float*>(bias), static_cast<const int*>(tgt),
      static_cast<float*>(ce), static_cast<float*>(mx),
      static_cast<float*>(se), M, V, D);
  return (int)cudaGetLastError();
}
// The backward kernels: as the forward, plus mx, se (M) fp32 from it and the
// coefficients a, b (M) fp32. which = 0: dh (M, D) bf16 into out (db
// unused); which = 1: dE (V, D) fp32 into out and db (V) fp32. D must be a
// multiple of 256. splits: the parts of dh's vocabulary walk (dE takes 1);
// above 1, ws is an (splits, M, D) fp32 workspace. Returns the launch
// error, or 0; -1 where the driver's cuTensorMapEncodeTiled is not found,
// -1000 - r where it refuses a descriptor with r.
extern "C" int ce_train_bwd(int which, const void* h, const void* emb,
                            const void* bias, const void* tgt, const void* mx,
                            const void* se, const void* a, const void* b,
                            void* out, void* db, void* ws, int M, int V,
                            int D, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool de = which != 0;
  const int n_own = de ? V : M, n_walk = de ? M : V;
  const BwdShape s = bwd_shape(D);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel(which), cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return (int)err;
  if (n_own == 0) return 0;
  if (n_walk == 0) {  // nothing to sum
    err = cudaMemsetAsync(out, 0, (size_t)n_own * D * (de ? 4 : 2), st);
    if (err == cudaSuccess && de)
      err = cudaMemsetAsync(db, 0, (size_t)V * 4, st);
    return (int)err;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  BwdParams prm = {};
  int r = encode_map(enc, &prm.xmap, de ? emb : h, n_own, D, OWN);
  if (r == 0) r = encode_map(enc, &prm.wmap, de ? h : emb, n_walk, D, WALK);
  if (r != 0) return -1000 - r;
  prm.bias = static_cast<const float*>(bias);
  prm.tgt = static_cast<const int*>(tgt);
  prm.mx = static_cast<const float*>(mx);
  prm.se = static_cast<const float*>(se);
  prm.ca = static_cast<const float*>(a);
  prm.cb = static_cast<const float*>(b);
  prm.out = out;
  prm.ws = static_cast<float*>(ws);
  prm.db = static_cast<float*>(db);
  prm.M = M;
  prm.D = D;
  prm.n_own = n_own;
  prm.n_walk = n_walk;
  prm.C = s.C;
  prm.n_slices = D / SLICE;
  prm.n_groups = ((n_walk + WALK - 1) / WALK + s.C - 1) / s.C;
  prm.splits = de ? 1 : splits;
  prm.nst = s.nst;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_config(
      s, dim3(s.C * s.G, (n_own + OWN - 1) / OWN, prm.splits), &attr, st);
  void* args[] = {&prm};
  err = cudaLaunchKernelExC(&cfg, bwd_kernel(which), args);
  if (err != cudaSuccess) return (int)err;
  if (prm.splits > 1) {
    const size_t n = (size_t)M * D;
    ce_dh_reduce<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(out), prm.splits,
        n);
  }
  return (int)cudaGetLastError();
}

// The clusters of the backward kernel `which` at width D that the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus the error.
extern "C" int ce_train_bwd_clusters(int which, int D) {
  const BwdShape s = bwd_shape(D);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel(which), cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      bwd_config(s, dim3(s.C * s.G, 1, 1), &attr, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, bwd_kernel(which), &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

