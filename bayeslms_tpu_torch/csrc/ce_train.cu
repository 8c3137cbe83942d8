// Fused tied-decoder cross-entropy for training: the forward with per-token
// statistics and the two backward kernels, for sm_90a.
//
// Replaces bayeslms_tpu/ops/ce_pallas.py `_fwd_stats_kernel` (pallas_call
// in `_run_fwd_stats`, :291), `_bwd_dh_kernel` (`_run_bwd_dh`, :320) and
// `_bwd_de_kernel` (`_run_bwd_de`, :344), the custom VJP
// `fused_decode_ce_train`; the forward also replaces `_kernel` (`_run`,
// :90; kernel row 2, the scoring CE `fused_decode_ce`), whose per-token ce
// is the forward's without the statistics (ops/ce_cuda.py launches it at
// D % 64 == 0 and drops max and sum-exp). With s_mv = h_m . E_v + b_v (bf16
// products, fp32 accumulation):
//   forward:  ce_m = log sum_v exp(s_mv) - s_{m,t_m}, and the statistics
//             max_m = max_v s_mv, sumexp_m = sum_v exp(s_mv - max_m);
//   backward: p_mv = exp(s_mv - max_m) / sumexp_m,
//             d_mv = a_m p_mv + b_m [v = t_m]   (a = g, b = -g for the CE),
//             dh_m = sum_v d_mv E_v      (d rounded to bf16, bf16 E),
//             dE_v = sum_m d_mv h_m      (d rounded to bf16, bf16 h), fp32,
//             db_v = sum_m d_mv          (fp32 d).
// The (M, V) scores never reach device memory: every kernel recomputes its
// score tiles, all three with one arithmetic, on K-major tiles in TMA's
// 128-byte swizzle: a score is the sum of D's 64-deep chunks in D's order,
// each chunk's product the tensor cores' (wgmma m64nNk16, the forward N =
// 128, the backward N = 64, over the chunk's four k16 steps from zero), the
// chunks added in fp32 registers from zero (rounded to nearest), then the
// bias, s + b_v in fp32. The tensor cores' fp32 sums truncate: accumulating
// a score over all of D in their k16 steps left it below float64 by a bias
// that grows with D and |s| (the row max 5.3e-6 low on average at D =
// 1,024, tools/ce_db_margin.py), which put db 2-4x farther from float64
// than the plain twin's and one card test past its tolerance; a 64-deep
// chunk gives the truncation only a part of the score to act on (PERF.md).
// The backward's d is consistent with the forward's max and sum-exp
// only if the two compute the same bits for every score; with one
// arithmetic they do on the H100: at V = 1, where d = a (p - 1), ce, dh, dE
// and db are 0 exactly, and with 256 equal rows of E every score of a token
// is the same in every column of both kernels' tiles
// (tests/test_torch_port_cuda.py, D = 256 to 2,304). PTX does not promise
// that equality; those tests hold it. A change to one kernel's score
// arithmetic is a change to all three: a backward that alone summed 64-deep
// parts left p off the forward's statistics, and db at the long step's M =
// 32,768 past its float64 tolerance in chip_smoke.py.
//
// Differences from the TPU kernels: no padding of M to the token tile and
// none of V with a -1e30 bias; the kernels mask the ragged edges. The
// statistics and coefficients are (M,) vectors, not (M, 8) / (M, 16)
// broadcasts.
//
// Forward (row 9, `ce_stats_split` and `ce_stats_merge`).
//   Bound (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s at 700 W): the
//   score products, 2 M V D = 322 GFLOP or 0.326 ms at (M 3,200, V 49,152,
//   D 1,024); the bytes (0.1 GB of E) are a smaller bound. Operations
//   bound. Executed: 2 M' V' D, M' and V' rounded up to the 128-token and
//   256-word tiles (the padding masked): the bound's count at that shape.
//   Measured: chip_smoke.py prints the time and the share of the bound
//   (PERF.md, kernel table, row 9; 18.3 ms before this design).
//   Design. A CTA owns 128 tokens: two consumer warpgroups of 64 and a
//   producer warp that issues every operand load by TMA (128-byte swizzle,
//   mbarrier completion) into a ring of four 48 KB stages, each a K chunk
//   of 64 columns of h (128 rows) and of E (256 rows). A consumer holds its
//   64 x 256 fp32 score tile in 128 registers a thread and takes each
//   chunk's product in two m64n128k16 halves through a buffer of 64 (the
//   halves' fragments side by side are the m64n256 one's), each added to
//   the tile when done; while one warpgroup waits for a half and adds it,
//   the other's products run (setmaxnreg: 240 for them, 24 for the
//   producer). The wait costs: the same tiles accumulated over all of D in
//   the tensor cores ran 1.3-1.5x faster (PERF.md); a second buffer, to
//   overlap a half's product with the last one's addition, does not fit
//   in the registers, and at 128 columns two buffers spilled and still ran
//   slower, reading h from L2 twice as often. Each thread folds its two
//   rows of a finished tile straight from the fragments: s + b (the bias
//   staged in shared memory once a column, -inf past V, where TMA's zero
//   rows of E would score the bias), the row max over the row's four lanes
//   by shuffles, the lane's own sum of exp against the running max, and
//   the target's logit where the lane holds it; no fp32 score tile in
//   shared memory. The producer is up to four stages ahead, so the next
//   tile's loads are in flight while one is folded. Clusters of two token
//   tiles sharing each E chunk by TMA multicast measured slower than
//   single CTAs (PERF.md) and were not kept.
//   The walk over V is split into S parts where the token tiles alone do
//   not fill the card (`_fwd_plan` in ops/ce_train_cuda.py: S = 5 at M =
//   3,200, 1 at M = 32,768); the grid's x is the token tile, so one part's
//   CTAs run, and walk E, together. Each part writes its (max, sum-exp,
//   target logit) partials to a (3, S, M) workspace and `ce_stats_merge`
//   combines them per token in part order: max = max_p max_p, sumexp =
//   sum_p sumexp_p exp(max_p - max), ce = log sumexp + max - s_target. No
//   atomics: two calls give the same bits.
//
// Backward (rows 10 and 11, `ce_bwd_kernel<DE>`). One template serves both:
// an "own" operand X indexes the output rows and a "walked" operand W the
// contraction of the d product (dh: X = h, W = E; dE: X = E, W = h). A score
// tile S[i][j] = X[own0 + i] . W[w0 + j] (128 x 64) is then d (dh) or d^T
// (dE), the A operand of out[own0 + i][slice] += d[i][j] W[w0 + j][slice].
//   Bound (H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s at 700 W): the
//   score products 2 M V D and the d products 2 M V D, 4 M V D = 644 GFLOP
//   or 0.651 ms at (M 3,200, V 49,152, D 1,024); the bytes (0.1 GB of E,
//   0.2 GB of fp32 dE) are a smaller bound. Operations bound. Measured:
//   chip_smoke.py prints the times and shares of the bound (PERF.md,
//   kernel table, rows 10-11).
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
//   The consumers run wgmma m64n64k16 (scores, a chunk's product into a
//   buffer of 32 registers, added to the tile's 32 when done) and
//   m64n256k16 (the 64 x 256 fp32 output slice, in registers for the whole
//   walk); setmaxnreg gives them 240 registers and the producer 24. The d epilogue works on the
//   score fragments: max, 1/sumexp, a, b and the target of the tile's rows
//   or columns loaded once a tile, the bias once a column; no fp32 score
//   tile in shared memory and no division per element.
//   dh (row 10): the vocabulary walk of a token tile can be split into S
//   parts (`_bwd_plan` in ops/ce_train_cuda.py picks S from the SMs and the
//   clusters the card holds); the parts write fp32 partials to an (S, M, D)
//   workspace, and `ce_dh_reduce` sums them in a fixed order and rounds
//   once to bf16. No atomics: two runs give the same bits.
//   dE (row 11): no split (V / 128 tiles fill the card); db is each CTA's
//   column sums of its fp32 d tiles (each tile's summed apart, then added,
//   so that few additions round at db's size), summed over the cluster's
//   ranks in rank order through distributed shared memory, written by
//   rank 0.
//   The TMA descriptors come from cuTensorMapEncodeTiled, a driver-API
//   function this library does not link: it is found at run time through
//   cudaGetDriverEntryPoint.

#include <cuda.h>  // CUtensorMap and its enums; the library links no libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------- tiles, barriers and wgmma

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

// One warpgroup's score tile, the one arithmetic of every score of the
// three kernels (see the header): D's nk 64-deep chunks in D's order from
// ring stage st on, each the tensor cores' product of the stage's 64 rows of
// A at a_off and N rows of B at X_BYTES (K-major, in the swizzle) over its
// four k16 steps from zero into c, added into s (N / 2 values a thread) in
// fp32 registers, rounded to nearest. N = 64 is one m64n64k16 product a
// step; N = 256 is two m64n128k16 halves taken in turn through c (64
// values), whose fragments side by side are the m64n256 one's. Stage i
// lies at ring + i stage_bytes, its full and empty barriers at full0 + 8 i
// and empty0 + 8 i; the leader gives each stage back once its products
// are done.
template <int N>
__device__ __forceinline__ void score_tile(float* s, float* c, uint32_t ring,
                                           int stage_bytes, int nst,
                                           uint32_t full0, uint32_t empty0,
                                           uint32_t a_off, int nk,
                                           bool leader, int& st,
                                           uint32_t& ph) {
  constexpr int NB = N == 64 ? 64 : 128;  // columns of one product
  constexpr int CV = NB / 2;              // its values a thread
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(full0 + 8 * st, ph);
    const uint32_t a = ring + st * stage_bytes + a_off;
#pragma unroll
    for (int half = 0; half < N / NB; ++half) {
      const uint32_t b = ring + st * stage_bytes + X_BYTES + half * NB * 128;
      fence_regs<CV>(c);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k) {
        if (N == 64)
          wgmma_n64(c, desc_k(a + 32 * k), desc_k(b + 32 * k), k > 0);
        else
          wgmma_n128(c, desc_k(a + 32 * k), desc_k(b + 32 * k), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<CV>(c);
#pragma unroll
      for (int i = 0; i < CV; ++i) s[half * CV + i] += c[i];
    }
    if (leader) mbar_arrive(empty0 + 8 * st);
    if (++st == nst) { st = 0; ph ^= 1; }
  }
}

// ------------------------------------------------------------------ backward

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

      // the score tile, as the forward's (see the header)
      float s[32], chunk[32];
      score_tile<WALK>(s, chunk, ring, STAGE, nst, full(0), empty(0),
                       wg * 64 * 128, nk, t == 0, st, ph);

      // the slot is free once every peer has read the last group's tile
      if (C > 1 && j > g0) mbar_wait_cluster(dfree, (j - g0 - 1) & 1);
      // d from the fragments, rounded to bf16 into this rank's slot; dE
      // sums the tile's fp32 d of each row apart, then adds that to db's
      float tsum[2] = {0.f, 0.f};
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
            tsum[rs] += d[e];
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
      if (DE) {
        dbsum[0] += tsum[0];
        dbsum[1] += tsum[1];
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
          wgmma_n256_mn(acc, desc_k(a + 32 * k), desc_mn(b + 16 * 128 * k));
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

// ------------------------------------------------------------------- forward

constexpr int FCOLS = 256;                    // vocabulary rows of a score tile
constexpr int F_E_BYTES = FCOLS * KC * 2;     // 32 KB: a chunk of E
constexpr int F_STAGE = X_BYTES + F_E_BYTES;  // 48 KB: chunks of h and E
constexpr int F_NST = 4;                      // ring stages
constexpr int FWD_SMEM =
    1024 + F_NST * F_STAGE + 4 * FCOLS * 4 + 2 * F_NST * 8;  // 201,792

struct FwdParams {
  CUtensorMap hmap;  // h (M, D) bf16, boxes of 64 columns x 128 rows
  CUtensorMap emap;  // E (V, D) bf16, boxes of 64 columns x 256 rows
  const float* bias;
  const int* tgt;
  float* ws;  // (3, splits, M) fp32: each part's max, sum-exp, target logit
  int M, V, D, n_vt, splits;
};

// One CTA: tokens [128 x, +128) over the vocabulary tiles [j0, j1) of part
// y. Dynamic shared memory, 1 KB aligned: the ring (4 x 48 KB: h's chunk,
// then E's), each warpgroup's bias of a tile (two buffers, by the tile's
// parity), the barriers.
__global__ void __launch_bounds__(BWD_THREADS, 1)
ce_stats_split(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vbias = reinterpret_cast<float*>(smem + F_NST * F_STAGE);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = smem_u32(vbias + 4 * FCOLS);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F_NST + s); };

  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * OWN;
  const int part = blockIdx.y;
  const int j0 = (int)((long long)part * p.n_vt / p.splits);
  const int j1 = (int)((long long)(part + 1) * p.n_vt / p.splits);
  const int nk = p.D / KC;

  if (tid == 0) {
    for (int s = 0; s < F_NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: one thread issues the loads in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int j = j0; j < j1; ++j)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty(st), ph ^ 1);
          mbar_expect(full(st), F_STAGE);
          tma_load(ring + st * F_STAGE, &p.hmap, kc * KC, m0, full(st));
          tma_load(ring + st * F_STAGE + X_BYTES, &p.emap, kc * KC,
                   j * FCOLS, full(st));
          if (++st == F_NST) { st = 0; ph ^= 1; }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns tokens [64 wg, +64) of the tile; a thread
  // rows rbase and rbase + 8, columns cbase + 8 g, + 1 (g < 32) of each
  // score tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int rbase = 64 * wg + 16 * (t >> 5) + (lane >> 2);
  const int cbase = 2 * (lane & 3);
  float* vb = vbias + wg * 2 * FCOLS;

  // per row: the running max (the same in the row's four lanes), this
  // lane's sum of exp(s - max) and the target's logit, if this lane met it
  float run_max[2], run_sum[2], run_tl[2];
  int rt[2];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    const int row = m0 + rbase + 8 * rs;
    rt[rs] = row < p.M ? p.tgt[row] : -1;
    run_max[rs] = -inf;
    run_sum[rs] = 0.f;
    run_tl[rs] = 0.f;
  }

  float acc[128], chunk[64];
  int st = 0;
  uint32_t ph = 0;
  for (int j = j0; j < j1; ++j) {
    const int v0 = j * FCOLS;
    // the tile's bias, -inf past V (E's rows there are TMA's zeros), read
    // now and staged after the products, which hide the load's latency
    float bv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = v0 + t + 128 * q;
      bv[q] = v < p.V ? p.bias[v] : -inf;
    }

    // the score tile, as the backward's (see the header)
    score_tile<FCOLS>(acc, chunk, ring, F_STAGE, F_NST, full(0), empty(0),
                      wg * 64 * 128, nk, t == 0, st, ph);

    // the buffer of tile j - 2 is free: every thread is past tile j - 1's
    // barrier
    float* bias = vb + (j & 1) * FCOLS;
    bias[t] = bv[0];
    bias[t + 128] = bv[1];
    named_sync(2 + wg, 128);

    // fold the tile from the fragments: s + b, the row max over the four
    // lanes, then the lane's sum of exp against the new max
    float tmax[2] = {-inf, -inf};
#pragma unroll
    for (int g = 0; g < FCOLS / 8; ++g) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * g + cbase);
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        float* x = acc + 4 * g + 2 * rs;
        x[0] += b.x;
        x[1] += b.y;
        tmax[rs] = fmaxf(tmax[rs], fmaxf(x[0], x[1]));
      }
    }
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      // the target's logit, where it is one of this lane's columns
      const int tc = rt[rs] - v0 - cbase;
      if (tc >= 0 && tc < FCOLS && (tc & 6) == 0) {
#pragma unroll
        for (int g = 0; g < FCOLS / 8; ++g) {
          if (tc == 8 * g) run_tl[rs] = acc[4 * g + 2 * rs];
          if (tc == 8 * g + 1) run_tl[rs] = acc[4 * g + 2 * rs + 1];
        }
      }
      float mx = tmax[rs];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float nm = fmaxf(run_max[rs], mx);
      // four partial sums, so that the additions do not wait on each other
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < FCOLS / 8; ++g)
        sum[g & 3] += expf(acc[4 * g + 2 * rs] - nm) +
                      expf(acc[4 * g + 2 * rs + 1] - nm);
      run_sum[rs] = run_sum[rs] * expf(run_max[rs] - nm) +
                    ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      run_max[rs] = nm;
    }
  }

  // the row's four lanes summed (one of them holds the target's logit, if
  // this part met it: the others add zeros, exactly); the part's partials
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    float sum = run_sum[rs], tl = run_tl[rs];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    tl += __shfl_xor_sync(0xffffffffu, tl, 1);
    tl += __shfl_xor_sync(0xffffffffu, tl, 2);
    const int row = m0 + rbase + 8 * rs;
    if ((lane & 3) == 0 && row < p.M) {
      const size_t o = (size_t)part * p.M + row;
      const size_t plane = (size_t)p.splits * p.M;
      p.ws[o] = run_max[rs];
      p.ws[plane + o] = sum;
      p.ws[2 * plane + o] = tl;
    }
  }
}

// ce, max and sum-exp of each token from its parts' partials, in part
// order: max = max_p max_p, sumexp = sum_p sumexp_p exp(max_p - max), the
// target's logit from the part that met it (the others hold zeros)
__global__ void ce_stats_merge(const float* __restrict__ ws,
                               float* __restrict__ ce, float* __restrict__ mx,
                               float* __restrict__ se, int M, int splits) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t plane = (size_t)splits * M;
  float big = ws[m];
  for (int k = 1; k < splits; ++k) big = fmaxf(big, ws[(size_t)k * M + m]);
  float sum = 0.f, tl = 0.f;
  for (int k = 0; k < splits; ++k) {
    const size_t o = (size_t)k * M + m;
    sum += ws[plane + o] * expf(ws[o] - big);
    tl += ws[2 * plane + o];
  }
  ce[m] = logf(sum) + big - tl;
  mx[m] = big;
  se[m] = sum;
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
// se (M) fp32. D must be a multiple of 64 (KC; the training wrappers ask
// 256, the backward's slice, and scoring 64). splits: the parts of the
// vocabulary walk (at most its 256-row tiles); ws is a (3, splits, M) fp32
// workspace. Returns the launch error, or 0; -1 where the driver's
// cuTensorMapEncodeTiled is not found, -1000 - r where it refuses a
// descriptor with r.
extern "C" int ce_train_fwd(const void* h, const void* emb, const void* bias,
                            const void* tgt, void* ce, void* mx, void* se,
                            void* ws, int M, int V, int D, int splits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ce_stats_split, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (M == 0) return 0;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  FwdParams prm = {};
  int r = encode_map(enc, &prm.hmap, h, M, D, OWN);
  if (r == 0) r = encode_map(enc, &prm.emap, emb, V, D, FCOLS);
  if (r != 0) return -1000 - r;
  prm.bias = static_cast<const float*>(bias);
  prm.tgt = static_cast<const int*>(tgt);
  prm.ws = static_cast<float*>(ws);
  prm.M = M;
  prm.V = V;
  prm.D = D;
  prm.n_vt = (V + FCOLS - 1) / FCOLS;
  prm.splits = splits;
  ce_stats_split<<<dim3((M + OWN - 1) / OWN, splits), BWD_THREADS, FWD_SMEM,
                   st>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_stats_merge<<<(M + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(ce),
      static_cast<float*>(mx), static_cast<float*>(se), M, splits);
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

