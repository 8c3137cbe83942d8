"""The LSTM training backward's designs (kernel row 6,
``csrc/lstm_train.cu``) on the CPU: the rule ``_design(B, H, n_sm)`` that
picks the persistent cooperative kernel or the two-launch kernels, the
persistent kernel's launch plan (CTAs, units a CTA, shared memory within
the 232,448 bytes a CTA may take, every hidden unit owned once), and a
Python copy of its tensor-core fragments: the k slots of ``warp_product``'s
m16n8k16 steps, filled from 16-byte loads, must pair A and B on the same k,
so that the warps' partial tiles sum to the product."""

import numpy as np
import pytest

from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

N_SM = 132  # the H100 SXM's SMs


@pytest.mark.parametrize("B,H", [(32, 1024), (20, 1024), (32, 512),
                                 (1, 32), (32, 1056)])
def test_persistent_design_where_it_fits(B, H):
    plan = ltc._design(B, H, N_SM, T=100)
    assert plan["design"] == "persistent"
    assert plan["units"] == 8 and plan["ctas"] == H // 8 <= N_SM
    assert plan["grid"] == (H // 8,) and plan["threads"] == 512
    assert plan["smem_bytes"] == ltc.persist_smem(H) <= 232448
    assert plan["launches"] == 1 and plan["barriers"] == 100
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once


def test_persistent_plan_at_the_training_shape():
    # T 100, B 32, H 1,024: 128 CTAs of 8 units, 215,552 bytes a CTA (the
    # gate rows and the column slice 66 KB each, the partial tiles 80 KB)
    plan = ltc._design(32, 1024, N_SM, T=100)
    assert (plan["ctas"], plan["smem_bytes"]) == (128, 215552)
    assert ltc.persist_smem(1024) == (32 * 1056 + 8 * 4128) * 2 + 16 * 32 * 40 * 4


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (37, 64, N_SM),     # the card test's shape
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs: more than the SMs
    (32, 2048, N_SM),   # 256 CTAs, and 344 KB a CTA
    (32, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs at once
])
def test_two_launch_design_takes_the_rest(B, H, n_sm):
    plan = ltc._design(B, H, n_sm, T=100)
    assert plan["design"] == "two_launch"
    assert plan["grid"] == (-(-B // 32), H // 32)
    assert plan["launches"] == 200 and plan["barriers"] == 0


def test_persistent_shared_memory_bounds_the_width():
    # the widest H whose CTA fits 232,448 bytes, on a card with SMs enough
    widest = max(H for H in range(8, 4096, 8)
                 if ltc.persist_smem(H) <= 232448)
    assert widest == 1152
    assert ltc._design(32, widest, 1000)["design"] == "persistent"
    assert ltc._design(32, widest + 8, 1000)["design"] == "two_launch"


def _mma16816(a, b, d):
    """PTX mma.m16n8k16 with A (4 regs of bf16 pairs a lane) and B (2 regs)
    in the ISA's fragment layout: a[lane][reg] (2,), b[lane][reg] (2,);
    d (16, 8) += A B, A and B rebuilt from the lanes' registers."""
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(2):
            A[g, 2 * t + i] = a[lane][0][i]
            A[g + 8, 2 * t + i] = a[lane][1][i]
            A[g, 2 * t + 8 + i] = a[lane][2][i]
            A[g + 8, 2 * t + 8 + i] = a[lane][3][i]
            Bm[2 * t + i, g] = b[lane][0][i]
            Bm[2 * t + 8 + i, g] = b[lane][1][i]
    d += A @ Bm


def _warp_product(a, ws, warps=16, batch=2):
    """``warp_product`` of csrc/warp_mma.cuh, every warp of a CTA, in
    Python: a (rows <= 32, K), ws (8 NT, K); each lane (g, t) loads 8
    consecutive k of A's rows g, g + 8 (per m tile) and of ws' row g (per
    n tile), values 0-3 to one k16 step, 4-7 to the next. Returns the
    warps' partial tiles summed in warp order, (32, 8 NT)."""
    rows, K = a.shape
    nt = ws.shape[0] // 8
    A = np.zeros((32, K))
    A[:rows] = a
    total = np.zeros((32, 8 * nt))
    for w in range(warps):
        acc = np.zeros((2, nt, 16, 8))
        for p0 in range(w, K // 32, warps * batch):
            for p in range(p0, min(K // 32, p0 + warps * batch), warps):
                for n in range(nt):
                    for m in range(2):
                        for s in range(2):
                            af, bf = [], []
                            for lane in range(32):
                                g, t = lane >> 2, lane & 3
                                k = 32 * p + 8 * t + 4 * s
                                lo = A[16 * m + g, k:k + 4]
                                hi = A[16 * m + 8 + g, k:k + 4]
                                wv = ws[8 * n + g, k:k + 4]
                                af.append([lo[0:2], hi[0:2], lo[2:4],
                                           hi[2:4]])
                                bf.append([wv[0:2], wv[2:4]])
                            _mma16816(af, bf, acc[m, n])
        for m in range(2):
            for n in range(nt):
                total[16 * m:16 * m + 16, 8 * n:8 * n + 8] += acc[m, n]
    return total


@pytest.mark.parametrize("rows,K,nt", [(32, 128, 4), (20, 64, 4),
                                       (32, 256, 1), (7, 96, 1)])
def test_fragments_pair_a_and_b_on_the_same_k(rows, K, nt):
    rng = np.random.default_rng(rows + K)
    a = rng.integers(-8, 8, size=(rows, K)).astype(np.float64)
    ws = rng.integers(-8, 8, size=(8 * nt, K)).astype(np.float64)
    got = _warp_product(a, ws, warps=4)
    want = np.zeros((32, 8 * nt))
    want[:rows] = a @ ws.T
    np.testing.assert_array_equal(got, want)  # small integers: exact
