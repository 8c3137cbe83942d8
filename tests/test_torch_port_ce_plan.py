"""The launch plans of the fused CE training kernels of
``csrc/ce_train.cu`` on the CPU. The backward (rows 10-11,
``ops.ce_train_cuda._bwd_plan``), with ``_cta`` below mirroring the
kernel's index arithmetic: the cluster size, the grid, the split of dh's
vocabulary walk and its workspace at the training shapes the port records
(the LSTM's D = 1,024 and the Transformer's D = 512 at M = 3,200 tokens,
the long-context M = 32,768), and that the CTAs' work covers every (output
tile, slice, walked tile) exactly once, each score tile computed by one
rank of its cluster. The forward (row 9, ``_fwd_plan``): the split of its
vocabulary walk, the grid and the workspace, and that the CTAs walk every
(token tile, vocabulary tile) pair exactly once."""

import collections
import itertools

import pytest

from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

V = 49152
SHAPES = [(3200, V, 1024), (3200, V, 512), (32768, V, 1024)]


def _cta(plan, x, y, z):
    """What CTA (x, y, z) of ``plan``'s grid does, as ``ce_bwd_kernel``
    computes it: (its slice, or None for a rank past the last slice; its
    own tile; its part; the walked tiles of its score tiles; the walked
    tiles of its cluster's d products), the tiles as ranges."""
    C, S, groups, n = plan["C"], plan["S"], plan["groups"], plan["walk_tiles"]
    rank = x % C
    slice_ = (x // C) * C + rank
    g0, g1 = z * groups // S, (z + 1) * groups // S
    end = min(g1 * C, n)
    return (slice_ if slice_ < plan["slices"] else None, y, z,
            range(min(g0 * C + rank, end), end, C),
            range(min(g0 * C, end), end))


def _check_cover(plan):
    """Every (own tile, slice) walks each tile once over the parts, and
    each cluster's score tiles are its d products' tiles, once each."""
    gx, gy, gz = plan["grid"]
    C = plan["C"]
    walked = {}
    for y, x0 in itertools.product(range(gy), range(0, gx, C)):
        for z in range(gz):
            units = [_cta(plan, x, y, z) for x in range(x0, x0 + C)]
            prods = {tuple(u[4]) for u in units}
            assert len(prods) == 1  # one walk a cluster
            scores = sorted(t for u in units for t in u[3])
            assert scores == list(units[0][4])
            for sl, own, part, _, prod in units:
                assert (own, part) == (y, z)
                if sl is not None:
                    walked.setdefault((y, sl), []).append(prod)
    assert set(walked) == set(itertools.product(range(gy),
                                                range(plan["slices"])))
    full = list(range(plan["walk_tiles"]))
    for parts in walked.values():
        assert [t for r in parts for t in r] == full


@pytest.mark.parametrize("de", [False, True], ids=["dh", "dE"])
@pytest.mark.parametrize("M,V,D", SHAPES)
def test_plan_at_recorded_shapes(M, V, D, de):
    plan = ctc._bwd_plan(M, V, D, 132, de=de)
    C, S = plan["C"], plan["S"]
    assert C == D // 256 and C <= 8 and plan["G"] == 1
    assert plan["grid"][0] % C == 0 and plan["cluster"] == (C, 1, 1)
    assert plan["grid"][1] == -(-(V if de else M) // 128)
    assert plan["ctas"] == plan["clusters"] * C
    assert plan["workspace_bytes"] == (S * M * D * 4 if S > 1 else 0)
    if de or M == 32768:
        assert S == 1  # the tiles fill the card already
    else:
        assert S > 1 and plan["ctas"] >= 132
    _check_cover(plan)


def test_plan_takes_the_card_s_cluster_count():
    # a card holding 32 clusters of 4: 25 token tiles split 5 ways make 125
    # clusters, 4 waves of 32 for a fifth of the walk each
    plan = ctc._bwd_plan(3200, V, 1024, 132, max_clusters=32)
    assert (plan["S"], plan["max_clusters"], plan["clusters"]) == (5, 32, 125)
    assert plan["grid"] == (4, 25, 5)


@pytest.mark.parametrize("de", [False, True], ids=["dh", "dE"])
def test_plan_beyond_the_portable_cluster(de):
    # D = 2,304: nine slices in two clusters of five, the tenth rank idle
    plan = ctc._bwd_plan(3201, 4097, 2304, 132, de=de)
    assert (plan["C"], plan["G"], plan["slices"]) == (5, 2, 9)
    assert plan["grid"][0] == 10
    idle = [x for x in range(10) if _cta(plan, x, 0, 0)[0] is None]
    assert idle == [9]
    _check_cover(plan)


@pytest.mark.parametrize("M,V,D,de", [(1, 1, 256, False), (129, 4097, 2048,
                                                             True),
                                      (300, 1000, 256, False)])
def test_plan_at_ragged_shapes(M, V, D, de):
    _check_cover(ctc._bwd_plan(M, V, D, 132, de=de))


@pytest.mark.parametrize("D", [128, 300, 1000])
def test_plan_refuses_a_width_off_the_slices(D):
    with pytest.raises(ValueError):
        ctc._bwd_plan(3200, V, D, 132)


# the forward's recorded calls: the LSTM step, the Transformer step, the
# long-context step
FWD_SHAPES = [(3200, V, 1024), (3200, V, 512), (32768, V, 512)]


def _check_fwd_cover(plan):
    """CTA (x, y) walks vocabulary tiles [y n / S, (y + 1) n / S) of token
    tile x, as ``ce_stats_split`` cuts the walk: every pair once."""
    T, S = plan["grid"]
    n = plan["vocab_tiles"]
    walked = collections.Counter(
        (x, j) for x, y in itertools.product(range(T), range(S))
        for j in range(y * n // S, (y + 1) * n // S))
    assert walked == collections.Counter(itertools.product(range(T),
                                                           range(n)))


@pytest.mark.parametrize("M,V,D", FWD_SHAPES)
def test_fwd_plan_at_recorded_shapes(M, V, D):
    plan = ctc._fwd_plan(M, V, D, 132)
    S = plan["S"]
    assert plan["grid"] == (-(-M // 128), S)
    assert plan["ctas"] == plan["grid"][0] * S
    assert plan["workspace_bytes"] == S * M * 3 * 4
    if M == 32768:
        assert S == 1  # 256 token tiles fill the card already
    else:
        assert S > 1 and plan["ctas"] >= 100
    _check_fwd_cover(plan)


@pytest.mark.parametrize("M,V,D", [(1, 1, 256), (300, 1, 1024),
                                   (300, 4097, 1024), (3201, 4097, 2304),
                                   (129, 1000, 512)])
def test_fwd_plan_at_ragged_shapes(M, V, D):
    plan = ctc._fwd_plan(M, V, D, 132)
    assert 1 <= plan["S"] <= plan["vocab_tiles"]  # no part walks nothing
    _check_fwd_cover(plan)


@pytest.mark.parametrize("D", [128, 300, 1000])
def test_fwd_plan_refuses_a_width_off_the_slices(D):
    with pytest.raises(ValueError):
        ctc._fwd_plan(3200, V, D, 132)


# Row 2, the scoring CE (``ops.ce_cuda``): its width rule, and the
# forward's plan at the scoring calls, D a multiple of the 64-deep chunk
@pytest.mark.parametrize("D,route", [(1024, "split"), (512, "split"),
                                     (64, "split"), (576, "split"),
                                     (96, "wmma"), (288, "wmma"),
                                     (32, "wmma")])
def test_scoring_width_rule(D, route):
    from bayeslms_tpu_torch.ops import ce_cuda

    assert ce_cuda.route(D) == route


@pytest.mark.parametrize("D", [0, 24, 100, 1000])
def test_scoring_width_rule_refuses_the_rest(D):
    from bayeslms_tpu_torch.ops import ce_cuda

    with pytest.raises(ValueError):
        ce_cuda.route(D)


# the LSTM pass's call (90,279 scored tokens, D = 1,024: 706 token tiles
# fill the card unsplit), the XL pass's calls (D = 512, M = 320-640: 3-5
# token tiles, the walk split 24-32 ways)
@pytest.mark.parametrize("M,D,S", [(90279, 1024, 1), (90279, 512, 1),
                                   (320, 512, 32), (480, 512, 32),
                                   (640, 512, 24)])
def test_fwd_plan_at_scoring_shapes(M, D, S):
    plan = ctc._fwd_plan(M, V, D, 132, width=ctc.FWD_CHUNK)
    assert plan["S"] == S
    assert plan["grid"] == (-(-M // 128), S)
    assert plan["workspace_bytes"] == S * M * 3 * 4
    if S > 1:
        assert plan["ctas"] >= 96  # the split fills most of the card
    _check_fwd_cover(plan)


@pytest.mark.parametrize("D", [64, 192, 576])
def test_fwd_plan_takes_the_chunk_width_for_scoring(D):
    # widths the backward's 256-column slices refuse, which the forward's
    # 64-deep chunks take
    with pytest.raises(ValueError):
        ctc._fwd_plan(300, 4097, D, 132)
    _check_fwd_cover(ctc._fwd_plan(300, 4097, D, 132, width=ctc.FWD_CHUNK))


@pytest.mark.parametrize("D", [32, 96, 100])
def test_fwd_plan_refuses_a_width_off_the_chunks(D):
    with pytest.raises(ValueError):
        ctc._fwd_plan(300, 4097, D, 132, width=ctc.FWD_CHUNK)
