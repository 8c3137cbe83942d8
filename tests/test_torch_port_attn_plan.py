"""The launch plans of the causal attention kernels on the CPU: the design
each call takes by dtype, head width and view (``_design``, one rule for
rows 14-17), the grids and tile walks of rows 15-17 in both designs
(``_fwd_plan``, ``_dq_plan``, ``_dkv_plan`` of
``ops.attention_train_cuda``: every causal pair of tiles visited exactly
once, none above the diagonal, the wgmma grids' longest walks first; the
words the library is launched with) and of row 14 (``ops.attention_cuda``
``_plan``, the same checks), and the wgmma fragments' dropout draws
(``frag_draws`` below, a Python copy of the kernels' fragment layout and
``pair_words``) in rows 15-17: every causal (row, column) of a fragment
once, its word from its own row's Philox call on its own group of four
keys, the keep bit ``keep_plain``'s. Shapes: the long step's call, T =
2,048 and 4,096 at B = 2, the card test's ragged T, and row 14's eval and
XL memory-build calls."""

import collections

import pytest
import torch

from bayeslms_tpu_torch.ops import attention_cuda as acu
from bayeslms_tpu_torch.ops import attention_train_cuda as atc
from bayeslms_tpu_torch.ops.bayes_sample_cuda import philox4x32_10

# (T, B, heads, d)
SHAPES = [(1024, 32, 8, 64), (2048, 2, 8, 64), (4096, 2, 8, 64),
          (1, 2, 3, 32), (24, 2, 3, 32), (70, 2, 3, 256), (130, 2, 3, 64),
          (257, 2, 3, 128), (130, 2, 3, 40), (257, 2, 3, 96)]


def _views(T, B, h, d, dtype, pad=0):
    """q, k, v as column views of one (T, B, 3 E + pad) projection."""
    E = h * d
    qkv = torch.zeros((T, B, 3 * E + pad), dtype=dtype)
    return list(qkv[..., :3 * E].split(E, dim=-1))


# row 14's calls (T, B, heads, d): the eval window, XL memory builds at B =
# 1, the long evaluate and T = 4,096, ragged T, the widest heads
ROW14_SHAPES = [(100, 20, 8, 64), (32, 1, 8, 64), (128, 1, 8, 64),
                (1024, 20, 8, 64), (4096, 2, 8, 64), (1, 2, 3, 32),
                (130, 5, 3, 32), (257, 5, 3, 128), (70, 2, 3, 256),
                (130, 2, 3, 40)]


@pytest.mark.parametrize("T,B,h,d", SHAPES)
def test_design_rule(T, B, h, d):
    # one rule for rows 14-17: the tensor cores for bf16 at d <= 128, the
    # CUDA cores for float32 and d = 256
    views = _views(T, B, h, d, torch.bfloat16)
    fast = "wgmma" if d <= atc.WGMMA_MAX_D else "simt"
    assert atc._design is acu._design
    assert atc._design(views, h) == fast
    assert atc._design(views + views[:1], h) == fast
    f32 = _views(T, B, h, d, torch.float32)
    assert atc._design(f32, h) == "simt"
    assert atc._design(f32 + f32[:1], h) == "simt"


def test_design_rule_needs_what_tma_reads():
    # d not a multiple of 8, a batch stride off 16 bytes: the CUDA cores
    assert atc._design(_views(8, 2, 2, 36, torch.bfloat16), 2) == "simt"
    assert atc._design(_views(8, 2, 2, 64, torch.bfloat16, pad=4),
                       2) == "simt"
    assert atc._design(_views(8, 2, 2, 40, torch.bfloat16), 2) == "wgmma"
    # dO contiguous beside the qkv views, as the backward hands it
    views = _views(8, 2, 2, 64, torch.bfloat16)
    assert atc._design(views + [torch.zeros((8, 2, 128),
                                            dtype=torch.bfloat16)],
                       2) == "wgmma"


def _designs(d):
    return ["simt"] + (["wgmma"] if d <= atc.WGMMA_MAX_D else [])


def _blocks(plan):
    n = 1
    for g in plan["grid"]:
        n *= g
    return [plan["block"](x) for x in range(n)]


@pytest.mark.parametrize("T,B,h,d", SHAPES)
def test_fwd_plan_visits_each_causal_tile_pair_once(T, B, h, d):
    for design in _designs(d):
        plan = atc._fwd_plan(T, B, h, d, design)
        rows, keys = plan["rows"], plan["keys"]
        seen = collections.Counter()
        order = []
        for qt, bh, walk in _blocks(plan):
            assert 0 <= bh < B * h and 0 <= qt < plan["ntiles"]
            order.append(qt)
            for kt in walk:
                seen[(bh, qt, kt)] += 1
        # every pair of tiles holding a causal (row, key), once; no tile
        # wholly above the diagonal
        want = {(bh, i, j) for bh in range(B * h)
                for i in range(-(-T // rows)) for j in range(-(-T // keys))
                if j * keys <= min(T, (i + 1) * rows) - 1}
        assert set(seen) == want and set(seen.values()) == {1}
        if design == "wgmma":
            assert plan["grid"] == (plan["ntiles"] * B * h,)
            assert order == sorted(order, reverse=True)  # longest first
            assert plan["threads"] == 384 and rows == keys == 128


@pytest.mark.parametrize("T,B,h,d", SHAPES)
def test_dq_plan_visits_each_causal_tile_pair_once(T, B, h, d):
    for design in _designs(d):
        plan = atc._dq_plan(T, B, h, d, design)
        rows, keys = plan["rows"], plan["keys"]
        part = 64 if design == "wgmma" else rows  # rows of a warpgroup
        seen = collections.Counter()
        order = []
        for qt, bh, walk in _blocks(plan):
            assert 0 <= bh < B * h and 0 <= qt < plan["ntiles"]
            order.append(qt)
            for kt, w in walk:
                seen[(bh, (qt * rows + w * part) // part, kt)] += 1
        # (batch-head, query part, key tile) pairs with a causal (row, key):
        # each once, none wholly above the diagonal or past T
        want = {(bh, hq, j) for bh in range(B * h)
                for hq in range(-(-T // part)) for j in range(-(-T // keys))
                if j * keys <= min(T, (hq + 1) * part) - 1}
        assert set(seen) == want and set(seen.values()) == {1}
        if design == "wgmma":
            assert plan["grid"] == (plan["ntiles"] * B * h,)
            assert order == sorted(order, reverse=True)  # longest first
            assert plan["threads"] == 384 and rows == 128
            assert keys == (128 if d <= 64 else 64) == atc.dq_keys(d)


@pytest.mark.parametrize("T,B,h,d", ROW14_SHAPES)
def test_row14_plan_visits_each_causal_tile_pair_once(T, B, h, d):
    for design in _designs(d):
        plan = acu._plan(T, B, h, design)
        rows, keys = plan["rows"], plan["keys"]
        assert rows == keys == 64
        seen = collections.Counter()
        order = []
        for qt, bh, walk in _blocks(plan):
            assert 0 <= bh < B * h and 0 <= qt < plan["ntiles"]
            order.append(qt)
            for kt in walk:
                seen[(bh, qt, kt)] += 1
        want = {(bh, i, j) for bh in range(B * h)
                for i in range(-(-T // rows)) for j in range(-(-T // keys))
                if j * keys <= min(T, (i + 1) * rows) - 1}
        assert set(seen) == want and set(seen.values()) == {1}
        words = list(acu._plan_words(plan))
        grid = (*plan["grid"], 1)[:2]
        assert words == [int(design == "wgmma"), *grid, plan["ntiles"],
                         rows, keys, plan["threads"]]
        if design == "wgmma":
            assert plan["grid"] == (plan["ntiles"] * B * h,)
            assert order == sorted(order, reverse=True)  # longest first
            assert plan["threads"] == 160
        else:
            assert plan["grid"] == (B * h, plan["ntiles"])
            assert plan["threads"] == 256


@pytest.mark.parametrize("T,B,h,d", ROW14_SHAPES)
def test_row14_design_rule(T, B, h, d):
    views = _views(T, B, h, d, torch.bfloat16)
    fast = "wgmma" if d <= acu.WGMMA_MAX_D else "simt"
    assert acu._design(views, h) == fast
    assert acu._design(_views(T, B, h, d, torch.float32), h) == "simt"
    assert acu._design(_views(T, B, h, d, torch.bfloat16, pad=4),
                       h) == "simt"


@pytest.mark.parametrize("T,B,h,d", SHAPES)
def test_dkv_plan_visits_each_causal_tile_pair_once(T, B, h, d):
    for design in _designs(d):
        plan = atc._dkv_plan(T, B, h, d, design)
        rows, keys = plan["rows"], plan["keys"]
        part = 64 if design == "wgmma" else keys  # keys of a warpgroup
        seen = collections.Counter()
        walks = []
        for kt, bh, walk in _blocks(plan):
            walks.append(len(walk))
            for qi, w in walk:
                seen[(bh, (kt * keys + w * part) // part, qi)] += 1
        # (batch-head, key part, query tile) pairs with a causal (row, key)
        want = {(bh, hk, i) for bh in range(B * h)
                for hk in range(-(-T // part)) for i in range(-(-T // rows))
                if hk * part <= min(T, (i + 1) * rows) - 1}
        assert set(seen) == want and set(seen.values()) == {1}
        if design == "wgmma":
            assert plan["grid"] == (plan["ntiles"] * B * h,)
            assert walks == sorted(walks, reverse=True)  # longest first
            assert (keys, rows) == (128, 64)


@pytest.mark.parametrize("T,B,h,d", SHAPES)
def test_plan_words_are_the_plan(T, B, h, d):
    # what the library launches: the plan's grid and tile count, and the
    # tile geometry it holds against its kernels' (Geo<DP>::BR of the
    # CUDA-core kernels: 64 rows up to d = 64, else 32)
    for design in _designs(d):
        for make in (atc._fwd_plan, atc._dq_plan, atc._dkv_plan):
            plan = make(T, B, h, d, design)
            words = list(atc._plan_words(plan))
            grid = (*plan["grid"], 1)[:2]
            assert words == [int(design == "wgmma"), *grid, plan["ntiles"],
                             plan["rows"], plan["keys"], plan["threads"]]
            if design == "simt":
                br = 64 if d <= 64 else 32
                assert (plan["rows"], plan["keys"]) == (br, br)
                assert plan["threads"] == 256
            else:
                assert plan["grid"][0] == plan["ntiles"] * B * h


def frag_draws(T: int, bh: int, row0: int, col0: int, ncols: int):
    """The Philox draws of a 64-row x ``ncols`` wgmma fragment (rows row0
    .., keys col0 .., both multiples of 64; ``ncols`` 128 for row 15 and
    row 16 at d <= 64, 64 for row 17 and row 16 at d = 128) as the kernels'
    ``pair_words`` makes them: for every
    (thread, 8-column block j, row half rs, element e), the (row, column)
    it holds, the thread that made the Philox call which gave its word (the
    lane's or its partner's), that call's row and first column of its group
    of four keys, the word's index, and the call's (tile, counter). Rows
    past T and groups above the diagonal are left out, as the kernels skip
    those draws."""
    bq = atc.block(T)
    nb = -(-T // bq)
    li, lj = row0 // bq, col0 // bq
    out = []
    for t in range(128):
        warp, lane = t // 32, t % 32
        r_lo = row0 + 16 * warp + lane // 4
        cq = 2 * (lane % 4)
        odd = lane & 1
        for j in range(ncols // 8):
            col4 = col0 + 8 * j + 4 * ((lane >> 1) & 1)
            # the draws of this lane and its partner (lane ^ 1)
            mine = r_lo + 8 * odd
            theirs = r_lo + 8 * (1 - odd)
            for rs in (0, 1):
                row = r_lo + 8 * rs
                src = mine if rs == odd else theirs
                for e in (0, 1):
                    col = col0 + 8 * j + cq + e
                    if row >= T or col > row:
                        continue
                    # the even lane keeps words 0, 1 of its group and
                    # hands over 2, 3; the odd lane keeps 2, 3
                    ctr = ((src - li * bq) * bq + (col4 - lj * bq)) >> 2
                    out.append(dict(thread=t, j=j, row=row, col=col,
                                    drawn_by=t if rs == odd else t ^ 1,
                                    src_row=src, col4=col4, word=2 * odd + e,
                                    tile=(bh * nb + li) * nb + lj, ctr=ctr))
    return out


def _fragments(T):
    """(row0, col0, ncols) of every wgmma fragment that draws at T: row
    15's 64 x 128 (a warpgroup's rows of a 128-row tile, a key tile), row
    17's 64 x 64 (a query tile, a warpgroup's keys)."""
    nt = -(-T // 128)
    fwd = [(128 * qt + 64 * w, 128 * kt, 128) for qt in range(nt)
           for w in (0, 1) for kt in range(qt + 1)]
    dkv = [(q0, 128 * kt + 64 * w, 64) for kt in range(nt) for w in (0, 1)
           for q0 in range(128 * kt, T, 64)]
    return fwd + dkv


def _dq_fragments(T, d):
    """(row0, col0, ncols) of row 16's wgmma fragments at T and head width
    d: a warpgroup's 64 rows by a key tile of ``dq_keys(d)``, as
    ``_dq_plan``'s walk visits them."""
    plan = atc._dq_plan(T, 1, 1, d, "wgmma")
    return [(128 * qt + 64 * w, plan["keys"] * kt, plan["keys"])
            for qt, _, walk in _blocks(plan) for kt, w in walk]


def _check_draws(T, fragments):
    rate, bh = 0.2, 1
    seed = torch.tensor([123457], dtype=torch.int32)
    ref = atc.keep_plain(seed, torch.tensor([bh]), T, rate)[0]
    thresh, _ = atc.drop_params(rate)
    for row0, col0, ncols in fragments:
        draws = frag_draws(T, bh, row0, col0, ncols)
        cells = collections.Counter((x["row"], x["col"]) for x in draws)
        want = {(r, c) for r in range(row0, min(T, row0 + 64))
                for c in range(col0, min(r + 1, col0 + ncols))}
        assert set(cells) == want and set(cells.values()) <= {1}
        if not draws:
            continue
        for x in draws:
            assert x["src_row"] == x["row"]
            assert x["col4"] == x["col"] - x["col"] % 4
            assert x["word"] == x["col"] % 4
        ctr = torch.tensor([x["ctr"] for x in draws], dtype=torch.int64)
        tile = torch.tensor([x["tile"] for x in draws], dtype=torch.int64)
        words = torch.stack(philox4x32_10(
            ctr, int(seed) & 0xFFFFFFFF, tile), dim=1)
        word = words[torch.arange(len(draws)),
                     torch.tensor([x["word"] for x in draws])]
        rows = torch.tensor([x["row"] for x in draws])
        cols = torch.tensor([x["col"] for x in draws])
        assert torch.equal((word >> 8) < thresh, ref[rows, cols])


@pytest.mark.parametrize("T", [1, 24, 70, 130, 257])
def test_fragment_draws_are_keep_plains(T):
    _check_draws(T, _fragments(T))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T", [1, 24, 70, 130, 257])
def test_dq_fragment_draws_are_keep_plains(T, d):
    # row 16 draws from row 15's fragment layout, on its own key tiles
    frags = _dq_fragments(T, d)
    assert frags and all(ncols == atc.dq_keys(d) for *_, ncols in frags)
    _check_draws(T, frags)


def test_fragment_pairs_share_one_philox_call():
    # lanes 2i and 2i + 1 hold the four columns of one group of four keys
    # for two rows: each draws one row's group once per 8-column block and
    # hands the other two words, so a fragment makes one Philox call per
    # four elements
    for row0, col0, ncols in ((256, 0, 128), (64, 0, 64)):
        draws = frag_draws(512, 0, row0, col0, ncols)
        calls = collections.defaultdict(set)
        for x in draws:
            calls[(x["drawn_by"], x["j"])].add((x["src_row"], x["col4"]))
            assert x["drawn_by"] in (x["thread"], x["thread"] ^ 1)
        assert {len(c) for c in calls.values()} == {1}
        if row0 >= col0 + ncols:  # no element above the diagonal
            assert len(calls) * 4 == len(draws) == 64 * ncols
