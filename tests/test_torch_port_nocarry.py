"""The LSTM without carry-over: the recurrent branch of the port's
packed-nocarry layout (``rescore/layouts/packed.py`` ``rnn_packed_impl``)
against the JAX package's ``score_packed_nocarry`` (the scorer forced onto
it with the fused CE kernel in interpret mode, as
test_torch_port_tm_scorer.py forces the Transformer's), on the same
weights: best-fit-decreasing columns, a zero-state reset (source -1) at
each hypothesis's start, one forward a block of Bc columns. Scores rtol
1e-4 / atol 1e-5 (the scorer tests'). And the port's layout registry
against the JAX package's selection (tests/test_layout_registry.py)."""

from collections import OrderedDict

import jax
import numpy as np
import pytest

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.rescore import layouts as jlayouts
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.ops import lstm_cuda
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
LSTM = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0)
TM = dict(model="Transformer", vocab_size=V, emsize=16, nhid=24, nlayers=2,
          nhead=2, dropout=0.0)
CORES = {
    "standard": {},
    "bayes3": dict(uncertainty="Bayesian", l_bayes_pos=3),
    "gp13": dict(uncertainty="Gaussian", l_gauss_pos="13"),
    "vlstm11": dict(uncertainty="Variational", l_v_pos="11"),
}


def _nbest(n_utts=70):
    """Uneven hypothesis counts and lengths, one hypothesis longer than
    max_hyp_len, an empty one and OOV words."""
    rng = np.random.default_rng(3)
    nbest = OrderedDict()
    for u in range(n_utts):
        nbest[f"u{u}"] = [
            " ".join(f"w{rng.integers(2, V)}"
                     for _ in range(rng.integers(1, 14)))
            for _ in range(rng.integers(1, 6))]
    nbest["u2"].append(" ".join(f"w{rng.integers(2, V)}" for _ in range(40)))
    nbest["u4"].append("")
    nbest["u5"][0] += " oov1 w3 oov2"
    return nbest


def _fused_on(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")


@pytest.mark.parametrize("core,batch_size,blocks,Bc", [
    ("standard", 20, 2, 8), ("standard", 100, 1, 24),
    *((core, 20, 2, 8) for core in list(CORES)[1:])])
def test_packed_nocarry_lstm_scores_match_jax(monkeypatch, core, batch_size,
                                              blocks, Bc):
    """At max_hyp_len 30 (T = 128 steps a column) ``batch_size`` 20 makes
    blocks of 8 columns (two here), 100 blocks of 24 (one); every reset
    source is -1 and every block starts from zeros."""
    _fused_on(monkeypatch)
    kw = {**LSTM, **CORES[core]}
    rc = dict(carry_over=False, max_hyp_len=30, batch_size=batch_size)
    params = jx.init_params(jx.build_model(jx.ModelConfig(**kw)),
                            jx.ModelConfig(**kw), seed=2)
    nbest = _nbest()
    ref_scorer = JaxScorer(jx.ModelConfig(**kw), params,
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert jlayouts.select(ref_scorer).name == "packed-nocarry"
    ref = ref_scorer.score_nbest(nbest, W2I)

    scorer = BatchScorer(bt.ModelConfig(**kw),
                         jax.tree.map(np.asarray, params),
                         bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(scorer).name == "packed-nocarry"
    calls = []
    forward = scorer.model.forward

    def spy(data, hidden, **kw_):
        calls.append((data.shape, kw_["reset_src"], hidden))
        return forward(data, hidden, **kw_)

    scorer.model.forward = spy
    got = scorer.score_nbest(nbest, W2I)
    assert len(calls) == blocks
    for shape, src, (h0, c0) in calls:
        assert shape == (128, Bc)
        assert (src == -1).all() and not h0.any() and not c0.any()
    assert list(got) == list(ref)
    for k in nbest:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert scorer.oov_stats == ref_scorer.oov_stats


def test_nocarry_scores_each_hypothesis_from_zero():
    """A hypothesis scores the same alone as packed behind others: the -1
    reset leaves nothing of the column's earlier hypotheses
    (``lstm_cuda.apply_reset``'s definition)."""
    cfg = bt.ModelConfig(**LSTM)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=4)
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(carry_over=False,
                                                       max_hyp_len=30),
                         device="cpu")
    nbest = _nbest(12)
    packed = scorer.score_nbest(nbest, W2I)
    for k in ("u1", "u7"):
        for i, hyp in enumerate(nbest[k]):
            alone = scorer.score_nbest(OrderedDict(x=[hyp]), W2I)["x"][0][1]
            np.testing.assert_allclose(packed[k][i][1], alone, rtol=1e-5)
    import torch
    state = torch.ones((3, 2))
    out = lstm_cuda.apply_reset(state, torch.tensor([1, 0, 1]),
                                torch.tensor([-1, -1, 0], dtype=torch.int32))
    assert out.tolist() == [[0, 0], [1, 1], [1, 1]]


def test_registry_names_are_pinned():
    assert [l.name for l in layouts.LAYOUTS] == [
        "xl", "packed-carry", "slotted-carry", "packed-nocarry",
        "slotted-bucketed"]


# (label, cfg, rcfg, layout, environment): the JAX registry's choice with
# the fused CE on (tests/test_layout_registry.py), which the port must make
# too; the environment holds the packed layouts' opt-outs
MATRIX = [
    ("lstm carry", LSTM, dict(carry_over=True), "packed-carry", {}),
    ("lstm no-carry", LSTM, dict(carry_over=False), "packed-nocarry", {}),
    ("bayes no-carry", {**LSTM, **CORES["bayes3"]}, dict(carry_over=False),
     "packed-nocarry", {}),
    ("gp no-carry", {**LSTM, **CORES["gp13"]}, dict(carry_over=False),
     "packed-nocarry", {}),
    ("tm", TM, dict(carry_over=False), "packed-nocarry", {}),
    ("tm carry", TM, dict(carry_over=True), "packed-nocarry", {}),
    ("tm xl", TM, dict(carry_over=False, xl_mems=True), "xl", {}),
    ("lstm carry opted out", LSTM, dict(carry_over=True), "slotted-carry",
     {"BAYESLM_PACKED_CARRY": "0"}),
    ("lstm mc", {**LSTM, **CORES["bayes3"]},
     dict(carry_over=False, mc_samples=2), "slotted-bucketed", {}),
]


@pytest.mark.parametrize("label,cfg_kw,rcfg_kw,expect,env", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_selection_matches_jax(monkeypatch, label, cfg_kw, rcfg_kw, expect,
                               env):
    _fused_on(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = dict(max_hyp_len=16, batch_size=4, **rcfg_kw)
    jcfg = jx.ModelConfig(**cfg_kw)
    js = JaxScorer(jcfg, jx.init_params(jx.build_model(jcfg), jcfg),
                   jx.RescoreConfig(**rc))
    js.use_fused_ce = True
    assert jlayouts.select(js).name == expect
    cfg = bt.ModelConfig(**cfg_kw)
    s = BatchScorer(cfg, bt.init_params(bt.build_model(cfg), cfg),
                    bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(s).name == expect


def test_every_port_layout_is_reachable():
    assert {m[3] for m in MATRIX} == {l.name for l in layouts.LAYOUTS}


def test_past_the_table_raises_naming_the_item(monkeypatch):
    """``slotted-bucketed`` matches every configuration; a table without it
    runs past its end and raises the JAX registry's AssertionError."""
    monkeypatch.setattr(layouts, "LAYOUTS", ())
    with pytest.raises(AssertionError, match="unreachable: slotted-bucketed"):
        layouts.select(object())


def test_gather_plan_sums_each_hypothesis_in_a_fixed_order():
    """``common.build_rows``' plan and ``fused_scores_packed``: each score
    is the sum of its own hypothesis's target CEs (held to a float64 sum a
    hypothesis), segments in any order, the padding of the (hypotheses,
    longest) matrix read as 0, the same bits from a second call."""
    import types

    import torch
    from bayeslms_tpu_torch.ops import ce_cuda
    from bayeslms_tpu_torch.rescore.layouts import common

    rng = np.random.default_rng(0)
    T, C, H = 12, 5, 8
    rows, offs = [], []
    for c in range(C):
        t = 0
        while t < T - 1:
            L = int(rng.integers(1, T - t))
            x = rng.integers(0, V, L).tolist()
            rows.append((c, x, x[1:] + [1]))
            offs.append(t)
            t += L
    segs = rng.permutation(len(rows))
    data, tgt, mask, plan = common.build_rows(rows, T, C, offs, segs)
    idx, cols, row_seg = plan
    assert cols.shape == (len(rows), max(len(r[1]) for r in rows))
    assert (np.sort(cols[cols < len(idx)]) == np.arange(len(idx))).all()
    emb = torch.randn((V, H), generator=torch.Generator().manual_seed(1))
    # a tied model: its decoder weight is the embedding
    model = types.SimpleNamespace(embedding=emb, decoder_weight=emb,
                                  decoder_b=torch.zeros((V,)))
    h = torch.randn((T * C, H), generator=torch.Generator().manual_seed(2))
    t_flat = torch.from_numpy(tgt.reshape(-1))
    to = [torch.from_numpy(a) for a in plan]
    scorer = types.SimpleNamespace(model=model, interp=0)
    got = common.fused_scores_packed(scorer, h, t_flat, to, len(rows))
    again = common.fused_scores_packed(scorer, h, t_flat, to, len(rows))
    assert torch.equal(got, again)
    ce = ce_cuda.ce_plain(h[to[0]], model.embedding, model.decoder_b,
                          t_flat[to[0]]).double().numpy()
    lens = np.array([len(r[1]) for r in rows])
    start = np.cumsum(lens) - lens
    want = np.zeros(len(rows))
    want[segs] = [ce[a:a + L].sum() for a, L in zip(start, lens)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert mask.sum() == lens.sum()
