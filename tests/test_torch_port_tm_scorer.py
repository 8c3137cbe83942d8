"""The port's Transformer scoring through the packed-nocarry layout
(``rescore/layouts/packed.py`` ``score_packed_nocarry``) against the JAX
package's ``BatchScorer`` forced onto its packed-nocarry layout with the
fused CE kernel in interpret mode (as test_torch_port_scorer.py forces
packed-carry), on the same weights: best-fit-decreasing columns,
per-segment positions and the segment-causal mask. Scores rtol 1e-4 /
atol 1e-5 (the scorer tests')."""

from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.nbest import encode_hyp
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}


def _cfg(pkg, pos):
    return pkg.ModelConfig(model="Transformer", vocab_size=V, emsize=16,
                           nhid=24, nlayers=2, nhead=2, dropout=0.1,
                           uncertainty="none" if pos == "none" else "Bayesian",
                           t_bayes_pos=pos)


def _nbest(n_utts=9):
    """Uneven hypothesis counts and lengths, one hypothesis longer than
    max_hyp_len, an empty one and OOV words."""
    rng = np.random.default_rng(11)
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


@pytest.mark.parametrize("pos,batch_size,blocks", [
    ("none", 20, 2), ("none", 100, 1), ("FFN", 20, 2), ("EMB", 20, 2)])
def test_packed_nocarry_scores_match_jax(monkeypatch, pos, batch_size,
                                         blocks):
    """One forward a block of Bc columns, as the JAX scan does: at
    max_hyp_len 126 (T = 128 steps a column) ``batch_size`` 20 makes blocks
    of 8 columns (two here), 100 blocks of 24 (one)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    rc = dict(carry_over=True, max_hyp_len=126, batch_size=batch_size)
    cfg = _cfg(bt, pos)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    nbest = _nbest(n_utts=70)

    ref_scorer = JaxScorer(_cfg(jx, pos), jax.tree.map(np.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_nocarry_allowed()
    ref = ref_scorer.score_nbest(nbest, W2I)

    scorer = BatchScorer(cfg, params, bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(scorer).name == "packed-nocarry"
    calls = []
    forward = scorer.model.forward
    scorer.model.forward = lambda *a, **kw: calls.append(1) or forward(*a, **kw)
    got = scorer.score_nbest(nbest, W2I)
    assert len(calls) == blocks
    assert list(got) == list(ref)
    for k in nbest:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert scorer.oov_stats == ref_scorer.oov_stats
    assert scorer.oov_stats["total"] == 2


def test_packed_scores_equal_one_hypothesis_at_a_time():
    """Packing changes nothing: each score equals the sum of the token CEs
    of that hypothesis run alone through the model's causal forward."""
    cfg = _cfg(bt, "MHA")
    params = bt.init_params(bt.build_model(cfg), cfg, seed=4)
    nbest = _nbest()
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(max_hyp_len=126),
                         device="cpu")
    got = scorer.score_nbest(nbest, W2I)
    with torch.no_grad():
        for k, hyps in nbest.items():
            for (hyp, score), h in zip(got[k], hyps):
                x, y, _, _ = encode_hyp(h, W2I)
                x, y = x[:126], y[:126]
                logits = scorer.model(torch.tensor(x)[:, None])[:, 0]
                ce = torch.nn.functional.cross_entropy(
                    logits, torch.tensor(y), reduction="sum")
                np.testing.assert_allclose(score, float(ce), rtol=1e-5,
                                           atol=1e-5)
