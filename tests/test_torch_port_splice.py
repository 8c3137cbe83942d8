"""Backward and context-spliced scoring of the port against the JAX
package's ``BatchScorer`` on the CPU (its slotted layouts, unfused there),
on the same weights: ``splice_len`` 3 with the automatic context map (each
utterance spliced with the first hypotheses before it in its chain) and
with a given one, and ``backward`` (each hypothesis's words reversed),
through every layout that takes them (the LSTM's four, the
Transformer's two; the slotted ones through the packed layouts'
opt-outs). Spliced-context targets condition the model and are not
scored. Scores rtol 1e-4 / atol 1e-5 (the scorer tests')."""

from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.models.lstm_lm import init_hidden
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.layouts import common
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
LSTM = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0)
TM = dict(model="Transformer", vocab_size=V, emsize=16, nhid=24, nlayers=2,
          nhead=2, dropout=0.0)
OPT_OUTS = ("BAYESLM_PACKED_CARRY", "BAYESLM_PACKED_NOCARRY",
            "BAYESLM_PACKED_TM")


def _nbest():
    rng = np.random.default_rng(21)
    nbest = OrderedDict()
    for u in range(6):
        nbest[f"{'AB'[u % 2]}_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(1, 10)))
            for _ in range(rng.integers(1, 4))]
    nbest["A_2"].append(" ".join(f"w{rng.integers(2, V)}" for _ in range(20)))
    nbest["B_3"][0] += " oov1 w3"
    return nbest


def _stream(key):
    return key.split("_")[0]


def _context(nbest):
    """A given context map: a few words for every utterance, one with an
    OOV word, one empty."""
    rng = np.random.default_rng(2)
    ctx = {k: " ".join(f"w{rng.integers(2, V)}"
                       for _ in range(rng.integers(1, 6))) for k in nbest}
    ctx["A_0"] = ""
    ctx["B_1"] += " zz"
    return ctx


def _assert_scores(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


LAYOUTS = [("lstm", True, False), ("lstm", True, True),
           ("lstm", False, False), ("lstm", False, True),
           ("tm", False, False), ("tm", False, True)]
MODES = ["splice-auto", "splice-map", "backward"]
CASES = [(m, *lay) for m in MODES for lay in LAYOUTS]


def _name(fam, carry, slotted):
    if fam == "lstm" and carry:
        return "slotted-carry" if slotted else "packed-carry"
    return "slotted-bucketed" if slotted else "packed-nocarry"


@pytest.mark.parametrize(
    "mode,fam,carry,slotted", CASES,
    ids=[f"{m}-{f}-{_name(f, c, s)}" for m, f, c, s in CASES])
def test_scores_match_jax(monkeypatch, mode, fam, carry, slotted):
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    cfg_kw = LSTM if fam == "lstm" else TM
    rc = dict(carry_over=carry, max_hyp_len=16, batch_size=4,
              carry_chunk_utts=2, splice_len=0 if mode == "backward" else 3,
              backward=mode == "backward")
    jcfg = jx.ModelConfig(**cfg_kw)
    jp = jx.init_params(jx.build_model(jcfg), jcfg, seed=8)
    nbest = _nbest()
    ctx = _context(nbest) if mode == "splice-map" else None
    ref = JaxScorer(jcfg, jp, jx.RescoreConfig(**rc)).score_nbest(
        nbest, W2I, stream_fn=_stream, context_map=ctx)
    if slotted:
        for name in OPT_OUTS:
            monkeypatch.setenv(name, "0")
    s = BatchScorer(bt.ModelConfig(**cfg_kw), jax.tree.map(np.asarray, jp),
                    bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(s).name == _name(fam, carry, slotted)
    got = s.score_nbest(nbest, W2I, stream_fn=_stream, context_map=ctx)
    _assert_scores(got, ref)


def test_context_targets_condition_the_model_but_are_not_scored():
    """A spliced hypothesis scores its own targets only: the sum of those
    CEs in a forward over <s> + context + hypothesis; a plan that kept the
    context targets would score more (every CE is positive). And
    ``build_rows``' plan holds len - n_ctx targets a hypothesis, whatever
    its time offset in a packed column."""
    cfg = bt.ModelConfig(**LSTM)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    rc = bt.RescoreConfig(carry_over=False, max_hyp_len=16, splice_len=3)
    s = BatchScorer(cfg, params, rc, device="cpu")
    nbest = OrderedDict(u=["w5 w6 w7", "w8"])
    got = s.score_nbest(nbest, W2I, context_map={"u": "w2 w9 w10 w11"})
    ctx = [9, 10, 11]
    for i, hyp in enumerate(nbest["u"]):
        ids = [W2I[w] for w in hyp.split()]
        inp = torch.tensor([1] + ctx + ids)[:, None]
        tgt = torch.tensor(ctx + ids + [1])
        with torch.no_grad():
            logits, _ = s.model(inp, init_hidden(2, 1, 16))
        ce = torch.nn.functional.cross_entropy(logits[:, 0], tgt,
                                               reduction="none")
        np.testing.assert_allclose(got["u"][i][1], float(ce[3:].sum()),
                                   rtol=1e-5)
        assert float(ce.sum()) > got["u"][i][1] + 1e-3
    rows = [(0, [1, 9, 10, 5], [9, 10, 5, 1], 2), (0, [1, 7, 8], [7, 8, 1], 0),
            (1, [1, 4, 4, 4, 4], [4, 4, 4, 4, 1], 3)]
    _, _, mask, (idx, cols, segs) = common.build_rows(rows, 8, 2, [0, 4, 0],
                                                      [0, 1, 2])
    assert int(mask.sum()) == 12 and len(idx) == 2 + 3 + 2
    assert sorted(idx.tolist()) == sorted([2 * 2, 3 * 2, 4 * 2, 5 * 2, 6 * 2,
                                           3 * 2 + 1, 4 * 2 + 1])
    assert (cols < len(idx)).sum(axis=1).tolist() == [2, 3, 2]
