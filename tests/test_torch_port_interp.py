"""Interpolated scoring with a second model (``inter_flag`` 1, logit-level;
2, score-level) of the port against the JAX package's ``BatchScorer`` on
the CPU (its slotted layouts, unfused there), on the same weights: a
Bayesian LSTM (``l_bayes_pos`` 3) with a standard LSTM of another width,
and two Transformers of different widths, through every layout that takes
the pair (packed-carry, slotted-carry, packed-nocarry, slotted-bucketed;
the slotted ones through the packed layouts' opt-outs). Scores rtol 1e-4
/ atol 1e-5 (the scorer tests'). And the identity the fused interpolated
CE rests on, and the configurations the scorer refuses at construction,
before any device work."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.rescore import layouts as jlayouts
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.layouts import common
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
LSTM1 = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0,
             uncertainty="Bayesian", l_bayes_pos=3)
LSTM2 = dict(model="LSTM", vocab_size=V, emsize=24, nhid=24, dropout=0.0)
TM1 = dict(model="Transformer", vocab_size=V, emsize=16, nhid=24, nlayers=2,
           nhead=2, dropout=0.0)
TM2 = dict(model="Transformer", vocab_size=V, emsize=24, nhid=32, nlayers=1,
           nhead=2, dropout=0.0)
OPT_OUT = {"packed-carry": None, "slotted-carry": "BAYESLM_PACKED_CARRY",
           "packed-nocarry": None,
           "slotted-bucketed": ("BAYESLM_PACKED_NOCARRY", "BAYESLM_PACKED_TM")}


def _nbest():
    """Two chains of uneven length, uneven hypothesis counts, a hypothesis
    past max_hyp_len, an empty one and OOV words."""
    rng = np.random.default_rng(11)
    nbest = OrderedDict()
    for u in range(6):
        nbest[f"A_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(1, 12)))
            for _ in range(rng.integers(1, 4))]
    for u in range(3):
        nbest[f"B_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(1, 9)))
            for _ in range(3)]
    nbest["A_2"].append(" ".join(f"w{rng.integers(2, V)}" for _ in range(25)))
    nbest["B_1"].append("")
    nbest["B_2"][0] += " oov1 w3 oov2"
    return nbest


def _stream(key):
    return key.split("_")[0]


def _params(cfg_kw, seed):
    cfg = bt.ModelConfig(**cfg_kw)
    p = bt.init_params(bt.build_model(cfg), cfg, seed=seed)
    p["decoder_b"] = np.random.default_rng(seed).normal(
        size=cfg.vocab_size).astype(np.float32) * 0.2
    return p


def _assert_scores(got, ref, atol=1e-5):
    assert list(got) == list(ref)
    for k in ref:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=atol, err_msg=k)


def jax_scores(monkeypatch, c1, p1, c2, p2, rc, nbest, **kw):
    """The JAX scorer's pass (its slotted layouts on the CPU)."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    js = JaxScorer(jx.ModelConfig(**c1), jax.tree.map(jnp.asarray, p1),
                   jx.RescoreConfig(**rc),
                   None if c2 is None else jx.ModelConfig(**c2),
                   None if p2 is None else jax.tree.map(jnp.asarray, p2))
    assert jlayouts.select(js).name.startswith("slotted")
    return js.score_nbest(nbest, W2I, **kw)


LAYOUT_CASES = [(fam, flag, layout)
                for fam, lays in (("lstm", ("packed-carry", "slotted-carry",
                                            "packed-nocarry",
                                            "slotted-bucketed")),
                                  ("tm", ("packed-nocarry",
                                          "slotted-bucketed")))
                for flag in (1, 2) for layout in lays]


@pytest.mark.parametrize("fam,flag,layout", LAYOUT_CASES,
                         ids=[f"{f}-{g}-{l}" for f, g, l in LAYOUT_CASES])
def test_interpolated_scores_match_jax(monkeypatch, fam, flag, layout):
    c1, c2 = (LSTM1, LSTM2) if fam == "lstm" else (TM1, TM2)
    p1, p2 = _params(c1, 1), _params(c2, 2)
    carry = layout.endswith("carry") and not layout.endswith("nocarry")
    rc = dict(carry_over=carry, max_hyp_len=16, batch_size=4,
              carry_chunk_utts=2, inter_flag=flag, inter_alpha=0.7)
    nbest = _nbest()
    ref = jax_scores(monkeypatch, c1, p1, c2, p2, rc, nbest,
                     stream_fn=_stream)
    env = OPT_OUT[layout]
    for name in (env,) if isinstance(env, str) else env or ():
        monkeypatch.setenv(name, "0")
    scorer = BatchScorer(bt.ModelConfig(**c1), p1, bt.RescoreConfig(**rc),
                         bt.ModelConfig(**c2), p2, device="cpu")
    assert layouts.select(scorer).name == layout
    got = scorer.score_nbest(nbest, W2I, stream_fn=_stream)
    _assert_scores(got, ref)
    assert scorer.oov_stats["total"] == 2


def test_alpha_one_is_the_first_model_alone():
    """At alpha 1 both flags score as the first model does alone, and the
    flags differ at alpha 0.5 (logit against score interpolation)."""
    p1, p2 = _params(LSTM1, 1), _params(LSTM2, 2)
    nbest = _nbest()
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=2)
    alone = BatchScorer(bt.ModelConfig(**LSTM1), p1, bt.RescoreConfig(**rc),
                        device="cpu").score_nbest(nbest, W2I)
    half = []
    for flag in (1, 2):
        for a in (1.0, 0.5):
            s = BatchScorer(bt.ModelConfig(**LSTM1), p1,
                            bt.RescoreConfig(**rc, inter_flag=flag,
                                             inter_alpha=a),
                            bt.ModelConfig(**LSTM2), p2, device="cpu")
            got = s.score_nbest(nbest, W2I)
            if a == 1.0:
                _assert_scores(got, alone, atol=1e-4)
            else:
                half.append([v for k in got for _, v in got[k]])
    assert np.abs(np.subtract(*half)).max() > 1e-3


@pytest.mark.parametrize("flag", [1, 2])
def test_fused_interpolated_ce_is_the_interpolated_distribution(flag):
    """``interp_m2`` and ``fused_ce_tokens`` against the CE of the
    interpolated logits a h1 W1' + (1 - a) h2 W2' (flag 1) and the
    interpolated CEs (flag 2), computed from the two decoders."""
    p1, p2 = _params(LSTM1, 1), _params(LSTM2, 2)
    a = 0.3
    s = BatchScorer(bt.ModelConfig(**LSTM1), p1,
                    bt.RescoreConfig(inter_flag=flag, inter_alpha=a),
                    bt.ModelConfig(**LSTM2), p2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    h1 = torch.randn((40, 16), generator=gen)
    h2 = torch.randn((40, 24), generator=gen)
    tgt = torch.randint(0, V, (40,), generator=gen)
    W1, b1 = (torch.from_numpy(p1[k]) for k in ("embedding", "decoder_b"))
    W2, b2 = (torch.from_numpy(p2[k]) for k in ("embedding", "decoder_b"))
    l1, l2 = h1 @ W1.t() + b1, h2 @ W2.t() + b2
    ce = torch.nn.functional.cross_entropy
    if flag == 1:
        want = ce(a * l1 + (1 - a) * l2, tgt, reduction="none")
        assert s.m2[0].shape == (V, 40)
    else:
        want = (a * ce(l1, tgt, reduction="none")
                + (1 - a) * ce(l2, tgt, reduction="none"))
    got = common.fused_ce_tokens(s, h1, h2, tgt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


REFUSALS = {
    "lstm-with-tm": (LSTM1, TM1, dict(inter_flag=1), "one family"),
    "tm-with-lstm": (TM1, LSTM2, dict(inter_flag=2), "one family"),
    "vocabulary": (LSTM1, {**LSTM2, "vocab_size": V + 1},
                   dict(inter_flag=1), "vocabulary"),
    "no-second-model": (LSTM1, None, dict(inter_flag=2), "second model"),
    "mc-with-interpolation": (LSTM1, LSTM2,
                              dict(inter_flag=1, mc_samples=2,
                                   carry_over=False), "interpolation"),
    "mc-with-carry-over": (LSTM1, None, dict(mc_samples=2, carry_over=True),
                           "carry_over=False"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused_configurations_raise_before_device_work(monkeypatch, case):
    """ValueError at construction, on a machine without a card and with no
    device named: the refusal comes before the scorer asks for one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c1, c2, rc, match = REFUSALS[case]
    p1 = _params(c1, 1)
    p2 = None if c2 is None or case == "no-second-model" else \
        _params(c2, 2)
    with pytest.raises(ValueError, match=match):
        BatchScorer(bt.ModelConfig(**c1), p1, bt.RescoreConfig(**rc),
                    None if c2 is None else bt.ModelConfig(**c2), p2)
