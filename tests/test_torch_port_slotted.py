"""The port's slotted layouts (``rescore/layouts/slotted.py``) and its
five-layout registry against the JAX package on the CPU.

The registry: its names in the JAX package's order, and the selection
matrix of tests/test_layout_registry.py (the JAX scorer forced onto its
fused CE, in interpret mode, where its packed layouts need it), opt-outs
and MC included; every layout reached. The scores: ``slotted-carry`` and
``slotted-bucketed`` (reached through the opt-outs) equal to the JAX
scorer's slotted passes (unfused on the CPU) for the standard LSTM, the
Bayesian LSTM at its posterior mean and the Transformer; and the packed
layouts equal to the slotted ones inside the port. Scores rtol 1e-4 /
atol 1e-5 (the scorer tests')."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.rescore import layouts as jlayouts
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
LSTM = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0)
BAYES = {**LSTM, "uncertainty": "Bayesian", "l_bayes_pos": 3}
TM = dict(model="Transformer", vocab_size=V, emsize=16, nhid=24, nlayers=2,
          nhead=2, dropout=0.0)
MODELS = {"standard": LSTM, "bayes3": BAYES, "tm": TM}


def test_registry_names_are_jax_names_in_jax_order():
    assert [l.name for l in layouts.LAYOUTS] == [
        l.name for l in jlayouts.LAYOUTS] == [
        "xl", "packed-carry", "slotted-carry", "packed-nocarry",
        "slotted-bucketed"]


# (label, cfg, rcfg, opt-outs set to 0, layout): the JAX registry's choice
# with its fused CE on, which the port must make too
MATRIX = [
    ("lstm carry", LSTM, dict(carry_over=True), (), "packed-carry"),
    ("lstm carry, opted out", LSTM, dict(carry_over=True),
     ("BAYESLM_PACKED_CARRY",), "slotted-carry"),
    ("lstm no-carry", LSTM, dict(carry_over=False), (), "packed-nocarry"),
    ("lstm no-carry, opted out", LSTM, dict(carry_over=False),
     ("BAYESLM_PACKED_NOCARRY",), "slotted-bucketed"),
    ("tm", TM, dict(carry_over=False), (), "packed-nocarry"),
    ("tm, opted out", TM, dict(carry_over=False), ("BAYESLM_PACKED_TM",),
     "slotted-bucketed"),
    ("tm carry, nocarry opt-out only", TM, dict(carry_over=True),
     ("BAYESLM_PACKED_NOCARRY",), "packed-nocarry"),
    ("tm xl", TM, dict(carry_over=False, xl_mems=True), (), "xl"),
    ("tm mc", TM, dict(carry_over=False, mc_samples=2), (),
     "slotted-bucketed"),
    ("bayes mc", BAYES, dict(carry_over=False, mc_samples=2), (),
     "slotted-bucketed"),
    ("lstm pair carry", LSTM, dict(carry_over=True, inter_flag=1), (),
     "packed-carry"),
    ("tm pair", TM, dict(carry_over=False, inter_flag=2), (),
     "packed-nocarry"),
]


@pytest.mark.parametrize("label,cfg_kw,rcfg_kw,env,expect", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_selection_matrix_matches_jax(monkeypatch, label, cfg_kw, rcfg_kw,
                                      env, expect):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    for name in env:
        monkeypatch.setenv(name, "0")
    rc = dict(max_hyp_len=16, batch_size=4, **rcfg_kw)
    pair = rc.get("inter_flag", 0)
    jcfg = jx.ModelConfig(**cfg_kw)
    jp = jx.init_params(jx.build_model(jcfg), jcfg)
    js = JaxScorer(jcfg, jp, jx.RescoreConfig(**rc), jcfg if pair else None,
                   jp if pair else None)
    js.use_fused_ce = True
    assert jlayouts.select(js).name == expect
    cfg = bt.ModelConfig(**cfg_kw)
    p = jax.tree.map(np.asarray, jp)
    s = BatchScorer(cfg, p, bt.RescoreConfig(**rc), cfg if pair else None,
                    p if pair else None, device="cpu")
    assert layouts.select(s).name == expect


def test_every_layout_is_reached_by_the_matrix():
    assert {m[4] for m in MATRIX} == {l.name for l in layouts.LAYOUTS}


def _nbest():
    """Chains of uneven length, hypotheses across the length buckets of
    max_hyp_len 32 (16, 24, 32), one past it, an empty one and OOV words."""
    rng = np.random.default_rng(9)
    nbest = OrderedDict()
    for u in range(7):
        nbest[f"{'AB'[u % 2]}_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(1, 28)))
            for _ in range(rng.integers(1, 5))]
    nbest["A_2"].append(" ".join(f"w{rng.integers(2, V)}" for _ in range(40)))
    nbest["B_3"].append("")
    nbest["A_4"][0] += " oov1 w3 oov2"
    return nbest


def _stream(key):
    return key.split("_")[0]


def _scores(res):
    return [s for pairs in res.values() for _, s in pairs]


def _assert_scores(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


CASES = [("standard", True), ("bayes3", True), ("standard", False),
         ("bayes3", False), ("tm", False)]


@pytest.mark.parametrize("model,carry", CASES,
                         ids=[f"{m}-{'carry' if c else 'bucketed'}"
                              for m, c in CASES])
def test_slotted_scores_match_jax(monkeypatch, model, carry):
    """The port forced onto its slotted layout (the opt-out of the packed
    one) against the JAX scorer's slotted pass, chunks of 3 utterances,
    rows of 4 columns."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    for name in ("BAYESLM_PACKED_CARRY", "BAYESLM_PACKED_NOCARRY",
                 "BAYESLM_PACKED_TM"):
        monkeypatch.setenv(name, "0")
    cfg_kw = MODELS[model]
    rc = dict(carry_over=carry, max_hyp_len=32, batch_size=4,
              carry_chunk_utts=3)
    jcfg = jx.ModelConfig(**cfg_kw)
    jp = jx.init_params(jx.build_model(jcfg), jcfg, seed=4)
    jp = {**jp, "decoder_b": jnp.asarray(np.random.default_rng(1).normal(
        size=V).astype(np.float32) * 0.2)}
    nbest = _nbest()
    js = JaxScorer(jcfg, jp, jx.RescoreConfig(**rc))
    ref = js.score_nbest(nbest, W2I, stream_fn=_stream)
    s = BatchScorer(bt.ModelConfig(**cfg_kw), jax.tree.map(np.asarray, jp),
                    bt.RescoreConfig(**rc), device="cpu")
    want = "slotted-carry" if carry and model != "tm" else "slotted-bucketed"
    assert layouts.select(s).name == jlayouts.select(js).name == want
    got = s.score_nbest(nbest, W2I, stream_fn=_stream)
    _assert_scores(got, ref)
    assert s.oov_stats == js.oov_stats


@pytest.mark.parametrize("model,carry", CASES,
                         ids=[f"{m}-{'carry' if c else 'nocarry'}"
                              for m, c in CASES])
def test_packed_equals_slotted_in_the_port(monkeypatch, model, carry):
    """The same pass through the packed layout and through its slotted
    twin (the opt-out), on the same scorer configuration."""
    cfg = bt.ModelConfig(**MODELS[model])
    params = bt.init_params(bt.build_model(cfg), cfg, seed=6)
    rc = bt.RescoreConfig(carry_over=carry, max_hyp_len=32, batch_size=4,
                          carry_chunk_utts=2)
    nbest = _nbest()
    packed = BatchScorer(cfg, params, rc, device="cpu")
    assert layouts.select(packed).name.startswith("packed")
    a = packed.score_nbest(nbest, W2I, stream_fn=_stream)
    for name in ("BAYESLM_PACKED_CARRY", "BAYESLM_PACKED_NOCARRY",
                 "BAYESLM_PACKED_TM"):
        monkeypatch.setenv(name, "0")
    assert layouts.select(packed).name.startswith("slotted")
    b = packed.score_nbest(nbest, W2I, stream_fn=_stream)
    _assert_scores(a, b)
