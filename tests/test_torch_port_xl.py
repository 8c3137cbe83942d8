"""Transformer-XL memories in the port (``TransformerLM`` ``mems`` /
``mem_len`` / ``return_mems``, the ``xl`` scoring layout) against their
definition and against the JAX package on the CPU, float32, from the same
weights (the existing weight exchange):

- the three cases of tests/test_xl_mems.py on the port's model: memories
  give the suffix of a full-context forward, right-padded memories with
  ``mem_len`` equal exact ones, empty memories equal the plain forward
  (the JAX test's tolerances);
- the forward with memories against the JAX model at rtol 2e-4 / atol
  1e-5 (the golden tests');
- ``BatchScorer(xl_mems=True).score_nbest`` against the JAX scorer on 2
  chains x 3 utterances, one longer than ``max_hyp_len``, at rtol 1e-4 /
  atol 1e-5 (the scorer tests');
- the scorer's refusals, in JAX's words."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 30


def _cfg(pkg, pos="none", dropout=0.0):
    return pkg.ModelConfig(
        model="Transformer", vocab_size=V, emsize=8, nhid=16, nlayers=2,
        nhead=2, dropout=dropout, uncertainty="none" if pos == "none"
        else "Bayesian", t_bayes_pos=pos)


def _setup(pos="none"):
    cfg = _cfg(bt, pos)
    model = bt.build_model(cfg)
    tree = bt.init_params(model, cfg)
    full = np.random.default_rng(0).integers(0, V, size=(12, 3))
    return model, tree, torch.from_numpy(full)


@torch.no_grad()
def test_mems_equal_full_context_suffix():
    model, _, full = _setup()
    seg1, seg2 = full[:7], full[7:]
    logits_full = model(full)
    logits1, mems = model(seg1, return_mems=True)
    assert len(mems) == 2 and mems[0].shape == (7, 3, 8)
    np.testing.assert_allclose(logits1.numpy(), logits_full[:7].numpy(),
                               rtol=1e-5, atol=1e-6)
    logits2 = model(seg2, mems=mems)
    np.testing.assert_allclose(logits2.numpy(), logits_full[7:].numpy(),
                               rtol=1e-4, atol=1e-5)


@torch.no_grad()
def test_right_padded_mems_equal_unpadded():
    model, _, full = _setup()
    seg1, seg2 = full[:7], full[7:]
    _, mems = model(seg1, return_mems=True)
    exact = model(seg2, mems=mems)
    padded = [torch.cat([m, torch.full((5,) + m.shape[1:], 7.0)], 0)
              for m in mems]
    got = model(seg2, mems=padded, mem_len=7)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-6)


@torch.no_grad()
def test_empty_mems_equal_plain():
    model, _, full = _setup()
    seg2 = full[7:]
    empty = [torch.zeros((0, 3, 8)) for _ in range(2)]
    np.testing.assert_allclose(model(seg2, mems=empty).numpy(),
                               model(seg2).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pos", ["none", "EMB"])
@torch.no_grad()
def test_forward_with_mems_matches_jax(pos):
    model, tree, full = _setup(pos)
    jm = jx.build_model(_cfg(jx, pos))
    jp = jax.tree.map(jnp.asarray, tree)
    seg1, seg2 = full[:7], full[7:]
    jl1, jmems = jm.apply({"params": jp}, jnp.asarray(seg1.numpy()),
                          deterministic=True, return_mems=True)
    l1, mems = model(seg1, return_mems=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), rtol=2e-4,
                               atol=1e-5)
    for a, b in zip(mems, jmems):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5)
    # right-padded memories, a real length, the hidden states too
    pad = [torch.cat([m, torch.full((3,) + m.shape[1:], -2.0)], 0)
           for m in mems]
    jpad = [jnp.asarray(m.numpy()) for m in pad]
    for hidden in (False, True):
        ref = jm.apply({"params": jp}, jnp.asarray(seg2.numpy()),
                       deterministic=True, mems=jpad, mem_len=7,
                       return_hidden=hidden)
        got = model(seg2, mems=pad, mem_len=7, return_hidden=hidden)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=1e-5)


def test_pack_mask_with_mems_raises():
    model, _, full = _setup()
    with torch.no_grad():
        _, mems = model(full[:4], return_mems=True)
        with pytest.raises(ValueError, match="pack_mask"):
            model(full[4:], mems=mems, positions=torch.zeros_like(full[4:]),
                  pack_mask=torch.zeros((3, 1, 8, 8)))


W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}


def _nbest():
    """2 chains (recordings) x 3 utterances, uneven hypothesis counts; one
    utterance longer than max_hyp_len (its memory keeps BOS and its last
    tokens), an OOV word."""
    rng = np.random.default_rng(4)
    nbest = OrderedDict()
    for u in range(3):
        for m in ("recA", "recB"):
            n = int(rng.integers(1, 5))
            nbest[f"{m}_utt{u}"] = [
                " ".join(f"w{rng.integers(2, V)}"
                         for _ in range(rng.integers(1, 12)))
                for _ in range(n)]
    nbest["recA_utt0"][0] = " ".join(f"w{rng.integers(2, V)}"
                                     for _ in range(30))
    nbest["recB_utt1"][0] += " oov1 w3"
    return nbest


def stream_of(key):
    return key.split("_")[0]


@pytest.mark.parametrize("pos", ["none", "EMB"])
def test_xl_scores_match_jax(pos):
    rc = dict(xl_mems=True, max_hyp_len=24)
    cfg = _cfg(bt, pos, dropout=0.1)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=2)
    nbest = _nbest()
    ref = JaxScorer(_cfg(jx, pos, dropout=0.1),
                    jax.tree.map(np.asarray, params),
                    jx.RescoreConfig(**rc)).score_nbest(nbest, W2I,
                                                        stream_fn=stream_of)
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(scorer).name == "xl"
    got = scorer.score_nbest(nbest, W2I, stream_fn=stream_of)
    assert list(got) == list(ref)
    for k in nbest:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # memories matter: without them (packed-nocarry) the later utterances
    # score otherwise, the chains' first ones the same
    plain = BatchScorer(cfg, params, bt.RescoreConfig(max_hyp_len=24),
                        device="cpu").score_nbest(nbest, W2I)
    np.testing.assert_allclose([s for _, s in plain["recA_utt0"]],
                               [s for _, s in got["recA_utt0"]], rtol=1e-4,
                               atol=1e-5)
    assert max(abs(a[1] - b[1]) for a, b in zip(plain["recA_utt1"],
                                                 got["recA_utt1"])) > 1e-3


@pytest.mark.parametrize("case", [
    dict(cfg=dict(pos="FFN")), dict(cfg=dict(pos="MHA")),
    dict(model="LSTM"), dict(rc=dict(inter_flag=1)),
    dict(rc=dict(mc_samples=2)), dict(rc=dict(splice_len=3))])
def test_scorer_refusals_match_jax(case):
    pos = case.get("cfg", {}).get("pos", "none")
    rc = dict(xl_mems=True, **case.get("rc", {}))

    def make(pkg):
        if case.get("model") == "LSTM":
            return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=8,
                                   nhid=8)
        return _cfg(pkg, pos)

    cfg = make(bt)
    params = bt.init_params(bt.build_model(cfg), cfg)
    jparams = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError) as jerr:
        JaxScorer(make(jx), jparams, jx.RescoreConfig(**rc),
                  cfg2=make(jx), params2=jparams)
    with pytest.raises(ValueError) as err:
        BatchScorer(cfg, params, bt.RescoreConfig(**rc), device="cpu")
    assert str(err.value) == str(jerr.value)
