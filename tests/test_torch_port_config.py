"""The port's configuration, parameter tree and weight exchange against the
JAX package (bayeslms_tpu_torch vs bayeslms_tpu)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu_torch.core.checkpoint import params_from_jax, params_to_jax

SMALL = dict(model="LSTM", vocab_size=50, emsize=24, nhid=24, dropout=0.0)


@pytest.mark.parametrize("name", ["ModelConfig", "RescoreConfig"])
def test_config_fields_and_defaults_match(name):
    ours = {f.name: f.default for f in dataclasses.fields(getattr(bt, name))}
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jx, name))}
    assert ours == ref


def _jax_params(seed=3):
    cfg = jx.ModelConfig(**SMALL)
    return jax.tree.map(np.asarray, jx.init_params(jx.build_model(cfg), cfg,
                                                   seed=seed))


def test_params_roundtrip_exact():
    tree = _jax_params()
    model = params_from_jax(bt.build_model(bt.ModelConfig(**SMALL)), tree)
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_mismatch():
    tree = _jax_params()
    model = bt.build_model(bt.ModelConfig(**SMALL))
    del tree["core"]["l1_b_hh"]
    with pytest.raises(KeyError):
        params_from_jax(model, tree)
    tree = _jax_params()
    tree["decoder_b"] = tree["decoder_b"][:-1]
    with pytest.raises(ValueError):
        params_from_jax(model, tree)


def test_init_params_tree_and_laws():
    cfg = bt.ModelConfig(**SMALL)
    ours = bt.init_params(bt.build_model(cfg), cfg, seed=5)
    ref = _jax_params()
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, ref)
    assert np.abs(ours["embedding"]).max() <= 0.1
    assert np.abs(ours["embedding"]).max() > 0.09
    np.testing.assert_array_equal(ours["decoder_b"], 0.0)
    bound = 1.0 / np.sqrt(cfg.nhid)
    for leaf in jax.tree.leaves(ours["core"]):
        assert np.abs(leaf).max() <= bound
        assert np.abs(leaf).max() > 0.8 * bound
    again = bt.init_params(bt.build_model(cfg), cfg, seed=5)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [
    dict(model="GRU"),
    dict(nlayers=1),
    dict(nlayers=3),
    dict(model="Transformer", tied=False),
    dict(uncertainty="Variational", nlayers=3),
    dict(tied=False),
])
def test_unported_models_raise(extra):
    """The GRU, LSTMs of other depths and untied decoders build since
    ROADMAP.md A3 landed; an uncertainty core at another depth still
    raises, where the JAX package quietly builds two layers."""
    cfg = bt.ModelConfig(**{**SMALL, **extra})
    if cfg.uncertainty != "none":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            bt.build_model(cfg)
        return
    model = bt.build_model(cfg)
    names = dict(model.named_parameters())
    assert ("decoder_w" in names) == (not cfg.tied)


def test_forward_logits_match_jax():
    """The container's logits path (embedding -> 2-layer LSTM -> tied
    decoder) equals the JAX model's on the same weights."""
    cfg_j = jx.ModelConfig(**SMALL)
    model_j = jx.build_model(cfg_j)
    tree = _jax_params()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab_size"], size=(7, 3)).astype(np.int32)
    h0 = rng.normal(size=(2, 3, SMALL["nhid"])).astype(np.float32) * 0.1
    c0 = rng.normal(size=(2, 3, SMALL["nhid"])).astype(np.float32) * 0.1
    ref, (rh, rc) = model_j.apply({"params": tree}, tokens, (h0, c0),
                                  deterministic=True)
    model = params_from_jax(bt.build_model(bt.ModelConfig(**SMALL)), tree)
    with torch.no_grad():
        got, (gh, gc) = model(torch.from_numpy(tokens).long(),
                              (torch.from_numpy(h0), torch.from_numpy(c0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-5, atol=1e-5)
