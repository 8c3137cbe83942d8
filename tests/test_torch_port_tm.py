"""The port's Transformer LM (``models/transformer_lm.py``), standard and
Bayesian at the FFN, the MHA and the embedding, against the JAX package's
``TransformerLM`` on the CPU, float32, from the same weights: the parameter
tree, the deterministic forward (causal, and packed with positions and a
pack mask), and the training forward with the same dropout masks and eps,
its KL (with and without the prior's means) and every gradient. The JAX
side takes the draws through ``jax.random.bernoulli`` and
``gaussian.sample_diff``, replaced by functions that hand out the injected
numpy draws in call order. Tolerance rtol 2e-4 / atol 1e-5 (the golden
tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu_torch.core.checkpoint import params_from_jax, params_to_jax
from bayeslms_tpu_torch.models.transformer_lm import (EncoderDropoutMasks,
                                                      TransformerDropoutMasks)

RTOL, ATOL = 2e-4, 1e-5
V, E, FF, NL, NH = 40, 16, 24, 2, 2
T, B = 7, 3
POSITIONS = ["none", "FFN", "MHA", "EMB"]


def _cfg(pkg, pos, dropout=0.1, **kw):
    bayes = pos != "none"
    return pkg.ModelConfig(model="Transformer", vocab_size=V, emsize=E,
                           nhid=FF, nlayers=NL, nhead=NH, dropout=dropout,
                           uncertainty="Bayesian" if bayes else "none",
                           t_bayes_pos=pos, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(pos, seed=0, **kw):
    """Both models on the port's initial weights."""
    model = bt.build_model(_cfg(bt, pos, **kw))
    tree = bt.init_params(model, _cfg(bt, pos, **kw), seed=seed)
    jm = jx.build_model(_cfg(jx, pos, **kw))
    return model, tree, jm, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("pos", POSITIONS)
def test_tree_and_deterministic_forward_match_jax(pos):
    model, tree, jm, jp = _pair(pos)
    ref_tree = jx.init_params(jm, _cfg(jx, pos), seed=1)
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    tokens = np.random.default_rng(0).integers(0, V, size=(T, B))
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True)
    hid = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True,
                   return_hidden=True)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
        got_h = model(torch.from_numpy(tokens), return_hidden=True)
    assert got.dtype == torch.float32 and got.shape == (T, B, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hid), rtol=RTOL,
                               atol=ATOL)
    # the exchange walks the tree both ways
    again = params_from_jax(bt.build_model(_cfg(bt, pos)), tree)
    for k, v in _flat(params_to_jax(again)).items():
        np.testing.assert_array_equal(v, _flat(tree)[k])


@pytest.mark.parametrize("pos", ["none", "EMB"])
def test_packed_forward_matches_jax(pos):
    """Per-segment positions and the packed scorer's segment-causal mask,
    with padding rows attending to themselves."""
    model, _, jm, jp = _pair(pos, seed=2)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, V, size=(T, B))
    seg = np.array([[1, 1, 1, 2, 2, 0, 0], [1, 1, 1, 1, 1, 1, 1],
                    [1, 2, 2, 3, 3, 3, 0]])  # (B, T), 0 = padding
    pos_ = np.zeros((B, T), np.int64)
    for b in range(B):
        for t in range(1, T):
            pos_[b, t] = pos_[b, t - 1] + 1 if seg[b, t] == seg[b, t - 1] else 0
    same = seg[:, :, None] == seg[:, None, :]
    valid = (same & np.tril(np.ones((T, T), bool))) | np.eye(T, dtype=bool)
    mask = np.where(valid, 0.0, -np.inf).astype(np.float32)[:, None]
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True,
                   return_hidden=True, positions=jnp.asarray(pos_.T),
                   pack_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), return_hidden=True,
                    positions=torch.from_numpy(pos_.T.copy()),
                    pack_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def draw_masks(rng, pos, dropout):
    """Keep masks in the JAX call order and as the port's structure: the
    embedding's, then per layer the attention probabilities', the attention
    branch's, the FFN middle's and the FFN branch's. The Bayesian layer 0
    drops at 0.2 whatever the model's rate."""
    order = [rng.uniform(size=(T, B, E)) >= dropout]
    layers = []
    for i in range(NL):
        rate = 0.2 if (i == 0 and pos in ("FFN", "MHA")) else dropout
        m = EncoderDropoutMasks(
            rng.uniform(size=(B, NH, T, T)) >= rate,
            rng.uniform(size=(T, B, E)) >= rate,
            rng.uniform(size=(T, B, FF)) >= rate,
            rng.uniform(size=(T, B, E)) >= rate)
        order += list(m)
        layers.append(EncoderDropoutMasks(*map(torch.from_numpy, m)))
    return order, TransformerDropoutMasks(torch.from_numpy(order[0]), layers)


def eps_shape(pos):
    return {"FFN": (E, FF), "MHA": (E, E), "EMB": (E, E)}.get(pos)


@pytest.fixture
def inject(monkeypatch):
    """Make the JAX package's dropout and weight draws hand out the given
    numpy draws in call order; ``install`` returns a check that all were
    taken."""
    def install(masks, eps):
        mit, eit = iter(masks), iter(eps)

        def bernoulli(key, p=0.5, shape=None):
            m = next(mit)
            assert tuple(shape) == m.shape
            return jnp.asarray(m)

        def sample_diff(key, lgstd, scale=1.0):
            e = next(eit)
            assert e.shape == tuple(jnp.shape(lgstd))
            return scale * jnp.asarray(e) * jnp.exp(lgstd)

        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
        return lambda: (next(mit, None), next(eit, None)) == (None, None)
    return install


@pytest.mark.parametrize("pos", POSITIONS)
def test_training_forward_kl_and_gradients_match_jax(pos, inject):
    """sum(logits * w) + KL with the same masks and eps: values, the KL and
    the gradient of every parameter."""
    dropout = 0.1
    model, _, jm, jp = _pair(pos, seed=3, dropout=dropout)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, V, size=(T, B))
    w = rng.normal(size=(T, B, V)).astype(np.float32)
    order, masks = draw_masks(rng, pos, dropout)
    eps = [] if pos == "none" else \
        [rng.normal(size=eps_shape(pos)).astype(np.float32)]
    all_taken = inject(order, eps)

    def jloss(p):
        logits, var = jm.apply({"params": p}, jnp.asarray(tokens),
                               deterministic=False,
                               rngs={"dropout": jax.random.key(0),
                                     "sample": jax.random.key(1)},
                               mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.float32(0))
        return jnp.sum(logits * w) + kl, (logits, kl)

    (_, (jlog, jkl)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    assert all_taken()
    logits = model(torch.from_numpy(tokens), deterministic=False,
                   dropout_masks=masks,
                   noise=[torch.from_numpy(e) for e in eps])
    kl = model.kl_value()
    ((logits * torch.from_numpy(w)).sum() + kl).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert (float(kl.detach()) > 0) == (pos != "none")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for name, ref in _flat(jg).items():
        assert grads[name] is not None, name
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the injected eps moved the Bayesian output off the posterior mean
    if pos != "none":
        with torch.no_grad():
            mean_out = model(torch.from_numpy(tokens), deterministic=False,
                             dropout_masks=masks,
                             noise=[torch.zeros(eps_shape(pos))])
        assert float((mean_out - logits.detach()).abs().max()) > 1e-4


@pytest.mark.parametrize("pos", ["FFN", "MHA", "EMB"])
def test_kl_with_prior_means_matches_jax(pos):
    """The KL dispatch with the prior's means where the reference has the
    branch (FFN, MHA: the BayesDense weight mean at its path in the
    ``priors`` collection); EMB keeps the N(0, 1) form."""
    model, _, jm, jp = _pair(pos, seed=5)
    rng = np.random.default_rng(6)
    site = model.bayes_site()
    prior = {}
    if site is not None:
        node = prior
        for k in site:
            node = node.setdefault(k, {})
        node["weight_mean"] = rng.normal(size=eps_shape(pos)).astype(
            np.float32)
    tokens = jnp.zeros((T, B), jnp.int32)
    _, var = jm.apply({"params": jp, "priors": jax.tree.map(jnp.asarray,
                                                            prior)},
                      tokens, deterministic=True, mutable=["losses"])
    ref = float(sum(jax.tree.leaves(var["losses"])))
    pm = None if site is None else torch.from_numpy(
        _flat(prior)[".".join(site) + ".weight_mean"])
    got = float(model.kl_value(pm).detach())
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    plain = float(model.kl_value().detach())
    assert (got != plain) == (site is not None)


@pytest.mark.parametrize("extra", [dict(uncertainty="Variational",
                                        t_v_pos=1),
                                   dict(uncertainty="Variational"),
                                   dict(tied=False)])
def test_unported_transformers_raise(extra):
    cfg = bt.ModelConfig(**{**_cfg(bt, "none").__dict__, **extra})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bt.build_model(cfg)
