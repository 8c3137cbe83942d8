"""The GRU and vanilla-RNN layers and the standard core at other depths
(``ops/lstm.py`` ``gru_layer``, ``rnn_layer``; ``models/lstm_lm.py``
``StandardRNNCore``) against the JAX package on the CPU, float32, from the
same weights: the layers with step masks and packed resets (-1 sources
too); the core's forward, states and every gradient with injected
inter-layer dropout masks (the JAX side's ``jax.random.bernoulli`` hands
them out in call order); trainer steps; packed-carry and packed-nocarry
scores of a GRU against the JAX ``BatchScorer``; and the uncertainty cores
at depths 1 and 3, which the JAX package quietly builds as two LSTM layers
and the port refuses. Tolerance rtol 2e-4 / atol 1e-5 (values, gradients),
1e-4 / 1e-5 (scores)."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.ops import lstm as jlstm
from bayeslms_tpu.rescore import layouts as jlayouts
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.models.lstm_lm import DropoutMasks, init_hidden
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, E, H, T, B = 40, 16, 16, 6, 3
GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _layer(rng, gates, in_size):
    s = 1.0 / np.sqrt(H)
    return [rng.uniform(-s, s, size=shape).astype(np.float32)
            for shape in ((gates * H, in_size), (gates * H, H),
                          (gates * H,), (gates * H,))]


def _masks(rng):
    step = (rng.uniform(size=(T, B)) < 0.8).astype(np.float32)
    reset = np.zeros((T, B), np.float32)
    reset[2, 0] = reset[4, 1] = reset[3, 2] = 1.0
    src = np.array([2, -1, 0], np.int32)
    return step, reset, src


@pytest.mark.parametrize("kind", ["GRU", "RNN_TANH", "RNN_RELU"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_gru_and_rnn_layers_match_jax(kind, masked):
    """Values, the final state and the gradients of the input, the state
    and every weight, with a step mask and packed resets (a -1 source)."""
    rng = np.random.default_rng(1)
    w = _layer(rng, GATES[kind], E)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    wy = rng.normal(size=(T, B, H)).astype(np.float32)
    step, reset, src = _masks(rng)
    mk = dict(step_mask=step, reset_mask=reset, reset_src=src) \
        if masked else {}
    act = "relu" if kind == "RNN_RELU" else "tanh"

    def jfn(x, h0, *w):
        p = jlstm.LSTMParams(*w)
        kw = {k: jnp.asarray(v) for k, v in mk.items()}
        if kind == "GRU":
            ys, hT = jlstm.gru_layer(x, h0, p, **kw)
        else:
            ys, hT = jlstm.rnn_layer(x, h0, p, act, **kw)
        return jnp.sum(ys * wy) + jnp.sum(hT), (ys, hT)

    (_, (rys, rhT)), rg = jax.value_and_grad(
        jfn, argnums=tuple(range(6)), has_aux=True)(
            jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, w))
    tx, th0 = (torch.from_numpy(a).requires_grad_(True) for a in (x, h0))
    tw = [torch.from_numpy(a).requires_grad_(True) for a in w]
    tk = {k: torch.from_numpy(v) for k, v in mk.items()}
    p = tlstm.LSTMParams(*tw)
    if kind == "GRU":
        ys, hT = tlstm.gru_layer(tx, th0, p, **tk)
    else:
        ys, hT = tlstm.rnn_layer(tx, th0, p, act, **tk)
    ((ys * torch.from_numpy(wy)).sum() + hT.sum()).backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(rys),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hT.detach().numpy(), np.asarray(rhT),
                               rtol=RTOL, atol=ATOL)
    for got, ref, name in zip([tx, th0, *tw], rg,
                              ["x", "h0", "w_ih", "w_hh", "b_ih", "b_hh"]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_rnn_layer_refuses_an_unknown_nonlinearity():
    p = tlstm.LSTMParams(*(torch.zeros(s) for s in ((H, E), (H, H), (H,),
                                                    (H,))))
    with pytest.raises(ValueError, match="tanh or relu"):
        tlstm.rnn_layer(torch.zeros((T, B, E)), torch.zeros((B, H)), p,
                        "gelu")


def _cfg(pkg, model="LSTM", nlayers=2, dropout=0.0, **kw):
    return pkg.ModelConfig(model=model, vocab_size=V, emsize=E, nhid=H,
                           nlayers=nlayers, dropout=dropout, **kw)


@pytest.fixture
def bernoulli(monkeypatch):
    """The JAX package's dropout draws hand out the given keep masks in
    call order."""
    def install(masks):
        it = iter(masks)

        def draw(key, p=0.5, shape=None):
            m = next(it)
            assert tuple(shape) == m.shape
            return jnp.asarray(m)
        monkeypatch.setattr(jax.random, "bernoulli", draw)
        return lambda: next(it, None) is None
    return install


CORES = [("LSTM", 1), ("LSTM", 3), ("GRU", 2), ("RNN_TANH", 2),
         ("RNN_RELU", 2)]


@pytest.mark.parametrize("model,nlayers", CORES,
                         ids=[f"{m}x{n}" for m, n in CORES])
def test_standard_core_matches_jax(model, nlayers, bernoulli):
    """The whole model's training forward with injected embedding,
    inter-layer and output dropout masks (rate 0.2): outputs, states and
    the gradient of every parameter; the scoring forward's logits and
    states; the parameter tree's shapes."""
    cfg = _cfg(bt, model, nlayers, dropout=0.2)
    jcfg = _cfg(jx, model, nlayers, dropout=0.2)
    net = bt.build_model(cfg)
    tree = bt.init_params(net, cfg, seed=3)
    jm = jx.build_model(jcfg)
    ref_tree = jx.init_params(jm, jcfg, seed=1)
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    assert tree["core"]["l0_w_ih"].shape == (GATES[model] * H, E)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, V, size=(T, B))
    h0 = rng.normal(size=(nlayers, B, H)).astype(np.float32) * 0.3
    c0 = rng.normal(size=(nlayers, B, H)).astype(np.float32) * 0.3
    wy = rng.normal(size=(T, B, H)).astype(np.float32)
    keep = 0.8
    layer = [rng.uniform(size=(T, B, H)) < keep for _ in range(nlayers - 1)]
    m_emb, m_out = (rng.uniform(size=(T, B, w)) < keep for w in (E, H))
    done = bernoulli([m_emb, *layer, m_out])

    def jfwd(p):
        out, (hs, cs) = jm.apply(
            {"params": p}, jnp.asarray(tokens),
            (jnp.asarray(h0), jnp.asarray(c0)), deterministic=False,
            return_hidden=True, rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * wy), (out, hs, cs)

    (_, (ref, rhs, rcs)), grads = jax.jit(jax.value_and_grad(
        jfwd, has_aux=True))(jax.tree.map(jnp.asarray, tree))
    assert done()
    masks = DropoutMasks(torch.from_numpy(m_emb),
                         tuple(map(torch.from_numpy, layer)),
                         torch.from_numpy(m_out))
    if nlayers == 2:
        masks = masks._replace(layer=masks.layer[0])
    out, (hs, cs) = net(torch.from_numpy(tokens),
                        (torch.from_numpy(h0), torch.from_numpy(c0)),
                        return_hidden=True, deterministic=False,
                        dropout_masks=masks)
    (out * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    for a, b in ((hs, rhs), (cs, rcs)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in net.named_parameters()}
    for name, g in _flat(grads).items():
        np.testing.assert_allclose(got[name], g, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the scoring forward
    jl, (jh, jc) = jm.apply({"params": jax.tree.map(jnp.asarray, tree)},
                            jnp.asarray(tokens),
                            (jnp.asarray(h0), jnp.asarray(c0)))
    with torch.no_grad():
        tl, (th, tc) = net(torch.from_numpy(tokens),
                           (torch.from_numpy(h0), torch.from_numpy(c0)))
    for a, b in ((tl, jl), (th, jh), (tc, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    if model != "LSTM":
        assert not tc.any()  # no cell state, as the JAX core stacks it


def test_drawn_masks_have_one_per_gap():
    """``draw_dropout_masks``: one inter-layer mask a gap at depth 3 and
    none at depth 1; the training forward takes them."""
    from bayeslms_tpu_torch.models.lstm_lm import draw_dropout_masks
    gen = torch.Generator().manual_seed(0)
    for n, gaps in ((1, 0), (3, 2)):
        cfg = _cfg(bt, "LSTM", n, dropout=0.3)
        m = draw_dropout_masks(cfg, T, B, gen)
        assert len(m.layer) == gaps
        net = bt.build_model(cfg)
        bt.init_params(net, cfg)
        out, _ = net(torch.zeros((T, B), dtype=torch.long),
                     init_hidden(n, B, H), deterministic=False,
                     generator=gen, return_hidden=True)
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("model,nlayers", [("LSTM", 3), ("GRU", 2),
                                           ("RNN_RELU", 1)])
def test_trainer_steps_match_jax(tmp_path, model, nlayers):
    """Two ``Trainer.train_step`` calls against JAX ``_train_step`` (dropout
    0): loss, gradient norm, parameters, momentum and the carried state."""
    kw = dict(lr=2.0, batch_size=B, seq_len=T, save=str(tmp_path / "m"))
    tt = Trainer(_cfg(bt, model, nlayers), bt.TrainConfig(**kw), device="cpu")
    jt = jloop.Trainer(_cfg(jx, model, nlayers), jx.TrainConfig(**kw))
    state = tt.init_state()
    jp = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jo = j_init_opt_state(jp)
    jh = j_init_hidden(nlayers, B, H)
    th = init_hidden(nlayers, B, H)
    rng = np.random.default_rng(7)
    for step in range(2):
        d, t = (rng.integers(0, V, size=(T, B)).astype(np.int32)
                for _ in range(2))
        jp, jo, jh, jloss, _, _, jgn = jt._train_step(
            jp, jo, jh, jnp.asarray(d), jnp.asarray(t), jnp.float32(2.0),
            jnp.float32(0.1), jax.random.key(step))
        th, loss, _, _, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jp).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        for name, ref in _flat(jo.momentum).items():
            np.testing.assert_allclose(
                state.opt_state.momentum[name].numpy(), ref, rtol=RTOL,
                atol=ATOL, err_msg=f"momentum {name}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}


def _nbest(n_utts=24):
    rng = np.random.default_rng(3)
    nbest = OrderedDict()
    for u in range(n_utts):
        nbest[f"m{u % 3}_u{u}"] = [
            " ".join(f"w{rng.integers(2, V)}"
                     for _ in range(rng.integers(1, 12)))
            for _ in range(rng.integers(1, 5))]
    nbest["m0_u3"].append("")
    nbest["m1_u4"][0] += " oov1 w3"
    return nbest


@pytest.mark.parametrize("carry", [True, False],
                         ids=["packed-carry", "packed-nocarry"])
def test_gru_scores_match_jax(monkeypatch, carry):
    """A 2-layer GRU's packed-carry (three chains) and packed-nocarry
    scores against the JAX scorer forced onto the same layout (its fused
    CE in interpret mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    rc = dict(carry_over=carry, max_hyp_len=20, carry_chunk_utts=3,
              batch_size=20)
    name = "packed-carry" if carry else "packed-nocarry"
    params = jx.init_params(jx.build_model(_cfg(jx, "GRU")), _cfg(jx, "GRU"),
                            seed=2)
    nbest = _nbest()
    stream = lambda k: k.split("_")[0]  # noqa: E731
    ref_scorer = JaxScorer(_cfg(jx, "GRU"), params, jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert jlayouts.select(ref_scorer).name == name
    ref = ref_scorer.score_nbest(nbest, W2I, stream_fn=stream)
    scorer = BatchScorer(_cfg(bt, "GRU"), jax.tree.map(np.asarray, params),
                         bt.RescoreConfig(**rc), device="cpu")
    assert layouts.select(scorer).name == name
    got = scorer.score_nbest(nbest, W2I, stream_fn=stream)
    assert list(got) == list(ref)
    for k in nbest:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


UNCERTAIN = {
    "bayes3": dict(uncertainty="Bayesian", l_bayes_pos=3),
    "gp13": dict(uncertainty="Gaussian", l_gauss_pos="13"),
    "gauss_legacy1": dict(uncertainty="Gaussian", l_gauss_legacy_pos=1),
    "vlstm11": dict(uncertainty="Variational", l_v_pos="11"),
    "vlstm_legacy": dict(uncertainty="Variational", l_v_pos="11",
                         l_v_legacy=True),
}


@pytest.mark.parametrize("nlayers", [1, 3])
@pytest.mark.parametrize("core", list(UNCERTAIN))
def test_uncertainty_cores_at_other_depths_as_jax_behaves(core, nlayers):
    """The JAX package builds and runs each uncertainty core at depths 1
    and 3 as two LSTM layers (its hidden comes back with two layers); the
    port refuses them, naming ROADMAP.md C."""
    kw = UNCERTAIN[core]
    jm = jx.build_model(_cfg(jx, nlayers=nlayers, **kw))
    tok = jnp.zeros((3, 32), jnp.int32)
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1),
            "sample": jax.random.key(2)}
    h = j_init_hidden(nlayers, 32, H)
    v = jm.init(rngs, tok, h)
    _, (hs, _) = jm.apply(v, tok, h)
    assert hs.shape == (2, 32, H)
    with pytest.raises(NotImplementedError, match="ROADMAP.md C"):
        bt.build_model(_cfg(bt, nlayers=nlayers, **kw))


def test_gp_gate0_core_runs_at_depth3_as_jax():
    """The GP-LSTM with gate digit 0 is the standard core, which both
    packages run at any depth: the scoring forward at depth 3."""
    kw = dict(uncertainty="Gaussian", l_gauss_pos="00")
    cfg, jcfg = _cfg(bt, nlayers=3, **kw), _cfg(jx, nlayers=3, **kw)
    net = bt.build_model(cfg)
    tree = bt.init_params(net, cfg, seed=4)
    tokens = np.random.default_rng(2).integers(0, V, size=(T, B))
    jl, (jh, _) = jx.build_model(jcfg).apply(
        {"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(tokens),
        j_init_hidden(3, B, H))
    with torch.no_grad():
        tl, (th, _) = net(torch.from_numpy(tokens), init_hidden(3, B, H))
    assert th.shape == (3, B, H)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
