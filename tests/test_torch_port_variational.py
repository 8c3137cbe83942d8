"""The port's variational family against the JAX package on the CPU,
float32, from the same weights and the same noise: ``VNN``
(``models/layers.py``); ``VLSTMCore`` (``l_v_pos`` 01, 10, 11) and the
legacy ``VLSTMLegacyCore`` (``models/lstm_lm.py``) in the training forward,
KL and every gradient, and in evaluation with resets; the variational
Transformer (``VEncoderLayer``, ``t_v_pos`` 1-3, ``models/transformer_lm.py``)
likewise; trainer steps, the ragged window at its true length, and
packed-carry / packed-nocarry scores.

The JAX side draws its noise with ``jax.random.normal`` (and, for the
Transformer's dropout, ``jax.random.bernoulli``), replaced by functions that
hand out injected numpy draws in call order; the port takes the same draws
through its ``noise`` argument and ``dropout_masks``. Models at rtol 2e-4 /
atol 1e-5; scores at rtol 1e-4 / atol 1e-5."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.models.layers import VNN as JVNN
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import params_from_jax, params_to_jax
from bayeslms_tpu_torch.models.layers import VNN
from bayeslms_tpu_torch.models.lstm_lm import init_hidden
from bayeslms_tpu_torch.models.transformer_lm import (EncoderDropoutMasks,
                                                      TransformerDropoutMasks,
                                                      VEncoderLayer)
from bayeslms_tpu_torch.ops import lstm2_train_cuda
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, H, T, B = 24, 8, 6, 3
LEGACY_B = 32  # the legacy VLSTM's noise table rows


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _check_grads(module, jgrads):
    grads = {k: p.grad for k, p in module.named_parameters()}
    for name, r in _flat(jgrads).items():
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture
def inject(monkeypatch):
    """``install(normals, masks=())``: ``jax.random.normal`` hands out
    ``normals`` and ``jax.random.bernoulli`` ``masks`` in call order;
    returns a check that every draw was taken."""
    def install(normals, masks=()):
        nit, mit = iter(normals), iter(masks)

        def normal(key, shape=(), dtype=jnp.float32):
            e = next(nit)
            assert tuple(shape) == e.shape
            return jnp.asarray(e, dtype)

        def bernoulli(key, p=0.5, shape=None):
            m = next(mit)
            assert tuple(shape) == m.shape
            return jnp.asarray(m)

        monkeypatch.setattr(jax.random, "normal", normal)
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        return lambda: (next(nit, None), next(mit, None)) == (None, None)
    return install


def _cfg(pkg, pos="11", legacy=False, E=H, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Variational",
                           l_v_pos=pos, l_v_legacy=legacy, **kw)


def _pair(pos, legacy=False, seed=0, **kw):
    model = bt.build_model(_cfg(bt, pos, legacy, **kw))
    tree = bt.init_params(model, _cfg(bt, pos, legacy, **kw), seed=seed)
    return model, jx.build_model(_cfg(jx, pos, legacy, **kw)), \
        jax.tree.map(jnp.asarray, tree)


def _lstm_noise(rng, pos, legacy, Tn):
    """The draws of one training forward in the JAX call order: (T, 1, H)
    for each noised layer of the variational LSTM, one (32, H) table for
    the legacy one."""
    if legacy:
        return [rng.normal(size=(LEGACY_B, H)).astype(np.float32)] \
            if "1" in pos else []
    return [rng.normal(size=(Tn, 1, H)).astype(np.float32)
            for d in pos if d == "1"]


def test_vnn_noise_kl_and_gradients_match_jax(inject):
    """``VNN``: the tree, the noise 0.1 eps exp(lgstd) from an injected
    eps, the KL of the activations (exp of the activations, the quirk) and
    the gradients of both."""
    rng = np.random.default_rng(0)
    mod = VNN(H)
    mod.reset_parameters(torch.Generator().manual_seed(1))
    tree = jax.tree.map(jnp.asarray, params_to_jax(mod))
    eps = rng.normal(size=(T, 1, H)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    w = rng.normal(size=(T, 1, H)).astype(np.float32)
    jm = JVNN(H)
    assert jax.tree.map(np.shape, jm.init(jax.random.key(0), h,
                                          method=JVNN.kl)["params"]) \
        == jax.tree.map(np.shape, tree)

    def jloss(p):
        inject([eps])
        n = jm.apply({"params": p}, jax.random.key(0), T, method=JVNN.noise)
        kl = jm.apply({"params": p}, jnp.asarray(h), method=JVNN.kl)
        return jnp.sum(n * w) + kl, (n, kl)

    (_, (jn, jkl)), jg = jax.value_and_grad(jloss, has_aux=True)(tree)
    n = mod.noise(T, eps=torch.from_numpy(eps))
    kl = mod.kl(torch.from_numpy(h))
    ((n * torch.from_numpy(w)).sum() + kl).backward()
    np.testing.assert_allclose(n.detach().numpy(), np.asarray(jn), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL)
    _check_grads(mod, jg)
    with pytest.raises(ValueError, match="injected eps"):
        mod.noise(T, eps=torch.zeros((T, H)))


CORES = [("01", False, True), ("10", False, False), ("11", False, True),
         ("11", True, True), ("10", True, False)]


@pytest.mark.parametrize(
    "pos,legacy,masked", CORES,
    ids=[f"{p}{'-legacy' if l else ''}-{'masked' if m else 'full'}"
         for p, l, m in CORES])
def test_lstm_training_forward_kl_and_gradients_match_jax(inject, pos, legacy,
                                                          masked):
    """``RecurrentLM`` with the variational core (or the legacy one, at its
    batch of 32) in the training forward: the same weights, initial state,
    step mask and noise; the logits, the new state, the KL the JAX core
    sows and every gradient of sum(logits w) + KL."""
    model, jm, jp = _pair(pos, legacy, seed=2)
    Bn = LEGACY_B if legacy else B
    rng = np.random.default_rng(3 + masked)
    tokens = rng.integers(0, V, size=(T, Bn))
    w = rng.normal(size=(T, Bn, V)).astype(np.float32)
    h0 = rng.normal(size=(2, 2, Bn, H)).astype(np.float32) * 0.5
    mask = (rng.uniform(size=(T, Bn)) > 0.3).astype(np.float32) \
        if masked else None
    noise = _lstm_noise(rng, pos, legacy, T)
    all_taken = inject(noise)

    def jloss(p):
        (logits, (hT, cT)), var = jm.apply(
            {"params": p}, jnp.asarray(tokens), (h0[0], h0[1]),
            deterministic=False, step_mask=None if mask is None
            else jnp.asarray(mask),
            rngs={"dropout": jax.random.key(0), "sample": jax.random.key(1)},
            mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.float32(0))
        return jnp.sum(logits * w) + kl, (logits, hT, cT, kl)

    (_, (jlog, jh, jc, jkl)), jg = jax.value_and_grad(jloss,
                                                      has_aux=True)(jp)
    assert all_taken()
    params_from_jax(model, jax.tree.map(np.asarray, jp))
    logits, (hT, cT) = model(
        torch.from_numpy(tokens), tuple(torch.from_numpy(a) for a in h0),
        None if mask is None else torch.from_numpy(mask),
        deterministic=False, noise=[torch.from_numpy(e) for e in noise])
    kl = model.core.kl_value()
    ((logits * torch.from_numpy(w)).sum() + kl).backward()
    for a, b in ((logits, jlog), (hT, jh), (cT, jc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert float(kl.detach()) != 0
    _check_grads(model, jg)
    with pytest.raises(ValueError, match="injected noise"):
        model(torch.from_numpy(tokens), tuple(torch.from_numpy(a) for a in h0),
              deterministic=False,
              noise=[torch.from_numpy(e) for e in noise] + [torch.zeros(1)])


@pytest.mark.parametrize("pos,legacy", [("11", False), ("01", False),
                                        ("11", True)],
                         ids=["11", "01", "11-legacy"])
def test_lstm_eval_with_resets_matches_jax(pos, legacy):
    """The deterministic forward (no noise) with a step mask and packed
    resets (-1 sources too): logits, the new state and the KL the JAX core
    sows there (the variational one always; the legacy one at batch 32
    only, zero at another batch)."""
    model, jm, jp = _pair(pos, legacy, seed=4)
    params_from_jax(model, jax.tree.map(np.asarray, jp))
    for Bn in ((LEGACY_B, 5) if legacy else (5,)):
        rng = np.random.default_rng(Bn)
        tokens = rng.integers(0, V, size=(T, Bn))
        h0 = rng.normal(size=(2, 2, Bn, H)).astype(np.float32) * 0.5
        mask = (rng.uniform(size=(T, Bn)) > 0.2).astype(np.float32)
        reset = (rng.uniform(size=(T, Bn)) > 0.6).astype(np.float32)
        src = rng.integers(-1, Bn, size=Bn).astype(np.int32)
        (jlog, (jh, jc)), var = jm.apply(
            {"params": jp}, jnp.asarray(tokens), (h0[0], h0[1]),
            deterministic=True, step_mask=jnp.asarray(mask),
            reset_mask=jnp.asarray(reset), reset_src=jnp.asarray(src),
            mutable=["losses"])
        jkl = float(sum(jax.tree.leaves(var.get("losses", {})),
                        jnp.float32(0)))
        with torch.no_grad():
            logits, (hT, cT) = model(
                torch.from_numpy(tokens),
                tuple(torch.from_numpy(a) for a in h0),
                torch.from_numpy(mask), reset_mask=torch.from_numpy(reset),
                reset_src=torch.from_numpy(src))
        for a, b in ((logits, jlog), (hT, jh), (cT, jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(float(model.core.kl_value()), jkl,
                                   rtol=RTOL, atol=ATOL)
        assert (jkl != 0) == (not legacy or Bn == LEGACY_B)


def test_legacy_vlstm_refuses_another_training_batch():
    """The legacy VLSTM's (32, H) noise table broadcasts only against batch
    32 (the JAX core asserts it)."""
    model, _, _ = _pair("11", True)
    tokens = torch.zeros((T, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="batch == 32"):
        model(tokens, init_hidden(2, 5, H), deterministic=False)


def test_legacy_vlstm_fused_route_matches_jax(monkeypatch, inject):
    """Under ``BAYESLM_PALLAS_LSTM2_TRAIN=1`` with the gate admitting, the
    legacy VLSTM's training forward takes rows 7-8's route (their twins on
    the CPU); its logits, KL and gradients still equal the JAX package's
    (whose CPU run takes its scan)."""
    monkeypatch.setenv("BAYESLM_PALLAS_LSTM2_TRAIN", "1")
    monkeypatch.setattr(lstm2_train_cuda, "lstm2_kernel_ok",
                        lambda x, n: True)
    calls = []
    real = lstm2_train_cuda.lstm2_layer_train
    monkeypatch.setattr(lstm2_train_cuda, "lstm2_layer_train",
                        lambda *a: calls.append(1) or real(*a))
    test_lstm_training_forward_kl_and_gradients_match_jax(inject, "11", True,
                                                          True)
    assert len(calls) == 2  # the port's forward and its refusal check


@pytest.mark.parametrize("pos,legacy", [("11", True)], ids=["11-legacy"])
def test_three_trainer_steps_match_jax(tmp_path, inject, pos, legacy):
    """Three steps of both trainers on the same batches and noise: loss, KL
    x kl_scale, gradient norm, weights, momentum and the carried state. The
    JAX step runs unjitted, so that each step takes its own draws."""
    Bn = LEGACY_B if legacy else B
    kw = dict(lr=2.0, batch_size=Bn, seq_len=T, save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_cfg(jx, pos, legacy), jx.TrainConfig(**kw))
    tt = Trainer(_cfg(bt, pos, legacy), bt.TrainConfig(**kw), device="cpu")
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    jh, th = j_init_hidden(2, Bn, H), init_hidden(2, Bn, H)
    rng = np.random.default_rng(4)
    for step in range(3):
        d = rng.integers(0, V, size=(T, Bn)).astype(np.int32)
        t = rng.integers(0, V, size=(T, Bn)).astype(np.int32)
        noise = _lstm_noise(rng, pos, legacy, T)
        inject(noise)
        jparams, jopt, jh, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(0.1), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1, noise=[torch.from_numpy(e) for e in noise])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        assert float(kl) > 0
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jparams).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}: {name}")
        for name, ref in _flat(jopt.momentum).items():
            np.testing.assert_allclose(
                state.opt_state.momentum[name].numpy(), ref, rtol=RTOL,
                atol=ATOL, err_msg=f"step {step}: momentum {name}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("model", ["LSTM", "Transformer"])
def test_ragged_window_runs_at_its_true_length(model):
    """The epoch's last, short window of a variational model reaches the
    step unpadded and unmasked, as in the JAX package (its KL reads the
    activations; the Transformer's noise gates on the length); other
    models pad it to seq_len and mask the CE."""
    for unc in ("Variational", "none"):
        if model == "LSTM":
            cfg = bt.ModelConfig(vocab_size=V, emsize=H, nhid=H, dropout=0.0,
                                 uncertainty=unc, l_v_pos="11")
        else:
            cfg = bt.ModelConfig(model="Transformer", vocab_size=V, emsize=8,
                                 nhid=16, nlayers=2, nhead=2, dropout=0.0,
                                 uncertainty=unc, t_v_pos=1, v_seq_len=T)
        tt = Trainer(cfg, bt.TrainConfig(batch_size=B, seq_len=T),
                     device="cpu")
        state = tt.init_state()
        seen = []
        step = tt.train_step

        def spy(st, hidden, data, target, kl_scale, mask=None, **kw):
            seen.append((data.shape[0], mask is None))
            return step(st, hidden, data, target, kl_scale, mask, **kw)

        tt.train_step = spy
        rows = np.arange(B * (2 * T + 3)).reshape(-1, B) % V
        tt.run_epoch(state, rows, log=lambda *a: None)
        ragged = (3 - 1, True) if unc == "Variational" else (T, False)
        assert seen == [(T, True), (T, True), ragged]


def _nbest():
    rng = np.random.default_rng(7)
    nbest = OrderedDict()
    for u in range(4):
        nbest[f"A_{u}"] = [" ".join(f"w{rng.integers(2, V)}"
                                    for _ in range(rng.integers(2, 9)))
                           for _ in range(3 if u % 2 else 2)]
    for u in range(2):
        nbest[f"B_{u}"] = [" ".join(f"w{rng.integers(2, V)}"
                                    for _ in range(rng.integers(1, 7)))
                           for _ in range(3)]
    nbest["B_1"][0] += " oov1 w3"
    return nbest


@pytest.mark.parametrize("pos,legacy", [("11", False), ("11", True)],
                         ids=["11", "11-legacy"])
def test_packed_carry_scores_match_jax(monkeypatch, pos, legacy):
    """Scoring through packed-carry (deterministic: no noise) against the
    JAX scorer forced onto packed-carry with the fused CE (interpret
    mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=2)
    cfg = _cfg(bt, pos, legacy)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    params["decoder_b"] = np.random.default_rng(0).normal(
        size=V).astype(np.float32) * 0.1
    stream = lambda k: k.split("_")[0]  # noqa: E731
    ref_scorer = JaxScorer(_cfg(jx, pos, legacy),
                           jax.tree.map(jnp.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_allowed()
    ref = ref_scorer.score_nbest(_nbest(), w2i, stream_fn=stream)
    got = BatchScorer(cfg, params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(_nbest(), w2i,
                                                stream_fn=stream)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------- the Transformer
TV, TE, FF, NH, VSEQ = 40, 16, 24, 2, 7


def _tcfg(pkg, vpos, nl=4, dropout=0.1, **kw):
    return pkg.ModelConfig(model="Transformer", vocab_size=TV, emsize=TE,
                           nhid=FF, nlayers=nl, nhead=NH, dropout=dropout,
                           uncertainty="Variational", t_v_pos=vpos,
                           v_seq_len=VSEQ, **kw)


def _tm_pair(vpos, seed=0, **kw):
    model = bt.build_model(_tcfg(bt, vpos, **kw))
    tree = bt.init_params(model, _tcfg(bt, vpos, **kw), seed=seed)
    jm = jx.build_model(_tcfg(jx, vpos, **kw))
    return model, tree, jm, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("vpos", [0, 1, 2, 3])
def test_tm_tree_layers_and_deterministic_forward_match_jax(vpos):
    """The layer lists of ``t_v_pos`` 0-3 (the reference's off-by-one for 2
    and 3: one layer fewer), the tree against the JAX init's, the
    (v_seq_len, 1, d) tables U(0, 1), and the causal and packed
    deterministic forwards."""
    model, tree, jm, jp = _tm_pair(vpos)
    ref_tree = jax.eval_shape(lambda: jx.init_params(jm, _tcfg(jx, vpos)))
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    kinds = [isinstance(layer, VEncoderLayer) for layer in model.layers]
    assert kinds == {0: [False] * 4, 1: [True, False, False, False],
                     2: [False, True, False], 3: [True, True, False]}[vpos]
    for i, is_v in enumerate(kinds):
        if is_v:
            t = tree[f"layers_{i}"]["hiddens_lgstd"]
            assert t.shape == (VSEQ, 1, TE) and 0 <= t.min() and t.max() < 1
    rng = np.random.default_rng(vpos)
    tokens = rng.integers(0, TV, size=(VSEQ, B))
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    pos_ = np.tile(np.array([0, 1, 2, 0, 1, 2, 3])[:, None], (1, B))
    seg = np.array([0, 0, 0, 1, 1, 1, 1])
    valid = (seg[:, None] == seg[None, :]) & np.tril(np.ones((7, 7), bool))
    mask = np.broadcast_to(np.where(valid, 0.0, -np.inf).astype(
        np.float32), (B, 1, 7, 7)).copy()
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True,
                   return_hidden=True, positions=jnp.asarray(pos_),
                   pack_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), return_hidden=True,
                    positions=torch.from_numpy(pos_),
                    pack_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _tm_masks(rng, n_layers, Tn, dropout):
    order = [rng.uniform(size=(Tn, B, TE)) >= dropout]
    layers = []
    for _ in range(n_layers):
        m = EncoderDropoutMasks(
            rng.uniform(size=(B, NH, Tn, Tn)) >= dropout,
            rng.uniform(size=(Tn, B, TE)) >= dropout,
            rng.uniform(size=(Tn, B, FF)) >= dropout,
            rng.uniform(size=(Tn, B, TE)) >= dropout)
        order += list(m)
        layers.append(EncoderDropoutMasks(*map(torch.from_numpy, m)))
    return order, TransformerDropoutMasks(torch.from_numpy(order[0]), layers)


@pytest.mark.parametrize("vpos", [1, 2, 3])
def test_tm_training_forward_kl_and_gradients_match_jax(vpos, inject):
    """The training forward with the same dropout masks and noise (one
    (T, B, d) eps a variational layer at T = v_seq_len): logits, the KL of
    the layers the loss reads and every gradient of sum(logits w) + KL; at
    another T no noise is drawn and the KL is zero."""
    Tn = VSEQ
    dropout = 0.1
    model, _, jm, jp = _tm_pair(vpos, seed=3, dropout=dropout)
    rng = np.random.default_rng(10 + vpos)
    tokens = rng.integers(0, TV, size=(Tn, B))
    w = rng.normal(size=(Tn, B, TV)).astype(np.float32)
    order, masks = _tm_masks(rng, len(model.layers), Tn, dropout)
    n_v = sum(isinstance(layer, VEncoderLayer) for layer in model.layers)
    eps = [rng.normal(size=(Tn, B, TE)).astype(np.float32)
           for _ in range(n_v if Tn == VSEQ else 0)]
    all_taken = inject(eps, order)

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
    assert float(kl.detach()) > 0
    _check_grads(model, jg)
    with pytest.raises(ValueError, match="injected noise"):
        model(torch.from_numpy(tokens), deterministic=False,
              dropout_masks=masks,
              noise=[torch.from_numpy(e) for e in eps] + [torch.zeros(1)])
    short = torch.from_numpy(tokens[:-2])
    with pytest.raises(ValueError, match="injected noise"):
        model(short, deterministic=False, noise=[torch.from_numpy(eps[0])])
    model(short, deterministic=False, noise=[])
    assert float(model.kl_value()) == 0.0


@pytest.mark.parametrize("vpos", [1, 3])
def test_tm_packed_nocarry_scores_match_jax(monkeypatch, vpos):
    """The variational Transformer scores through packed-nocarry,
    deterministically, as the JAX scorer forced onto that layout."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, TV)}}
    rc = dict(carry_over=True, max_hyp_len=30, batch_size=20)
    cfg = _tcfg(bt, vpos)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    ref_scorer = JaxScorer(_tcfg(jx, vpos), jax.tree.map(np.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_nocarry_allowed()
    nbest = _nbest()
    ref = ref_scorer.score_nbest(nbest, w2i)
    got = BatchScorer(cfg, params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(nbest, w2i)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="standard"):
        BatchScorer(cfg, params, bt.RescoreConfig(xl_mems=True),
                    device="cpu")

