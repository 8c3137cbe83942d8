"""The port's Bayesian gate-slice LSTM (``models.lstm_lm.BayesLSTMCore``,
``train.loop.Trainer`` with its KL and prior workflow, ``BatchScorer`` at
the posterior mean) against the JAX package on the CPU, float32, from the
same weights and the same noise: the JAX side draws its eps through
``bayeslms_tpu.ops.gaussian.sample_diff``, which the tests replace with
one that hands out injected numpy draws in call order; the port takes the
same draws through its ``noise`` argument. Tolerance rtol 2e-4 / atol 1e-5
(the golden tests'), scores rtol 1e-4 / atol 1e-5 as the scorer test."""

import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.core.checkpoint import save_checkpoint as j_save_checkpoint
from bayeslms_tpu.models.lstm_lm import BayesLSTMCore as JCore
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import (params_from_jax,
                                                params_to_jax,
                                                save_checkpoint)
from bayeslms_tpu_torch.models.lstm_lm import BayesLSTMCore, init_hidden
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, H = 24, 8
T, B = 6, 3


def _cfg(pkg, pos, E=12, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Bayesian",
                           l_bayes_pos=pos, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _draw_shapes(pos, both, E):
    """Shapes of the sampled tensors, in the JAX call order."""
    if 1 <= pos <= 4:
        return [s for ins in ((E, H) if both else (E,))
                for s in ((H, H), (H, ins), (H,), (H,))]
    if pos == 5 and not both:
        return [(4 * H, H), (4 * H, E), (4 * H,), (4 * H,)]
    return []


def _noise(rng, shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture
def inject(monkeypatch):
    """Make the JAX package's ``gaussian.sample_diff`` hand out the given
    draws in call order."""
    def install(draws):
        it = iter(draws)

        def sample_diff(key, lgstd, scale=1.0):
            eps = next(it)
            assert eps.shape == tuple(jnp.shape(lgstd))
            return scale * jnp.asarray(eps) * jnp.exp(lgstd)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
    return install


CASES = [(pos, both) for pos in range(6) for both in (True, False)]


@pytest.mark.parametrize("pos,both", CASES)
def test_core_forward_gradients_and_kl_match_jax(pos, both, inject):
    """Deterministic forward (the posterior means), training forward with
    injected eps, the KL, and the gradient of every mean and lgstd of
    sum(out * w) + KL."""
    E = H if (pos == 5 and not both) else 12  # that branch adds (4H, E) to (4H, H)
    jcfg, tcfg = _cfg(jx, pos, E), _cfg(bt, pos, E)
    rng = np.random.default_rng(10 * pos + both)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    h0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
    c0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.3
    wout = rng.normal(size=(T, B, H)).astype(np.float32)
    draws = _noise(rng, _draw_shapes(pos, both, E))

    core = BayesLSTMCore(tcfg, both_layers=both)
    core.reset_parameters(torch.Generator().manual_seed(pos))
    tree = params_to_jax(core)
    jcore = JCore(jcfg, both_layers=both)
    jparams = jax.tree.map(jnp.asarray, tree)
    assert set(_flat(tree)) == set(_flat(jcore.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)))["params"]))
    hid = (torch.from_numpy(h0), torch.from_numpy(c0))

    # deterministic: the posterior means
    (ref, (rh, rc)), var = jcore.apply({"params": jparams}, jnp.asarray(x),
                                       (jnp.asarray(h0), jnp.asarray(c0)),
                                       deterministic=True, mutable=["losses"])
    with torch.no_grad():
        got, (gh, gc) = core(torch.from_numpy(x), hid)
    for a, b in ((got, ref), (gh, rh), (gc, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)

    # training forward with the same eps, and every gradient
    inject(draws)

    def jloss(p):
        (out, _), var = jcore.apply(
            {"params": p}, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
            deterministic=False, rngs={"sample": jax.random.key(2)},
            mutable=["losses"])
        kl = sum(jax.tree.leaves(var["losses"]))
        return jnp.sum(out * wout) + kl, (out, kl)

    (_, (jout, jkl)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    out, _ = core(torch.from_numpy(x), hid, train=True,
                  noise=[torch.from_numpy(d) for d in draws])
    kl = core.kl_value()
    ((out * torch.from_numpy(wout)).sum() + kl).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kl.item(), float(jkl), rtol=RTOL, atol=ATOL)
    if 1 <= pos <= 4 or (pos == 5 and not both):
        # the sample moved the output
        assert float(np.abs(out.detach().numpy() - got.numpy()).max()) > 1e-4
    grads = {k: p.grad for k, p in core.named_parameters()}
    for name, ref_g in _flat(jgrads).items():
        g = grads[name]
        g = np.zeros_like(ref_g) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref_g, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("pos,both", CASES)
def test_kl_value_with_and_without_prior_matches_jax(pos, both):
    """``kl_value`` against the JAX ``kl_value``, zero-prior branch and the
    prior-mean branch (prior weight means drawn at random)."""
    E = H if (pos == 5 and not both) else 12
    core = BayesLSTMCore(_cfg(bt, pos, E), both_layers=both)
    core.reset_parameters(torch.Generator().manual_seed(7))
    with torch.no_grad():  # means far from N(0, 1)'s and the prior's
        for n, p in core.named_parameters():
            p.add_(0.3 if "_mean_" in n else 0.1)
    jcore = JCore(_cfg(jx, pos, E), both_layers=both)
    tree = _flat(params_to_jax(core))
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
             "b_hh": "bias_hh"}
    means = [{n: jnp.asarray(tree[f"{t}_mean_{l}"]) for n, t in names.items()}
             for l in (1, 2)]
    lgstds = {l: {n: jnp.asarray(tree[f"{t}_lgstd_{l}"])
                  for n, t in names.items()}
              for l in core.lgstd_layers}
    rng = np.random.default_rng(pos)
    prior = (rng.normal(size=(4 * H, H)).astype(np.float32),
             rng.normal(size=(4 * H, E)).astype(np.float32))
    for prior_w in (None, prior):
        ref = jcore.kl_value(means, lgstds,
                             None if prior_w is None else
                             tuple(map(jnp.asarray, prior_w)))
        got = core.kl_value(None if prior_w is None else
                            tuple(map(torch.from_numpy, prior_w)))
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL,
                                   atol=ATOL)
        assert (float(got) != 0.0) == (pos != 0)


def _trainers(tmp_path, pos=3, **tkw):
    kw = {**dict(lr=2.0, batch_size=B, seq_len=T, eval_batch_size=2,
                 save=str(tmp_path / "model.ckpt")), **tkw}
    # a tied decoder: emsize = nhid
    return (jloop.Trainer(_cfg(jx, pos, H), jx.TrainConfig(**kw)),
            Trainer(_cfg(bt, pos, H), bt.TrainConfig(**kw), device="cpu"))


def _check_state(jparams, jopt, state, what):
    got = _flat(params_to_jax(state.model))
    for name, ref in _flat(jparams).items():
        np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")
    for name, ref in _flat(jopt.momentum).items():
        np.testing.assert_allclose(state.opt_state.momentum[name].numpy(),
                                   ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: momentum {name}")


def _steps(jt, tt, jparams, state, inject, n, seed, kl_scale=0.1):
    """``n`` steps of both trainers on the same batches and draws."""
    jopt = j_init_opt_state(jparams)
    jh, th = j_init_hidden(2, B, H), init_hidden(2, B, H)
    rng = np.random.default_rng(seed)
    for step in range(n):
        d = rng.integers(0, V, size=(T, B)).astype(np.int32)
        t = rng.integers(0, V, size=(T, B)).astype(np.int32)
        draws = _noise(rng, _draw_shapes(tt.mcfg.l_bayes_pos, True, H))
        inject(draws)
        jparams, jopt, jh, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(kl_scale), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            kl_scale, noise=[torch.from_numpy(x) for x in draws])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        _check_state(jparams, jopt, state, f"step {step}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    return jparams, kl


def test_three_trainer_steps_with_kl_match_jax(tmp_path, inject):
    """The JAX step runs unjitted, so that each step takes its own injected
    draws (a jitted step would keep the first trace's)."""
    jt, tt = _trainers(tmp_path)
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    _, kl = _steps(jt, tt, jparams, state, inject, 3, seed=4)
    assert float(kl) > 0


def test_prior_partial_load_matches_jax(tmp_path):
    """Finetune from a prior (the JAX test_train_loop prior test): the
    means and the embedding come from the prior, the lgstds keep their
    fresh init. The prior is a JAX ``.ckpt`` (read by the port's msgpack
    reader) and the port's own checkpoint; both packages load the same
    means."""
    t1 = jloop.Trainer(_cfg(jx, 0, H), jx.TrainConfig(
        save=str(tmp_path / "p.ckpt")))
    prior = t1.init_state().params
    j_save_checkpoint(str(tmp_path / "p.ckpt"), prior)
    save_checkpoint(str(tmp_path / "p.pt"), jax.tree.map(np.asarray, prior))
    kw = dict(prior=True, save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_cfg(jx, 2, H), jx.TrainConfig(
        prior_path=str(tmp_path / "p.ckpt"), **kw))
    jstate = _flat(jt.init_state().params)
    fresh = _flat(params_to_jax(Trainer(_cfg(bt, 2, H), bt.TrainConfig(
        save=str(tmp_path / "m.ckpt")), device="cpu").init_state().model))
    prior_flat = _flat(prior)
    for path in ("p.ckpt", "p.pt"):
        tt = Trainer(_cfg(bt, 2, H), bt.TrainConfig(
            prior_path=str(tmp_path / path), **kw), device="cpu")
        got = _flat(params_to_jax(tt.init_state().model))
        assert set(got) == set(jstate)
        for name, v in got.items():
            if "_lgstd_" in name:
                assert name not in prior_flat
                np.testing.assert_array_equal(v, fresh[name])
            else:
                np.testing.assert_array_equal(v, prior_flat[name])
                np.testing.assert_array_equal(v, jstate[name])
        assert tt.prior_w is None  # prior_kl off


def test_prior_kl_pulls_means_toward_the_prior_as_jax(tmp_path, inject):
    """TrainConfig.prior_kl (the JAX test_train_loop prior-KL test): one
    step of both packages from the same weights, draws and prior, with the
    prior-mean KL; the port's update equals JAX's, and it lands the layer-1
    weight means closer to the prior than the step without the prior KL."""
    pt = jloop.Trainer(_cfg(jx, 2, H), jx.TrainConfig(batch_size=B,
                                                      seq_len=T))
    prior = pt.init_state(seed=99).params
    j_save_checkpoint(str(tmp_path / "prior.ckpt"), prior)
    prior_flat = _flat(prior)
    data = np.ones((T, B), np.int32)

    def step(prior_kl):
        jt, tt = _trainers(tmp_path, pos=2, lr=1.0, prior=True,
                           prior_path=str(tmp_path / "prior.ckpt"),
                           prior_kl=prior_kl)
        state = tt.init_state(seed=0)
        jt.init_state(seed=0)  # loads jt.priors
        with torch.no_grad():  # means pushed away from the prior
            for n, p in state.model.named_parameters():
                if "weight_ih_mean_1" in n or "weight_hh_mean_1" in n:
                    p.add_(0.5)
        jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
        draws = _noise(np.random.default_rng(1), _draw_shapes(2, True, H))
        inject(draws)
        jout = jt._step_impl(jparams, j_init_opt_state(jparams),
                             j_init_hidden(2, B, H), jnp.asarray(data),
                             jnp.asarray(data), jnp.float32(1.0),
                             jnp.float32(1.0), jax.random.key(0))
        _, _, _, kl, _ = tt.train_step(
            state, init_hidden(2, B, H), torch.from_numpy(data).long(),
            torch.from_numpy(data).long(), 1.0,
            noise=[torch.from_numpy(x) for x in draws])
        np.testing.assert_allclose(float(kl), float(jout[5]), rtol=RTOL,
                                   atol=ATOL)
        _check_state(jout[0], jout[1], state, f"prior_kl={prior_kl}")
        got = _flat(params_to_jax(state.model))
        return sum(float(np.abs(got[k] - prior_flat[k]).sum())
                   for k in ("core.weight_ih_mean_1", "core.weight_hh_mean_1"))

    assert step(True) < step(False)


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


@pytest.mark.parametrize("pos", [3, 5])
def test_packed_carry_scores_of_a_bayes_model_match_jax(monkeypatch, pos):
    """Scoring at the posterior mean through packed-carry, against the JAX
    scorer forced onto packed-carry with the fused CE (interpret mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=2)
    model = bt.build_model(_cfg(bt, pos, H))
    params = bt.init_params(model, _cfg(bt, pos, H), seed=3)
    params["decoder_b"] = np.random.default_rng(0).normal(
        size=V).astype(np.float32) * 0.1
    stream = lambda k: k.split("_")[0]  # noqa: E731
    ref_scorer = JaxScorer(_cfg(jx, pos, H), jax.tree.map(jnp.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_allowed()
    ref = ref_scorer.score_nbest(_nbest(), w2i, stream_fn=stream)
    got = BatchScorer(_cfg(bt, pos, H), params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(_nbest(), w2i,
                                                stream_fn=stream)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_drawn_samples_follow_the_generator():
    """Without injected noise the CPU core draws eps with ``torch.randn``
    from the generator (the CUDA gate admits no CPU tensor): the same
    generator seed gives the same forward, another seed another one."""
    cfg = _cfg(bt, 3)
    core = BayesLSTMCore(cfg)
    core.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((T, B, 12), generator=torch.Generator().manual_seed(1))
    hid = init_hidden(2, B, H)
    run = lambda s: core(x, hid, train=True, generator=torch.Generator(  # noqa: E731
        ).manual_seed(s))[0].detach()
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with pytest.raises(ValueError, match="more injected noise"):
        core(x, hid, train=True, noise=[torch.zeros(s) for s in
                                        _draw_shapes(3, True, 12) * 2])
    # the module-level variant of the JAX BayesLSTM: layer 1 only
    one = BayesLSTMCore(cfg, both_layers=False)
    assert one.lgstd_layers == (1,)
    assert not any("_lgstd_2" in n for n, _ in one.named_parameters())
    params_from_jax(one, params_to_jax(one))


def test_container_dropout_with_injected_masks_matches_jax(inject):
    """The container's training forward of a Bayesian model with dropout:
    the embedding and output masks injected (flax Dropout: x / keep where
    kept), no inter-layer mask, the same eps; values and every gradient
    against the JAX core between hand-applied masks."""
    from bayeslms_tpu_torch.models.lstm_lm import (DropoutMasks,
                                                   draw_dropout_masks)

    keep = 0.8
    cfg = dataclasses.replace(_cfg(bt, 3, H), dropout=0.2)
    model = bt.build_model(cfg)
    tree = bt.init_params(model, cfg, seed=4)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, V, size=(T, B))
    m_emb, m_out = (rng.uniform(size=(T, B, H)) < keep for _ in range(2))
    wout = rng.normal(size=(T, B, H)).astype(np.float32)
    draws = _noise(rng, _draw_shapes(3, True, H))
    jcore = JCore(_cfg(jx, 3, H))
    inject(draws)
    h0 = j_init_hidden(2, B, H)

    def jfwd(p):
        emb = jnp.where(m_emb, p["embedding"][tokens] / keep, 0.0)
        (out, _), _ = jcore.apply({"params": p["core"]}, emb, h0,
                                  deterministic=False,
                                  rngs={"sample": jax.random.key(0)},
                                  mutable=["losses"])
        out = jnp.where(m_out, out / keep, 0.0)
        return jnp.sum(out * wout), out

    (_, ref), grads = jax.value_and_grad(jfwd, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    out, _ = model(torch.from_numpy(tokens), init_hidden(2, B, H),
                   return_hidden=True, deterministic=False,
                   dropout_masks=DropoutMasks(torch.from_numpy(m_emb), None,
                                              torch.from_numpy(m_out)),
                   noise=[torch.from_numpy(d) for d in draws])
    (out * torch.from_numpy(wout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    got = {k: p.grad for k, p in model.named_parameters()}
    for name, ref_g in _flat(grads).items():
        g = got[name]
        g = np.zeros_like(ref_g) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref_g, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    drawn = draw_dropout_masks(cfg, T, B, torch.Generator().manual_seed(0))
    assert drawn.layer is None and drawn.emb.shape == (T, B, H)


def test_gaussian_closed_forms_and_samplers_match_jax():
    """``ops.gaussian`` against the JAX module: the four KL closed forms
    with their reduction quirks, the samplers with an injected eps, and the
    lgstd law's range."""
    from bayeslms_tpu_torch.ops import gaussian as tg

    rng = np.random.default_rng(5)
    m, lg, pm, plg, eps = (rng.normal(size=(6, 5)).astype(np.float32) * sc
                           for sc in (0.5, 0.3, 0.5, 0.3, 1.0))
    t = [torch.from_numpy(a) for a in (m, lg, pm, plg)]
    j = [jnp.asarray(a) for a in (m, lg, pm, plg)]
    for name, n in (("kl_std_normal", 2), ("kl_std_normal_m1", 2),
                    ("kl_vs_prior_sum", 3), ("kl_vs_prior_full", 4)):
        np.testing.assert_allclose(float(getattr(tg, name)(*t[:n])),
                                   float(getattr(jgauss, name)(*j[:n])),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    e = torch.from_numpy(eps)
    np.testing.assert_allclose(
        tg.sample_gaussian(t[0], t[1], 0.1, eps=e).numpy(),
        m + 0.1 * eps * np.exp(lg), rtol=1e-6)
    np.testing.assert_allclose(tg.sample_diff(t[1], eps=e).numpy(),
                               eps * np.exp(lg), rtol=1e-6)
    with pytest.raises(ValueError):
        tg.sample_diff(t[1], eps=e[:2])
    s = 1 / np.sqrt(64)
    x = tg.lgstd_init_(torch.empty(4000), s, torch.Generator().manual_seed(0))
    ref = jgauss.lgstd_init(s)(jax.random.key(0), (4000,))
    for a in (x.numpy(), np.asarray(ref)):
        assert 2 * np.log(s) <= a.min() and a.max() <= np.log(s)
        assert a.max() - a.min() > 0.95 * -np.log(s)
