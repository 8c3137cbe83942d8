"""The port's GP-LSTM through ``train.loop.Trainer`` (three steps, with and
without GP sampling, and two epochs of ``fit``) and the packed-carry
``BatchScorer`` against the JAX package on the CPU, float32, from the same
weights and the same noise (the JAX side's eps injected through
``bayeslms_tpu.ops.gaussian.sample_diff``, as in ``test_torch_port_gp.py``).
Trainer at rtol 2e-4 / atol 1e-5 (the golden tests'); scores at rtol 1e-4
/ atol 1e-5 (the scorer tests')."""

import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.data import corpus as jcorpus
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.data import corpus as tcorpus
from bayeslms_tpu_torch.models.lstm_lm import draw_dropout_masks, init_hidden
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer
RTOL, ATOL = 2e-4, 1e-5
V, H = 24, 8
T, B = 6, 3


def _cfg(pkg, pos="13", E=H, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Gaussian",
                           l_gauss_pos=pos, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


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


def _draw_shapes(pos):
    """Shapes of a GP core's draws (``gp_sample``, emsize = nhid) in the
    JAX call order: coef (types 1, 3), then weights and bias (2, 3), a
    cell at a time."""
    t = int(pos[1])
    gates = [int(pos[0])] + ([int(pos[2])] if len(pos) == 4 else [])
    return [s for g in gates for s in
            ([(1 if g == 2 else 3, H)] if t in (1, 3) else [])
            + ([(H, 2 * H), (H,)] if t in (2, 3) else [])]

# ---------------------------------------------------------------- trainer
def _check_state(jparams, jopt, state, what):
    got = _flat(params_to_jax(state.model))
    for name, ref in _flat(jparams).items():
        np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")
    for name, ref in _flat(jopt.momentum).items():
        np.testing.assert_allclose(state.opt_state.momentum[name].numpy(),
                                   ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: momentum {name}")


@pytest.mark.parametrize("pos,sample", [("13", False), ("1323", True)])
def test_three_trainer_steps_with_kl_match_jax(tmp_path, inject, pos,
                                               sample):
    """Three steps of both trainers on the same batches (and, sampling,
    the same eps): loss, KL x kl_scale, gradient norm, weights, momentum
    and the carried state. The JAX step runs unjitted, so that each step
    takes its own injected draws."""
    kw = dict(lr=2.0, batch_size=B, seq_len=T, save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_cfg(jx, pos, H, gp_sample=sample),
                       jx.TrainConfig(**kw))
    tt = Trainer(_cfg(bt, pos, H, gp_sample=sample), bt.TrainConfig(**kw),
                 device="cpu")
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    jh, th = j_init_hidden(2, B, H), init_hidden(2, B, H)
    rng = np.random.default_rng(4)
    for step in range(3):
        d = rng.integers(0, V, size=(T, B)).astype(np.int32)
        t = rng.integers(0, V, size=(T, B)).astype(np.int32)
        draws = [rng.normal(size=s).astype(np.float32)
                 for s in (_draw_shapes(pos) if sample else [])]
        inject(draws)
        jparams, jopt, jh, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(0.1), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1, noise=[torch.from_numpy(x) for x in draws] or None)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        assert float(kl) > 0
        _check_state(jparams, jopt, state, f"step {step}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


def _write_corpus(root, n_train=700, n_valid=150, n_test=150, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V - 2)]
    succ = rng.integers(0, V - 2, size=(V - 2, 3))
    (root / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, w in enumerate(["<s>", "<unk>", *words])))
    w = 0
    for name, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        lines, line = [], []
        for _ in range(n):
            w = succ[w, rng.integers(0, 3)]
            line.append(words[w])
            if len(line) == 9:
                lines.append(" ".join(line))
                line = []
        lines.append(" ".join(line + ["oov_word"]))
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")


def test_fit_matches_jax(tmp_path):
    """Two epochs of ``fit`` from the same weights (ragged tails, the KL
    and the token-exact evaluation included): the same validation history
    and test loss."""
    _write_corpus(tmp_path)
    kw = dict(lr=2.0, batch_size=4, seq_len=10, eval_batch_size=3,
              epochs=2, log_interval=5)
    jt = jloop.Trainer(_cfg(jx, "13", H), jx.TrainConfig(
        save=str(tmp_path / "j.ckpt"), **kw))
    tt = Trainer(_cfg(bt, "13", H), bt.TrainConfig(
        save=str(tmp_path / "t.ckpt"), **kw), device="cpu")
    init = tt.init_state()
    tree = jax.tree.map(jnp.asarray, params_to_jax(init.model))
    real = jt.init_state

    def init_state(seed=None):
        s = real(seed)
        s.params, s.opt_state = tree, j_init_opt_state(tree)
        return s
    jt.init_state = init_state
    _, jout = jt.fit(jcorpus.Corpus(str(tmp_path)), log=lambda *_: None)
    _, out = tt.fit(tcorpus.Corpus(str(tmp_path)), log=lambda *_: None)
    for a, b in zip(out["history"], jout["history"]):
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(out["test_loss"], jout["test_loss"],
                               rtol=RTOL, atol=ATOL)
    assert len(out["history"]) == 2


def test_container_dropout_draws_no_inter_layer_mask():
    """The GP kinds have no inter-layer dropout (as the Bayesian core);
    the standard kind (gate digit 0) has."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(_cfg(bt, "13", H), dropout=0.2)
    assert draw_dropout_masks(cfg, T, B, gen).layer is None
    std = dataclasses.replace(cfg, l_gauss_pos="00")
    assert draw_dropout_masks(std, T, B, gen).layer.shape == (T, B, H)
    model = bt.build_model(cfg)
    bt.init_params(model, cfg, seed=1)
    out, _ = model(torch.zeros((T, B), dtype=torch.long),
                   init_hidden(2, B, H), return_hidden=True,
                   deterministic=False, generator=gen)
    assert 0.05 < float((out == 0).float().mean()) < 0.45


# ---------------------------------------------------------------- scoring
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


@pytest.mark.parametrize("pos", ["13", "23", "1323"])
def test_packed_carry_scores_of_a_gp_model_match_jax(monkeypatch, pos):
    """Scoring through packed-carry (the GP cell's scan with resets, the
    standard layer's route, the fused CE), against the JAX scorer forced
    onto packed-carry with the fused CE (interpret mode)."""
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
