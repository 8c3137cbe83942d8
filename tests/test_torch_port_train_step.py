"""The port's training slice (``bayeslms_tpu_torch.train``, ``data``,
``core.checkpoint``) against the JAX package on the CPU, float32, from the
same weights: corpus helpers, three trainer steps, the masked ragged-tail
step, the training forward with injected dropout masks, and ``fit`` (its
epochs and its plateau schedule)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu import ModelConfig as JModelConfig
from bayeslms_tpu import TrainConfig as JTrainConfig
from bayeslms_tpu.data import corpus as jcorpus
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import lstm as jlstm
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch import ModelConfig, TrainConfig
from bayeslms_tpu_torch.core.checkpoint import (load_checkpoint,
                                                params_to_jax)
from bayeslms_tpu_torch.data import corpus as tcorpus
from bayeslms_tpu_torch.models.lstm_lm import DropoutMasks, init_hidden
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5  # the golden tests' tolerance
V, E, H = 40, 16, 16


def _cfgs(dropout=0.0):
    kw = dict(model="LSTM", vocab_size=V, emsize=E, nhid=H, nlayers=2,
              dropout=dropout, tied=True)
    return JModelConfig(**kw), ModelConfig(**kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _write_corpus(root, n_train=700, n_valid=150, n_test=150, seed=0):
    """Markov text over V - 2 words: each word is followed by one of three
    successors, so there is something to learn."""
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


def test_corpus_helpers_match_jax(tmp_path):
    _write_corpus(tmp_path)
    jc = jcorpus.Corpus(str(tmp_path))
    tc = tcorpus.Corpus(str(tmp_path))
    assert tc.vocab.idx2word == jc.vocab.idx2word
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(tc, split), getattr(jc, split))
    for frac in (1.0, 0.3):
        np.testing.assert_array_equal(
            tcorpus.apply_data_fraction(tc.train, frac),
            jcorpus.apply_data_fraction(jc.train, frac))
    for bsz, L in ((4, 10), (7, 13), (3, 300)):
        rows = tcorpus.batchify(tc.train, bsz)
        np.testing.assert_array_equal(rows, jcorpus.batchify(jc.train, bsz))
        for i in (0, L, rows.shape[0] - 3):
            for a, b in zip(tcorpus.get_batch(rows, i, L),
                            jcorpus.get_batch(rows, i, L)):
                np.testing.assert_array_equal(a, b)
        got = tcorpus.windows(rows, L, drop_ragged=False)
        ref = jcorpus.windows(rows, L, drop_ragged=False)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert (got[2] is None) == (ref[2] is None)
        if got[2] is not None:
            for a, b in zip(got[2], ref[2]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(tcorpus.windows(rows, L), jcorpus.windows(rows, L)):
            np.testing.assert_array_equal(a, b)


def _pair(tmp_path, dropout=0.0, **tkw):
    jcfg, tcfg = _cfgs(dropout)
    kw = dict(lr=2.0, batch_size=4, seq_len=10, eval_batch_size=3,
              save=str(tmp_path / "model.ckpt"), **tkw)
    tt = Trainer(tcfg, TrainConfig(**kw), device="cpu")
    jt = jloop.Trainer(jcfg, JTrainConfig(**kw))
    return jt, tt


def _check_state(jparams, jopt, state, what):
    got_p = _flat(params_to_jax(state.model))
    for name, ref in _flat(jparams).items():
        np.testing.assert_allclose(got_p[name], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {name}")
    for name, ref in _flat(jopt.momentum).items():
        np.testing.assert_allclose(state.opt_state.momentum[name].numpy(),
                                   ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: momentum {name}")


def _batch(rng, T, B):
    return (rng.integers(0, V, size=(T, B)).astype(np.int32),
            rng.integers(0, V, size=(T, B)).astype(np.int32))


def test_three_train_steps_match_jax(tmp_path):
    jt, tt = _pair(tmp_path)
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    jh = j_init_hidden(2, 4, H)
    th = init_hidden(2, 4, H)
    rng = np.random.default_rng(7)
    for step in range(3):
        d, t = _batch(rng, 10, 4)
        jparams, jopt, jh, jloss, _, _, jgn = jt._train_step(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(0.1), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        assert float(kl) == 0.0
        _check_state(jparams, jopt, state, f"step {step}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


def test_masked_ragged_tail_step_matches_jax(tmp_path):
    jt, tt = _pair(tmp_path)
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    rng = np.random.default_rng(8)
    d, t = _batch(rng, 10, 4)
    m = np.zeros((10, 4), np.float32)
    m[:6] = 1.0
    d[6:], t[6:] = 0, 0  # padding, as run_epoch pads
    jparams, jopt, _, jloss, _, _, jgn = jt._get_masked_step()(
        jparams, jopt, j_init_hidden(2, 4, H), jnp.asarray(d),
        jnp.asarray(t), jnp.float32(2.0), jnp.float32(0.1),
        jax.random.key(0), jnp.asarray(m))
    _, loss, _, _, gn = tt.train_step(
        state, init_hidden(2, 4, H), torch.from_numpy(d).long(),
        torch.from_numpy(t).long(), 0.1, mask=torch.from_numpy(m))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
    _check_state(jparams, jopt, state, "masked step")


def test_training_forward_with_injected_dropout_masks_matches_jax(tmp_path):
    """Embedding, inter-layer and output dropout with the same keep masks:
    the port's model against JAX ``lstm_stack2(dropout_mask=...)`` with the
    embedding and output masks applied by hand (flax Dropout: x / keep where
    kept), values and the gradients of every parameter."""
    _, tt = _pair(tmp_path, dropout=0.2)
    keep = 0.8
    state = tt.init_state()
    tree = params_to_jax(state.model)
    rng = np.random.default_rng(9)
    T, B = 6, 3
    tokens = rng.integers(0, V, size=(T, B))
    masks = [rng.uniform(size=(T, B, w)) < keep for w in (E, H, H)]
    h0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.1
    wout = rng.normal(size=(T, B, H)).astype(np.float32)

    def jax_fwd(p):
        emb = jnp.where(masks[0], p["embedding"][tokens] / keep, 0.0)
        c = p["core"]
        lp = [jlstm.LSTMParams(*(c[f"l{k}_{n}"] for n in
                                 ("w_ih", "w_hh", "b_ih", "b_hh")))
              for k in (0, 1)]
        out, hs, cs = jlstm.lstm_stack2(
            emb, h0, c0, *lp,
            dropout_mask=masks[1].astype(jnp.float32) / keep)
        out = jnp.where(masks[2], out / keep, 0.0)
        return jnp.sum(out * wout), (out, hs, cs)

    (_, (ref, rhs, rcs)), grads = jax.value_and_grad(jax_fwd, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    out, (hs, cs) = state.model(
        torch.from_numpy(tokens), (torch.from_numpy(h0), torch.from_numpy(c0)),
        return_hidden=True, deterministic=False,
        dropout_masks=DropoutMasks(*map(torch.from_numpy, masks)))
    (out * torch.from_numpy(wout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    for a, b in ((hs, rhs), (cs, rcs)):
        np.testing.assert_allclose(a.detach().numpy(),
                                   np.stack([np.asarray(x) for x in b]),
                                   rtol=RTOL, atol=ATOL)
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in state.model.named_parameters()}  # no decoder here
    for name, ref_g in _flat(grads).items():
        np.testing.assert_allclose(got[name], ref_g, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # drawn masks: Bernoulli(keep) from the trainer's generator
    gen = torch.Generator().manual_seed(0)
    out2, _ = state.model(torch.from_numpy(tokens),
                          (torch.from_numpy(h0), torch.from_numpy(c0)),
                          return_hidden=True, deterministic=False,
                          generator=gen)
    assert 0.05 < float((out2 == 0).float().mean()) < 0.45


def _same_init(jt, tt):
    """The JAX trainer starts from the port's initial weights."""
    init = tt.init_state()
    tree = jax.tree.map(jnp.asarray, params_to_jax(init.model))
    real = jt.init_state

    def init_state(seed=None):
        s = real(seed)
        s.params, s.opt_state = tree, j_init_opt_state(tree)
        return s
    jt.init_state = init_state


def test_fit_matches_jax(tmp_path):
    """Two epochs of ``fit`` from the same weights, ragged tails and the
    token-exact evaluation included: the same validation history and test
    loss, and the best checkpoint scores in the port's model."""
    _write_corpus(tmp_path)
    corpus = tcorpus.Corpus(str(tmp_path))
    jt, tt = _pair(tmp_path / "t", epochs=2, log_interval=5)
    jt.tcfg = dataclasses.replace(jt.tcfg, save=str(tmp_path / "j.ckpt"))
    _same_init(jt, tt)
    _, jout = jt.fit(jcorpus.Corpus(str(tmp_path)), log=lambda *_: None)
    state, out = tt.fit(corpus, log=lambda *_: None)
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    for a, b in zip(out["history"], jout["history"]):
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=RTOL)
    np.testing.assert_allclose(out["test_loss"], jout["test_loss"], rtol=RTOL)
    assert out["history"][1]["val_loss"] < out["history"][0]["val_loss"]
    tree, meta = load_checkpoint(tt.tcfg.save)
    assert meta["epoch"] == 2 and meta["model_config"]["vocab_size"] == V
    for name, v in _flat(params_to_jax(state.model)).items():
        np.testing.assert_array_equal(_flat(tree)[name], v)


def test_plateau_schedule_matches_jax(tmp_path):
    """Scripted validation losses (improve, plateau, improve, plateau):
    both packages halve the LR on a plateau and stop after
    ``max_plateaus``; the port reloads the best checkpoint and resets the
    momentum at each plateau."""
    _write_corpus(tmp_path, n_train=300, n_valid=60, n_test=60)
    corpus = tcorpus.Corpus(str(tmp_path))
    jt, tt = _pair(tmp_path / "t", epochs=6, max_plateaus=2)
    jt.tcfg = dataclasses.replace(jt.tcfg, save=str(tmp_path / "j.ckpt"))
    _same_init(jt, tt)
    script = [3.0, 3.5, 2.5, 2.6, 9.0]
    for tr in (jt, tt):
        losses = iter(script)
        tr.evaluate = lambda params, rows, it=losses: next(it)
    _, jout = jt.fit(jcorpus.Corpus(str(tmp_path)), log=lambda *_: None)

    starts, run_epoch = [], tt.run_epoch

    def spy(state, rows, log, on_step=None):
        starts.append((_flat(params_to_jax(state.model)),
                       {k: v.clone() for k, v in
                        state.opt_state.momentum.items()}, state.lr))
        if state.epoch == 2:
            saved = load_checkpoint(tt.tcfg.save)[0]
            starts.append(_flat(saved))
        return run_epoch(state, rows, log, on_step)

    tt.run_epoch = spy
    state, out = tt.fit(corpus, log=lambda *_: None)
    assert out["history"] == jout["history"]
    assert [h["lr"] for h in out["history"]] == [2.0, 2.0, 1.0, 1.0]
    assert out["test_loss"] == jout["test_loss"] == 9.0
    assert state.plateaus == 2
    epoch1_ckpt = starts[2]
    # epoch 3 starts from the reloaded epoch-1 checkpoint, momentum zeroed
    params3, mom3, lr3 = starts[3]
    assert lr3 == 1.0
    for name, v in epoch1_ckpt.items():
        np.testing.assert_array_equal(params3[name], v)
    assert all(float(m.abs().max()) == 0.0 for m in mom3.values())
    assert any(float(m.abs().max()) > 0 for m in starts[1][1].values())
    tree, meta = load_checkpoint(tt.tcfg.save)
    assert meta["epoch"] == 3


def test_trainer_defaults_to_cuda_and_refuses_unported_options(monkeypatch):
    """No card: an error, not a CPU run. Data-parallel training is
    ported (ROADMAP.md A13; tests/test_torch_port_parallel.py): without a
    process group ``dp_shards`` asks for one; the tp meshes the port's tp
    step does not take raise naming A13b."""
    from bayeslms_tpu_torch.parallel.train_parallel import check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="no process group"):
        Trainer(cfg, TrainConfig(dp_shards=2), device="cpu")
    untied = dataclasses.replace(cfg, tied=False)
    emb = ModelConfig(model="Transformer", vocab_size=V, emsize=E, nhid=32,
                      nhead=2, uncertainty="Bayesian", t_bayes_pos="EMB")
    for c, t, dp, tp in ((untied, TrainConfig(batch_size=4), 1, 2),
                         (emb, TrainConfig(batch_size=4), 2, 2),
                         (cfg, TrainConfig(batch_size=6), 1, 4),
                         (dataclasses.replace(cfg, vocab_size=41),
                          TrainConfig(batch_size=4), 1, 2),
                         (cfg, TrainConfig(batch_size=5), 2, 1)):
        with pytest.raises(NotImplementedError, match="item A13b"):
            check(c, t, dp, tp)
    check(cfg, TrainConfig(batch_size=4), 2, 2)
    # full-state resume and profiling are ported (ROADMAP.md A6)
    for kw in (dict(resume=True), dict(profile_dir="p")):
        assert Trainer(cfg, TrainConfig(**kw), device="cpu").tcfg == \
            TrainConfig(**kw)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("scale", [1.0, 100.0], ids=["unclipped", "clipped"])
def test_sgd_momentum_step_matches_jax(weight_decay, scale):
    from bayeslms_tpu.train.optim import sgd_momentum_step as j_step
    from bayeslms_tpu_torch.train.optim import (init_opt_state,
                                                sgd_momentum_step)

    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = init_opt_state(tp)
    for _ in range(2):
        grads = {k: rng.normal(size=s).astype(np.float32) * scale
                 for k, s in shapes.items()}
        jp, jopt, jgn = j_step(jp, jax.tree.map(jnp.asarray, grads), jopt,
                               0.5, 1.0, 0.9, weight_decay)
        topt, gn = sgd_momentum_step(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, topt,
            0.5, 1.0, 0.9, weight_decay)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(topt.momentum[k].numpy(),
                                       np.asarray(jopt.momentum[k]),
                                       rtol=1e-6, atol=1e-6)
