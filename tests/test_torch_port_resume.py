"""Full-state resume of the port's trainer (``train/loop.py``
``_save_resume``, ``_try_resume``) on the CPU: one epoch and a resume equal
two straight epochs bit for bit (the generator's state in the resume file
gives the resumed epoch the same dropout masks and Bayesian draws); the
plateau schedule (LR halved, best reloaded, momentum reset) survives a
resume; and, at dropout 0, the port resumes from the ``.resume`` that the
JAX package's ``Trainer`` wrote and its epoch 2 (parameters, validation
loss, the resume file's meta) equals the JAX trainer's own resumed epoch 2
(rtol 2e-4 / atol 1e-5)."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu import ModelConfig as JModelConfig
from bayeslms_tpu import TrainConfig as JTrainConfig
from bayeslms_tpu.data import corpus as jcorpus
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch import ModelConfig, TrainConfig
from bayeslms_tpu_torch.core.checkpoint import (load_checkpoint,
                                                params_to_jax)
from bayeslms_tpu_torch.data import corpus as tcorpus
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, E, H = 40, 16, 16


def _write_corpus(root, n_train=500, n_valid=120, n_test=120, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V - 2)]
    succ = rng.integers(0, V - 2, size=(V - 2, 3))
    root.mkdir(parents=True, exist_ok=True)
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
        lines.append(" ".join(line))
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    _write_corpus(root)
    return root


MODELS = {"standard": dict(dropout=0.3),
          "bayes3": dict(dropout=0.2, uncertainty="Bayesian", l_bayes_pos=3)}


def _trainer(save, epochs, **mkw):
    cfg = ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H, **mkw)
    return Trainer(cfg, TrainConfig(lr=2.0, batch_size=4, seq_len=10,
                                    eval_batch_size=3, epochs=epochs,
                                    resume=True, save=str(save)),
                   device="cpu")


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model", list(MODELS))
def test_one_epoch_and_a_resume_equal_two_epochs(tmp_path, corpus_dir,
                                                 model):
    corpus = tcorpus.Corpus(str(corpus_dir))
    straight, out = _trainer(tmp_path / "a" / "m.ckpt", 2,
                             **MODELS[model]).fit(corpus,
                                                  log=lambda *_: None)
    first = _trainer(tmp_path / "b" / "m.ckpt", 1, **MODELS[model])
    first.fit(corpus, log=lambda *_: None)
    lines = []
    again = _trainer(tmp_path / "b" / "m.ckpt", 2, **MODELS[model])
    resumed, rout = again.fit(corpus, log=lines.append)
    assert lines[0].startswith("resumed from epoch 1 (lr ")
    assert [h["epoch"] for h in rout["history"]] == [2]
    assert rout["history"][0] == out["history"][1]
    assert rout["test_loss"] == out["test_loss"]
    _same(dict(straight.model.named_parameters()),
          dict(resumed.model.named_parameters()))
    _same(straight.opt_state.momentum, resumed.opt_state.momentum)
    assert (straight.lr, straight.best_val_loss, straight.plateaus) == \
        (resumed.lr, resumed.best_val_loss, resumed.plateaus)
    tree, meta = load_checkpoint(str(tmp_path / "b" / "m.ckpt.resume"))
    assert meta == {"epoch": 2, "lr": resumed.lr,
                    "best_val_loss": resumed.best_val_loss,
                    "plateaus": resumed.plateaus}
    assert set(tree) == {"params", "momentum", "generator"}
    assert torch.equal(torch.from_numpy(tree["generator"]),
                       again.gen.get_state())


def test_resume_needs_the_flag_and_the_file(tmp_path, corpus_dir):
    corpus = tcorpus.Corpus(str(corpus_dir))
    t = _trainer(tmp_path / "m.ckpt", 1)
    assert t._try_resume() is None  # no file yet
    t.fit(corpus, log=lambda *_: None)
    off = _trainer(tmp_path / "m.ckpt", 1)
    off.tcfg = dataclasses.replace(off.tcfg, resume=False)
    assert off._try_resume() is None
    assert _trainer(tmp_path / "m.ckpt", 1)._try_resume().epoch == 1


def test_plateau_schedule_survives_a_resume(tmp_path, corpus_dir):
    """Scripted validation losses (improve, plateau, plateau): three
    straight epochs against two and a resume; the resume file after the
    first plateau holds the halved LR, one plateau and zero momentum."""
    corpus = tcorpus.Corpus(str(corpus_dir))
    script = [3.0, 3.5, 3.2, 2.0]

    def scripted(t, start):
        it = iter(script[start:])
        t.evaluate = lambda model, rows: next(it)
        return t

    straight, out = scripted(_trainer(tmp_path / "a" / "m.ckpt", 3), 0).fit(
        corpus, log=lambda *_: None)
    scripted(_trainer(tmp_path / "b" / "m.ckpt", 2), 0).fit(
        corpus, log=lambda *_: None)
    tree, meta = load_checkpoint(str(tmp_path / "b" / "m.ckpt.resume"))
    assert meta == {"epoch": 2, "lr": 1.0, "best_val_loss": 3.0,
                    "plateaus": 1}
    assert all(not np.any(v) for v in jax.tree.leaves(tree["momentum"]))
    resumed, rout = scripted(_trainer(tmp_path / "b" / "m.ckpt", 3), 2).fit(
        corpus, log=lambda *_: None)
    assert rout["history"] == out["history"][2:]
    assert [h["lr"] for h in out["history"]] == [2.0, 2.0, 1.0]
    assert resumed.lr == straight.lr == 0.5 and resumed.plateaus == 2
    _same(dict(straight.model.named_parameters()),
          dict(resumed.model.named_parameters()))
    _same(straight.opt_state.momentum, resumed.opt_state.momentum)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_port_resumes_from_the_jax_trainers_resume_file(tmp_path,
                                                        corpus_dir):
    """Dropout 0: the JAX trainer runs epoch 1 and writes its ``.resume``
    (flax msgpack and its ``.json`` sidecar); from a copy of those files
    the port runs epoch 2, and so does the JAX trainer from its own: the
    parameters, the validation loss and the meta agree."""
    kw = dict(model="LSTM", vocab_size=V, emsize=E, nhid=H, dropout=0.0)
    tkw = dict(lr=2.0, batch_size=4, seq_len=10, eval_batch_size=3,
               resume=True)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    seed_tree = params_to_jax(_trainer(tmp_path / "x", 1,
                                       dropout=0.0).init_state().model)
    jt = jloop.Trainer(JModelConfig(**kw), JTrainConfig(
        epochs=1, save=str(jdir / "m.ckpt"), **tkw))
    real = jt.init_state

    def init_state(seed=None):
        s = real(seed)
        s.params = jax.tree.map(jnp.asarray, seed_tree)
        s.opt_state = j_init_opt_state(s.params)
        return s
    jt.init_state = init_state
    jcorp = jcorpus.Corpus(str(corpus_dir))
    jt.fit(jcorp, log=lambda *_: None)
    shutil.copytree(jdir, tdir)
    jt.tcfg = dataclasses.replace(jt.tcfg, epochs=2)
    jstate, jout = jt.fit(jcorp, log=lambda *_: None)
    tt = Trainer(ModelConfig(**kw), TrainConfig(
        epochs=2, save=str(tdir / "m.ckpt"), **tkw), device="cpu")
    lines = []
    state, out = tt.fit(tcorpus.Corpus(str(corpus_dir)), log=lines.append)
    assert lines[0] == \
        f"resumed from epoch 1 (lr {jout['history'][0]['lr']})"
    assert state.lr == jstate.lr and state.plateaus == jstate.plateaus
    assert [h["epoch"] for h in out["history"]] == [2]
    np.testing.assert_allclose(out["history"][0]["val_loss"],
                               jout["history"][0]["val_loss"], rtol=RTOL)
    np.testing.assert_allclose(out["test_loss"], jout["test_loss"],
                               rtol=RTOL)
    got = _flat(params_to_jax(state.model))
    for name, ref in _flat(jstate.params).items():
        np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    _, meta = load_checkpoint(str(tdir / "m.ckpt.resume"))
    jmeta = json.loads((jdir / "m.ckpt.resume.json").read_text())
    for k in ("epoch", "lr", "plateaus"):
        assert meta[k] == jmeta[k], k
    np.testing.assert_allclose(meta["best_val_loss"],
                               jmeta["best_val_loss"], rtol=RTOL)
