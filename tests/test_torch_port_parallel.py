"""The port's multi-device paths (``bayeslms_tpu_torch.parallel``, the
trainer's and the scorer's ``mesh``, the command line's ``--dp-shards`` /
``--tp-shards``) on gloo ranks on the CPU, one thread each, against the
JAX package on the same numpy-seeded inputs. The ranks run the functions
of ``tests/torch_parallel_ranks.py`` through ``parallel.multihost.spawn``
and import no JAX; the test computes the JAX reference itself. Each spawn
has a time limit of its own, so that a hung collective fails its test.
Tolerances: rtol 2e-4 / atol 1e-5 for values, KLs and gradients, 1e-4 /
1e-5 for scores."""

import dataclasses
import json
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
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.parallel.mesh import make_mesh as j_make_mesh
from bayeslms_tpu.parallel.train_parallel import (make_sharded_train_step,
                                                  place)
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.parallel.multihost import spawn
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
S_RTOL, S_ATOL = 1e-4, 1e-5
SPAWN_TIMEOUT = 120.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _ranks(fn, world, payload):
    return spawn(f"torch_parallel_ranks:{fn}", world, payload,
                 timeout=SPAWN_TIMEOUT)


def _close(got: dict, ref: dict, what: str):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def test_dp_bayes_step_matches_jax_one_device(monkeypatch):
    """Two dp = 2 steps of the Bayesian LSTM (l_bayes_pos 3, dropout 0.2)
    against two one-device JAX steps with JAX's dropout masks and weight
    draws injected: the ranks take the same masks (each its columns) and
    the same draws (one for the whole batch, as JAX's shared sample key);
    loss, KL, gnorm, parameters, momentum and each rank's state."""
    V, H, T, B = 24, 8, 5, 4
    kw = dict(model="LSTM", vocab_size=V, emsize=H, nhid=H, nlayers=2,
              dropout=0.2, uncertainty="Bayesian", l_bayes_pos=3)
    tkw = dict(lr=2.0, batch_size=B, seq_len=T)
    model = bt.build_model(bt.ModelConfig(**kw))
    tree = bt.init_params(model, bt.ModelConfig(**kw), seed=3)
    jt = jloop.Trainer(jx.ModelConfig(**kw), jx.TrainConfig(**tkw))
    rng = np.random.default_rng(4)
    shapes = [s for ins in (H, H) for s in ((H, H), (H, ins), (H,), (H,))]
    batches = []
    for _ in range(2):
        batches.append(dict(
            data=rng.integers(0, V, (T, B)).astype(np.int64),
            target=rng.integers(0, V, (T, B)).astype(np.int64),
            masks=[rng.uniform(size=(T, B, H)) < 0.8, None,
                   rng.uniform(size=(T, B, H)) < 0.8],
            noise=[rng.normal(size=s).astype(np.float32) for s in shapes],
            kl_scale=0.1))

    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = j_init_opt_state(jparams)
    jh = j_init_hidden(2, B, H)
    ref_stats = []
    for step, b in enumerate(batches):
        masks, eps = iter([b["masks"][0], b["masks"][2]]), iter(b["noise"])
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p=0.5, shape=None: jnp.asarray(
                                next(masks)))
        monkeypatch.setattr(jgauss, "sample_diff",
                            lambda key, lg, scale=1.0: scale * jnp.asarray(
                                next(eps)) * jnp.exp(lg))
        # a new function each step: its trace takes this step's draws
        jparams, jopt, jh, loss, mle, kl, gn = jax.jit(
            lambda *a: jt._step_impl(*a))(
            jparams, jopt, jh, jnp.asarray(b["data"]),
            jnp.asarray(b["target"]), jnp.float32(2.0),
            jnp.float32(b["kl_scale"]), jax.random.key(step))
        ref_stats.append((float(loss), float(mle), float(kl), float(gn)))
    monkeypatch.undo()

    res = _ranks("train_steps", 2, dict(dp=2, tp=1, cfg=kw, tcfg=tkw,
                                        params=tree, batches=batches))
    for r in res:
        np.testing.assert_allclose(r["stats"], ref_stats, rtol=RTOL,
                                   atol=ATOL)
        assert r["stats"][0][2] > 0  # the KL term
        _close(r["params"], _flat(jparams), "params")
        _close(r["momentum"], _flat(jopt.momentum), "momentum")
    for i in range(2):
        got = np.concatenate([r["hidden"][i] for r in res], axis=1)
        np.testing.assert_allclose(got, np.asarray(jh[i]), rtol=RTOL,
                                   atol=ATOL)


def test_dp_tp_step_matches_jax_sharded_step():
    """Two steps of the tied LSTM on a dp 2 x tp 2 mesh (the vocabulary
    split over tp, rows 9-11 on each rank's rows) against the JAX
    package's ``make_sharded_train_step`` on a (2, 2) mesh, and the masked
    step of a ragged window against JAX's masked variant; every rank's
    gathered parameters, loss, mle and gnorm."""
    V, E, H, T, B = 40, 16, 16, 6, 8
    kw = dict(model="LSTM", vocab_size=V, emsize=E, nhid=H, nlayers=2,
              dropout=0.0)
    tkw = dict(lr=2.0, batch_size=B, seq_len=T, clip=0.1)
    tree = bt.init_params(bt.build_model(bt.ModelConfig(**kw)),
                          bt.ModelConfig(**kw), seed=6)
    rng = np.random.default_rng(8)
    mask = np.zeros((T, B), np.float32)
    mask[:4] = 1.0
    batches = [dict(data=rng.integers(0, V, (T, B)),
                    target=rng.integers(0, V, (T, B)), kl_scale=0.1,
                    mask=None if i < 2 else mask) for i in range(3)]
    jt = jloop.Trainer(jx.ModelConfig(**kw), jx.TrainConfig(**tkw))
    mesh = j_make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    jparams = jax.tree.map(jnp.asarray, tree)
    ref_stats = []
    with mesh:
        step, p_sh, b_sh, h_sh = make_sharded_train_step(jt, mesh, jparams)
        masked = make_sharded_train_step(jt, mesh, jparams, masked=True)[0]
        params = place(jparams, p_sh)
        opt = j_init_opt_state(params)
        hid = place(j_init_hidden(2, B, H), (h_sh, h_sh))
        for i, b in enumerate(batches):
            args = (params, opt, hid, place(jnp.asarray(b["data"]), b_sh),
                    place(jnp.asarray(b["target"]), b_sh), jnp.float32(2.0),
                    jnp.float32(0.1), jax.random.key(i))
            if b["mask"] is None:
                params, opt, hid, loss, mle, kl, gn = step(*args)
            else:
                params, opt, hid, loss, mle, kl, gn = masked(
                    *args, place(jnp.asarray(b["mask"]), b_sh))
            ref_stats.append((float(loss), float(mle), float(kl), float(gn)))
        ref = _flat(jax.device_get(params))

    res = _ranks("train_steps", 4, dict(dp=2, tp=2, cfg=kw, tcfg=tkw,
                                        params=tree, batches=batches))
    for r in res:
        np.testing.assert_allclose(r["stats"], ref_stats, rtol=RTOL,
                                   atol=ATOL)
        _close(r["params"], ref, "params")
    # the clip bites (gnorm above clip 0.1)
    assert ref_stats[0][3] > 0.1


def _streams(seed, V):
    """Markov id streams (train with a ragged last window, valid, test)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(2, V, size=(V, 3))
    w, out = 2, []
    for n in (403, 97, 97):
        ids = []
        for _ in range(n):
            w = int(succ[w, rng.integers(0, 3)])
            ids.append(w)
        out.append(np.asarray(ids, np.int64))
    return out


def test_fit_with_dp_shards_matches_one_device():
    """``Trainer.fit`` with ``dp_shards=2`` (dropout 0, two epochs, a
    ragged last window each epoch, the token-exact evaluation) gives the
    one-device history, test loss and parameters; with dropout on, one
    epoch and a resumed second (the ``.resume`` file with every rank's
    dropout stream) end bit-equal to two straight epochs."""
    V = 30
    kw = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, nlayers=2,
              dropout=0.0)
    tkw = dict(lr=2.0, batch_size=4, seq_len=12, eval_batch_size=3, epochs=2)
    streams = _streams(1, V)
    assert (len(streams[0]) // 4 - 1) % 12  # a ragged last window
    tree = bt.init_params(bt.build_model(bt.ModelConfig(**kw)),
                          bt.ModelConfig(**kw), seed=2)

    class Corpus:
        train, valid, test = streams

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(bt.ModelConfig(**kw),
                     bt.TrainConfig(save=f"{d}/one.ckpt", **tkw),
                     device="cpu")
        init = tr.init_state

        def init_state(seed=None):
            st = init(seed)
            tr._load_tree(st.model, tree)
            return st
        tr.init_state = init_state
        state, ref = tr.fit(Corpus, log=lambda *a: None)
        res = _ranks("fit", 2, dict(
            cfg=kw, tcfg=dict(tkw, dp_shards=2, save=f"{d}/dp.ckpt"),
            params=tree, streams=streams, resume_dir=d))
    for r in res:
        assert [h["lr"] for h in r["history"]] == \
            [h["lr"] for h in ref["history"]]
        np.testing.assert_allclose([h["val_loss"] for h in r["history"]],
                                   [h["val_loss"] for h in ref["history"]],
                                   rtol=RTOL)
        np.testing.assert_allclose(r["test_loss"], ref["test_loss"],
                                   rtol=RTOL)
        _close(r["params"], _flat(params_to_jax(state.model)), "params")
        assert r["resume_equal"]
    assert ref["history"][1]["val_loss"] < ref["history"][0]["val_loss"]


def _nbest(V):
    rng = np.random.default_rng(3)
    nbest = OrderedDict()
    for m in range(3):
        for u in range(3):
            nbest[f"m{m}-u{u}"] = [" ".join(
                f"w{x}" for x in rng.integers(2, V, rng.integers(1, 9)))
                for _ in range(2 + (u % 2))]
    nbest["m0-u1"][0] += " oov"
    return nbest


def test_dp_scorer_matches_one_device_and_jax(monkeypatch):
    """``BatchScorer(mesh=)`` on dp = 2 ranks: the LSTM through
    packed-carry (three chains over two ranks) and the Transformer through
    packed-nocarry, against the one-device port and the JAX scorer on a
    dp = 2 mesh (its fused CE forced on, interpret mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setattr(cp, "fused_ce_ok", lambda D: True)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    V = 32
    w2i = {"<s>": 0, "<unk>": 1, **{f"w{i}": i for i in range(2, V)}}
    nbest = _nbest(V)
    cases = [(dict(model="LSTM", vocab_size=V, emsize=16, nhid=16,
                   dropout=0.0), dict(carry_over=True, max_hyp_len=16)),
             (dict(model="Transformer", vocab_size=V, emsize=16, nhid=32,
                   nlayers=2, nhead=2, dropout=0.0),
              dict(carry_over=False, max_hyp_len=16, batch_size=16))]
    mesh = j_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    stream = lambda k: k.split("-")[0]  # noqa: E731
    refs = []
    payload = []
    for kw, rc in cases:
        params = bt.init_params(bt.build_model(bt.ModelConfig(**kw)),
                                bt.ModelConfig(**kw), seed=4)
        one = BatchScorer(bt.ModelConfig(**kw), params, bt.RescoreConfig(**rc),
                          device="cpu").score_nbest(nbest, w2i,
                                                    stream_fn=stream)
        js = JaxScorer(jx.ModelConfig(**kw),
                       jax.tree.map(jnp.asarray, params),
                       jx.RescoreConfig(**rc), mesh=mesh)
        assert js.use_fused_ce
        with mesh:
            jref = js.score_nbest(nbest, w2i, stream_fn=stream)
        refs.append((one, jref))
        payload.append(dict(cfg=kw, params=params, rcfg=rc))
    res = _ranks("score", 2, dict(dp=2, cases=payload, nbest=nbest, w2i=w2i))
    for (one, jref), r0, r1 in zip(refs, res[0], res[1]):
        for got in (r0, r1):
            assert list(got) == list(nbest)
            for k in nbest:
                g = [s for _, s in got[k]]
                assert [h for h, _ in got[k]] == nbest[k]
                assert g == [s for _, s in one[k]], k
                np.testing.assert_allclose(g, [s for _, s in jref[k]],
                                           rtol=S_RTOL, atol=S_ATOL,
                                           err_msg=k)


def test_cli_train_dp_tp_and_score_dp(tmp_path, capfd):
    """``bayeslm-torch --platform cpu train --dp-shards 2 --tp-shards 2``
    and ``score --dp-shards 2`` (as tests/test_multichip.py runs the JAX
    CLI): one command starts its gloo ranks; rank 0 prints and writes; the
    sharded scores equal a one-device run's."""
    from bayeslms_tpu_torch.cli import main as cli

    words = ["<s>", "<unk>"] + [f"w{i}" for i in range(2, 18)]
    (tmp_path / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, w in enumerate(words)))
    text = "\n".join("w2 w3 w4 w5 w6 w7" for _ in range(60)) + "\n"
    for split in ("train", "valid", "test"):
        (tmp_path / f"{split}.txt").write_text(text)
    save = str(tmp_path / "m.ckpt")
    model = ["--model", "LSTM", "--emsize", "8", "--nhid", "8",
             "--uncertainty", "Bayesian", "--L_bayes_pos", "2"]
    assert cli.main(["--platform", "cpu", "train", "--data", str(tmp_path),
                     *model, "--epochs", "1", "--batch-size", "8",
                     "--seq_len", "6", "--lr", "1.0", "--dp-shards", "2",
                     "--tp-shards", "2", "--save", save]) == 0
    out = capfd.readouterr().out.strip().splitlines()
    assert np.isfinite(json.loads(out[-1])["test_loss"])
    assert sum(line.startswith("{") for line in out) == 1  # rank 0 alone

    nb = tmp_path / "nbest.txt"
    nb.write_text("u1-1 w2 w3 w4\nu1-2 w5 w6\nu2-1 w7\n")
    files = []
    for extra in (["--dp-shards", "2"], []):
        outfile = tmp_path / f"scores{len(extra)}.txt"
        assert cli.main(["--platform", "cpu", "score", "--nbest-list",
                         str(nb), "--vocabulary", str(tmp_path / "words.txt"),
                         "--model-path", save, *model, *extra,
                         "--outfile", str(outfile)]) == 0
        files.append(outfile.read_text())
    lines = files[0].splitlines()
    assert len(lines) == 3 and lines[0].startswith("u1-1 ")
    assert files[0] == files[1]
