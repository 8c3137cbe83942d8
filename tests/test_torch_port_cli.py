"""The port's command line (``bayeslms_tpu_torch/cli/main.py``,
``bayeslm-torch``) against the JAX package's (``bayeslm``): the same
subcommands, flags and defaults; ``score --platform cpu`` on a JAX
CLI-trained ``.ckpt`` writes the keys of the JAX scores file in its order,
each score within the scores' rtol 1e-4 (the 4th decimal of a printed
score may round the other way); ``snr`` and
``snr_report`` equal JAX's; ``train`` writes the port's checkpoint that
``score`` and ``rescore`` read; without ``--platform cpu`` and without a
card the CLI raises; each flag not ported raises naming its ROADMAP.md
item; ``search`` (first and second order), ``train --resume``, ``train
--profile``, ``score --profile``, the GRU, the RNN, other depths and
``--not-tied`` run on the CPU."""

import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import chip_smoke
from bayeslms_tpu.analysis.snr import snr_report as jax_snr_report
from bayeslms_tpu.cli import main as jcli
from bayeslms_tpu.core import checkpoint as jckpt
from bayeslms_tpu_torch.analysis.snr import snr_report
from bayeslms_tpu_torch.cli import main as cli
from bayeslms_tpu_torch.core.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--emsize", "16", "--nhid", "16", "--dropout", "0.0"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    chip_smoke.write_markov_corpus(str(root), 40, 4 * (10 * 4 + 3), 200, 120)
    with open(root / "nbest.txt", "w") as f:
        rng = np.random.default_rng(0)
        for u in range(6):
            for n in range(1, 4):
                words = [f"w{w}" for w in rng.integers(0, 40, rng.integers(1, 9))]
                f.write(f"rec{u % 2}_utt{u}-{n} {' '.join(words)}\n")
        f.write("rec0_utt9-1 w3 zz w5\n")
    return root


@pytest.fixture(scope="module")
def jax_ckpt(corpus):
    """A Bayesian LSTM trained by the JAX package's own CLI."""
    path = str(corpus / "jax_model.ckpt")
    assert jcli.main(["train", "--data", str(corpus), *TINY,
                      "--uncertainty", "Bayesian", "--L_bayes_pos", "3",
                      "--batch-size", "4", "--seq_len", "10", "--epochs", "1",
                      "--lr", "1", "--save", path]) == 0
    return path


def _actions(parser):
    """{subcommand: {dest: (option strings, default, choices, nargs)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                            a.nargs, a.required)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_subcommands_flags_and_defaults_match_jax():
    got, ref = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert list(got) == list(ref) == ["train", "score", "rescore", "snr",
                                      "search"]
    for name in ref:
        assert got[name] == ref[name], name
    plat = next(a for a in cli.build_parser()._actions
                if a.dest == "platform")
    assert (plat.default, plat.choices) == ("cuda", ["cpu", "cuda"])


def test_score_on_a_jax_cli_checkpoint_writes_the_jax_scores(
        corpus, jax_ckpt, tmp_path, capsys):
    common = ["--nbest-list", str(corpus / "nbest.txt"), "--vocabulary",
              str(corpus / "words.txt"), "--model-path", jax_ckpt, *TINY,
              "--uncertainty", "Bayesian", "--L_bayes_pos", "3"]
    for no_carry in ([], ["--no-carry-over"]):
        jout, out = tmp_path / "jax.scores", tmp_path / "port.scores"
        assert jcli.main(["score", *common, *no_carry, "--outfile",
                          str(jout)]) == 0
        capsys.readouterr()
        assert cli.main(["--platform", "cpu", "score", *common, *no_carry,
                         "--outfile", str(out)]) == 0
        assert capsys.readouterr().out.splitlines() == [
            "oov tokens: 1", f"wrote {out}"]
        ref = [line.split() for line in jout.read_text().splitlines()]
        got = [line.split() for line in out.read_text().splitlines()]
        assert [k for k, _ in got] == [k for k, _ in ref]
        assert len(got) == 19
        np.testing.assert_allclose([float(v) for _, v in got],
                                   [float(v) for _, v in ref],
                                   rtol=1e-4, atol=1e-4)


def test_snr_matches_jax(jax_ckpt, capsys):
    """Without --L_bayes_pos no pair matches in shape (the gate slice's
    lgstd against the whole mean), as in JAX; with it, every pair of the
    two layers (W_ih, W_hh and their biases)."""
    for pos, n in (([], 0), (["--L_bayes_pos", "3", "--nhid", "16"], 8)):
        assert jcli.main(["snr", "--model-path", jax_ckpt, *pos]) == 0
        ref = json.loads(capsys.readouterr().out)
        assert cli.main(["snr", "--model-path", jax_ckpt, *pos]) == 0
        got = json.loads(capsys.readouterr().out)
        assert list(got) == list(ref) and len(got) == n
        for k in ref:
            assert got[k]["shape"] == ref[k]["shape"]
            for m in ("median_snr", "mean_snr", "mean_sigma"):
                np.testing.assert_allclose(got[k][m], ref[k][m], rtol=1e-6)


def test_snr_report_matches_jax():
    cfg = jx.ModelConfig(vocab_size=12, emsize=8, nhid=8,
                         uncertainty="Bayesian", l_bayes_pos=2)
    params = jx.init_params(jx.build_model(cfg), cfg, seed=5)
    params = jax.tree.map(np.asarray, params)
    from bayeslms_tpu_torch import ModelConfig
    tcfg = ModelConfig(vocab_size=12, emsize=8, nhid=8,
                       uncertainty="Bayesian", l_bayes_pos=2)
    for c, tc in ((None, None), (cfg, tcfg)):
        assert snr_report(params, tc) == jax_snr_report(params, c)


def test_train_writes_the_port_checkpoint_that_score_and_rescore_read(
        corpus, tmp_path, capsys):
    save = str(tmp_path / "port.ckpt")
    assert cli.main(["--platform", "cpu", "train", "--data", str(corpus),
                     *TINY, "--batch-size", "4", "--seq_len", "10",
                     "--epochs", "2", "--lr", "2", "--save", save]) == 0
    out = capsys.readouterr().out
    test_loss = json.loads(out.strip().splitlines()[-1])["test_loss"]
    assert np.isfinite(test_loss)
    params, meta = load_checkpoint(save)
    assert meta["model_config"]["nhid"] == 16 and meta["epoch"] in (1, 2)
    scores = tmp_path / "s.txt"
    assert cli.main(["--platform", "cpu", "score", "--nbest-list",
                     str(corpus / "nbest.txt"), "--vocabulary",
                     str(corpus / "words.txt"), "--model-path", save, *TINY,
                     "--outfile", str(scores)]) == 0
    assert len(scores.read_text().splitlines()) == 19
    lats = tmp_path / "lats.txt"
    lats.write_text("u1\n0 1 3 0.1,1.0\n0 1 4 2.0,1.0\n1 2 5 0.1,1.0\n2\n\n")
    (tmp_path / "ref.txt").write_text("u1 w1 w3\n")
    capsys.readouterr()
    assert cli.main(["--platform", "cpu", "rescore", "--lattices", str(lats),
                     "--words", str(corpus / "words.txt"), "--model-path",
                     save, *TINY, "--workdir", str(tmp_path / "wd"), "--ref",
                     str(tmp_path / "ref.txt"), "--N", "5", "--max-lmwt",
                     "8"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["n_utts"], res["n_hyps"]) == (1, 2)
    assert set(res["wer_by_lmwt"]) == {"7", "8"}
    assert (tmp_path / "wd" / "nnlm.scores").exists()


def test_module_runs_without_jax(corpus, jax_ckpt):
    """``python -m bayeslms_tpu_torch.cli.main`` in a process that refuses
    jax: snr of the JAX checkpoint."""
    code = ("import sys\n"
            "class R:\n"
            "    def find_spec(self, n, p=None, t=None):\n"
            "        if n.split('.')[0] in ('jax', 'flax', 'bayeslms_tpu'):\n"
            "            raise ImportError(n)\n"
            "sys.meta_path.insert(0, R())\n"
            "import runpy\n"
            "sys.argv = ['bayeslm-torch', 'snr', '--model-path', "
            f"{jax_ckpt!r}, '--L_bayes_pos', '3', '--nhid', '16']\n"
            "runpy.run_module('bayeslms_tpu_torch.cli.main', "
            "run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "core/weight_hh_lgstd_1" in json.loads(res.stdout)


def _score_args(corpus, path, *extra):
    return ["score", "--nbest-list", str(corpus / "nbest.txt"),
            "--vocabulary", str(corpus / "words.txt"), "--model-path", path,
            "--outfile", "unused", *TINY, *extra]


def test_without_a_card_the_cli_raises(corpus, jax_ckpt, monkeypatch):
    """No --platform cpu and no CUDA: an error, not a CPU run; on the card a
    float32 compute dtype passes the device check for score and rescore,
    and names --compute-dtype bfloat16 and the ROADMAP item of B.5's
    float32 training slices for train and a recurrent model's MC scoring,
    before any device work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (_score_args(corpus, jax_ckpt),
                 ["train", "--data", str(corpus), "--save", "unused"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    parse = cli.build_parser().parse_args
    for argv in (_score_args(corpus, jax_ckpt),
                 ["rescore", "--lattices", "l", "--words", "w",
                  "--model-path", jax_ckpt, "--workdir", "wd"],
                 _score_args(corpus, jax_ckpt, "--model", "Transformer",
                             "--mc-samples", "2")):
        cli._check_device(parse(argv))
    for item in ("ROADMAP.md B.5a-B.5d", "--compute-dtype bfloat16"):
        with pytest.raises(ValueError, match=item):
            cli.main(["train", "--data", str(corpus), "--save", "unused"])
    for sub in (_score_args(corpus, jax_ckpt, "--mc-samples", "2"),
                ["rescore", "--lattices", "l", "--words", "w",
                 "--model-path", jax_ckpt, "--workdir", "wd",
                 "--mc-samples", "2"]):
        with pytest.raises(ValueError, match="ROADMAP.md B.5b"):
            cli.main(sub)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cli.main(_score_args(corpus, jax_ckpt, "--compute-dtype", "float16"))


@pytest.mark.parametrize("argv,item", [
    (["train", "--data", "d", "--multihost"], None),
    (["train", "--data", "d", "--tp-shards", "2"], None),
    (["train", "--data", "d", "--dp-shards", "2"], None),
    (["score", "--nbest-list", "n", "--vocabulary", "v", "--model-path", "m",
      "--outfile", "o", "--dp-shards", "2"], None),
    (["rescore", "--lattices", "l", "--words", "w", "--model-path", "m",
      "--workdir", "wd", "--dp-shards", "2"], None),
    (["--platform", "cpu", "train", "--data", "d", "--tp-shards", "2",
      "--not-tied"], "item A13b"),
    (["--platform", "cpu", "train", "--data", "d", "--dp-shards", "2",
      "--tp-shards", "2", "--batch-size", "6"], "item A13b"),
    (["train", "--data", "d", "--profile", "p"], None),
    (["train", "--data", "d", "--resume"], None),
    (["score", "--nbest-list", "n", "--vocabulary", "v", "--model-path", "m",
      "--outfile", "o", "--profile", "p"], None),
    (["rescore", "--lattices", "l", "--words", "w", "--model-path", "m",
      "--workdir", "wd", "--profile", "p"], None),
    (["search", "--data", "d"], None),
], ids=["multihost", "tp", "dp", "score-dp", "rescore-dp", "tp-untied",
        "tp-batch", "profile", "resume", "score-profile", "rescore-profile",
        "search"])
def test_unported_flags_raise_before_device_work(argv, item, monkeypatch):
    """Raised before anything is read or any device is asked for: the
    files named here do not exist and no card is needed. The profile and
    resume flags, ``search`` (ROADMAP.md A6, A12) and the multi-device
    flags (A13) are ported: they pass the refusals and stop at the device
    check (no card, no --platform cpu); the tp meshes the port's tp step
    does not take raise naming A13b before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if item is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A {item}"):
        cli.main(argv)


@pytest.fixture(scope="module")
def jax_baseline(corpus):
    """A standard LSTM of another width (24) trained by the JAX package's
    own CLI: the second model of an interpolation, its geometry in its
    sidecar only."""
    path = str(corpus / "jax_baseline.ckpt")
    assert jcli.main(["train", "--data", str(corpus), "--emsize", "24",
                      "--nhid", "24", "--dropout", "0.0", "--batch-size", "4",
                      "--seq_len", "10", "--epochs", "1", "--lr", "1",
                      "--save", path]) == 0
    return path


def _scores_file(path):
    return [line.split() for line in path.read_text().splitlines()]


@pytest.mark.parametrize("extra", [
    ["--interpolation_flag", "1"], ["--interpolation_flag", "2"],
    ["--mc-samples", "2", "--no-carry-over"], ["--backward"],
    ["--splice-len", "3"], ["--model_var", "back"]],
    ids=["inter1", "inter2", "mc", "backward", "splice", "back"])
def test_scoring_extras_reach_the_scorer_refusals(
        corpus, jax_ckpt, jax_baseline, extra, tmp_path, monkeypatch,
        capsys):
    """The scorer options once refused now score as the JAX CLI does, on the
    Bayesian LSTM it trained: interpolation with the baseline of
    ``--inter_path`` (its width from its sidecar), MC with the same draws
    on both sides (``tests/test_torch_port_mc.py``), backward and spliced
    scoring. Scores rtol 1e-4 / atol 1e-4, as the CLI's score test."""
    from test_torch_port_mc import Draws, bayes_shapes, install_jax_draws

    from bayeslms_tpu_torch.rescore import scorer as scorer_mod

    if extra[0] == "--interpolation_flag":
        extra = [*extra, "--inter_path", jax_baseline]
    argv = [*_score_args(corpus, jax_ckpt, *extra)[:-len(TINY) - len(extra)],
            *TINY, "--uncertainty", "Bayesian", "--L_bayes_pos", "3", *extra]
    out, jout = tmp_path / "port.scores", tmp_path / "jax.scores"
    argv[argv.index("--outfile") + 1] = str(out)
    draws = Draws(bayes_shapes(16, 16))

    class Scorer(scorer_mod.BatchScorer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.mc_noise = draws

    monkeypatch.setattr(scorer_mod, "BatchScorer", Scorer)
    assert cli.main(["--platform", "cpu", *argv]) == 0
    argv[argv.index("--outfile") + 1] = str(jout)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    # without jit the JAX model updates its weights in place (.at): its
    # checkpoint's numpy arrays go in as JAX arrays
    load = jckpt.load_checkpoint
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda path: (
        lambda p, m: (jax.tree.map(jax.numpy.asarray, p), m))(*load(path)))
    done = install_jax_draws(monkeypatch, draws.in_jax_order())
    with jax.disable_jit():
        assert jcli.main(argv) == 0
    assert done()
    capsys.readouterr()
    got, ref = _scores_file(out), _scores_file(jout)
    assert [k for k, _ in got] == [k for k, _ in ref] and len(got) == 19
    np.testing.assert_allclose([float(v) for _, v in got],
                               [float(v) for _, v in ref], rtol=1e-4,
                               atol=1e-4)


def test_inter_path_takes_its_sidecar_and_checks_it(corpus, jax_ckpt,
                                                    jax_baseline, tmp_path):
    """The second model's geometry comes from its checkpoint's sidecar;
    without ``--inter_path`` and on a vocabulary mismatch the CLI exits with
    the JAX package's messages, before the scorer is built."""
    import shutil

    args = cli.build_parser().parse_args(
        _score_args(corpus, jax_ckpt, "--interpolation_flag", "1",
                    "--inter_path", jax_baseline))
    cfg2, params2 = cli._inter_model(args, 42)
    assert (cfg2.nhid, cfg2.emsize, cfg2.uncertainty) == (24, 24, "none")
    assert params2["embedding"].shape == (42, 24)
    with pytest.raises(SystemExit, match="requires --inter_path"):
        cli.main(["--platform", "cpu",
                  *_score_args(corpus, jax_ckpt, "--interpolation_flag", "2")])
    bad = str(tmp_path / "other.ckpt")
    shutil.copy(jax_baseline, bad)
    with open(jax_baseline + ".json") as f:
        meta = json.load(f)
    meta["model_config"]["vocab_size"] += 1
    with open(bad + ".json", "w") as f:
        json.dump(meta, f)
    argv = _score_args(corpus, jax_ckpt, "--interpolation_flag", "1",
                       "--inter_path", bad)
    for main, pre in ((cli.main, ["--platform", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match="trained with vocab_size=43"):
            main([*pre, *argv])


def test_mc_samples_with_carry_over_raises_before_device_work(
        corpus, jax_ckpt, monkeypatch):
    """``--mc-samples`` on a recurrent model needs ``--no-carry-over``: the
    scorer's refusal, on a machine without a card, before it asks for
    one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="carry_over=False"):
        cli.main([*_score_args(corpus, jax_ckpt, "--mc-samples", "4"),
                  "--compute-dtype", "bfloat16"])


@pytest.mark.parametrize("unrolled", [False, True], ids=["1st", "2nd"])
def test_search_prints_the_arch_weights_as_jax_does(corpus, capsys,
                                                    unrolled):
    """``search --platform cpu`` (first order and ``--unrolled``): the
    JAX CLI's JSON keys, a (layers, gates, 2) softmax that sums to one
    and its argmax."""
    argv = ["search", "--data", str(corpus), *TINY, "--batch-size", "4",
            "--seq_len", "8", "--epochs", "1"]
    if unrolled:
        argv.append("--unrolled")
    assert cli.main(["--platform", "cpu", *argv]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"arch_softmax", "derived_choice"}
    soft = np.asarray(res["arch_softmax"])
    assert soft.shape == (2, 4, 2)
    np.testing.assert_allclose(soft.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(soft.argmax(-1), res["derived_choice"])


def test_train_resume_and_profile(corpus, tmp_path, capsys):
    """``train --resume``: one epoch, then a run of two that continues from
    ``<save>.resume``; ``--profile DIR`` traces the first trained epoch
    (the resumed one) into DIR; ``score --profile`` traces the pass."""
    save = str(tmp_path / "m.ckpt")
    base = ["--platform", "cpu", "train", "--data", str(corpus), *TINY,
            "--batch-size", "4", "--seq_len", "10", "--lr", "2", "--save",
            save, "--resume"]
    assert cli.main([*base, "--epochs", "1"]) == 0
    assert os.path.exists(save + ".resume")
    capsys.readouterr()
    prof = tmp_path / "prof"
    assert cli.main([*base, "--epochs", "2", "--profile", str(prof)]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1 (lr 2.0)" in out
    assert load_checkpoint(save + ".resume")[1]["epoch"] == 2
    assert len(os.listdir(prof)) == 1
    sprof = tmp_path / "sprof"
    assert cli.main(["--platform", "cpu", "score", "--nbest-list",
                     str(corpus / "nbest.txt"), "--vocabulary",
                     str(corpus / "words.txt"), "--model-path", save, *TINY,
                     "--outfile", str(tmp_path / "s.txt"), "--profile",
                     str(sprof)]) == 0
    assert len(os.listdir(sprof)) == 1


@pytest.mark.parametrize("flags", [["--model", "GRU"], ["--nlayers", "3"],
                                   ["--not-tied"],
                                   ["--model", "RNN_RELU", "--nlayers", "1"]],
                         ids=["gru", "nlayers3", "not-tied", "rnn-relu-1"])
def test_train_and_score_other_cores(corpus, tmp_path, capsys, flags):
    """The GRU, the RNN, other depths and an untied decoder train and score
    through the command line on the CPU; the checkpoint holds the model's
    geometry."""
    save = str(tmp_path / "m.ckpt")
    assert cli.main(["--platform", "cpu", "train", "--data", str(corpus),
                     *TINY, *flags, "--batch-size", "4", "--seq_len", "10",
                     "--epochs", "1", "--lr", "1", "--save", save]) == 0
    params, meta = load_checkpoint(save)
    mc = meta["model_config"]
    assert (mc["model"], mc["nlayers"], mc["tied"]) == (
        flags[flags.index("--model") + 1] if "--model" in flags else "LSTM",
        int(flags[flags.index("--nlayers") + 1]) if "--nlayers" in flags
        else 2, "--not-tied" not in flags)
    assert ("decoder_w" in params) == ("--not-tied" in flags)
    scores = tmp_path / "s.txt"
    assert cli.main(["--platform", "cpu", "score", "--nbest-list",
                     str(corpus / "nbest.txt"), "--vocabulary",
                     str(corpus / "words.txt"), "--model-path", save, *TINY,
                     *flags, "--outfile", str(scores)]) == 0
    vals = [float(ln.split()[-1]) for ln in scores.read_text().splitlines()]
    assert len(vals) == 19 and np.all(np.isfinite(vals))
