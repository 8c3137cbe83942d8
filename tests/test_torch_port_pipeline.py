"""The port's lattice rescoring pipeline (``bayeslms_tpu_torch/rescore/
pipeline.py``, tools built from tools/src into the port's _build/) with the
port's ``BatchScorer`` on the CPU against the JAX package's
``run_pipeline`` with the JAX scorer, on the same weights (JAX
``init_params``) and the fixtures of tests/test_pipeline.py: every stage's
file, ``nnlm.scores`` and ``lmwt.rescored`` within the scores' rtol 1e-4 /
atol 1e-5, the WER sweep equal; the gzipped binary lattice; the sanity-test
branch; a scorer that flips the decision."""

import gzip
import os
import re
import subprocess

import jax
import numpy as np
import pytest

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.rescore.pipeline import run_pipeline as jax_pipeline
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import pipeline
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.utils import host_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["<eps>", "<s>", "<unk>", "good", "bad", "day", "night"]
UWORDS = ["<eps>", "<s>", "<unk>", "café", "naïve", "日本語", "день"]
SAME = ("words.int", "lmwt.withlm", "acwt", "ali", "words.txt",
        "lmwt.lmonly")


@pytest.fixture(scope="module", autouse=True)
def build_tools():
    # the JAX pipeline runs tools/bin (tests/test_pipeline.py builds it)
    subprocess.run(["make", "-C", os.path.join(ROOT, "tools")], check=True,
                   capture_output=True)


def _write(tmp_path, words, lats, ref, arpa=None):
    (tmp_path / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, w in enumerate(words)), encoding="utf-8")
    (tmp_path / "lats.txt").write_text(lats, encoding="utf-8")
    (tmp_path / "ref.txt").write_text(ref, encoding="utf-8")
    if arpa:
        (tmp_path / "lm.arpa").write_text(arpa)


SIMPLE_LATS = (
    "u1\n0 1 4 0.1,1.0\n0 2 3 2.0,1.0\n1 3 5 0.1,1.0\n2 3 5 0.1,1.0\n3\n\n"
    "u2\n0 1 3 0.3,2.0\n0 1 4 0.2,2.5\n1 2 6 0.4,1.0\n1 2 5 0.9,0.5\n2\n\n"
    "u3\n0 1 6 0.5,0.5\n1 2 5 0.1,0.2\n1 2 0 0.3,0.4\n2 0.1,0.0\n\n")
SIMPLE_REF = "u1 good day\nu2 good night\nu3 night day\n"
ARPA = ("\\data\\\nngram 1=6\n\n\\1-grams:\n"
        "-0.5\t<s>\t-0.3\n-0.8\tgood\t0.0\n-0.8\tbad\t0.0\n"
        "-0.8\tday\t0.0\n-1.0\t</s>\n-2.0\t<unk>\n\n\\end\\\n")
# tests/test_pipeline.py's messy lattices: epsilon arcs, two final states,
# unicode words, one word sequence from two paths
UNICODE_LATS = (
    "u1\n0 1 0 0.2,0.1\n1 2 3 0.5,0.5\n0 2 3 1.0,0.8\n1 3 4 0.9,0.4\n"
    "2 4 6 0.1,0.1\n3 0.5,0.2\n4 0.1,0.1\n\nu2\n0 1 5 0.3,0.4\n1\n\n")
UNICODE_REF = "u1 café день\nu2 日本語\n"


def _floats(path):
    with open(path, encoding="utf-8") as f:
        rows = [line.split() for line in f]
    return [r[0] for r in rows], np.array([float(r[1]) for r in rows])


def _lattice_numbers(path):
    """A lattice text file's tokens: the numbers apart, the rest as text."""
    with open(path, encoding="utf-8") as f:
        toks = re.split(r"[\s,]+", f.read())
    nums = [float(t) for t in toks if re.fullmatch(r"-?\d+\.\d*(e-?\d+)?", t)]
    text = [t for t in toks if not re.fullmatch(r"-?\d+\.\d*(e-?\d+)?", t)]
    return text, np.array(nums)


def _scorers(words, carry_over, seed=0):
    cfg_kw = dict(model="LSTM", vocab_size=len(words), emsize=8, nhid=8,
                  dropout=0.0)
    rc = dict(carry_over=carry_over, max_hyp_len=16)
    jcfg = jx.ModelConfig(**cfg_kw)
    params = jx.init_params(jx.build_model(jcfg), jcfg, seed=seed)
    return (JaxScorer(jcfg, params, jx.RescoreConfig(**rc)),
            BatchScorer(bt.ModelConfig(**cfg_kw),
                        jax.tree.map(np.asarray, params),
                        bt.RescoreConfig(**rc), device="cpu"))


def _compare(jres, res, jwd, wd, sanity=False):
    assert (res.n_utts, res.n_hyps, res.oov_tokens) == \
        (jres.n_utts, jres.n_hyps, jres.oov_tokens)
    assert res.wer_by_lmwt == jres.wer_by_lmwt
    assert (res.best_lmwt, res.best_wer) == (jres.best_lmwt, jres.best_wer)
    names = ("words.int", "lmwt.withlm", "acwt") if sanity else SAME
    for name in names:
        if os.path.exists(jwd / name):
            assert (wd / name).read_bytes() == (jwd / name).read_bytes(), name
    if sanity:
        return
    for name in ("nnlm.scores", "lmwt.rescored"):
        keys, got = _floats(wd / name)
        jkeys, ref = _floats(jwd / name)
        assert keys == jkeys
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    text, got = _lattice_numbers(res.rescored_lattices)
    jtext, ref = _lattice_numbers(jres.rescored_lattices)
    assert text == jtext
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    if jres.best_hyps_path:
        assert open(res.best_hyps_path, encoding="utf-8").read() == \
            open(jres.best_hyps_path, encoding="utf-8").read()
        assert os.path.basename(res.best_hyps_path) == \
            os.path.basename(jres.best_hyps_path)


@pytest.mark.parametrize("carry_over", [True, False])
@pytest.mark.parametrize("nn_weight", [1.0, 0.5])
def test_pipeline_matches_jax(tmp_path, carry_over, nn_weight):
    _write(tmp_path, WORDS, SIMPLE_LATS, SIMPLE_REF, ARPA)
    w2i = {w: i for i, w in enumerate(WORDS)}
    jscorer, scorer = _scorers(WORDS, carry_over)
    rcfg_kw = dict(nbest=5, nn_weight=nn_weight, min_lmwt=7, max_lmwt=10)
    args = (str(tmp_path / "lats.txt"), str(tmp_path / "words.txt"))
    kw = dict(arpa_lm=str(tmp_path / "lm.arpa"),
              ref_text=str(tmp_path / "ref.txt"))
    jres = jax_pipeline(*args, jscorer, w2i, str(tmp_path / "jwd"),
                        jx.RescoreConfig(**rcfg_kw), **kw)
    res = pipeline.run_pipeline(*args, scorer, w2i, str(tmp_path / "wd"),
                                bt.RescoreConfig(**rcfg_kw), **kw)
    assert res.n_hyps == 8 and set(res.wer_by_lmwt) == set(range(7, 11))
    _compare(jres, res, tmp_path / "jwd", tmp_path / "wd")


@pytest.mark.parametrize("flag", [1, 2])
def test_pipeline_with_an_interpolating_scorer_matches_jax(tmp_path, flag):
    """Stage 4's scores from a scorer that interpolates two LSTMs of
    different widths (logits or scores, alpha 0.7), then stage 5's n-gram
    interpolation at nn_weight 0.5, as in the JAX package's pipeline."""
    _write(tmp_path, WORDS, SIMPLE_LATS, SIMPLE_REF, ARPA)
    w2i = {w: i for i, w in enumerate(WORDS)}
    kws = [dict(model="LSTM", vocab_size=len(WORDS), emsize=w, nhid=w,
                dropout=0.0) for w in (8, 16)]
    rc = dict(carry_over=True, max_hyp_len=16, inter_flag=flag,
              inter_alpha=0.7)
    ps = [jx.init_params(jx.build_model(jx.ModelConfig(**kw)),
                         jx.ModelConfig(**kw), seed=s)
          for s, kw in enumerate(kws)]
    jscorer = JaxScorer(jx.ModelConfig(**kws[0]), ps[0],
                        jx.RescoreConfig(**rc), jx.ModelConfig(**kws[1]),
                        ps[1])
    scorer = BatchScorer(bt.ModelConfig(**kws[0]),
                         jax.tree.map(np.asarray, ps[0]),
                         bt.RescoreConfig(**rc), bt.ModelConfig(**kws[1]),
                         jax.tree.map(np.asarray, ps[1]), device="cpu")
    rcfg_kw = dict(nbest=5, nn_weight=0.5, min_lmwt=7, max_lmwt=10)
    args = (str(tmp_path / "lats.txt"), str(tmp_path / "words.txt"))
    kw = dict(arpa_lm=str(tmp_path / "lm.arpa"),
              ref_text=str(tmp_path / "ref.txt"))
    jres = jax_pipeline(*args, jscorer, w2i, str(tmp_path / "jwd"),
                        jx.RescoreConfig(**rcfg_kw), **kw)
    res = pipeline.run_pipeline(*args, scorer, w2i, str(tmp_path / "wd"),
                                bt.RescoreConfig(**rcfg_kw), **kw)
    _compare(jres, res, tmp_path / "jwd", tmp_path / "wd")


def test_pipeline_gzipped_binary_lattices_match_jax(tmp_path):
    """tests/test_pipeline.py's adversarial case: the lattices converted to
    a gzipped binary archive by the port's own lattice_copy."""
    _write(tmp_path, UWORDS, UNICODE_LATS, UNICODE_REF)
    binark = tmp_path / "lats.ark"
    subprocess.run([host_build.path("lattice_copy"), "--binary",
                    str(tmp_path / "lats.txt"), str(binark)], check=True,
                   capture_output=True)
    gz = tmp_path / "lat.1.gz"
    gz.write_bytes(gzip.compress(binark.read_bytes()))
    w2i = {w: i for i, w in enumerate(UWORDS)}
    jscorer, scorer = _scorers(UWORDS, True, seed=3)
    rcfg_kw = dict(nbest=5, nn_weight=0.5, min_lmwt=7, max_lmwt=9)
    args = (str(gz), str(tmp_path / "words.txt"))
    kw = dict(ref_text=str(tmp_path / "ref.txt"))
    jres = jax_pipeline(*args, jscorer, w2i, str(tmp_path / "jwd"),
                        jx.RescoreConfig(**rcfg_kw), **kw)
    res = pipeline.run_pipeline(*args, scorer, w2i, str(tmp_path / "wd"),
                                bt.RescoreConfig(**rcfg_kw), **kw)
    assert res.n_utts == 2 and res.n_hyps == 4
    hyps = (tmp_path / "wd" / "words.txt").read_text(encoding="utf-8")
    assert "café" in hyps and "日本語" in hyps
    _compare(jres, res, tmp_path / "jwd", tmp_path / "wd")


def test_pipeline_sanity_test_matches_jax(tmp_path):
    _write(tmp_path, WORDS, SIMPLE_LATS, SIMPLE_REF, ARPA)
    w2i = {w: i for i, w in enumerate(WORDS)}
    jscorer, scorer = _scorers(WORDS, True)
    args = (str(tmp_path / "lats.txt"), str(tmp_path / "words.txt"))
    jres = jax_pipeline(*args, jscorer, w2i, str(tmp_path / "jwd"),
                        jx.RescoreConfig(nbest=5), sanity_test=True)
    res = pipeline.run_pipeline(*args, scorer, w2i, str(tmp_path / "wd"),
                                bt.RescoreConfig(nbest=5), sanity_test=True)
    assert (res.n_utts, res.n_hyps, res.wer_by_lmwt) == (3, 8, {})
    assert not (tmp_path / "wd" / "nnlm.scores").exists()
    assert (tmp_path / "wd" / "test_lats.txt").read_bytes() == \
        (tmp_path / "jwd" / "test_lats.txt").read_bytes()
    _compare(jres, res, tmp_path / "jwd", tmp_path / "wd", sanity=True)


class BiasedScorer:
    """Strongly prefers hypotheses with 'good' (tests/test_pipeline.py)."""

    oov_stats = {"total": 0}

    def score_nbest(self, nbest, word2idx):
        return {k: [(h, 1.0 if "good" in h.split() else 50.0) for h in hyps]
                for k, hyps in nbest.items()}


def test_pipeline_nn_flips_decision_as_jax(tmp_path):
    """nn_weight 0 keeps the lattice's choice ('bad day', 50% WER on u1);
    nn_weight 1 lets the NN flip it; every file as the JAX pipeline's."""
    _write(tmp_path, WORDS, SIMPLE_LATS.split("u2")[0], "u1 good day\n",
           ARPA)
    w2i = {w: i for i, w in enumerate(WORDS)}
    args = (str(tmp_path / "lats.txt"), str(tmp_path / "words.txt"))
    kw = dict(arpa_lm=str(tmp_path / "lm.arpa"),
              ref_text=str(tmp_path / "ref.txt"))
    for w, wer in ((0.0, 50.0), (1.0, 0.0)):
        rc = dict(nbest=5, nn_weight=w, min_lmwt=7, max_lmwt=9)
        jres = jax_pipeline(*args, BiasedScorer(), w2i,
                            str(tmp_path / f"jwd{w}"), jx.RescoreConfig(**rc),
                            **kw)
        res = pipeline.run_pipeline(*args, BiasedScorer(), w2i,
                                    str(tmp_path / f"wd{w}"),
                                    bt.RescoreConfig(**rc), **kw)
        assert res.best_wer == wer
        for name in (*SAME, "nnlm.scores", "lmwt.rescored",
                     "rescored_lats.txt"):
            assert (tmp_path / f"wd{w}" / name).read_bytes() == \
                (tmp_path / f"jwd{w}" / name).read_bytes(), name
        _compare(jres, res, tmp_path / f"jwd{w}", tmp_path / f"wd{w}")


def test_tools_build_at_first_use_and_failures_raise(tmp_path, monkeypatch):
    """The tools build from tools/src into the port's _build/ with
    tools/Makefile's flags; a broken source raises with g++'s message."""
    built = host_build.build(host_build.TOOLS)
    assert sorted(built) == sorted(host_build.TOOLS)
    for name, path in built.items():
        assert os.path.dirname(path) == host_build.BUILD_DIR
        assert os.path.basename(path).startswith(f"{name}-")
        assert os.access(path, os.X_OK)
    assert host_build.path("wer") == built["wer"]
    src = tmp_path / "src"
    src.mkdir()
    for name in host_build.TOOLS:
        (src / f"{name}_main.cc").write_text("int main() { return missing; }\n")
    monkeypatch.setattr(host_build, "SRC", str(src))
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pipeline.run_pipeline("lats", "words", BiasedScorer(), {},
                              str(tmp_path / "wd"), bt.RescoreConfig())
