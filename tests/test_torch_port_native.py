"""The port's native host data path (``bayeslms_tpu_torch/data/native.py``,
``rescore/nbest.py`` ``encode_all_native``, the native ``Corpus``) against
the JAX package's and against the port's Python paths: the same ids, OOV
counts and framing, with OOV, unicode and empty hypotheses; a failed build
of the library raises; the scorer encodes a pass in one native call."""

import os
import subprocess
from collections import OrderedDict

import numpy as np
import pytest

import bayeslms_tpu_torch as bt
from bayeslms_tpu.data import native as jnative
from bayeslms_tpu.data.corpus import Corpus as JaxCorpus
from bayeslms_tpu.rescore import nbest as jnb
from bayeslms_tpu_torch.data import native
from bayeslms_tpu_torch.data.corpus import Corpus
from bayeslms_tpu_torch.rescore import nbest as tnb
from bayeslms_tpu_torch.rescore.layouts import common
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.utils import host_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["<unk>", "<s>", "café", "naïve", "日本語", "день", "w6", "w7"]
W2I = {w: i for i, w in enumerate(WORDS)}


@pytest.fixture(scope="module", autouse=True)
def build_tools():
    # the JAX package's library (tools/bin), as tests/test_pipeline.py
    # builds it; the port builds its own at first use
    subprocess.run(["make", "-C", os.path.join(ROOT, "tools")], check=True,
                   capture_output=True)


def _nbest():
    rng = np.random.default_rng(5)
    nbest = OrderedDict()
    for u in range(6):
        nbest[f"u{u}"] = [" ".join(WORDS[rng.integers(2, len(WORDS))]
                                   for _ in range(rng.integers(1, 9)))
                          for _ in range(rng.integers(1, 5))]
    nbest["u1"] += ["", " ", "oov1 日本語  zz\tcafé"]
    nbest["u3"][0] += " qq <unk> день"
    nbest["u_empty"] = []
    nbest["u5"].append("naïve")
    return nbest


@pytest.mark.parametrize("backward", [False, True])
def test_encode_all_native_matches_jax_and_encode_hyp(backward):
    nbest = _nbest()
    enc = native.NativeEncoder.build(W2I)
    got = tnb.encode_all_native(nbest, enc, backward=backward)
    ref = jnb.encode_all_native(nbest, jnative.NativeEncoder.build(W2I),
                                backward=backward)
    assert list(got) == list(nbest) == list(ref)
    n_oov = 0
    for k, hyps in nbest.items():
        assert len(got[k]) == len(hyps) == len(ref[k])
        for (x, y, nc, oov), (rx, ry, rnc, roov), h in zip(got[k], ref[k],
                                                           hyps):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
            assert (nc, oov) == (rnc, roov)
            px, py, pnc, poov = tnb.encode_hyp(h, W2I, backward=backward)
            assert (list(x), list(y), nc, oov) == (px, py, pnc, poov)
            n_oov += oov
    assert n_oov == 3


def test_encoder_refuses_whitespace_words_as_jax():
    w2i = {**W2I, "two words": 8}
    assert native.NativeEncoder.build(w2i) is None
    assert jnative.NativeEncoder.build(w2i) is None
    assert native.NativeEncoder.build({}).bos == 0


def test_native_corpus_matches_python_and_jax(tmp_path):
    (tmp_path / "words.txt").write_text(
        "".join(f"{w} {i}\n" for i, w in enumerate(WORDS)), encoding="utf-8")
    texts = {"train": "café naïve zz\n日本語 день  w6\n\nw7\tcafé\n",
             "valid": "oov день\n", "test": "w6 w7 w6\n"}
    for name, text in texts.items():
        (tmp_path / f"{name}.txt").write_text(text, encoding="utf-8")
    got = Corpus(str(tmp_path))
    assert got._native is not None
    plain = Corpus(str(tmp_path), use_native=False)
    ref = JaxCorpus(str(tmp_path))
    for name in texts:
        a, b, c = (getattr(x, name) for x in (got, plain, ref))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got.train[:4], [2, 3, 0, 1])
    assert len(got._native) == len(WORDS)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A tokenizer that does not compile raises with g++'s message, from
    the encoder and the corpus alike; no Python fallback."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "tokenizer.cc").write_text("this is not C++\n")
    monkeypatch.setattr(host_build, "SRC", str(src))
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeEncoder.build(W2I)
    (tmp_path / "words.txt").write_text("<unk> 0\n<s> 1\n")
    for name in ("train", "valid", "test"):
        (tmp_path / f"{name}.txt").write_text("a b\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        Corpus(str(tmp_path))
    assert Corpus(str(tmp_path), use_native=False).train.tolist() == \
        [0, 0, 1]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(host_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(host_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host_build.build(["wer"])


def test_build_rows_takes_native_views():
    """The layouts' row builder gives the same batch and gather plan from
    the native encoder's int32 views as from encode_hyp's lists."""
    nbest = _nbest()
    nat = tnb.encode_all_native(nbest, native.NativeEncoder.build(W2I))
    rows_n, rows_p, offs = [], [], []
    for c, k in enumerate(nbest):
        for j, (x, y, _, _) in enumerate(nat[k]):
            px, py, _, _ = tnb.encode_hyp(nbest[k][j], W2I)
            rows_n.append((c, x[:6], y[:6]))
            rows_p.append((c, px[:6], py[:6]))
            offs.append(3 * j)
    seg = range(len(rows_n))
    a = common.build_rows(rows_n, 24, len(nbest), offs, seg)
    b = common.build_rows(rows_p, 24, len(nbest), offs, seg)
    for u, v in zip(a[:3] + a[3], b[:3] + b[3]):
        np.testing.assert_array_equal(u, v)


def test_scorer_encodes_a_pass_in_one_native_call(monkeypatch):
    """One ``encode_lines`` call a pass, the encoder built once for a
    word2idx; scores and OOV counts equal to a pass that encodes in Python
    (a whitespace word in the mapping)."""
    V = len(WORDS)
    cfg = bt.ModelConfig(model="LSTM", vocab_size=V + 1, emsize=8, nhid=8,
                         dropout=0.0)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=1)
    nbest = _nbest()
    calls = []
    encode_lines = native.NativeEncoder.encode_lines
    monkeypatch.setattr(native.NativeEncoder, "encode_lines",
                        lambda self, t: calls.append(1) or encode_lines(self, t))
    for carry in (True, False):
        s = BatchScorer(cfg, params, bt.RescoreConfig(carry_over=carry),
                        device="cpu")
        got = s.score_nbest(nbest, W2I)
        got2 = s.score_nbest(nbest, W2I)
        enc = s._enc
        assert len(calls) == 2 and enc is not None
        calls.clear()
        p = BatchScorer(cfg, params, bt.RescoreConfig(carry_over=carry),
                        device="cpu")
        ref = p.score_nbest(nbest, {**W2I, "two words": V})
        assert p._enc is None and not calls
        for k in nbest:
            assert [h for h, _ in got[k]] == nbest[k]
            np.testing.assert_allclose([x for _, x in got[k]],
                                       [x for _, x in ref[k]], rtol=1e-6)
            assert got2[k] == got[k]
        assert s.oov_stats == p.oov_stats
        assert s.oov_stats["total"] == 3
