"""The port's first slice end to end: packed-carry N-best scoring with the
2-layer LSTM LM (bayeslms_tpu_torch.rescore.scorer.BatchScorer on the CPU)
against the JAX package's BatchScorer forced onto its packed-carry layout
with the fused CE kernel (interpret mode), on the same weights."""

from collections import OrderedDict

import jax
import numpy as np
import pytest

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.rescore import nbest as jnb
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import nbest as tnb
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
CFG = dict(model="LSTM", vocab_size=V, emsize=16, nhid=16, dropout=0.0)
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}


def _nbest():
    """Chains of uneven length (5 and 2 utterances), uneven hypothesis
    counts, a hypothesis longer than max_hyp_len and OOV words (the
    nbest of tests/test_rescore.py's packed-carry parity test)."""
    rng = np.random.default_rng(7)
    nbest = OrderedDict()
    for u in range(5):
        nbest[f"A_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(2, 10)))
            for _ in range(3 if u % 2 else 2)
        ]
    nbest["A_2"].append(" ".join(f"w{rng.integers(2, V)}" for _ in range(25)))
    for u in range(2):
        nbest[f"B_{u}"] = [
            " ".join(f"w{rng.integers(2, V)}" for _ in range(rng.integers(1, 8)))
            for _ in range(3)
        ]
    nbest["B_1"][0] += " oov1 w3 oov2"
    return nbest


def _stream(key):
    return key.split("_")[0]


@pytest.fixture
def jax_params():
    cfg = jx.ModelConfig(**CFG)
    return jx.init_params(jx.build_model(cfg), cfg, seed=2)


@pytest.mark.parametrize("chunk,streams", [(2, True), (10, True), (3, False)])
def test_packed_carry_scores_match_jax(monkeypatch, jax_params, chunk, streams):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=chunk)
    stream_fn = _stream if streams else None
    nbest = _nbest()

    ref_scorer = JaxScorer(jx.ModelConfig(**CFG), jax_params, jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_allowed()
    ref = ref_scorer.score_nbest(nbest, W2I, stream_fn=stream_fn)

    scorer = BatchScorer(bt.ModelConfig(**CFG),
                         jax.tree.map(np.asarray, jax_params),
                         bt.RescoreConfig(**rc), device="cpu")
    got = scorer.score_nbest(nbest, W2I, stream_fn=stream_fn)
    assert list(got) == list(ref)
    for k in nbest:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose(
            [s for _, s in got[k]], [s for _, s in ref[k]],
            rtol=1e-4, atol=1e-5, err_msg=k)
    assert scorer.oov_stats == ref_scorer.oov_stats
    assert scorer.oov_stats["total"] == 2


@pytest.mark.parametrize("rc", [
    dict(inter_flag=1),
    dict(mc_samples=2, carry_over=False),
    dict(splice_len=3),
    dict(backward=True),
    dict(inter_flag=2),
])
def test_unported_scoring_raises(monkeypatch, jax_params, rc):
    """The flags the port once refused (interpolation, MC, splicing,
    backward scoring) now score as the JAX scorer does on the CPU (its
    slotted layouts, unfused there); the second model of an interpolation
    is the same geometry from another seed."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    cfg2 = jp2 = None
    if rc.get("inter_flag"):
        jcfg = jx.ModelConfig(**CFG)
        cfg2, jp2 = CFG, jx.init_params(jx.build_model(jcfg), jcfg, seed=5)
    rc = dict(max_hyp_len=16, batch_size=4, carry_chunk_utts=2, **rc)
    nbest = _nbest()
    ref = JaxScorer(jx.ModelConfig(**CFG), jax_params, jx.RescoreConfig(**rc),
                    None if cfg2 is None else jx.ModelConfig(**cfg2),
                    jp2).score_nbest(nbest, W2I, stream_fn=_stream)
    s = BatchScorer(bt.ModelConfig(**CFG), jax.tree.map(np.asarray, jax_params),
                    bt.RescoreConfig(**rc),
                    None if cfg2 is None else bt.ModelConfig(**cfg2),
                    None if jp2 is None else jax.tree.map(np.asarray, jp2),
                    device="cpu")
    got = s.score_nbest(nbest, W2I, stream_fn=_stream)
    assert list(got) == list(ref)
    for k in nbest:
        np.testing.assert_allclose(
            [v for _, v in got[k]], [v for _, v in ref[k]],
            rtol=1e-4, atol=1e-4 if rc.get("mc_samples") else 1e-5, err_msg=k)


def test_nbest_io_and_encoding_match_jax(tmp_path):
    path = tmp_path / "nbest.txt"
    path.write_text("u1-1 w2 w3\nu1-2 w4\nu2-1 w5 zz w6\nu2-2\n", encoding="utf-8")
    nb = tnb.load_nbest(str(path))
    assert nb == jnb.load_nbest(str(path))
    scored = OrderedDict((k, [(h, 1.5 * i) for i, h in enumerate(v)])
                         for k, v in nb.items())
    tnb.write_scores(scored, str(tmp_path / "a"))
    jnb.write_scores(scored, str(tmp_path / "b"))
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    for kw in (dict(), dict(backward=True),
               dict(context="w9 qq w8", splice_len=2)):
        for hyp in ("w2 zz w3", "", "w4 <unk> w4"):
            assert tnb.encode_hyp(hyp, W2I, **kw) == jnb.encode_hyp(hyp, W2I, **kw)
    for max_len in (8, 16, 64, 128, 200):
        b = tnb.length_buckets(max_len)
        assert b == jnb.length_buckets(max_len)
        for n in (1, 16, 17, max_len, max_len + 5):
            assert tnb.bucket_for(n, b) == jnb.bucket_for(n, b)
