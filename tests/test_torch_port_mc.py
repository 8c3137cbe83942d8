"""MC-average scoring (``mc_samples`` > 0, ``layouts/slotted.py``
``mc_fused_impl``) of the port against the JAX package's ``BatchScorer`` on
the CPU (its slotted-bucketed ``mc_impl``, unfused there), on the same
weights and the same draws: the Bayesian gate-slice LSTM (``l_bayes_pos``
3) and the variational Transformer (``t_v_pos`` 1, ``v_seq_len`` 24, the
bucket of length 24 drawing its noise), ``mc_samples`` 3.

The port takes its eps through ``BatchScorer.mc_noise``, keyed by (bucket
length, row, draw); the JAX package draws through
``bayeslms_tpu.ops.gaussian.sample_diff`` and ``jax.random.normal``,
replaced by functions that hand out the same eps in its call order (row
by row, each row's draws in turn), under ``jax.disable_jit`` so that each
draw is a call. Scores rtol 1e-4 / atol 1e-4, the JAX package's own
tolerance between its two MC forms (tests/test_rescore.py)."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.layouts import slotted
from bayeslms_tpu_torch.rescore.scorer import BatchScorer

V = 32
W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
H, E = 16, 16
K = 3
BAYES = dict(model="LSTM", vocab_size=V, emsize=E, nhid=H, dropout=0.2,
             uncertainty="Bayesian", l_bayes_pos=3)
VSEQ = 24
VTM = dict(model="Transformer", vocab_size=V, emsize=E, nhid=24, nlayers=2,
           nhead=2, dropout=0.1, uncertainty="Variational", t_v_pos=1,
           v_seq_len=VSEQ)
RC = dict(carry_over=False, max_hyp_len=64, batch_size=4, mc_samples=K)


class Draws:
    """Standard-normal eps keyed by (bucket length T, row, draw), made on
    first request: the port's ``mc_noise``. ``shapes(T)`` gives the shapes
    one forward draws, in its call order. ``in_jax_order`` lists every eps
    handed out in the JAX package's order: buckets by length, rows, draws,
    a forward's tensors."""

    def __init__(self, shapes, seed=0):
        self.shapes, self.seed, self.table = shapes, seed, {}

    def __call__(self, T, row, draw):
        key = (T, row, draw)
        if key not in self.table:
            rng = np.random.default_rng([self.seed, T, row, draw])
            self.table[key] = [rng.normal(size=s).astype(np.float32)
                               for s in self.shapes(T)]
        return [torch.from_numpy(e) for e in self.table[key]]

    def in_jax_order(self):
        return [e for key in sorted(self.table) for e in self.table[key]]


def bayes_shapes(H_, E_):
    """The Bayesian LSTM's draws a forward (position 1-4, both layers): per
    layer w_hh, w_ih, b_hh, b_ih of the gate's H rows."""
    return lambda T: [s for ins in (E_, H_)
                      for s in ((H_, H_), (H_, ins), (H_,), (H_,))]


def vtm_shapes(B, E_, v_seq_len):
    """The variational Transformer's draw a forward: one (T, B, E) eps on a
    window of exactly ``v_seq_len`` steps, none otherwise."""
    return lambda T: [(T, B, E_)] if T == v_seq_len else []


def install_jax_draws(monkeypatch, eps):
    """The JAX package's ``gaussian.sample_diff`` and ``jax.random.normal``
    hand out ``eps`` in call order; returns a check that every eps was
    taken."""
    it = iter(eps)

    def sample_diff(key, lgstd, scale=1.0):
        e = next(it)
        assert e.shape == tuple(jnp.shape(lgstd))
        return scale * jnp.asarray(e) * jnp.exp(lgstd)

    def normal(key, shape=(), dtype=jnp.float32):
        e = next(it)
        assert tuple(shape) == e.shape
        return jnp.asarray(e, dtype)

    monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
    monkeypatch.setattr(jax.random, "normal", normal)
    return lambda: next(it, None) is None


def jax_mc_scores(monkeypatch, cfg_kw, params, rc, nbest, draws, **kw):
    """The JAX scorer's MC pass with the port's draws injected."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    ref_scorer = JaxScorer(jx.ModelConfig(**cfg_kw),
                           jax.tree.map(jnp.asarray, params),
                           jx.RescoreConfig(**rc))
    assert not ref_scorer.use_fused_mc
    done = install_jax_draws(monkeypatch, draws.in_jax_order())
    with jax.disable_jit():
        ref = ref_scorer.score_nbest(nbest, W2I, **kw)
    assert done(), "the JAX pass took fewer draws than the port made"
    return ref


def _nbest(n_utts=14, seed=5):
    """Hypotheses of 1-30 words (buckets 16, 24 and 32 at max_hyp_len 64),
    uneven counts, an empty one and OOV words."""
    rng = np.random.default_rng(seed)
    nbest = OrderedDict()
    for u in range(n_utts):
        nbest[f"r{u % 3}_u{u}"] = [
            " ".join(f"w{rng.integers(2, V)}"
                     for _ in range(rng.integers(1, 31)))
            for _ in range(rng.integers(1, 4))]
    nbest["r1_u4"].append("")
    nbest["r2_u5"][0] += " oov1 w3"
    return nbest


def _assert_scores(got, ref, atol=1e-4):
    assert list(got) == list(ref)
    for k in ref:
        assert [h for h, _ in got[k]] == [h for h, _ in ref[k]]
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=atol, err_msg=k)


CASES = {
    "bayes3": (BAYES, lambda: bayes_shapes(H, E)),
    "vtm1": (VTM, lambda: vtm_shapes(RC["batch_size"], E, VSEQ)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mc_scores_match_jax_with_its_draws(monkeypatch, case):
    """The port's draw-major fused MC against the JAX package's row-major
    legacy MC, every draw the same eps on both sides; the pass selects
    slotted-bucketed and runs on the dropout-free twin."""
    cfg_kw, shapes = CASES[case]
    cfg = bt.ModelConfig(**cfg_kw)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=1)
    params["decoder_b"] = np.random.default_rng(0).normal(
        size=V).astype(np.float32) * 0.1
    nbest = _nbest()
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(**RC), device="cpu")
    assert layouts.select(scorer).name == "slotted-bucketed"
    assert scorer.model.cfg.dropout == 0.0
    draws = Draws(shapes())
    scorer.mc_noise = draws
    got = scorer.score_nbest(nbest, W2I)
    if case == "vtm1":
        assert any(draws.table[k] for k in draws.table if k[0] == VSEQ)
    ref = jax_mc_scores(monkeypatch, cfg_kw, params, RC, nbest, draws)
    _assert_scores(got, ref)
    assert scorer.oov_stats["total"] == 1


def test_mc_average_is_the_mean_of_the_draws_probabilities():
    """score = -sum_t log(mean_k p_k(target_t)) against each draw scored
    alone (one draw a pass, the same eps): no more than the mean of the
    draws' scores (Jensen, token by token), and with every draw equal the
    one-draw score."""
    cfg = bt.ModelConfig(**BAYES)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    nbest = OrderedDict(a=["w3 w4 w5", "w9"], b=["w7 w7 w2 w11"])
    draws = Draws(bayes_shapes(H, E), seed=4)
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(**RC), device="cpu")
    scorer.mc_noise = draws
    got = scorer.score_nbest(nbest, W2I)

    one = BatchScorer(cfg, params, bt.RescoreConfig(**{**RC, "mc_samples": 1}),
                      device="cpu")
    per_draw = []
    for k in range(K):
        one.mc_noise = lambda T, r, d, k=k: draws(T, r, k)
        per_draw.append(one.score_nbest(nbest, W2I))
    for key in nbest:
        for i, (_, s) in enumerate(got[key]):
            lone = [d[key][i][1] for d in per_draw]
            assert min(lone) - 1e-5 <= s <= np.mean(lone) + 1e-5
            assert len(set(lone)) == K  # the draws differ
    same = BatchScorer(cfg, params, bt.RescoreConfig(**RC), device="cpu")
    same.mc_noise = lambda T, r, d: draws(T, r, 0)
    np.testing.assert_allclose(
        [s for v in same.score_nbest(nbest, W2I).values() for _, s in v],
        [s for v in per_draw[0].values() for _, s in v], rtol=1e-5,
        atol=1e-5)


def test_mc_draws_are_keyed_by_bucket_row_and_draw():
    """Without injected noise, a row's draws come from generators seeded by
    (bucket, row, draw) alone: the same pass twice gives the same scores,
    and a hypothesis's score does not depend on the rows of other
    buckets."""
    cfg = bt.ModelConfig(**BAYES)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    nbest = _nbest(6)
    scorer = BatchScorer(cfg, params, bt.RescoreConfig(**RC), device="cpu")
    a = scorer.score_nbest(nbest, W2I)
    b = scorer.score_nbest(nbest, W2I)
    assert a == b
    seeds = {slotted.mc_seed(T, r, k) for T in (16, 24, 32) for r in range(9)
             for k in range(K)}
    assert len(seeds) == 3 * 9 * K
    short = OrderedDict((k, [h for h in v if len(h.split()) <= 15])
                        for k, v in nbest.items())
    short = OrderedDict((k, v) for k, v in short.items() if v)
    alone = scorer.score_nbest(short, W2I)
    # the 16-bucket's rows are the same rows in both passes
    for k, pairs in alone.items():
        for h, s in pairs:
            assert s == dict(a[k])[h]
