"""The port's legacy GaussLSTM (``GaussLSTMLegacyCore``,
``l_gauss_legacy_pos`` 0-8, ``models/lstm_lm.py``) against the JAX
package's on the CPU, float32, from the same weights: the training forward
and every gradient, the evaluation forward with a step mask and resets,
trainer steps and packed-carry scores; the refusals. The reference's golden
tests of this class (``tests/test_golden_reference.py``) need the reference
itself; these hold the port to the JAX class instead. Models at rtol 2e-4 /
atol 1e-5; scores at rtol 1e-4 / atol 1e-5."""

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
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import params_from_jax, params_to_jax
from bayeslms_tpu_torch.models.lstm_lm import (GaussLSTMLegacyCore,
                                               draw_dropout_masks,
                                               init_hidden)
from bayeslms_tpu_torch.ops import lstm_cuda
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, H, T, B = 24, 8, 6, 3
POSITIONS = list(range(9))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _cfg(pkg, pos, dropout=0.0, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=H, nhid=H,
                           nlayers=2, dropout=dropout, uncertainty="Gaussian",
                           l_gauss_legacy_pos=pos, **kw)


def _pair(pos, seed=0):
    model = bt.build_model(_cfg(bt, pos))
    tree = bt.init_params(model, _cfg(bt, pos), seed=seed)
    jm = jx.build_model(_cfg(jx, pos))
    return model, tree, jm, jax.tree.map(jnp.asarray, tree)


def _inputs(rng, Bn=B):
    tokens = rng.integers(0, V, size=(T, Bn))
    h0 = rng.normal(size=(2, 2, Bn, H)).astype(np.float32) * 0.5
    mask = (rng.uniform(size=(T, Bn)) > 0.3).astype(np.float32)
    return tokens, h0, mask


@pytest.mark.parametrize("pos", POSITIONS)
def test_tree_and_training_forward_and_gradients_match_jax(pos):
    """The tree (the GP unit: (H -> H) with the act set sigmoid, tanh, relu
    for 1-5 and 8, (H -> 4H) for 6-7, none for 0) against the JAX init's;
    the training forward with a step mask (layer 2 on its grad route, the
    JAX scan on the CPU), the new state and every gradient of sum(logits w)
    + hT + cT, bias_hh_mean_1 at 6 and bias_ih_mean_1 at 7 unreached (zero
    gradient)."""
    model, tree, jm, jp = _pair(pos, seed=pos)
    ref_tree = jax.eval_shape(lambda: jx.init_params(jm, _cfg(jx, pos)))
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    assert ("gpnn" in tree["core"]) == (pos > 0)
    rng = np.random.default_rng(pos)
    tokens, h0, mask = _inputs(rng)
    w = rng.normal(size=(T, B, V)).astype(np.float32)

    def jloss(p):
        logits, (hT, cT) = jm.apply(
            {"params": p}, jnp.asarray(tokens), (h0[0], h0[1]),
            deterministic=False, step_mask=jnp.asarray(mask),
            rngs={"dropout": jax.random.key(0), "sample": jax.random.key(1)})
        return (jnp.sum(logits * w) + jnp.sum(hT * 0.3) + jnp.sum(cT * 0.2),
                (logits, hT, cT))

    (_, (jlog, jh, jc)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    logits, (hT, cT) = model(torch.from_numpy(tokens),
                             tuple(torch.from_numpy(a) for a in h0),
                             torch.from_numpy(mask), deterministic=False)
    ((logits * torch.from_numpy(w)).sum() + (hT * 0.3).sum()
     + (cT * 0.2).sum()).backward()
    for a, b in ((logits, jlog), (hT, jh), (cT, jc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for name, r in _flat(jg).items():
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)
    unreached = {6: "core.bias_hh_mean_1", 7: "core.bias_ih_mean_1"}.get(pos)
    if unreached:
        assert not np.any(_flat(jg)[unreached])
    assert not hasattr(model.core, "kl_value")  # no KL, as in JAX


@pytest.mark.parametrize("pos", [0, 3, 5, 6, 7])
def test_eval_with_resets_matches_jax(pos):
    """The deterministic forward with a step mask and packed resets (-1
    sources too), one position of each kind (none, a gate's activation,
    the cell state, the hidden and the input projection): logits and the
    new state."""
    model, _, jm, jp = _pair(pos, seed=10 + pos)
    params_from_jax(model, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(20 + pos)
    tokens, h0, mask = _inputs(rng, 5)
    reset = (rng.uniform(size=(T, 5)) > 0.6).astype(np.float32)
    src = rng.integers(-1, 5, size=5).astype(np.int32)
    jlog, (jh, jc) = jm.apply(
        {"params": jp}, jnp.asarray(tokens), (h0[0], h0[1]),
        deterministic=True, step_mask=jnp.asarray(mask),
        reset_mask=jnp.asarray(reset), reset_src=jnp.asarray(src))
    with torch.no_grad():
        logits, (hT, cT) = model(torch.from_numpy(tokens),
                                 tuple(torch.from_numpy(a) for a in h0),
                                 torch.from_numpy(mask),
                                 reset_mask=torch.from_numpy(reset),
                                 reset_src=torch.from_numpy(src))
    for a, b in ((logits, jlog), (hT, jh), (cT, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    routing's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


def test_layer2_routes_as_jax(monkeypatch):
    """Layer 2 is ``ops.lstm.lstm_layer``: the forward-only kernel route
    (rows 3-4) when deterministic, the grad route (rows 5-6) in training,
    where the gate admits; in training the float32 carry promotes layer 1's
    output to float32 (JAX's promotion), which the gate refuses at
    H = 1,024 (a 16 MiB W_hh), so the scan runs there."""
    from bayeslms_tpu_torch.ops import lstm as tlstm
    calls = []
    monkeypatch.setattr(tlstm, "lstm_layer_fwd",
                        lambda *a: calls.append("fwd") or (a[0], a[1], a[2]))
    monkeypatch.setattr(tlstm, "lstm_layer_train",
                        lambda *a: calls.append("train") or (a[0], a[1], a[2]))
    x = torch.zeros((T, B, H)).as_subclass(_OnCard)
    z = torch.zeros((B, H))
    p = tlstm.LSTMParams(torch.zeros(4 * H, H), torch.zeros(4 * H, H),
                         torch.zeros(4 * H), torch.zeros(4 * H))
    tlstm.lstm_layer(x, z, z, p, allow_kernel=True)
    tlstm.lstm_layer(x, z, z, p)
    assert calls == ["fwd", "train"]
    big = torch.zeros((T, B, 1024)).as_subclass(_OnCard)
    assert lstm_cuda.lstm_kernel_ok(big.bfloat16(), 1024, train=True)
    assert not lstm_cuda.lstm_kernel_ok(big, 1024, train=True)


@pytest.mark.parametrize("pos", [6])
def test_three_trainer_steps_match_jax(tmp_path, pos):
    """Three steps of both trainers on the same batches: loss (no KL),
    gradient norm, weights, momentum and the carried state."""
    kw = dict(lr=2.0, batch_size=B, seq_len=T, save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_cfg(jx, pos), jx.TrainConfig(**kw))
    tt = Trainer(_cfg(bt, pos), bt.TrainConfig(**kw), device="cpu")
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    jh, th = j_init_hidden(2, B, H), init_hidden(2, B, H)
    rng = np.random.default_rng(4)
    for step in range(3):
        d = rng.integers(0, V, size=(T, B)).astype(np.int32)
        t = rng.integers(0, V, size=(T, B)).astype(np.int32)
        jparams, jopt, jh, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(0.1), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(kl) == float(jkl) == 0.0
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jparams).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}: {name}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


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


@pytest.mark.parametrize("pos", [1, 6])
def test_packed_carry_scores_match_jax(monkeypatch, pos):
    """Scoring through packed-carry (layer 1's scan and layer 2's route
    under the resets, the fused CE) against the JAX scorer forced onto
    packed-carry with the fused CE (interpret mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=2)
    cfg = _cfg(bt, pos)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    params["decoder_b"] = np.random.default_rng(0).normal(
        size=V).astype(np.float32) * 0.1
    stream = lambda k: k.split("_")[0]  # noqa: E731
    ref_scorer = JaxScorer(_cfg(jx, pos), jax.tree.map(jnp.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_allowed()
    ref = ref_scorer.score_nbest(_nbest(), w2i, stream_fn=stream)
    got = BatchScorer(cfg, params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(_nbest(), w2i,
                                                stream_fn=stream)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_refusals():
    """emsize must equal nhid; a position outside 0-8 is refused; the core
    has no inter-layer dropout mask and draws no noise."""
    with pytest.raises(ValueError, match="emsize == nhid"):
        bt.build_model(_cfg(bt, 2).__class__(
            **{**_cfg(bt, 2).__dict__, "emsize": 2 * H}))
    with pytest.raises(ValueError, match="0-8"):
        GaussLSTMLegacyCore(_cfg(bt, 9))
    cfg = _cfg(bt, 2, dropout=0.2)
    assert draw_dropout_masks(cfg, T, B, torch.Generator()).layer is None
    core = GaussLSTMLegacyCore(cfg)
    x = torch.zeros((T, B, H))
    with pytest.raises(ValueError, match="no inter-layer dropout"):
        core(x, init_hidden(2, B, H), train=True,
             dropout_mask=torch.ones((T, B, H)))
