"""Untied decoders (``decoder_w``) of the port's ``RecurrentLM`` and
``TransformerLM`` against the JAX package on the CPU, float32, from the
same weights: the training forward's logits and the gradient of every
parameter, ``decoder_w``'s apart from the embedding's; the weight exchange
from a JAX ``.ckpt`` and from a reference-style state dict with
``decoder.weight``; trainer steps (the port's fused CE on ``decoder_w``
against JAX's XLA CE); scores and the layout each package picks (the port
packed-carry / packed-nocarry, the JAX package slotted, since its untied
model leaves its fused CE; ROADMAP.md C), and interpolation with an untied
second model. Tolerance rtol 2e-4 / atol 1e-5 (values, gradients), 1e-4 /
1e-5 (scores)."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.core import checkpoint as jckpt
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.rescore import layouts as jlayouts
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import (import_torch_state_dict,
                                                load_params, params_from_jax,
                                                params_to_jax)
from bayeslms_tpu_torch.models.lstm_lm import init_hidden
from bayeslms_tpu_torch.rescore import layouts
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, T, B = 40, 6, 3
LSTM = dict(model="LSTM", vocab_size=V, emsize=12, nhid=16, dropout=0.0,
            tied=False)
TM = dict(model="Transformer", vocab_size=V, emsize=16, nhid=24, nlayers=2,
          nhead=2, dropout=0.0, tied=False)
FAMILIES = {"lstm": LSTM, "tm": TM}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _params(kw, seed):
    cfg = bt.ModelConfig(**kw)
    net = bt.build_model(cfg)
    tree = bt.init_params(net, cfg, seed=seed)
    tree["decoder_b"] = np.random.default_rng(seed).normal(
        size=V).astype(np.float32) * 0.2
    return net, tree


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_untied_forward_and_gradients_match_jax(fam):
    kw = FAMILIES[fam]
    net, tree = _params(kw, 1)
    params_from_jax(net, tree)
    jm = jx.build_model(jx.ModelConfig(**kw))
    ref_tree = jx.init_params(jm, jx.ModelConfig(**kw), seed=0)
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    D = kw["emsize"] if fam == "tm" else kw["nhid"]
    assert tree["decoder_w"].shape == (V, D)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, V, size=(T, B))
    wl = rng.normal(size=(T, B, V)).astype(np.float32)
    h0 = init_hidden(2, B, kw["nhid"])

    def jfwd(p):
        if fam == "tm":
            lo = jm.apply({"params": p}, jnp.asarray(tokens),
                          deterministic=False,
                          rngs={"dropout": jax.random.key(0)})
        else:
            lo, _ = jm.apply({"params": p}, jnp.asarray(tokens),
                             j_init_hidden(2, B, kw["nhid"]),
                             deterministic=False,
                             rngs={"dropout": jax.random.key(0)})
        return jnp.sum(lo * wl), lo

    (_, ref), grads = jax.jit(jax.value_and_grad(jfwd, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    if fam == "tm":
        lo = net(torch.from_numpy(tokens), deterministic=False)
    else:
        lo, _ = net(torch.from_numpy(tokens), h0, deterministic=False)
    (lo * torch.from_numpy(wl)).sum().backward()
    np.testing.assert_allclose(lo.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    got = {k: p.grad.numpy() for k, p in net.named_parameters()
           if p.grad is not None}
    for name, g in _flat(grads).items():
        np.testing.assert_allclose(got.get(name, 0 * g), g, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the decoder's gradient lands on decoder_w; the embedding's is the
    # lookup's alone (rows of tokens not seen stay zero)
    unseen = np.setdiff1d(np.arange(V), tokens)
    assert np.abs(got["decoder_w"][unseen]).max() > 0
    assert not got["embedding"][unseen].any()


def test_weight_exchange_reads_jax_ckpt_and_reference_state_dict(tmp_path):
    """A JAX ``.ckpt`` of an untied LSTM through ``load_params``, and a
    reference state dict whose ``decoder.weight`` becomes ``decoder_w``
    (the JAX importer's mapping), each filling the port's model."""
    cfg = bt.ModelConfig(**LSTM)
    _, tree = _params(LSTM, 3)
    path = str(tmp_path / "m.ckpt")
    jckpt.save_checkpoint(path, jax.tree.map(jnp.asarray, tree),
                          meta={"epoch": 1})
    got = load_params(path, cfg)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    params_from_jax(bt.build_model(cfg), got)
    c = tree["core"]
    sd = {"encoder.weight": tree["embedding"],
          "decoder.weight": tree["decoder_w"],
          "decoder.bias": tree["decoder_b"],
          **{f"rnn.{n}_l{k}": c[f"l{k}_{s}"]
             for k in (0, 1)
             for n, s in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))}}
    ours = import_torch_state_dict(sd, cfg)
    ref = jckpt.import_torch_state_dict(sd, jx.ModelConfig(**LSTM))
    assert _flat(ours).keys() == _flat(ref).keys()
    for k, v in _flat(ref).items():
        np.testing.assert_array_equal(_flat(ours)[k], v)
    params_from_jax(bt.build_model(cfg), ours)
    tied = import_torch_state_dict(sd, bt.ModelConfig(**{**LSTM,
                                                         "tied": True}))
    assert "decoder_w" not in tied


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_untied_trainer_steps_match_jax(tmp_path, fam):
    """Two steps: the port's fused CE with ``decoder_w`` as its weight
    against the JAX trainer's XLA CE (its untied model leaves the fused
    CE); loss, gradient norm, parameters and momentum."""
    kw = FAMILIES[fam]
    tkw = dict(lr=0.5, batch_size=B, seq_len=T, save=str(tmp_path / "m"))
    tt = Trainer(bt.ModelConfig(**kw), bt.TrainConfig(**tkw), device="cpu")
    jt = jloop.Trainer(jx.ModelConfig(**kw), jx.TrainConfig(**tkw))
    assert not jt.use_fused_ce_train
    state = tt.init_state()
    jp = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jo = j_init_opt_state(jp)
    jh = j_init_hidden(2, B, kw["nhid"])
    th = None if fam == "tm" else init_hidden(2, B, kw["nhid"])
    rng = np.random.default_rng(4)
    for step in range(2):
        d, t = (rng.integers(0, V, size=(T, B)).astype(np.int32)
                for _ in range(2))
        jp, jo, jh, jloss, _, _, jgn = jt._train_step(
            jp, jo, jh, jnp.asarray(d), jnp.asarray(t), jnp.float32(0.5),
            jnp.float32(0.0), jax.random.key(step))
        th, loss, _, _, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(),
            torch.from_numpy(t).long())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jp).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        for name, ref in _flat(jo.momentum).items():
            np.testing.assert_allclose(
                state.opt_state.momentum[name].numpy(), ref, rtol=RTOL,
                atol=ATOL, err_msg=f"momentum {name}")


W2I = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}


def _nbest():
    rng = np.random.default_rng(11)
    nbest = OrderedDict()
    for u in range(6):
        nbest[f"A_{u}"] = [" ".join(f"w{rng.integers(2, V)}"
                                    for _ in range(rng.integers(1, 12)))
                           for _ in range(rng.integers(1, 4))]
    for u in range(3):
        nbest[f"B_{u}"] = [" ".join(f"w{rng.integers(2, V)}"
                                    for _ in range(rng.integers(1, 9)))
                           for _ in range(3)]
    nbest["B_1"].append("")
    nbest["B_2"][0] += " oov1 w3"
    return nbest


def _stream(key):
    return key.split("_")[0]


def _scores(monkeypatch, c1, p1, rc, c2=None, p2=None):
    """(JAX layout, JAX scores, port layout, port scores) of one pass."""
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    nbest = _nbest()
    js = JaxScorer(jx.ModelConfig(**c1), jax.tree.map(jnp.asarray, p1),
                   jx.RescoreConfig(**rc),
                   None if c2 is None else jx.ModelConfig(**c2),
                   None if p2 is None else jax.tree.map(jnp.asarray, p2))
    ref = js.score_nbest(nbest, W2I, stream_fn=_stream)
    ts = BatchScorer(bt.ModelConfig(**c1), p1, bt.RescoreConfig(**rc),
                     None if c2 is None else bt.ModelConfig(**c2), p2,
                     device="cpu")
    got = ts.score_nbest(nbest, W2I, stream_fn=_stream)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    return jlayouts.select(js).name, layouts.select(ts).name


@pytest.mark.parametrize("fam,carry", [("lstm", True), ("lstm", False),
                                       ("tm", False)])
def test_untied_scores_match_jax_on_the_ports_layout(monkeypatch, fam,
                                                     carry):
    """The port scores an untied model on its packed layouts (its fused CE
    on ``decoder_w``); the JAX package's untied model leaves its fused CE
    and so its packed layouts: slotted-carry for the LSTM with carry-over
    (the recorded difference, ROADMAP.md C). The scores are the same."""
    kw = FAMILIES[fam]
    _, p = _params(kw, 5)
    rc = dict(carry_over=carry, max_hyp_len=16, batch_size=4,
              carry_chunk_utts=2)
    jname, name = _scores(monkeypatch, kw, p, rc)
    if fam == "lstm" and carry:
        assert (jname, name) == ("slotted-carry", "packed-carry")
    else:
        assert (jname, name) == ("slotted-bucketed", "packed-nocarry")


@pytest.mark.parametrize("flag", [1, 2])
@pytest.mark.parametrize("which", ["second", "both"])
def test_interpolation_with_an_untied_model_matches_jax(monkeypatch, flag,
                                                        which):
    """A tied or untied first LSTM with an untied second one of another
    width, through packed-carry: the concatenated decoder (flag 1) reads
    each model's own decoder weight, flag 2 the second's ``decoder_w``."""
    c1 = {**LSTM, "tied": which == "second", "emsize": 16}
    c2 = {**LSTM, "emsize": 20, "nhid": 20}
    _, p1 = _params(c1, 1)
    _, p2 = _params(c2, 2)
    rc = dict(carry_over=True, max_hyp_len=16, batch_size=4,
              carry_chunk_utts=2, inter_flag=flag, inter_alpha=0.7)
    _, name = _scores(monkeypatch, c1, p1, rc, c2, p2)
    assert name == "packed-carry"
