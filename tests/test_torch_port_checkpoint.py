"""The port's weight exchange (``core.checkpoint``, ``core.flax_msgpack``)
against the JAX package and the reference's own checkpoints and logs, on
the CPU in float32.

The repository holds checkpoints that the reference's ``train.py`` wrote
(``exp/campaign/torch_lstm_*/model.pt``, ``prior_lstm/model.pt``, the
Transformers ``torch_tm_bayesft/model.pt`` and ``prior_tm/model.pt``) with
their training logs, one that the JAX package wrote
(``ours_lstm_bayes3_e8/model.ckpt`` and its ``.json`` sidecar), and the
corpus they were trained on (``exp/corpus_mid``). The port reads them with
neither JAX, flax nor msgpack, gives the JAX package's trees, and its
evaluation meets the logged perplexities at the JAX package's eval batch
size of 20: each log states its perplexity to two decimals, so the port's
exp(loss) must round to it (``pytest -s`` prints the values read). Each
such check evaluates all of a 220,000-token split (~46 s on one CPU
thread), so it is marked ``slow``: ``pytest -m slow
tests/test_torch_port_checkpoint.py`` runs them."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import bayeslms_tpu as jx
from bayeslms_tpu.core import checkpoint as jck
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
import bayeslms_tpu_torch as bt
from bayeslms_tpu_torch.core import checkpoint as tck
from bayeslms_tpu_torch.core import flax_msgpack
from bayeslms_tpu_torch.data.corpus import Corpus, batchify
from bayeslms_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(ROOT, "exp", "campaign")
CORPUS = os.path.join(ROOT, "exp", "corpus_mid")
EVAL_BATCH = 20  # the JAX package's TrainConfig.eval_batch_size


def _cfg(pkg, uncertainty="Bayesian", pos=3):
    """The campaign's models: LSTM 256/256 x 2, tied, V = 10,000."""
    return pkg.ModelConfig(model="LSTM", vocab_size=10000, emsize=256,
                           nhid=256, nlayers=2, dropout=0.2,
                           uncertainty=uncertainty, l_bayes_pos=pos)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("name,unc,pos", [
    ("torch_lstm_bayes3", "Bayesian", 3),
    ("torch_lstm_base_quick", "none", 0),
    ("prior_lstm", "Bayesian", 0),
])
def test_import_of_the_reference_checkpoints_matches_jax(name, unc, pos):
    path = os.path.join(CAMPAIGN, name, "model.pt")
    got = tck.load_torch_checkpoint(path, _cfg(bt, unc, pos))
    _assert_trees_equal(got, jck.load_torch_checkpoint(path,
                                                       _cfg(jx, unc, pos)))
    _assert_trees_equal(tck.load_params(path, _cfg(bt, unc, pos)), got)
    # and the tree fills the model it was trained as
    model = bt.build_model(_cfg(bt, unc, pos))
    tree, updated = tck.partial_update(bt.init_params(model, _cfg(bt, unc,
                                                                  pos)), got)
    assert len(updated) == len(_flat(got))
    tck.params_from_jax(model, tree)


def test_import_maps_every_rnn_name_as_jax():
    """Synthetic state_dict: nn.LSTM names, Bayes(2)LSTM names, an untied
    decoder and keys with no counterpart."""
    rng = np.random.default_rng(0)
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("encoder.weight", (7, 4)), ("decoder.weight", (7, 4)),
        ("decoder.bias", (7,)), ("rnn.weight_ih_l0", (16, 4)),
        ("rnn.bias_hh_l1", (16,)), ("rnn.weight_hh_lgstd_1", (4, 4)),
        ("rnn.bias_ih_mean_2", (16,)), ("rnn.weight_hh_l0_extra", (2,)),
        ("transformerlayers.0.linear1.weight", (3, 4)),
        ("pos_encoder.pe", (5, 1, 4)))}
    for tied in (True, False):
        kw = dict(model="LSTM", vocab_size=7, emsize=4, nhid=4, tied=tied)
        _assert_trees_equal(
            tck.import_torch_state_dict(sd, bt.ModelConfig(**kw)),
            jck.import_torch_state_dict(sd, jx.ModelConfig(**kw)))


def _gp_cfg(pkg):
    """The campaign's GP-LSTMs: 128/128 x 2, L_gauss_pos 13, V = 10,000."""
    return pkg.ModelConfig(model="LSTM", vocab_size=10000, emsize=128,
                           nhid=128, nlayers=2, dropout=0.2,
                           uncertainty="Gaussian", l_gauss_pos="13")


@pytest.mark.parametrize("name", ["torch_lstm_gp12", "torch_lstm_gp_nf2222"])
def test_import_of_the_reference_gp_checkpoints_matches_jax(name):
    """The reference's GPLSTM names (``rnn.rnn.0.{weights,bias}_{ih,hh}``,
    ``rnn.rnn.0.gpnn.*``, ``rnn.rnn.1.*_l0``) map onto the JAX package's
    tree, which the port's GP model takes whole."""
    path = os.path.join(CAMPAIGN, name, "model.pt")
    got = tck.load_torch_checkpoint(path, _gp_cfg(bt))
    _assert_trees_equal(got, jck.load_torch_checkpoint(path, _gp_cfg(jx)))
    _assert_trees_equal(tck.load_params(path, _gp_cfg(bt)), got)
    tck.params_from_jax(bt.build_model(_gp_cfg(bt)), got)


def test_import_maps_every_stack_name_as_jax():
    """Synthetic state_dict of the GP and variational stacks, the legacy
    GaussLSTM's bare GP unit and the legacy VLSTM's tables, under both
    uncertainties that read them."""
    rng = np.random.default_rng(1)
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rnn.rnn.0.weights_ih", (16, 4)), ("rnn.rnn.0.bias_hh", (16,)),
        ("rnn.rnn.0.gpnn.weights_mean", (4, 8)),
        ("rnn.rnn.0.gpnn.coef_lgstd", (3, 4)),
        ("rnn.rnn.1.gpnn.coef.weight", (4, 6)),
        ("rnn.rnn.1.gpnn.coef.bias", (4,)),
        ("rnn.rnn.1.weight_hh_l0", (16, 4)), ("rnn.rnn.1.bias_ih_l0", (16,)),
        ("rnn.rnn.1.vnn.hidden_lgstd", (4,)), ("rnn.rnn.1.other", (2,)),
        ("rnn.gpnn.bias_mean", (4,)), ("rnn.hiddens_mean_p", (5, 4)),
        ("rnn.hiddens_lgstd", (5, 4)))}
    for unc in ("Gaussian", "Variational"):
        kw = dict(model="LSTM", vocab_size=7, emsize=4, nhid=4,
                  uncertainty=unc)
        _assert_trees_equal(
            tck.import_torch_state_dict(sd, bt.ModelConfig(**kw)),
            jck.import_torch_state_dict(sd, jx.ModelConfig(**kw)))


def test_first_validation_windows_of_the_gp_checkpoint_match_jax():
    """torch_lstm_gp12 (reference, L_gauss_pos 13): the CE of the first
    validation windows, carried state, through the port and through the
    JAX package's import of the same file; rtol 2e-4."""
    path = os.path.join(CAMPAIGN, "torch_lstm_gp12", "model.pt")
    rows = batchify(Corpus(CORPUS).valid, EVAL_BATCH)[:201]
    jcfg = _gp_cfg(jx)
    jmodel = jx.build_model(jcfg)
    jparams, _ = jck.partial_update(jx.init_params(jmodel, jcfg),
                                    jck.load_torch_checkpoint(path, jcfg))
    model = tck.params_from_jax(bt.build_model(_gp_cfg(bt)),
                                tck.load_torch_checkpoint(path, _gp_cfg(bt)))
    jh = j_init_hidden(2, EVAL_BATCH, 128)
    th = (torch.zeros(2, EVAL_BATCH, 128), torch.zeros(2, EVAL_BATCH, 128))
    for d, t in _eval_windows(rows, 2):
        jlogits, jh = jmodel.apply({"params": jparams}, jnp.asarray(d), jh,
                                   deterministic=True)
        ref = float(jnp.mean(jax.nn.logsumexp(jlogits, -1) - jnp.take_along_axis(
            jlogits, jnp.asarray(t)[..., None], -1)[..., 0]))
        with torch.no_grad():
            logits, th = model(torch.from_numpy(d).long(), th)
        got = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, 10000), torch.from_numpy(t).long().reshape(-1)))
        np.testing.assert_allclose(got, ref, rtol=2e-4)
        assert 3.0 < got < 6.0


def test_import_maps_every_transformer_name_as_jax():
    """Synthetic state_dict: every name of the Transformer table (torch
    TransformerEncoder's ``layers.N.`` prefix and the reference's
    self-built ``N.``), Linear weights transposed to (in, out) kernels, the
    EMB projection, the variational layer's tables, and the positional
    table with no counterpart. The GP-FFN names have a test of their
    own."""
    rng = np.random.default_rng(3)
    sd = {"encoder.weight": (7, 4), "decoder.bias": (7,),
          "embed_mean": (4, 4), "embed_lgstd": (4, 4),
          "pos_encoder.pe": (9, 1, 4)}
    for rest, shape in (
            ("self_attn.in_proj_weight", (12, 4)),
            ("self_attn.in_proj_bias", (12,)),
            ("self_attn.out_proj.weight", (4, 4)),
            ("self_attn.out_proj.bias", (4,)),
            ("linear1.weight", (6, 4)), ("linear1.bias", (6,)),
            ("linear2.weight", (4, 6)), ("linear2.bias", (4,)),
            ("norm1.weight", (4,)), ("norm1.bias", (4,)),
            ("norm2.weight", (4,)), ("norm2.bias", (4,))):
        sd[f"transformerlayers.layers.0.{rest}"] = shape
    for rest, shape in (
            ("self_attn.qkv_net.weight", (12, 4)),
            ("self_attn.qkv_net.bias", (12,)),
            ("self_attn.o_net.weight", (4, 4)), ("self_attn.o_net.bias", (4,)),
            ("self_attn.q_net.weight", (4, 4)), ("self_attn.q_net.bias", (4,)),
            ("self_attn.k_net.weight", (4, 4)), ("self_attn.k_net.bias", (4,)),
            ("self_attn.v_net.weight", (4, 4)), ("self_attn.v_net.bias", (4,)),
            ("self_attn.o_net.weight_mean", (4, 4)),
            ("self_attn.o_net.weight_lgstd", (4, 4)),
            ("linear2.weight_mean", (4, 6)), ("linear2.weight_lgstd", (4, 6)),
            ("hiddens_mean", (5, 1, 4)), ("hiddens_lgstd", (5, 1, 4)),
            ("hiddens_mean_p", (5, 1, 4)), ("hiddens_lgstd_p", (5, 1, 4))):
        sd[f"transformerlayers.1.{rest}"] = shape
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}
    kw = dict(model="Transformer", vocab_size=7, emsize=4, nhid=6, nhead=2)
    got = tck.import_torch_state_dict(sd, bt.ModelConfig(**kw))
    _assert_trees_equal(got, jck.import_torch_state_dict(
        sd, jx.ModelConfig(**kw)))
    np.testing.assert_array_equal(got["layers_0"]["linear1"]["kernel"],
                                  sd["transformerlayers.layers.0.linear1.weight"]
                                  .T)


def _tm_cfg(pkg, uncertainty="Bayesian", pos="FFN"):
    """The campaign's Transformers: 128/512 x 2, 4 heads, tied,
    V = 10,000."""
    return pkg.ModelConfig(model="Transformer", vocab_size=10000, emsize=128,
                           nhid=512, nlayers=2, nhead=4, dropout=0.2,
                           uncertainty=uncertainty, t_bayes_pos=pos)


@pytest.mark.parametrize("name,unc,pos", [
    ("torch_tm_bayesft", "Bayesian", "FFN"), ("prior_tm", "none", "none")])
def test_import_of_the_reference_transformers_matches_jax(name, unc, pos):
    """The reference's Transformer ``model.pt`` files read as JAX reads
    them, and each fills the model it was trained as, every parameter."""
    path = os.path.join(CAMPAIGN, name, "model.pt")
    got = tck.load_params(path, _tm_cfg(bt, unc, pos))
    _assert_trees_equal(got, jck.load_torch_checkpoint(
        path, _tm_cfg(jx, unc, pos)))
    model = bt.build_model(_tm_cfg(bt, unc, pos))
    assert sorted(_flat(got)) == sorted(_flat(tck.params_to_jax(model)))
    tck.params_from_jax(model, got)


def _vtm_cfg(pkg):
    """torch_vtm_fixed: the campaign's Transformer with a variational layer
    0 (T_v_pos 1; its L_v_pos 11 is an LSTM flag)."""
    return pkg.ModelConfig(model="Transformer", vocab_size=10000, emsize=128,
                           nhid=512, nlayers=2, nhead=4, dropout=0.2,
                           uncertainty="Variational", t_v_pos=1, l_v_pos="11")


def test_import_of_the_variational_transformer_matches_jax():
    """torch_vtm_fixed's ``model.pt`` read as JAX reads it (its layer 0's
    (100, 1, 128) tables beside the layer's weights, the positional table
    and the untied-decoder weight skipped), and it fills the model it was
    trained as, every parameter."""
    path = os.path.join(CAMPAIGN, "torch_vtm_fixed", "model.pt")
    got = tck.load_params(path, _vtm_cfg(bt))
    _assert_trees_equal(got, jck.load_torch_checkpoint(path, _vtm_cfg(jx)))
    assert got["layers_0"]["hiddens_lgstd"].shape == (100, 1, 128)
    model = bt.build_model(_vtm_cfg(bt))
    assert sorted(_flat(got)) == sorted(_flat(tck.params_to_jax(model)))
    tck.params_from_jax(model, got)


def test_prior_tm_partial_updates_into_a_bayes_ffn_tree():
    """The finetune workflow of torch_tm_bayesft: the standard prior_tm
    fills every parameter of the Bayesian-FFN tree but the FFN's Bayesian
    linear2 (a plain kernel and bias in the prior), as JAX's
    ``partial_update`` does."""
    prior = tck.load_params(os.path.join(CAMPAIGN, "prior_tm", "model.pt"),
                            _tm_cfg(bt, "none", "none"))
    cfg = _tm_cfg(bt)
    fresh = bt.init_params(bt.build_model(cfg), cfg, seed=0)
    got, updated = tck.partial_update(fresh, prior)
    ref, ref_updated = jck.partial_update(fresh, prior)
    assert updated == ref_updated
    _assert_trees_equal(got, ref)
    left = sorted(set(_flat(fresh)) - set(updated))
    assert left == ["layers_0/linear2/weight_lgstd",
                    "layers_0/linear2/weight_mean"]
    tck.params_from_jax(bt.build_model(cfg), got)


def test_partial_update_matches_jax():
    rng = np.random.default_rng(1)
    params = {"embedding": rng.normal(size=(5, 3)).astype(np.float32),
              "decoder_b": np.zeros(5, np.float32),
              "core": {"a": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": rng.normal(size=(4,)).astype(np.float32),
                       "c": rng.normal(size=(2,)).astype(np.float32)}}
    prior = {"embedding": rng.normal(size=(5, 3)),  # float64: cast back
             "core": {"a": rng.normal(size=(4, 3)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32),
                      "d": np.ones(3, np.float32)},
             "extra": np.ones(2, np.float32)}
    got, upd = tck.partial_update(params, prior)
    ref, ref_upd = jck.partial_update(params, prior)
    assert upd == ref_upd == ["embedding", "core/a"]
    _assert_trees_equal(got, ref)
    np.testing.assert_array_equal(params["core"]["b"], got["core"]["b"])


def test_msgpack_reader_matches_jax_on_the_campaign_checkpoint():
    path = os.path.join(CAMPAIGN, "ours_lstm_bayes3_e8", "model.ckpt")
    got, meta = tck.load_jax_checkpoint(path)
    ref, ref_meta = jck.load_checkpoint(path)
    _assert_trees_equal(got, ref)
    assert meta == ref_meta and meta["epoch"] == 8
    _assert_trees_equal(tck.load_params(path, _cfg(bt)), ref)


def test_msgpack_reader_decodes_what_flax_writes():
    """Every msgpack type a flax tree may hold: nested maps, ndarrays of
    several dtypes and shapes (0-d, empty, over 64 KiB for bin 32), numpy
    scalars, Python ints of every width, floats, bools, None, strings,
    lists; against flax's own ``msgpack_restore``."""
    rng = np.random.default_rng(2)
    tree = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "big": rng.normal(size=(200, 100)).astype(np.float32),
        "i32": np.arange(-4, 4, dtype=np.int32).reshape(2, 4),
        "f64": np.float64(2.5) * np.ones((2,)),
        "u8": np.arange(300, dtype=np.uint8)[:7],
        "zero_d": np.asarray(3.0, np.float32), "empty": np.zeros((0, 4)),
        "scalar": np.float32(1.25),
        "nested": {"ints": [0, 1, -1, -33, 127, 128, 255, 256, 65535,
                            65536, 2 ** 32, -(2 ** 40), 2 ** 63 - 1],
                   "float": 0.1, "flags": [True, False, None],
                   "text": "x" * 40, "long_text": "y" * 70000, "t": "é"},
    }
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.restore(data)
    ref = serialization.msgpack_restore(data)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, (np.ndarray, np.generic)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b)

    same(got, ref)
    with pytest.raises(ValueError):
        flax_msgpack.restore(data[:-3])


def _eval_windows(rows, n):
    return [(rows[i:i + 100], rows[i + 1:i + 101]) for i in range(0, 100 * n,
                                                                   100)]


def test_first_validation_windows_of_the_bayes_checkpoint_match_jax():
    """torch_lstm_bayes3 (reference, L_bayes_pos 3) at the posterior mean:
    the CE of the first validation windows, carried state, through the
    port and through the JAX package's import of the same file;
    rtol 2e-4."""
    path = os.path.join(CAMPAIGN, "torch_lstm_bayes3", "model.pt")
    corpus = Corpus(CORPUS)
    rows = batchify(corpus.valid, EVAL_BATCH)[:301]
    jcfg = _cfg(jx)
    jmodel = jx.build_model(jcfg)
    jparams, _ = jck.partial_update(jx.init_params(jmodel, jcfg),
                                    jck.load_torch_checkpoint(path, jcfg))
    model = tck.params_from_jax(bt.build_model(_cfg(bt)),
                                tck.load_torch_checkpoint(path, _cfg(bt)))
    jh = j_init_hidden(2, EVAL_BATCH, 256)
    th = (torch.zeros(2, EVAL_BATCH, 256), torch.zeros(2, EVAL_BATCH, 256))
    for d, t in _eval_windows(rows, 3):
        jlogits, jh = jmodel.apply({"params": jparams}, jnp.asarray(d), jh,
                                   deterministic=True)
        ref = float(jnp.mean(jax.nn.logsumexp(jlogits, -1) - jnp.take_along_axis(
            jlogits, jnp.asarray(t)[..., None], -1)[..., 0]))
        with torch.no_grad():
            logits, th = model(torch.from_numpy(d).long(), th)
        got = float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, 10000), torch.from_numpy(t).long().reshape(-1)))
        np.testing.assert_allclose(got, ref, rtol=2e-4)
        assert 3.0 < got < 6.0


def _evaluate(path, cfg, split):
    model = tck.params_from_jax(bt.build_model(cfg), tck.load_params(path,
                                                                     cfg))
    trainer = Trainer(cfg, bt.TrainConfig(eval_batch_size=EVAL_BATCH),
                      device="cpu")
    loss = trainer.evaluate(model, batchify(getattr(Corpus(CORPUS), split),
                                            EVAL_BATCH))
    print(f"{os.path.relpath(path, ROOT)} on {split}.txt, eval batch "
          f"{EVAL_BATCH}: loss {loss:.6f}, ppl {math.exp(loss):.4f}")
    return loss


def _meets_log(loss, ppl):
    """exp(loss) rounds to the logged ppl; |loss - ln ppl| is then within
    the rounding half-width, ln(ppl + 0.005) - ln ppl."""
    half = math.log(ppl + 0.005) - math.log(ppl)
    assert round(math.exp(loss), 2) == ppl, (loss, math.exp(loss), ppl)
    assert abs(loss - math.log(ppl)) <= half


@pytest.mark.slow
def test_reference_base_quick_meets_its_valid_ppl():
    """train.log, epoch 4: valid ppl 82.35 (ln 4.41098 +- 6.1e-5)."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_lstm_base_quick",
                                  "model.pt"), _cfg(bt, "none", 0), "valid")
    _meets_log(loss, 82.35)


@pytest.mark.slow
def test_reference_bayes3_meets_its_test_ppl_at_the_posterior_mean():
    """train.log, end of training: test ppl 61.61 (ln 4.12082 +- 8.1e-5)."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_lstm_bayes3", "model.pt"),
                     _cfg(bt), "test")
    _meets_log(loss, 61.61)


@pytest.mark.slow
def test_jax_checkpoint_meets_its_sidecar_val_loss():
    """The JAX package's ours_lstm_bayes3_e8: the sidecar's val_loss
    4.254958121192836 at epoch 8, within 2e-5 (its float32 CE sums in
    another order; 6.6e-6 apart in this port's CPU run)."""
    path = os.path.join(CAMPAIGN, "ours_lstm_bayes3_e8", "model.ckpt")
    meta = tck.load_jax_checkpoint(path)[1]
    loss = _evaluate(path, _cfg(bt), "valid")
    assert abs(loss - meta["val_loss"]) <= 2e-5, (loss, meta["val_loss"])


@pytest.mark.slow
def test_reference_tm_bayesft_meets_its_test_ppl_at_the_posterior_mean():
    """torch_tm_bayesft (the reference's Bayesian-FFN Transformer,
    finetuned from prior_tm), train.log end of training: test loss 4.80,
    test ppl 121.51 (ln 4.79999 +- 4.1e-5), at eval batch 20."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_tm_bayesft", "model.pt"),
                     _tm_cfg(bt), "test")
    _meets_log(loss, 121.51)
    assert round(loss, 2) == 4.80


@pytest.mark.slow
def test_reference_gp12_meets_its_test_ppl():
    """torch_lstm_gp12 (the reference's GP-LSTM, L_gauss_pos 13, GP sampling
    off as it ships), train.log end of training: test loss 4.42, test ppl
    83.12 (ln 4.42029 +- 6.0e-5), at eval batch 20."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_lstm_gp12", "model.pt"),
                     _gp_cfg(bt), "test")
    _meets_log(loss, 83.12)


@pytest.mark.slow
def test_reference_gp_nf2222_meets_its_test_ppl():
    """torch_lstm_gp_nf2222 (the same GP-LSTM, another seed), train.log end
    of training: test loss 4.53, test ppl 93.12 (ln 4.53389 +- 5.4e-5), at
    eval batch 20."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_lstm_gp_nf2222",
                                  "model.pt"), _gp_cfg(bt), "test")
    _meets_log(loss, 93.12)


@pytest.mark.slow
def test_reference_vtm_fixed_meets_its_test_ppl():
    """torch_vtm_fixed (the reference's variational Transformer, T_v_pos 1),
    train.log end of training: test loss 4.64, test ppl 103.82 (ln 4.64265
    +- 4.8e-5), at eval batch 20 (deterministic: no noise)."""
    loss = _evaluate(os.path.join(CAMPAIGN, "torch_vtm_fixed", "model.pt"),
                     _vtm_cfg(bt), "test")
    _meets_log(loss, 103.82)
    assert round(loss, 2) == 4.64


@pytest.mark.slow
def test_jax_gp_ffn_checkpoint_meets_its_sidecar_val_loss():
    """The JAX package's ours_tm_gauss_e8 (the GP-FFN Transformer, 256/1024
    x 4, t_gauss_pos 3, float32): the sidecar's val_loss 4.509649 at epoch
    8, within 2e-5, the configuration read from the sidecar."""
    path = os.path.join(CAMPAIGN, "ours_tm_gauss_e8", "model.ckpt")
    meta = tck.load_jax_checkpoint(path)[1]
    cfg = bt.ModelConfig(**meta["model_config"])
    assert (cfg.uncertainty, cfg.t_gauss_pos) == ("Gaussian", 3)
    loss = _evaluate(path, cfg, "valid")
    assert abs(loss - meta["val_loss"]) <= 2e-5, (loss, meta["val_loss"])
