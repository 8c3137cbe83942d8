"""The port's GP family beyond gates 1-4 against the JAX package on the
CPU, float32, from the same weights and the same noise: ``GPNN2``
(``models/layers.py``); ``GPLSTMCore`` for GP gates 5-7, GPNN2 (type 4) and
the two-cell strings (``models/lstm_lm.py``); three ``Trainer`` steps and
packed-carry scores of the gate-6 and GPNN2 models; the GP-FFN Transformer
(``GaussEncoderLayer``, ``t_gauss_pos`` 0-4) in forward, the training
forward, KL and gradients, three trainer steps and packed-nocarry scores;
and the reference's GP names in ``import_torch_state_dict``.

The JAX side takes its draws through ``gaussian.sample_diff`` (and, for the
Transformer, ``jax.random.bernoulli``), replaced by functions that hand out
injected numpy draws in call order; GPNN2's per-step draws in the GP-LSTM
cell come from ``jax.random.fold_in(key, step)``, which the tests replace,
in that module only, by one that passes (the cell, the step) through, so
that ``sample_diff`` reads that cell's numpy eps table at the step. The
port takes the same draws through its ``noise`` argument. Models at rtol
2e-4 / atol 1e-5 (the golden tests'); scores at rtol 1e-4 / atol 1e-5 (the
scorer tests')."""

import dataclasses
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.core.checkpoint import \
    import_torch_state_dict as j_import_torch_state_dict
from bayeslms_tpu.models import lstm_lm as jlstm_lm
from bayeslms_tpu.models.layers import GPNN2 as JGPNN2
from bayeslms_tpu.models.lstm_lm import GPLSTMCore as JCore
from bayeslms_tpu.models.lstm_lm import init_hidden as j_init_hidden
from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.rescore.scorer import BatchScorer as JaxScorer
from bayeslms_tpu.train import loop as jloop
from bayeslms_tpu.train.optim import init_opt_state as j_init_opt_state
from bayeslms_tpu_torch.core.checkpoint import (import_torch_state_dict,
                                                params_from_jax,
                                                params_to_jax)
from bayeslms_tpu_torch.models.layers import GPNN2
from bayeslms_tpu_torch.models.lstm_lm import GPLSTMCell, GPLSTMCore, \
    init_hidden
from bayeslms_tpu_torch.models.transformer_lm import (EncoderDropoutMasks,
                                                      TransformerDropoutMasks)
from bayeslms_tpu_torch.ops import gp_lstm_cuda, lstm_cuda, lstm_train_cuda
from bayeslms_tpu_torch.rescore.scorer import BatchScorer
from bayeslms_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 1e-5
V, H = 24, 8
T, B = 6, 3
N_MC = 150


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _check_grads(module, jgrads):
    grads = {k: p.grad for k, p in module.named_parameters()}
    for name, r in _flat(jgrads).items():
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


class _CellRandom:
    """``jax.random`` as the JAX GP-LSTM module sees it: ``fold_in(key,
    step)`` returns (the index of the cell whose key it is, step), the
    cells numbered in the order in which their keys first appear."""

    def __init__(self):
        self.keys = []

    def fold_in(self, key, step):
        for i, k in enumerate(self.keys):
            if k is key:
                return (i, step)
        self.keys.append(key)
        return (len(self.keys) - 1, step)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    def __init__(self):
        self.random = _CellRandom()

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def inject(monkeypatch):
    """``install(draws, tables)``: the JAX package's ``sample_diff`` hands
    out ``draws`` in call order, and GPNN2's per-step draw of cell i at step
    s reads ``tables[i][s]``."""
    def install(draws, tables=()):
        it = iter(draws)
        monkeypatch.setattr(jlstm_lm, "jax", _Jax())

        def sample_diff(key, lgstd, scale=1.0):
            if isinstance(key, tuple):
                cell, step = key
                eps = jnp.asarray(tables[cell])[step]
            else:
                eps = jnp.asarray(next(it))
            assert eps.shape == tuple(jnp.shape(lgstd))
            return scale * eps * jnp.exp(lgstd)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
        return lambda: next(it, None) is None
    return install


# ---------------------------------------------------------------- GPNN2
@pytest.mark.parametrize("acts", [("sigmoid", "relu", "tanh"),
                                  ("tanh", "sigmoid", "relu", "gelu")])
def test_gpnn2_value_kl_and_gradients_match_jax(acts, inject):
    """``GPNN2``: the tree, the value at the mean, the sampled value with an
    injected eps, the prior-updating KL (zero prior and a given one) and
    every gradient of the sampled value plus the KL."""
    n_in, n_out = 5, 7
    rng = np.random.default_rng(len(acts))
    x = rng.normal(size=(4, n_in)).astype(np.float32)
    wout = rng.normal(size=(4, n_out)).astype(np.float32)
    mod = GPNN2(n_in, n_out, act_set=acts)
    mod.reset_parameters(torch.Generator().manual_seed(2))
    tree = jax.tree.map(jnp.asarray, params_to_jax(mod))
    jmod = JGPNN2(n_in, n_out, act_set=acts)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jmod.init(
        jax.random.key(0), jnp.asarray(x))["params"])
    ref = jmod.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    eps = rng.normal(size=(n_in, N_MC)).astype(np.float32)
    pm = rng.normal(size=(n_in, N_MC)).astype(np.float32) * 0.1
    pl = rng.uniform(-3, -2, size=(n_in, N_MC)).astype(np.float32)
    inject([eps])

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), deterministic=False,
                         rngs={"sample": jax.random.key(1)})
        kl = jmod.apply({"params": p}, method=JGPNN2.kl)
        kl_p = jmod.apply({"params": p}, jnp.asarray(pm), jnp.asarray(pl),
                          method=JGPNN2.kl)
        return jnp.sum(out * wout) + kl + kl_p, (out, kl, kl_p)

    (_, (jout, jkl, jklp)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(tree)
    out = mod(torch.from_numpy(x), deterministic=False,
              noise=iter([torch.from_numpy(eps)]))
    kl, kl_p = mod.kl(), mod.kl(torch.from_numpy(pm), torch.from_numpy(pl))
    ((out * torch.from_numpy(wout)).sum() + kl + kl_p).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    for a, b in ((kl, jkl), (kl_p, jklp)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=RTOL)
    _check_grads(mod, jgrads)


# ---------------------------------------------------------------- the core
CORE_POS = ["63", "633", "6360", "73", "53", "52", "14", "54", "74", "1453"]


def _cfg(pkg, pos, E, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Gaussian",
                           l_gauss_pos=pos, **kw)


def _emsize(pos):
    """emsize = nhid where a layer-0 cell has gate 6 (its unit reads h
    through an (emsize -> 4H) weight), 12 otherwise."""
    return H if pos[0] == "6" and len(pos) in (2, 4) else 12


def _cells(pos, E):
    """(gate, input width) of each GP cell of a string, in call order."""
    g = int(pos[0])
    if len(pos) == 2:
        return [(g, E)]
    if len(pos) == 3:
        return [(g, H)]
    return [(g, E), (int(pos[2]), H)]


def _gpnn_shapes(gate, gtype, n_in):
    """One GPNN draw's shapes in the JAX call order (coef, then weights and
    bias), for a gate's (input, output) widths."""
    n, out = {5: (H, H), 6: (n_in, 4 * H), 7: (n_in, 4 * H)}.get(
        gate, (n_in + H, H))
    k = 1 if gate == 2 else 3
    return ([(k, out)] if gtype in (1, 3) else []) + (
        [(out, n), (out,)] if gtype in (2, 3) else [])


def core_draws(rng, pos, E, steps):
    """A training forward's draws with ``gp_sample``: the GPNN eps in the
    JAX call order, and GPNN2's per-step tables, one (steps, H, N_MC) a
    cell of gates 1-5; and the port's ``noise`` list (per step for GPNN2)."""
    gtype = int(pos[1])
    draws, tables, noise = [], [], []
    for gate, n_in in _cells(pos, E):
        if gtype <= 3 and 1 <= gate <= 7:
            d = [rng.normal(size=s).astype(np.float32)
                 for s in _gpnn_shapes(gate, gtype, n_in)]
            draws += d
            noise += d
        elif gtype == 4 and 1 <= gate <= 5:
            tab = rng.normal(size=(steps, H, N_MC)).astype(np.float32)
            tables.append(tab)
            noise += list(tab)
    return draws, tables, [torch.from_numpy(n) for n in noise]


@pytest.mark.parametrize("pos", CORE_POS)
def test_core_forward_kl_and_gradients_match_jax(pos, inject):
    """``GPLSTMCore`` for gates 5, 6 and 7, GPNN2 (type 4: gates 1 and 5
    apply it, 6 and 7 build it unused) and the two-cell strings: the tree,
    the deterministic forward with a step mask and packed resets (-1
    sources too), the training forward with ``gp_sample`` and injected eps
    (GPNN2 drawing every step), the KL the JAX core sows, and every
    gradient of sum(out w) + KL."""
    E = _emsize(pos)
    jcfg, tcfg = _cfg(jx, pos, E, gp_sample=True), _cfg(bt, pos, E,
                                                         gp_sample=True)
    rng = np.random.default_rng(len(pos) + int(pos[0]))
    Tn, Bn = T + 2, B + 1
    x = rng.normal(size=(Tn, Bn, E)).astype(np.float32)
    h0 = (rng.normal(size=(2, Bn, H)) * 0.3).astype(np.float32)
    c0 = (rng.normal(size=(2, Bn, H)) * 0.3).astype(np.float32)
    mask = np.ones((Tn, Bn), np.float32)
    mask[5:, 1] = 0.0
    mask[:2, 3] = 0.0
    rmask = np.zeros((Tn, Bn), np.float32)
    rmask[3, :2] = 1.0
    rmask[6, 2:] = 1.0
    rsrc = np.array([0, 0, -1, 2], np.int32)
    core = GPLSTMCore(tcfg)
    core.reset_parameters(torch.Generator().manual_seed(3))
    tree = params_to_jax(core)
    jparams = jax.tree.map(jnp.asarray, tree)
    jcore = JCore(jcfg)
    hid = (jnp.asarray(h0), jnp.asarray(c0))
    assert set(_flat(tree)) == set(_flat(jcore.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.asarray(x), hid)["params"]))
    thid = (torch.from_numpy(h0), torch.from_numpy(c0))

    (ref, (rh, rc)), _ = jcore.apply(
        {"params": jparams}, jnp.asarray(x), hid, True, jnp.asarray(mask),
        reset_mask=jnp.asarray(rmask), reset_src=jnp.asarray(rsrc),
        mutable=["losses"])
    with torch.no_grad():
        got, (gh, gc) = core(torch.from_numpy(x), thid,
                             torch.from_numpy(mask), torch.from_numpy(rmask),
                             torch.from_numpy(rsrc))
    for a, b in ((got, ref), (gh, rh), (gc, rc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)

    draws, tables, noise = core_draws(rng, pos, E, Tn)
    all_taken = inject(draws, tables)
    wout = rng.normal(size=(Tn, Bn, H)).astype(np.float32)

    def jloss(p):
        (out, _), var = jcore.apply(
            {"params": p}, jnp.asarray(x), hid, False, jnp.asarray(mask),
            rngs={"sample": jax.random.key(2)}, mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.asarray(0.0))
        return jnp.sum(out * wout) + kl, (out, kl)

    (_, (jout, jkl)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    assert all_taken()
    out, _ = core(torch.from_numpy(x), thid, torch.from_numpy(mask),
                  train=True, noise=noise)
    kl = core.kl_value()
    ((out * torch.from_numpy(wout)).sum() + kl).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert (float(kl.detach()) > 0) == (pos[1] in "123")
    _check_grads(core, jgrads)
    # the draws moved the training forward off the deterministic one where
    # a GP unit samples (gates 6 and 7 of type 4 build GPNN2 unused)
    with torch.no_grad():
        det, _ = core(torch.from_numpy(x), thid, torch.from_numpy(mask))
    assert (float((det - out.detach()).abs().max()) > 1e-4) == bool(noise)


def test_gpnn2_cell_draws_every_step_from_the_generator():
    """Type 4 draws T frequency matrices a training call (a step each),
    whatever ``gp_sample`` says: the same generator seed gives the same
    forward, another seed another; deterministic takes the mean; injected
    noise must hold one eps a step."""
    core = GPLSTMCore(_cfg(bt, "14", 12))
    core.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((T, B, 12), generator=torch.Generator().manual_seed(1))
    hid = init_hidden(2, B, H)
    run = lambda s: core(x, hid, train=True, generator=torch.Generator(  # noqa: E731
        ).manual_seed(s))[0].detach()
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    with torch.no_grad():
        det = core(x, hid)[0]
        zero = core(x, hid, train=True,
                    noise=[torch.zeros((H, N_MC))] * T)[0]
    torch.testing.assert_close(zero, det, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fewer injected noise"):
        core(x, hid, train=True, noise=[torch.zeros((H, N_MC))] * (T - 1))
    with pytest.raises(ValueError, match="more injected noise"):
        core(x, hid, train=True, noise=[torch.zeros((H, N_MC))] * (T + 1))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def test_gate7_gate5_and_gpnn2_routes_follow_jax(monkeypatch):
    """On a CUDA tensor gate 7 hands its recurrence over the hoisted GP
    input to rows 5-6 (``lstm_scan_fused`` with W_hh and b_ih), in
    evaluation too, unless resets are given; gate 5 and GPNN2 have no
    kernel in JAX and run the scan."""
    calls = []

    def scan_fused(xg, w_hh, b, h0, c0, mask=None):
        calls.append((tuple(xg.shape), tuple(w_hh.shape), tuple(b.shape)))
        return (torch.zeros((xg.shape[0], xg.shape[1], H)), None, h0, c0)

    monkeypatch.setattr(lstm_train_cuda, "lstm_scan_fused", scan_fused)
    monkeypatch.setattr(lstm_cuda, "lstm_kernel_ok",
                        lambda t, n, train=False: t.is_cuda and train)
    monkeypatch.setattr(gp_lstm_cuda, "gp6_kernel_ok", lambda t, n: t.is_cuda)
    monkeypatch.setattr(gp_lstm_cuda, "gpg_kernel_ok", lambda t, n: t.is_cuda)
    x = torch.randn((5, 3, 12))
    card = x.as_subclass(_OnCard)
    hid = (torch.zeros((3, H)), torch.zeros((3, H)))
    rm = torch.zeros((5, 3))
    rs = torch.zeros((3,), dtype=torch.int32)
    with torch.no_grad():
        for g, t in ((7, 3), (5, 3), (1, 4), (5, 4), (6, 4), (7, 4)):
            cell = GPLSTMCell(12, H, g, t)
            cell.reset_parameters(torch.Generator().manual_seed(g))
            cell(x, hid)
            cell(card, hid)
            cell(card, hid, deterministic=False)
            cell(card, hid, reset_mask=rm, reset_src=rs)
    assert calls == [((5, 3, 4 * H), (4 * H, H), (4 * H,))] * 2


@pytest.mark.parametrize("pos", ["73", "733"])
def test_gate7_kernel_route_through_the_core_matches_jax(monkeypatch, pos,
                                                         inject):
    """The core with its gate-7 cell on rows 5-6's route (the Function over
    the twins, admitted on CPU tensors for this test) against the JAX
    core's scan: the training forward with a step mask and sampled GP
    weights, and every gradient."""
    monkeypatch.setattr(lstm_cuda, "lstm_kernel_ok",
                        lambda t, n, train=False: train)
    n_calls = []
    fused = lstm_train_cuda.lstm_scan_fused
    monkeypatch.setattr(lstm_train_cuda, "lstm_scan_fused",
                        lambda *a, **k: n_calls.append(1) or fused(*a, **k))
    E = 12
    core = GPLSTMCore(_cfg(bt, pos, E, gp_sample=True))
    core.reset_parameters(torch.Generator().manual_seed(6))
    jp = jax.tree.map(jnp.asarray, params_to_jax(core))
    jcore = JCore(_cfg(jx, pos, E, gp_sample=True))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    h0 = (rng.normal(size=(2, B, H)) * 0.3).astype(np.float32)
    mask = (rng.uniform(size=(T, B)) > 0.25).astype(np.float32)
    wout = rng.normal(size=(T, B, H)).astype(np.float32)
    draws, _, noise = core_draws(rng, pos, E, T)
    inject(draws)

    def jloss(p):
        (out, _), var = jcore.apply(
            {"params": p}, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(h0)),
            False, jnp.asarray(mask), rngs={"sample": jax.random.key(0)},
            mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.asarray(0.0))
        return jnp.sum(out * wout) + kl, out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    out, _ = core(torch.from_numpy(x), (torch.from_numpy(h0),
                                        torch.from_numpy(h0)),
                  torch.from_numpy(mask), train=True, noise=noise)
    ((out * torch.from_numpy(wout)).sum() + core.kl_value()).backward()
    assert len(n_calls) == 2  # the gate-7 cell's and the standard layer's
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _check_grads(core, jg)


@pytest.mark.parametrize("extra", [
    dict(l_gauss_pos="13", l_gauss_legacy_pos=6),
    dict(uncertainty="Variational", l_v_pos="11"),
    dict(tied=False, l_gauss_pos="63"),
])
def test_what_is_still_unported_raises(extra):
    """The legacy GaussLSTM, the variational cores and an untied decoder
    still raise, naming their ROADMAP.md items."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bt.build_model(dataclasses.replace(_cfg(bt, "13", H), **extra))


# ---------------------------------------------------------------- trainer
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


@pytest.mark.parametrize("pos", ["63", "14"])
def test_three_trainer_steps_match_jax(tmp_path, inject, pos):
    """Three steps of both trainers on the same batches and draws (63 with
    ``gp_sample``: one GPNN draw a step, and its KL; 14: GPNN2's draw every
    time step, no KL): loss, KL x kl_scale, gradient norm, weights,
    momentum and the carried state. The JAX step runs unjitted, so that
    each step takes its own draws."""
    kw = dict(lr=2.0, batch_size=B, seq_len=T, save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_cfg(jx, pos, H, gp_sample=True), jx.TrainConfig(**kw))
    tt = Trainer(_cfg(bt, pos, H, gp_sample=True), bt.TrainConfig(**kw),
                 device="cpu")
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    jh, th = j_init_hidden(2, B, H), init_hidden(2, B, H)
    rng = np.random.default_rng(4)
    for step in range(3):
        d = rng.integers(0, V, size=(T, B)).astype(np.int32)
        t = rng.integers(0, V, size=(T, B)).astype(np.int32)
        draws, tables, noise = core_draws(rng, pos, H, T)
        inject(draws, tables)
        jparams, jopt, jh, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, jh, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(2.0), jnp.float32(0.1), jax.random.key(step))
        th, loss, _, kl, gn = tt.train_step(
            state, th, torch.from_numpy(d).long(), torch.from_numpy(t).long(),
            0.1, noise=noise)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        assert (float(kl) > 0) == (pos == "63")
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jparams).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}: {name}")
        for name, ref in _flat(jopt.momentum).items():
            np.testing.assert_allclose(
                state.opt_state.momentum[name].numpy(), ref, rtol=RTOL,
                atol=ATOL, err_msg=f"step {step}: momentum {name}")
        for a, b in zip(th, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("pos", ["63", "14", "53", "73"])
def test_packed_carry_scores_match_jax(monkeypatch, pos):
    """Scoring through packed-carry (the GP cell's scan under the resets,
    the standard layer's route, the fused CE) against the JAX scorer
    forced onto packed-carry with the fused CE (interpret mode)."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, V)}}
    rc = dict(carry_over=True, max_hyp_len=16, carry_chunk_utts=2)
    params = bt.init_params(bt.build_model(_cfg(bt, pos, H)),
                            _cfg(bt, pos, H), seed=3)
    params["decoder_b"] = np.random.default_rng(0).normal(
        size=V).astype(np.float32) * 0.1
    stream = lambda k: k.split("_")[0]  # noqa: E731
    ref_scorer = JaxScorer(_cfg(jx, pos, H), jax.tree.map(jnp.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_allowed()
    ref = ref_scorer.score_nbest(_nbest(), w2i, stream_fn=stream)
    got = BatchScorer(_cfg(bt, pos, H), params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(_nbest(), w2i,
                                                stream_fn=stream)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_trainer_hands_the_ce_its_states_in_the_compute_dtype(monkeypatch):
    """A GPNN2 cell on the scan carries the float32 state the epoch starts
    from (JAX's promotion); the trainer rounds the states to the compute
    dtype before the CE, whose kernels take bf16 only."""
    from bayeslms_tpu_torch.train import loop as tloop

    seen = []
    real = tloop.fused_decode_ce_train
    monkeypatch.setattr(tloop, "fused_decode_ce_train",
                        lambda h, *a: seen.append(h.dtype) or real(h, *a))
    cfg = _cfg(bt, "14", H, compute_dtype="bfloat16")
    tt = Trainer(cfg, bt.TrainConfig(batch_size=B, seq_len=T), device="cpu")
    state = tt.init_state()
    d = torch.randint(0, V, (T, B), generator=torch.Generator().manual_seed(0))
    hidden, loss, *_ = tt.train_step(state, init_hidden(2, B, H), d, d, 0.1)
    assert seen == [torch.bfloat16] and np.isfinite(float(loss))
    assert hidden[0].dtype == torch.float32  # the scan's promoted carry


# ---------------------------------------------------------- the Transformer
TV, TE, FF, NL, NH = 40, 16, 24, 2, 2
GAUSS_POS = [0, 1, 2, 3, 4]


def _tcfg(pkg, gpos, dropout=0.1, **kw):
    return pkg.ModelConfig(model="Transformer", vocab_size=TV, emsize=TE,
                           nhid=FF, nlayers=NL, nhead=NH, dropout=dropout,
                           uncertainty="Gaussian", t_gauss_pos=gpos,
                           gp_sample=True, **kw)


def _tm_pair(gpos, seed=0, **kw):
    model = bt.build_model(_tcfg(bt, gpos, **kw))
    tree = bt.init_params(model, _tcfg(bt, gpos, **kw), seed=seed)
    jm = jx.build_model(_tcfg(jx, gpos, **kw))
    return model, tree, jm, jax.tree.map(jnp.asarray, tree)


def _tm_eps(rng, gpos):
    """The GP-FFN layer's draws of one training forward (``gp_sample``), in
    the JAX call order."""
    if gpos == 4:
        shapes = [(TE, N_MC)]
    else:
        shapes = ([(4, FF)] if gpos in (1, 3) else []) + (
            [(FF, TE), (FF,)] if gpos in (2, 3) else [])
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture
def tm_inject(monkeypatch):
    def install(masks, eps):
        mit, eit = iter(masks), iter(eps)

        def bernoulli(key, p=0.5, shape=None):
            m = next(mit)
            assert tuple(shape) == m.shape
            return jnp.asarray(m)

        def sample_diff(key, lgstd, scale=1.0):
            e = next(eit)
            assert e.shape == tuple(jnp.shape(lgstd))
            return scale * jnp.asarray(e) * jnp.exp(lgstd)

        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
        return lambda: (next(mit, None), next(eit, None)) == (None, None)
    return install


@pytest.mark.parametrize("gpos", GAUSS_POS + [5])
def test_tm_tree_deterministic_and_packed_forward_match_jax(gpos):
    """The GP-FFN Transformer's tree (layer 0 holds ``gpnn`` in place of
    ``linear1``; ``t_gauss_pos`` 5 is all standard), its causal forward and
    its packed forward with positions and a segment-causal mask."""
    model, tree, jm, jp = _tm_pair(gpos)
    ref_tree = jx.init_params(jm, _tcfg(jx, gpos), seed=1)
    assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(np.shape, tree)
    assert ("gpnn" in tree["layers_0"]) == (gpos <= 4)
    rng = np.random.default_rng(gpos)
    tokens = rng.integers(0, TV, size=(7, B))
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    seg = np.array([[1, 1, 1, 2, 2, 0, 0], [1, 1, 1, 1, 1, 1, 1],
                    [1, 2, 2, 3, 3, 3, 0]])
    pos_ = np.zeros(seg.shape, np.int64)
    for b in range(B):
        for t in range(1, 7):
            pos_[b, t] = pos_[b, t - 1] + 1 if seg[b, t] == seg[b, t - 1] else 0
    same = seg[:, :, None] == seg[:, None, :]
    valid = (same & np.tril(np.ones((7, 7), bool))) | np.eye(7, dtype=bool)
    mask = np.where(valid, 0.0, -np.inf).astype(np.float32)[:, None]
    ref = jm.apply({"params": jp}, jnp.asarray(tokens), deterministic=True,
                   return_hidden=True, positions=jnp.asarray(pos_.T),
                   pack_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), return_hidden=True,
                    positions=torch.from_numpy(pos_.T.copy()),
                    pack_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("gpos", GAUSS_POS)
def test_tm_training_forward_kl_and_gradients_match_jax(gpos, tm_inject):
    """The training forward with the same dropout masks (the GP layer at
    the model's rate: attention probabilities, attention branch, the GP
    output, the FFN branch) and the same GP draws, the KL dispatch (the
    GPNN's for types 1-3, none for 0 and GPNN2) and every gradient of
    sum(logits w) + KL."""
    dropout = 0.1
    model, _, jm, jp = _tm_pair(gpos, seed=3, dropout=dropout)
    rng = np.random.default_rng(10 + gpos)
    Tn = 7
    tokens = rng.integers(0, TV, size=(Tn, B))
    w = rng.normal(size=(Tn, B, TV)).astype(np.float32)
    order = [rng.uniform(size=(Tn, B, TE)) >= dropout]
    layers = []
    for _ in range(NL):
        m = EncoderDropoutMasks(
            rng.uniform(size=(B, NH, Tn, Tn)) >= dropout,
            rng.uniform(size=(Tn, B, TE)) >= dropout,
            rng.uniform(size=(Tn, B, FF)) >= dropout,
            rng.uniform(size=(Tn, B, TE)) >= dropout)
        order += list(m)
        layers.append(EncoderDropoutMasks(*map(torch.from_numpy, m)))
    masks = TransformerDropoutMasks(torch.from_numpy(order[0]), layers)
    eps = _tm_eps(rng, gpos)
    all_taken = tm_inject(order, eps)

    def jloss(p):
        logits, var = jm.apply({"params": p}, jnp.asarray(tokens),
                               deterministic=False,
                               rngs={"dropout": jax.random.key(0),
                                     "sample": jax.random.key(1)},
                               mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.float32(0))
        return jnp.sum(logits * w) + kl, (logits, kl)

    (_, (jlog, jkl)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    assert all_taken()
    logits = model(torch.from_numpy(tokens), deterministic=False,
                   dropout_masks=masks,
                   noise=[torch.from_numpy(e) for e in eps])
    kl = model.kl_value()
    ((logits * torch.from_numpy(w)).sum() + kl).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert (float(kl.detach()) > 0) == (gpos in (1, 2, 3))
    _check_grads(model, jg)
    with pytest.raises(ValueError, match="injected noise"):
        model(torch.from_numpy(tokens), deterministic=False,
              dropout_masks=masks,
              noise=[torch.from_numpy(e) for e in eps] + [torch.zeros(1)])


@pytest.mark.parametrize("gpos", GAUSS_POS)
def test_tm_three_trainer_steps_match_jax(tmp_path, gpos, tm_inject):
    """Three steps of both trainers (dropout 0, the GP draws injected):
    loss, KL x kl_scale, gradient norm, weights and momentum."""
    kw = dict(lr=0.5, batch_size=B, seq_len=8, eval_batch_size=2,
              save=str(tmp_path / "m.ckpt"))
    jt = jloop.Trainer(_tcfg(jx, gpos, dropout=0.0), jx.TrainConfig(**kw))
    tt = Trainer(_tcfg(bt, gpos, dropout=0.0), bt.TrainConfig(**kw),
                 device="cpu")
    state = tt.init_state()
    jparams = jax.tree.map(jnp.asarray, params_to_jax(state.model))
    jopt = j_init_opt_state(jparams)
    rng = np.random.default_rng(7)
    for step in range(3):
        d = rng.integers(0, TV, size=(8, B)).astype(np.int32)
        t = rng.integers(0, TV, size=(8, B)).astype(np.int32)
        eps = _tm_eps(rng, gpos)
        tm_inject([], eps)
        jparams, jopt, _, jloss, _, jkl, jgn = jt._step_impl(
            jparams, jopt, None, jnp.asarray(d), jnp.asarray(t),
            jnp.float32(0.5), jnp.float32(0.1), jax.random.key(0))
        _, loss, _, kl, gn = tt.train_step(
            state, None, torch.from_numpy(d).long(),
            torch.from_numpy(t).long(), 0.1,
            noise=[torch.from_numpy(e) for e in eps])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=RTOL)
        assert (float(kl) > 0) == (gpos in (1, 2, 3))
        got = _flat(params_to_jax(state.model))
        for name, ref in _flat(jparams).items():
            np.testing.assert_allclose(got[name], ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}: {name}")


def _tm_nbest(n_utts=40):
    rng = np.random.default_rng(11)
    nbest = OrderedDict()
    for u in range(n_utts):
        nbest[f"u{u}"] = [
            " ".join(f"w{rng.integers(2, TV)}"
                     for _ in range(rng.integers(1, 14)))
            for _ in range(rng.integers(1, 6))]
    nbest["u5"][0] += " oov1 w3"
    return nbest


@pytest.mark.parametrize("gpos", GAUSS_POS)
def test_tm_packed_nocarry_scores_match_jax(monkeypatch, gpos):
    """The GP-FFN Transformer through packed-nocarry against the JAX
    scorer forced onto that layout with the fused CE (interpret mode);
    Transformer-XL scoring refuses it, as JAX does."""
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)
    monkeypatch.setenv("BAYESLM_NATIVE_ENCODE", "0")
    w2i = {"<s>": 1, "<unk>": 0, **{f"w{i}": i for i in range(2, TV)}}
    rc = dict(carry_over=True, max_hyp_len=30, batch_size=20)
    cfg = _tcfg(bt, gpos)
    params = bt.init_params(bt.build_model(cfg), cfg, seed=3)
    nbest = _tm_nbest()
    ref_scorer = JaxScorer(_tcfg(jx, gpos), jax.tree.map(np.asarray, params),
                           jx.RescoreConfig(**rc))
    ref_scorer.use_fused_ce = True
    assert ref_scorer._packed_nocarry_allowed()
    ref = ref_scorer.score_nbest(nbest, w2i)
    got = BatchScorer(cfg, params, bt.RescoreConfig(**rc),
                      device="cpu").score_nbest(nbest, w2i)
    assert list(got) == list(ref)
    for k in nbest:
        np.testing.assert_allclose([s for _, s in got[k]],
                                   [s for _, s in ref[k]], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="xl_mems requires"):
        BatchScorer(cfg, params, bt.RescoreConfig(xl_mems=True),
                    device="cpu")


# ---------------------------------------------------------------- import
@pytest.mark.parametrize("kind", ["gpnn", "gpnn2"])
def test_reference_gp_names_import_as_jax(kind):
    """The reference's GP names map as the JAX package maps them: the
    GP-FFN layer's ``transformerlayers.N.gpnn.*`` (GPNN2's read-out Linear
    transposed to ``coef_kernel``) and a GP-LSTM stack's
    ``rnn.rnn.<i>.gpnn.*``; the result loads into the port's model."""
    rng = np.random.default_rng(5)
    gpos = 3 if kind == "gpnn" else 4
    model = bt.build_model(_tcfg(bt, gpos))
    tree = bt.init_params(model, _tcfg(bt, gpos), seed=0)
    sd = {"encoder.weight": tree["embedding"],
          "decoder.bias": tree["decoder_b"]}
    for i in range(NL):
        L = tree[f"layers_{i}"]
        p = f"transformerlayers.layers.{i}."
        sd[p + "self_attn.in_proj_weight"] = L["self_attn"]["qkv_net"][
            "kernel"].T
        sd[p + "self_attn.in_proj_bias"] = L["self_attn"]["qkv_net"]["bias"]
        sd[p + "self_attn.out_proj.weight"] = L["self_attn"]["o_net"][
            "kernel"].T
        sd[p + "self_attn.out_proj.bias"] = L["self_attn"]["o_net"]["bias"]
        for n in ("norm1", "norm2"):
            sd[p + f"{n}.weight"] = L[n]["scale"]
            sd[p + f"{n}.bias"] = L[n]["bias"]
        sd[p + "linear2.weight"] = L["linear2"]["kernel"].T
        sd[p + "linear2.bias"] = L["linear2"]["bias"]
        if "gpnn" in L:
            for n, v in L["gpnn"].items():
                if n == "coef_kernel":
                    sd[p + "gpnn.coef.weight"] = v.T
                elif n == "coef_bias":
                    sd[p + "gpnn.coef.bias"] = v
                else:
                    sd[p + f"gpnn.{n}"] = v
        else:
            sd[p + "linear1.weight"] = L["linear1"]["kernel"].T
            sd[p + "linear1.bias"] = L["linear1"]["bias"]
    # a GP-LSTM stack's cell names ride along (their own config's)
    sd["rnn.rnn.0.gpnn.frequency_mean"] = rng.normal(size=(H, N_MC))
    sd["rnn.rnn.0.gpnn.coef.weight"] = rng.normal(size=(4 * H, N_MC))
    sd["rnn.rnn.0.gpnn.coef.bias"] = rng.normal(size=(4 * H,))
    cfg = _tcfg(bt, gpos)
    got = import_torch_state_dict(sd, cfg)
    ref = j_import_torch_state_dict(sd, _tcfg(jx, gpos))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, ref)
    for k, v in _flat(ref).items():
        np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
    del got["core"]
    loaded = params_from_jax(bt.build_model(cfg), got)
    for k, v in _flat(params_to_jax(loaded)).items():
        np.testing.assert_array_equal(v, _flat(tree)[k], err_msg=k)
