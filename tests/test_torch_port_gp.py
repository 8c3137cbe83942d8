"""The port's GP-LSTM (``models.layers.GPNN``, ``models.lstm_lm.GPLSTMCell``,
``StdLSTMLayer``, ``GPLSTMCore``, ``ops.gp_lstm_cuda``, the routes of
``ops.lstm`` and the GP cell) against the JAX package on the CPU, float32,
from the same weights and the same noise: the JAX side draws its eps through
``bayeslms_tpu.ops.gaussian.sample_diff``, which the tests replace with one
that hands out injected numpy draws in call order; the port takes the same
draws through its ``noise`` argument.

Kernel rows 20-21's plain twin (the autograd Function on CPU tensors)
against ``gpg_layer_fused`` in interpret mode, in value and all eight
gradients, at rtol 1e-4 / atol 1e-6 (``tests/test_gp_pallas.py``'s bound);
the models at rtol 2e-4 / atol 1e-5 (the golden tests'). The trainer and
the scorer are ``test_torch_port_gp_train.py``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.models.layers import GPNN as JGPNN
from bayeslms_tpu.models.lstm_lm import GPLSTMCore as JCore
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu.ops import gp_lstm_pallas as gpl
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.models.layers import GPNN
from bayeslms_tpu_torch.models.lstm_lm import (GPLSTMCell, GPLSTMCore,
                                               init_hidden)
from bayeslms_tpu_torch.ops import gp_lstm_cuda, lstm_cuda

RTOL, ATOL = 2e-4, 1e-5
V, H = 24, 8
T, B = 6, 3
ACTS3 = ("sigmoid", "tanh", "relu")


def _cfg(pkg, pos="13", E=12, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=V, emsize=E, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Gaussian",
                           l_gauss_pos=pos, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture
def inject(monkeypatch):
    """Make the JAX package's ``gaussian.sample_diff`` hand out the given
    draws in call order."""
    def install(draws):
        it = iter(draws)

        def sample_diff(key, lgstd, scale=1.0):
            eps = next(it)
            assert eps.shape == tuple(jnp.shape(lgstd))
            return scale * jnp.asarray(eps) * jnp.exp(lgstd)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
    return install


def _gpnn_shapes(gtype, n_in, n_out, k):
    """Shapes of one GPNN draw, in the JAX call order."""
    return ([(k, n_out)] if gtype in (1, 3) else []) + (
        [(n_out, n_in), (n_out,)] if gtype in (2, 3) else [])


def _draw_shapes(pos, E):
    """Shapes of a GP core's draws (gp_sample) in the JAX call order."""
    g, t = int(pos[0]), int(pos[1])
    if len(pos) == 2:
        cells = [(g, E)]
    elif len(pos) == 3:
        cells = [(g, H)]
    else:
        cells = [(g, E), (int(pos[2]), H)]
    return [s for gate, n_in in cells
            for s in _gpnn_shapes(t, n_in + H, H, 1 if gate == 2 else 3)]


# ---------------------------------------------------------- rows 20-21 twin
def _gpg_inputs(gate, masked, seed, T_=8, B_=4, H_=16):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    k = 1 if gate == 2 else 3
    a = dict(xg=f(T_, B_, 4 * H_), gpx=f(T_, B_, H_), w_hh=f(4 * H_, H_, sc=0.3),
             b_ih=f(4 * H_, sc=0.1), w_h=f(H_, H_, sc=0.3),
             coef=rng.uniform(size=(k, H_)).astype(np.float32),
             h0=f(B_, H_, sc=0.2), c0=f(B_, H_, sc=0.2))
    mask = None
    if masked:
        mask = (rng.uniform(size=(T_, B_)) > 0.3).astype(np.float32)
    w = dict(ys=f(T_, B_, H_, sc=1.0), hT=f(B_, H_, sc=1.0),
             cT=f(B_, H_, sc=1.0))
    return a, mask, w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gate", [1, 2, 3, 4])
def test_gpg_twin_matches_pallas_interpret(monkeypatch, gate, masked):
    """Rows 20-21's plain twin (forward, and the backward through the
    autograd Function) against ``gpg_layer_fused`` in interpret mode: ys,
    hT, cT and the gradients of xg, gpx, w_hh, b_ih, w_h, coef, h0 and c0
    of sum(ys wy) + sum(hT wh) + sum(cT wc)."""
    monkeypatch.setattr(lp, "_INTERPRET", True)
    a, mask, w = _gpg_inputs(gate, masked, seed=gate + 10 * masked)
    acts = ("sigmoid",) if gate == 2 else ACTS3
    names = list(a)

    def jloss(*args):
        ys, (hT, cT) = gpl.gpg_layer_fused(
            *args, gate, acts,
            step_mask=None if mask is None else jnp.asarray(mask))
        loss = (jnp.sum(ys * w["ys"]) + jnp.sum(hT * w["hT"])
                + jnp.sum(cT * w["cT"]))
        return loss, (ys, hT, cT)

    (_, ref), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(a[n]) for n in names))
    targs = {n: torch.from_numpy(v).requires_grad_(True) for n, v in a.items()}
    ys, (hT, cT) = gp_lstm_cuda.gpg_layer_fused(
        *targs.values(), gate, acts,
        None if mask is None else torch.from_numpy(mask))
    ((ys * torch.from_numpy(w["ys"])).sum() + (hT * torch.from_numpy(
        w["hT"])).sum() + (cT * torch.from_numpy(w["cT"])).sum()).backward()
    for g, r in zip((ys, hT, cT), ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-6)
    for n, r in zip(names, jgrads):
        np.testing.assert_allclose(targs[n].grad.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_gpg_twin_dcoef_and_zeroed_slice():
    """The backward twin zeroes the replaced gate's slice of du5 and sums
    dcoef over batch and time; CPU calls launch nothing."""
    a, mask, _ = _gpg_inputs(3, True, seed=4)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    w5 = torch.cat([t["w_hh"], t["w_h"]])
    before = dict(gp_lstm_cuda.launches)
    args = (t["xg"], t["gpx"], w5, t["b_ih"], t["coef"],
            torch.from_numpy(mask), t["h0"], t["c0"])
    ys, cs, hT, cT = gp_lstm_cuda.gpg_fwd(*args, 3)
    dy = torch.ones_like(ys)
    du5, dcoef, dh0, dc0 = gp_lstm_cuda.gpg_bwd(
        *args, ys, cs, dy, torch.zeros_like(hT), torch.zeros_like(cT), 3)
    Hh = t["w_h"].shape[0]
    assert torch.count_nonzero(du5[..., 2 * Hh:3 * Hh]) == 0
    assert torch.count_nonzero(du5[..., 4 * Hh:]) > 0
    assert dcoef.shape == (3, Hh) and torch.count_nonzero(dcoef) > 0
    assert gp_lstm_cuda.launches == before


# ---------------------------------------------------------------- GPNN
@pytest.mark.parametrize("gtype", [0, 1, 2, 3])
def test_gpnn_value_and_kl_match_jax(gtype, inject):
    """``GPNN`` types 0-3: the deterministic value over cat(x, h), the
    sampled value with injected eps, the KL and every gradient of the
    sampled value plus the KL."""
    n_x, n_h, n_out = 5, 4, 6
    rng = np.random.default_rng(gtype)
    x = rng.normal(size=(3, n_x)).astype(np.float32)
    hx = rng.normal(size=(3, n_h)).astype(np.float32)
    wout = rng.normal(size=(3, n_out)).astype(np.float32)
    mod = GPNN(n_x + n_h, n_out, gpnn_type=gtype, sample_enabled=True)
    mod.reset_parameters(torch.Generator().manual_seed(gtype))
    tree = jax.tree.map(jnp.asarray, params_to_jax(mod))
    jmod = JGPNN(n_x + n_h, n_out, gpnn_type=gtype, sample_enabled=True)
    assert set(_flat(tree)) == set(_flat(jmod.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.asarray(x), jnp.asarray(hx))["params"]))
    ref = jmod.apply({"params": tree}, jnp.asarray(x), jnp.asarray(hx))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(hx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    draws = [rng.normal(size=s).astype(np.float32)
             for s in _gpnn_shapes(gtype, n_x + n_h, n_out, 3)]
    inject(draws)

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(hx),
                         deterministic=False,
                         rngs={"sample": jax.random.key(2)})
        kl = jmod.apply({"params": p}, method=JGPNN.kl)
        return jnp.sum(out * wout) + kl, (out, kl)

    (_, (jout, jkl)), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree)
    w, b, coef = mod.draw(False, noise=iter(torch.from_numpy(d)
                                            for d in draws))
    out = GPNN.apply_drawn(torch.cat([torch.from_numpy(x),
                                      torch.from_numpy(hx)], -1), w, b, coef,
                           mod.act_set)
    kl = mod.kl()
    ((out * torch.from_numpy(wout)).sum() + kl).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert (float(kl) != 0.0) == (gtype != 0)
    grads = {k: p.grad for k, p in mod.named_parameters()}
    for name, r in _flat(jgrads).items():
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------- the core
CORE_POS = ["13", "23", "33", "43", "132", "1323", "10", "03"]


def _core_inputs(pos, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T + 2, B + 1, E)).astype(np.float32)
    h0 = rng.normal(size=(2, B + 1, H)).astype(np.float32) * 0.3
    c0 = rng.normal(size=(2, B + 1, H)).astype(np.float32) * 0.3
    mask = np.ones((T + 2, B + 1), np.float32)
    mask[5:, 1] = 0.0
    mask[:2, 3] = 0.0
    rmask = np.zeros((T + 2, B + 1), np.float32)
    rmask[3, :2] = 1.0
    rmask[6, 2:] = 1.0
    rsrc = np.array([0, 0, -1, 2], np.int32)
    return rng, x, h0, c0, mask, rmask, rsrc


@pytest.mark.parametrize("pos", CORE_POS)
def test_core_forward_kl_and_gradients_match_jax(pos, inject):
    """``GPLSTMCore`` for gates 1-4 (length 2), a length-3 and a length-4
    string, GPNN type 0 and the standard kind (gate digit 0): the
    deterministic forward with a step
    mask and packed resets (-1 sources too), the training forward with
    ``gp_sample`` and injected eps, the KL the JAX core sows, and every
    gradient of sum(out w) + KL."""
    E = 12
    jcfg, tcfg = _cfg(jx, pos, E, gp_sample=True), _cfg(bt, pos, E,
                                                         gp_sample=True)
    rng, x, h0, c0, mask, rmask, rsrc = _core_inputs(pos, E, len(pos))
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

    # deterministic, masked, with packed resets
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

    # training, masked, with the same eps, and every gradient
    draws = [rng.normal(size=s).astype(np.float32)
             for s in (_draw_shapes(pos, E) if pos[0] != "0" else [])]
    inject(draws)
    wout = rng.normal(size=(T + 2, B + 1, H)).astype(np.float32)

    def jloss(p):
        (out, _), var = jcore.apply(
            {"params": p}, jnp.asarray(x), hid, False, jnp.asarray(mask),
            rngs={"sample": jax.random.key(2),
                  "dropout": jax.random.key(3)}, mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.asarray(0.0))
        return jnp.sum(out * wout) + kl, (out, kl)

    (_, (jout, jkl)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)
    out, _ = core(torch.from_numpy(x), thid, torch.from_numpy(mask),
                  train=True, noise=[torch.from_numpy(d) for d in draws])
    kl = core.kl_value()
    ((out * torch.from_numpy(wout)).sum() + kl).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL,
                               atol=ATOL)
    assert (float(kl) > 0) == (pos[0] != "0" and pos[1] != "0")
    grads = {k: p.grad for k, p in core.named_parameters()}
    for name, r in _flat(jgrads).items():
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)


def test_core_sampling_follows_the_generator_and_counts_noise():
    """Without injected noise the GP units draw eps from the generator:
    the same seed gives the same forward, another seed another one;
    without ``gp_sample`` training is deterministic (the reference ships
    sampling off); a wrong number of injected tensors raises."""
    x = torch.randn((T, B, 12), generator=torch.Generator().manual_seed(1))
    hid = init_hidden(2, B, H)
    core = GPLSTMCore(_cfg(bt, "13", gp_sample=True))
    core.reset_parameters(torch.Generator().manual_seed(0))
    run = lambda s: core(x, hid, train=True, generator=torch.Generator(  # noqa: E731
        ).manual_seed(s))[0].detach()
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    shapes = _draw_shapes("13", 12)
    with pytest.raises(ValueError, match="more injected noise"):
        core(x, hid, train=True, noise=[torch.zeros(s) for s in shapes * 2])
    with pytest.raises(ValueError, match="fewer injected noise"):
        core(x, hid, train=True, noise=[torch.zeros(s) for s in shapes[:1]])
    plain = GPLSTMCore(_cfg(bt, "13"))
    plain.load_state_dict(core.state_dict())
    with torch.no_grad():
        det = plain(x, hid)[0]
        assert torch.equal(plain(x, hid, train=True)[0], det)


@pytest.mark.parametrize("extra", [
    dict(l_gauss_pos="13", l_gauss_legacy_pos=2),
    dict(uncertainty="Variational"),
])
def test_unported_gp_configurations_raise(extra):
    """The legacy GaussLSTM and the variational cores, once refused naming
    ROADMAP.md queue A item 10, now build, and with another depth raise
    naming ROADMAP.md C (the JAX package quietly builds two layers there);
    a string that is not 2 to 4 digits is refused."""
    cfg = dataclasses.replace(_cfg(bt, E=H), **extra)
    assert bt.build_model(cfg) is not None
    with pytest.raises(NotImplementedError, match="ROADMAP.md C"):
        bt.build_model(dataclasses.replace(cfg, nlayers=3))
    with pytest.raises(ValueError, match="2 to 4 digits"):
        bt.build_model(_cfg(bt, "13030"))


# ---------------------------------------------------------------- routes
class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    routing's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


class _Chip:
    platform = "tpu"


@pytest.mark.parametrize("Hh,dtype,Bb", [
    (1024, torch.bfloat16, 32), (1024, torch.bfloat16, 20),
    (1024, torch.bfloat16, 600), (1024, torch.bfloat16, 3000),
    (1024, torch.float32, 32), (1152, torch.bfloat16, 32),
    (512, torch.float32, 600), (128, torch.float32, 20)])
def test_gates_are_the_jax_gates(monkeypatch, Hh, dtype, Bb):
    """``gpg_kernel_ok`` and ``lstm_kernel_ok`` (forward and training) on
    a CUDA tensor admit exactly what ``gpg_pallas_ok`` and
    ``pallas_lstm_ok`` admit on the JAX package's chip; a CPU tensor
    never."""
    monkeypatch.setattr(jax, "devices", lambda *a: [_Chip()])
    jd = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    x = torch.zeros((1, Bb, 1), dtype=dtype)
    card = x.as_subclass(_OnCard)
    assert gp_lstm_cuda.gpg_kernel_ok(card, Hh) == gpl.gpg_pallas_ok(Hh, jd,
                                                                     Bb)
    for train in (False, True):
        assert lstm_cuda.lstm_kernel_ok(card, Hh, train) == \
            lp.pallas_lstm_ok(Hh, jd, batch=Bb, train=train)
        assert not lstm_cuda.lstm_kernel_ok(x, Hh, train)
    assert not gp_lstm_cuda.gpg_kernel_ok(x, Hh)


def test_routes_follow_jax(monkeypatch):
    """On a CUDA tensor the GP cell hands its recurrence to rows 20-21
    unless resets are given (then the scan runs, as in JAX); the standard
    layer takes rows 3-4 when deterministic and rows 5-6 when training
    without resets; on a CPU tensor everything runs the scan."""
    from bayeslms_tpu_torch.ops import lstm as tlstm

    calls = []

    def rec(name, pair):
        def call(x, *a, **kw):  # stands in for the kernel: zeros
            calls.append(name)
            z = torch.zeros((x.shape[1], H))
            ys = torch.zeros((x.shape[0], x.shape[1], H)).as_subclass(
                type(x))
            return (ys, (z, z)) if pair else (ys, z, z)
        return call

    monkeypatch.setattr(gp_lstm_cuda, "gpg_layer_fused", rec("gpg", True))
    monkeypatch.setattr(tlstm, "lstm_layer_fwd", rec("fwd", False))
    monkeypatch.setattr(tlstm, "lstm_layer_train", rec("train", False))
    core = GPLSTMCore(_cfg(bt, "13", E=H))
    core.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((T, B, H))
    hid = init_hidden(2, B, H)
    rm = torch.zeros((T, B))
    rs = torch.zeros((B,), dtype=torch.int32)
    with torch.no_grad():
        core(x, hid)
        core(x, hid, train=True)
        core(x, hid, reset_mask=rm, reset_src=rs)
    assert calls == []
    card = x.as_subclass(_OnCard)
    monkeypatch.setattr(gp_lstm_cuda, "gpg_kernel_ok",
                        lambda t, n: t.is_cuda)
    monkeypatch.setattr(lstm_cuda, "lstm_kernel_ok",
                        lambda t, n, train=False: t.is_cuda)
    with torch.no_grad():
        core(card, hid)
        assert calls == ["gpg", "fwd"]
        core(card, hid, train=True)
        assert calls[2:] == ["gpg", "train"]
        core(card, hid, reset_mask=rm, reset_src=rs)
        assert calls[4:] == ["fwd"]


def test_gp_cell_scan_in_bf16_carries_the_compute_dtype():
    """The scan (resets, as packed-carry scoring runs it) keeps the carry
    in the promoted dtype of h0 and x, as JAX's scan: bf16 state in, bf16
    out."""
    cell = GPLSTMCell(H, H, 1, 3)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((T, B, H)).bfloat16()
    hid = (torch.zeros((B, H)).bfloat16(), torch.zeros((B, H)).bfloat16())
    with torch.no_grad():
        ys, (h, c) = cell(x, hid, reset_mask=torch.zeros((T, B)),
                          reset_src=torch.zeros((B,), dtype=torch.int32))
    assert ys.dtype == h.dtype == c.dtype == torch.bfloat16
