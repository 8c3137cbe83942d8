"""Kernel rows 18-19 of the port (``ops/gp_lstm_cuda.py`` gate 6: the plain
twins ``gp6_fwd_plain`` / ``gp6_bwd_plain``, the autograd Function behind
``gp6_layer_fused``, the gate ``gp6_kernel_ok``) and the gate-6 GP cell's
routes, against the JAX package on the CPU: ``gp6_layer_fused`` in
interpret mode (as ``tests/test_gp_pallas.py`` runs it), ``gp6_pallas_ok``
and the JAX core's scan, from the same numpy inputs.

Tolerances: float32 values and all six gradients at rtol 1e-4 / atol 1e-6
(rows 20-21's bound); the bf16 case at one bf16 step (2^-7 of the value,
2^-9 of the largest entry), since both sides round the same fp32 values at
the same points and those values differ only in the order of fp32 sums;
the cell at rtol 2e-4 / atol 1e-5 (the golden tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.models.lstm_lm import GPLSTMCore as JCore
from bayeslms_tpu.ops import gp_lstm_pallas as gpl
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.models.lstm_lm import GPLSTMCell, GPLSTMCore
from bayeslms_tpu_torch.ops import gp_lstm_cuda

RTOL, ATOL = 2e-4, 1e-5
NAMES = ("xg", "w", "b", "coef", "h0", "c0")


def _inputs(T, B, H, masked, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    a = dict(xg=f(T, B, 4 * H), w=f(4 * H, H, sc=0.3), b=f(4 * H, sc=0.3),
             coef=rng.uniform(-1.0, 1.0, size=(3, 4 * H)).astype(np.float32),
             h0=f(B, H, sc=0.3), c0=f(B, H, sc=0.3))
    mask = None
    if masked:
        mask = (rng.uniform(size=(T, B)) > 0.3).astype(np.float32)
    w = dict(ys=f(T, B, H, sc=1.0), hT=f(B, H, sc=1.0), cT=f(B, H, sc=1.0))
    return a, mask, w


def _jax(a, mask, w, dtype=jnp.float32):
    """Value and the six gradients of sum(ys wy) + sum(hT wh) + sum(cT wc)
    through the JAX package's ``gp6_layer_fused`` (interpret mode set by the
    caller); xg, h0 and c0 in ``dtype``."""
    def loss(xg, wt, b, coef, h0, c0):
        ys, (hT, cT) = gpl.gp6_layer_fused(
            xg.astype(dtype), wt, b, coef, h0.astype(dtype),
            c0.astype(dtype),
            step_mask=None if mask is None else jnp.asarray(mask))
        out = (ys, hT, cT)
        return sum(jnp.sum(o.astype(jnp.float32) * w[k])
                   for o, k in zip(out, ("ys", "hT", "cT"))), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(6)),
                                         has_aux=True)(
        *(jnp.asarray(a[n]) for n in NAMES))
    return [np.asarray(o.astype(jnp.float32)) for o in out], \
        [np.asarray(g) for g in grads]


def _port(a, mask, w, dtype=torch.float32, fn=None):
    """The same through the port's ``gp6_layer_fused`` (or ``fn``)."""
    t = {n: torch.from_numpy(v).requires_grad_(True) for n, v in a.items()}
    fn = fn or gp_lstm_cuda.gp6_layer_fused
    ys, (hT, cT) = fn(t["xg"].to(dtype), t["w"], t["b"], t["coef"],
                      t["h0"].to(dtype), t["c0"].to(dtype),
                      None if mask is None else torch.from_numpy(mask))
    out = (ys, hT, cT)
    sum((o.float() * torch.from_numpy(w[k])).sum()
        for o, k in zip(out, ("ys", "hT", "cT"))).backward()
    return [o.detach().float().numpy() for o in out], \
        [t[n].grad.numpy() for n in NAMES]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [1, 7, 8])
def test_gp6_twin_matches_pallas_interpret(monkeypatch, T, masked):
    """Rows 18-19's plain twins (the forward, and the backward through the
    autograd Function) against ``gp6_layer_fused`` in interpret mode, in
    float32: ys, hT, cT and the gradients of xg, w, b, coef, h0 and c0."""
    monkeypatch.setattr(lp, "_INTERPRET", True)
    a, mask, w = _inputs(T, 3, 16, masked, seed=T + 10 * masked)
    ref, jgrads = _jax(a, mask, w)
    got, grads = _port(a, mask, w)
    for g, r, k in zip(got, ref, ("ys", "hT", "cT")):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6, err_msg=k)
    for g, r, n in zip(grads, jgrads, NAMES):
        assert np.abs(r).max() > 0, n
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6, err_msg=n)


def test_gp6_bf16_rounding_points_match_pallas_interpret(monkeypatch):
    """In bf16 the port rounds where the JAX wrapper and kernel round: W'
    and b' to bf16 before the product, ys, cs, dux and dupre stored in
    bf16, dW' rounded to W's compute dtype and db' to bf16 (b' entered the
    custom VJP in bf16) before they return to the float32 parameters; coef
    and its gradient stay float32. One bf16 step of tolerance, and the
    gradients of w and b are bf16 values on both sides."""
    monkeypatch.setattr(lp, "_INTERPRET", True)
    a, mask, w = _inputs(6, 4, 32, True, seed=5)
    ref, jgrads = _jax(a, mask, w, jnp.bfloat16)
    got, grads = _port(a, mask, w, torch.bfloat16)
    for g, r, k in zip(got, ref, ("ys", "hT", "cT")):
        np.testing.assert_allclose(g, r, rtol=2 ** -7,
                                   atol=2 ** -9 * np.abs(r).max(), err_msg=k)
    for g, r, n in zip(grads, jgrads, NAMES):
        np.testing.assert_allclose(g, r, rtol=2 ** -7,
                                   atol=2 ** -9 * np.abs(r).max(), err_msg=n)
    for n in ("w", "b"):
        i = NAMES.index(n)
        for arr in (grads[i], jgrads[i]):
            t = torch.from_numpy(np.array(arr))
            assert torch.equal(t, t.bfloat16().float()), n
    # coef's gradient is not rounded (a float32 sum over the sweep)
    c = torch.from_numpy(grads[NAMES.index("coef")])
    assert not torch.equal(c, c.bfloat16().float())


@pytest.mark.parametrize("masked", [False, True])
def test_gp6_function_backward_matches_autograd_through_plain_forward(masked):
    """The Function's backward (the backward twin, dW' and db' outside)
    equals autograd through the differentiable plain forward."""
    a, mask, w = _inputs(5, 3, 8, masked, seed=21 + masked)

    def through_plain(xg, wt, b, coef, h0, c0, m):
        ys, _, hT, cT = gp_lstm_cuda.gp6_fwd_plain(xg, wt, b, coef, m, h0, c0)
        return ys, (hT, cT)

    ref, rgrads = _port(a, mask, w, fn=through_plain)
    got, grads = _port(a, mask, w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
    for g, r, n in zip(grads, rgrads, NAMES):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6, err_msg=n)


def test_gp6_twin_on_cpu_launches_nothing_and_sums_dcoef():
    """CPU calls run the twins and count no launch; masked steps add no
    gradient to the gates or dcoef and pass dh through: a sweep whose steps
    1-3 are masked gives step 0's dcoef with dy[0] + ... + dy[3]."""
    a, _, _ = _inputs(4, 3, 8, False, seed=3)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    mask = torch.zeros((4, 3))
    mask[0] = 1.0
    before = dict(gp_lstm_cuda.launches)
    args = (t["xg"], t["w"], t["b"], t["coef"], mask, t["h0"], t["c0"])
    ys, cs, hT, cT = gp_lstm_cuda.gp6_fwd(*args)
    dy = torch.ones_like(ys)
    z = torch.zeros_like(hT)
    dux, dupre, dcoef, dh0, dc0 = gp_lstm_cuda.gp6_bwd(*args, ys, cs, dy, z,
                                                       z)
    assert gp_lstm_cuda.launches == before
    assert dux.shape == dupre.shape == a["xg"].shape
    assert dcoef.shape == (3, a["xg"].shape[2])
    # steps 1-3 are masked: no gradient reaches their gates
    assert torch.count_nonzero(dux[1:]) == 0
    assert torch.count_nonzero(dux[0]) > 0
    # step 0's dh_tot is dy[0] plus what the masked steps pass through
    # unchanged: dy[1] + dy[2] + dy[3]
    s0 = gp_lstm_cuda.gp6_bwd(t["xg"][:1], t["w"], t["b"], t["coef"], None,
                              t["h0"], t["c0"], ys[:1], cs[:1], 4 * dy[:1],
                              z, z)[2]
    torch.testing.assert_close(dcoef, s0, rtol=1e-5, atol=1e-6)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that a gate's
    and a route's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


class _Chip:
    platform = "tpu"


@pytest.mark.parametrize("Hh,dtype,Bb", [
    (1024, torch.bfloat16, 32), (1024, torch.bfloat16, 20),
    (1024, torch.bfloat16, 600), (1024, torch.bfloat16, 1200),
    (1024, torch.bfloat16, 3000), (1024, torch.float32, 32),
    (1056, torch.bfloat16, 32), (1008, torch.bfloat16, 32),
    (512, torch.float32, 600), (128, torch.float32, 20)])
def test_gp6_gate_is_the_jax_gate(monkeypatch, Hh, dtype, Bb):
    """``gp6_kernel_ok`` on a CUDA tensor admits exactly what
    ``gp6_pallas_ok`` admits on the JAX package's chip: W' of exactly
    8 MiB (H = 1,024 in bf16) is admitted, one row more is not, and the
    U = 1 backward block set bounds the batch; a CPU tensor never."""
    monkeypatch.setattr(jax, "devices", lambda *a: [_Chip()])
    jd = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    x = torch.zeros((1, Bb, 1), dtype=dtype)
    assert gp_lstm_cuda.gp6_kernel_ok(x.as_subclass(_OnCard), Hh) == \
        gpl.gp6_pallas_ok(Hh, jd, Bb)
    assert not gp_lstm_cuda.gp6_kernel_ok(x, Hh)
    if (Hh, dtype, Bb) == (1024, torch.bfloat16, 32):
        assert gpl.gp6_pallas_ok(Hh, jd, Bb)  # the 8 MiB edge admits


# ---------------------------------------------------------------- the cell
H = 8


def _cfg(pkg, pos, **kw):
    return pkg.ModelConfig(model="LSTM", vocab_size=24, emsize=H, nhid=H,
                           nlayers=2, dropout=0.0, uncertainty="Gaussian",
                           l_gauss_pos=pos, **kw)


def test_gp6_cell_routes_follow_jax(monkeypatch):
    """On a CUDA tensor the gate-6 cell hands its recurrence to rows 18-19
    (with the drawn W', b' and coef, and the step mask) unless resets are
    given, where the scan runs, as in JAX, deterministic or not; a CPU
    tensor runs the scan."""
    calls = []

    def fused(xg, w, b, coef, h0, c0, step_mask=None):
        calls.append((tuple(w.shape), tuple(b.shape), tuple(coef.shape),
                      step_mask is not None))
        ys = torch.zeros((xg.shape[0], xg.shape[1], H)).as_subclass(
            type(xg))
        return ys, (h0, c0)

    monkeypatch.setattr(gp_lstm_cuda, "gp6_layer_fused", fused)
    cell = GPLSTMCell(H, H, 6, 3)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((5, 3, H))
    hid = (torch.zeros((3, H)), torch.zeros((3, H)))
    rm = torch.zeros((5, 3))
    rs = torch.zeros((3,), dtype=torch.int32)
    with torch.no_grad():
        cell(x, hid)
        assert calls == []
        card = x.as_subclass(_OnCard)
        monkeypatch.setattr(gp_lstm_cuda, "gp6_kernel_ok",
                            lambda t, n: t.is_cuda)
        cell(card, hid)
        cell(card, hid, deterministic=False, step_mask=torch.ones((5, 3)))
        cell(card, hid, reset_mask=rm, reset_src=rs)
    assert calls == [((4 * H, H), (4 * H,), (3, 4 * H), False),
                     ((4 * H, H), (4 * H,), (3, 4 * H), True)]


def test_layer0_gate6_cell_needs_emsize_equal_nhid():
    """JAX fails at the product h W'^T when emsize != nhid; the port says
    why when it builds the cell."""
    with pytest.raises(ValueError, match="emsize == nhid"):
        bt.build_model(bt.ModelConfig(
            model="LSTM", vocab_size=24, emsize=12, nhid=H,
            uncertainty="Gaussian", l_gauss_pos="63"))
    GPLSTMCell(H, H, 6, 3)
    GPLSTMCell(12, H, 6, 4)  # GPNN2 (type 4) is built and unused


@pytest.mark.parametrize("pos", ["63", "6360"])
def test_gp6_kernel_route_through_the_core_matches_jax(monkeypatch, pos):
    """The core with its gate-6 cells on the kernel route (the Function
    over the twins, admitted on CPU tensors for this test) against the JAX
    core's scan: the training forward with a step mask and every gradient
    of sum(out w) + KL."""
    monkeypatch.setattr(gp_lstm_cuda, "gp6_kernel_ok", lambda t, n: True)
    fused = gp_lstm_cuda.gp6_layer_fused
    n_calls = []
    monkeypatch.setattr(gp_lstm_cuda, "gp6_layer_fused",
                        lambda *a, **k: n_calls.append(1) or fused(*a, **k))
    core = GPLSTMCore(_cfg(bt, pos))
    core.reset_parameters(torch.Generator().manual_seed(4))
    jp = jax.tree.map(jnp.asarray, params_to_jax(core))
    jcore = JCore(_cfg(jx, pos))
    rng = np.random.default_rng(2)
    T, B = 6, 3
    x = rng.normal(size=(T, B, H)).astype(np.float32)
    h0 = (rng.normal(size=(2, B, H)) * 0.3).astype(np.float32)
    c0 = (rng.normal(size=(2, B, H)) * 0.3).astype(np.float32)
    mask = (rng.uniform(size=(T, B)) > 0.25).astype(np.float32)
    wout = rng.normal(size=(T, B, H)).astype(np.float32)

    def jloss(p):
        (out, _), var = jcore.apply(
            {"params": p}, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
            False, jnp.asarray(mask), rngs={"sample": jax.random.key(0)},
            mutable=["losses"])
        kl = sum(jax.tree.leaves(var.get("losses", {})), jnp.asarray(0.0))
        return jnp.sum(out * wout) + kl, out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    out, _ = core(torch.from_numpy(x), (torch.from_numpy(h0),
                                        torch.from_numpy(c0)),
                  torch.from_numpy(mask), train=True)
    ((out * torch.from_numpy(wout)).sum() + core.kl_value()).backward()
    assert len(n_calls) == (2 if pos == "6360" else 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    grads = {k: p.grad for k, p in core.named_parameters()}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    for name, r in flat(jg):
        g = grads[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)
