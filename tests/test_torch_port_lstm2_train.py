"""The port's fused 2-layer LSTM training route (kernel rows 7-8:
``lstm2_train_cuda.lstm2_layer_train``, the ``lstm2_scan_fused`` autograd
Function on the CUDA kernels' plain twins) against the JAX package's
``lstm2_layer_pallas_train`` in interpret mode: value and all eleven
gradients (x, both layers' four weights, h0, c0) with and without a step
mask and a dropout mask, float32 at rtol 2e-4 / atol 1e-5; the twins'
rounding points in bf16; the gate against ``pallas_lstm2_ok(train=True)``;
and ``ops.lstm.lstm_stack2``'s route under JAX's switch and conditions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c

T, B, E, H = 10, 4, 8, 8
RTOL, ATOL = 2e-4, 1e-5
NAMES = ("dx", "dw_ih1", "dw_hh1", "db_ih1", "db_hh1", "dw_ih2", "dw_hh2",
         "db_ih2", "db_hh2", "dh0", "dc0")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(lp, "_INTERPRET", True)


def _inputs(masked, dropped, seed=5, e=E):
    rng = np.random.default_rng(seed)
    g = 4 * H
    args = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((T, B, e), 1.0), ((g, e), 0.3), ((g, H), 0.3), ((g,), 0.1),
        ((g,), 0.1), ((g, H), 0.3), ((g, H), 0.3), ((g,), 0.1), ((g,), 0.1),
        ((2, B, H), 1.0), ((2, B, H), 1.0))]
    dy = rng.normal(size=(T, B, H)).astype(np.float32)
    mask = (rng.uniform(size=(T, B)) > 0.3).astype(np.float32) \
        if masked else None
    dm = ((rng.uniform(size=(T, B, H)) < 0.8) / 0.8).astype(np.float32) \
        if dropped else None
    return args, dy, mask, dm


def _jax_value_and_grads(args, dy, mask, dm, dtype=jnp.float32):
    def loss(x, w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2, h0,
             c0):
        ys, (h1, h2), (c1, c2) = lp.lstm2_layer_pallas_train(
            x.astype(dtype), h0[0], c0[0], h0[1], c0[1], w_ih1, w_hh1, b_ih1,
            b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
            None if mask is None else jnp.asarray(mask),
            None if dm is None else jnp.asarray(dm))
        f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
        return (jnp.sum(f32(ys) * dy) + jnp.sum(f32(h1) * 0.7)
                + jnp.sum(f32(c1) * 0.3) + jnp.sum(f32(h2) * 0.5)
                + jnp.sum(f32(c2) * 0.2), f32(ys))

    (v, ys), g = jax.value_and_grad(loss, argnums=tuple(range(11)),
                                    has_aux=True)(*map(jnp.asarray, args))
    return float(v), np.asarray(ys), [np.asarray(a) for a in g]


def _torch_value_and_grads(args, dy, mask, dm, dtype=torch.float32,
                           fn=None):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    x, w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2, h0, c0 = ts
    p1 = tlstm.LSTMParams(w_ih1, w_hh1, b_ih1, b_hh1)
    p2 = tlstm.LSTMParams(w_ih2, w_hh2, b_ih2, b_hh2)
    m = None if mask is None else torch.from_numpy(mask)
    d = None if dm is None else torch.from_numpy(dm)
    if fn is None:
        ys, (h1, h2), (c1, c2) = l2c.lstm2_layer_train(
            x.to(dtype), h0[0], c0[0], h0[1], c0[1], p1, p2, m, d)
    else:
        ys, (h1, h2), (c1, c2) = fn(x.to(dtype), h0, c0, p1, p2, m, d)
    loss = ((ys.float() * torch.from_numpy(dy)).sum() + (h1.float() * 0.7).sum()
            + (c1.float() * 0.3).sum() + (h2.float() * 0.5).sum()
            + (c2.float() * 0.2).sum())
    loss.backward()
    return (float(loss.detach()), ys.detach().float().numpy(),
            [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("dropped", [False, True], ids=["dm1", "dropout"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_lstm2_layer_train_matches_pallas_interpret(masked, dropped):
    args, dy, mask, dm = _inputs(masked, dropped)
    v_ref, ys_ref, g_ref = _jax_value_and_grads(args, dy, mask, dm)
    before = dict(l2c.launches)
    v, ys, g = _torch_value_and_grads(args, dy, mask, dm)
    assert l2c.launches == before  # CPU: plain twins
    np.testing.assert_allclose(v, v_ref, rtol=1e-5)
    np.testing.assert_allclose(ys, ys_ref, rtol=RTOL, atol=ATOL)
    for a, b, name in zip(g, g_ref, NAMES):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_lstm2_scan_fused_outputs_match_pallas_train_kernel():
    """Forward outputs of the plain twin (ys1, cs1, ys2, cs2 and the four
    final states) against the Pallas training kernel, masked and dropped."""
    args, _, mask, dm = _inputs(True, True, seed=9, e=H)
    x, w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2, h0, c0 = args
    xg1 = (x.reshape(T * B, -1) @ w_ih1.T + b_ih1).reshape(T, B, 4 * H)
    m8 = np.broadcast_to(mask[:, :, None], (T, B, 8))
    ref = lp.lstm2_scan_fused(*map(jnp.asarray, (
        xg1, dm, w_hh1.T, b_hh1[None], w_ih2.T, w_hh2.T,
        (b_ih2 + b_hh2)[None], m8, h0[0], c0[0], h0[1], c0[1])))
    got = l2c.lstm2_scan_fused(*map(torch.from_numpy, (
        xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b_ih2 + b_hh2, h0[0], c0[0],
        h0[1], c0[1], mask)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_lstm2_bf16_rounding_points_match_pallas_interpret():
    """In bf16 the twins round where the Pallas kernels round: the forward
    takes layer 2's input from the float32 h1 times dm, rounded once, its
    product h1d W_ih2^T unrounded inside the gate sum, b2 = b_ih2 + b_hh2
    summed before its rounding; the backward recomputes layer 2 from the
    stored bf16 ys1 times dm. ys1, cs1, ys2, cs2, du1 and du2 within one
    bf16 step of the interpreted kernels. The biases' sums are chosen so
    that rounding b_ih2 and b_hh2 before the sum would move b2."""
    args, dy, mask, dm = _inputs(True, True, seed=13, e=H)
    x, w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2, h0, c0 = args
    b_ih2 = (b_ih2 + 1.0 + 2.0 ** -9).astype(np.float32)
    b_hh2 = (b_hh2 + 2.0 ** -9).astype(np.float32)
    bf = jnp.bfloat16
    summed = np.asarray(jnp.asarray(b_ih2 + b_hh2, bf), np.float32)
    rounded = np.asarray(jnp.asarray(b_ih2, bf).astype(jnp.float32)
                         + jnp.asarray(b_hh2, bf).astype(jnp.float32))
    assert not np.array_equal(summed, rounded)
    xg1 = (x.reshape(T * B, -1) @ w_ih1.T + b_ih1).reshape(T, B, 4 * H)
    m8 = jnp.broadcast_to(jnp.asarray(mask, bf)[:, :, None], (T, B, 8))
    jargs = (jnp.asarray(xg1, bf), jnp.asarray(dm, bf),
             jnp.asarray(w_hh1.T, bf), jnp.asarray(b_hh1[None], bf),
             jnp.asarray(w_ih2.T, bf), jnp.asarray(w_hh2.T, bf),
             jnp.asarray((b_ih2 + b_hh2)[None], bf), m8,
             *(jnp.asarray(s, bf) for s in (h0[0], c0[0], h0[1], c0[1])))
    ref, vjp = jax.vjp(lp.lstm2_scan_fused, *jargs)
    cot = (jnp.zeros_like(ref[0]), jnp.zeros_like(ref[1]),
           jnp.asarray(dy, bf)) + tuple(jnp.zeros_like(r) for r in ref[3:])
    du1_ref = vjp(cot)[0]
    tb = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).bfloat16()
    targs = (tb(xg1), tb(dm), tb(w_hh1), tb(b_hh1).float(), tb(w_ih2),
             tb(w_hh2), torch.from_numpy(b_ih2 + b_hh2).bfloat16().float(),
             torch.from_numpy(mask), *(tb(s) for s in (h0[0], c0[0], h0[1],
                                                       c0[1])))
    fwd = l2c.lstm2_train_fwd_plain(*targs)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    for a, b in zip(fwd, ref):
        np.testing.assert_allclose(a.float().numpy(), f32(b), rtol=2 ** -7,
                                   atol=2 ** -9)
    z = torch.zeros((B, H)).bfloat16()
    du1, du2, *_ = l2c.lstm2_train_bwd_plain(
        *targs, *fwd[:4], torch.zeros((T, B, H)).bfloat16(), tb(dy), z, z, z,
        z)
    np.testing.assert_allclose(du1.float().numpy(), f32(du1_ref),
                               rtol=2 ** -6, atol=2 ** -9)
    # du2 through the same VJP: the gradient of b2 is its sum over (T, B)
    db2_ref = f32(vjp(cot)[6])[0]
    np.testing.assert_allclose(
        du2.float().reshape(T * B, -1).sum(0).numpy(), db2_ref, rtol=2 ** -6,
        atol=2 ** -6 * np.abs(db2_ref).max())


@pytest.mark.parametrize("masked", [False, True])
def test_lstm2_function_backward_matches_autograd_through_plain_forward(
        masked):
    """The Function's backward (the backward twin, the weight gradients
    outside) equals autograd through the differentiable plain forward."""
    args, dy, mask, dm = _inputs(masked, True, seed=21 + masked, e=H)

    def through_plain(x, h0, c0, p1, p2, m, d):
        xg1 = (x.reshape(T * B, -1) @ p1.w_ih.t() + p1.b_ih).reshape(
            T, B, 4 * H)
        out = l2c.lstm2_train_fwd_plain(xg1, d, p1.w_hh, p1.b_hh, p2.w_ih,
                                        p2.w_hh, p2.b_ih + p2.b_hh, m, h0[0],
                                        c0[0], h0[1], c0[1])
        return out[2], (out[4], out[6]), (out[5], out[7])

    v_ref, _, g_ref = _torch_value_and_grads(args, dy, mask, dm,
                                             fn=through_plain)
    v, _, g = _torch_value_and_grads(args, dy, mask, dm)
    np.testing.assert_allclose(v, v_ref, rtol=1e-6)
    for a, b, name in zip(g, g_ref, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    routing's kernel branch is reached without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("nhid,batch,dtype", [
    (1024, 32, "bfloat16"), (1024, 600, "bfloat16"), (1024, 2000, "bfloat16"),
    (1024, 32, "float32"), (1448, 32, "bfloat16"), (1449, 32, "bfloat16"),
    (256, 4000, "float32"), (512, 8000, "bfloat16")])
def test_gate_is_jax_gate(monkeypatch, nhid, batch, dtype):
    """``lstm2_kernel_ok`` on a CUDA tensor admits exactly the shapes that
    the JAX package's ``pallas_lstm2_ok(train=True)`` admits on its chip
    (the 8 MiB weight blocks, the U = 1 block set within the VMEM budget);
    a CPU tensor never."""
    class Chip:
        platform = "tpu"

    monkeypatch.setattr(lp.jax, "devices", lambda *a: [Chip()])
    x = torch.zeros((2, batch, 1), dtype=getattr(torch, dtype))
    assert l2c.lstm2_kernel_ok(x.as_subclass(_OnCard), nhid) == \
        lp.pallas_lstm2_ok(nhid, getattr(jnp, dtype), batch=batch,
                           train=True)
    assert not l2c.lstm2_kernel_ok(x, nhid)


@pytest.mark.parametrize("env,shape_ok,gate,fused", [
    ({}, True, True, False),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "1"}, True, True, True),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "1"}, True, False, False),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "1"}, False, True, False),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "1", "BAYESLM_PALLAS_LSTM2": "0"}, True,
     True, False),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "1", "BAYESLM_PALLAS_LSTM_TRAIN": "0"},
     True, True, False),
    ({"BAYESLM_PALLAS_LSTM2_TRAIN": "0"}, True, True, False),
])
def test_stack2_takes_the_fused_route_only_under_jax_conditions(
        monkeypatch, env, shape_ok, gate, fused):
    """``lstm_stack2(train=True)`` runs ``lstm2_layer_train`` only with
    ``BAYESLM_PALLAS_LSTM2_TRAIN=1``, neither ``BAYESLM_PALLAS_LSTM2`` nor
    ``BAYESLM_PALLAS_LSTM_TRAIN`` at 0, layer 2's w_ih (4H, H) and the gate
    admitting; it refuses resets either way. Both routes give the same
    values and gradients (float32, the twins)."""
    for k in ("BAYESLM_PALLAS_LSTM2_TRAIN", "BAYESLM_PALLAS_LSTM2",
              "BAYESLM_PALLAS_LSTM_TRAIN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(l2c, "lstm2_kernel_ok", lambda x, n: gate)
    calls = []
    real = l2c.lstm2_layer_train

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(l2c, "lstm2_layer_train", spy)
    e = H if shape_ok else E + 4
    args, dy, mask, dm = _inputs(True, True, seed=3, e=e)
    if not shape_ok:  # the legacy VLSTM's (4H, emsize) layer-2 quirk
        args[5] = np.random.default_rng(0).normal(
            size=(4 * H, e)).astype(np.float32) * 0.3

    def stack(x, h0, c0, p1, p2, m, d):
        return tlstm.lstm_stack2(x, h0, c0, p1, p2, m, train=True,
                                 dropout_mask=d)

    if not shape_ok:
        # w_ih2 (4H, E + 4) cannot take layer 1's H-wide output: the
        # two-layer route refuses the shape, the fused one is never asked
        with pytest.raises(RuntimeError):
            _torch_value_and_grads(args, dy, mask, dm, fn=stack)
        assert not calls
        return
    v, ys, g = _torch_value_and_grads(args, dy, mask, dm, fn=stack)
    assert len(calls) == int(fused)
    monkeypatch.setenv("BAYESLM_PALLAS_LSTM2_TRAIN", "0" if fused else "1")
    monkeypatch.setattr(l2c, "lstm2_kernel_ok", lambda x, n: True)
    v2, ys2, g2 = _torch_value_and_grads(args, dy, mask, dm, fn=stack)
    np.testing.assert_allclose(v, v2, rtol=1e-6)
    np.testing.assert_allclose(ys, ys2, rtol=RTOL, atol=ATOL)
    for a, b, name in zip(g, g2, NAMES):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    x = torch.zeros((T, B, H))
    p = tlstm.LSTMParams(torch.zeros(4 * H, H), torch.zeros(4 * H, H),
                         torch.zeros(4 * H), torch.zeros(4 * H))
    z = torch.zeros((2, B, H))
    with pytest.raises(NotImplementedError, match="resets"):
        tlstm.lstm_stack2(x, z, z, p, p, reset_mask=torch.zeros((T, B)),
                          reset_src=torch.zeros(B), train=True)
