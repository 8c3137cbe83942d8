"""The port's differentiable LSTM layer (``ops.lstm.lstm_layer_train``:
the ``lstm_scan_fused`` autograd Function on the CUDA kernels' plain twins)
against the JAX package: value and all seven gradients (x, W_ih, W_hh,
b_ih, b_hh, h0, c0) against ``lstm_layer_pallas_train`` in interpret mode
and against the JAX scan's autodiff, with and without a step mask, float32,
at the JAX kernel test's tolerance (rtol 5e-4 / atol 1e-5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm as jlstm
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.ops import lstm_train_cuda

T, B, E, H = 7, 4, 8, 8
NAMES = ("dx", "dw_ih", "dw_hh", "db_ih", "db_hh", "dh0", "dc0")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(lp, "_INTERPRET", True)


def _inputs(masked):
    rng = np.random.default_rng(5)
    args = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((T, B, E), 1.0), ((4 * H, E), 0.3), ((4 * H, H), 0.3),
        ((4 * H,), 0.1), ((4 * H,), 0.1), ((B, H), 1.0), ((B, H), 1.0))]
    dy = rng.normal(size=(T, B, H)).astype(np.float32)
    mask = (rng.uniform(size=(T, B)) > 0.3).astype(np.float32) if masked else None
    return args, dy, mask


def _jax_loss(fused, dy, mask):
    def loss(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
        if fused:
            ys, hT, cT = lp.lstm_layer_pallas_train(
                x, h0, c0, w_ih, w_hh, b_ih, b_hh,
                None if mask is None else jnp.asarray(mask))
        else:
            ys, hT, cT = jlstm.lstm_layer(
                x, h0, c0, jlstm.LSTMParams(w_ih, w_hh, b_ih, b_hh),
                step_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(ys * dy) + jnp.sum(hT * 0.7) + jnp.sum(cT * 0.3)
    return loss


def _torch_value_and_grads(args, dy, mask):
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = (
        torch.tensor(a, requires_grad=True) for a in args)
    ys, hT, cT = tlstm.lstm_layer_train(
        x, h0, c0, tlstm.LSTMParams(w_ih, w_hh, b_ih, b_hh),
        None if mask is None else torch.from_numpy(mask))
    loss = (ys * torch.from_numpy(dy)).sum() + (hT * 0.7).sum() \
        + (cT * 0.3).sum()
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in (x, w_ih, w_hh, b_ih, b_hh,
                                                   h0, c0)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [True, False], ids=["pallas", "scan"])
def test_lstm_scan_fused_matches_jax(monkeypatch, masked, fused):
    args, dy, mask = _inputs(masked)
    if not fused:  # the JAX scan, not its train kernel
        monkeypatch.setitem(os.environ, "BAYESLM_PALLAS_LSTM_TRAIN", "0")
    v_ref, g_ref = jax.value_and_grad(
        _jax_loss(fused, jnp.asarray(dy), mask), argnums=tuple(range(7)))(
        *map(jnp.asarray, args))
    before = dict(lstm_train_cuda.launches)
    v, g = _torch_value_and_grads(args, dy, mask)
    assert lstm_train_cuda.launches == before  # CPU: plain twins
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for a, b, name in zip(g, g_ref, NAMES):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=1e-5,
                                   err_msg=name)


def test_lstm_scan_fused_outputs_match_pallas_train_kernel():
    """Forward outputs ys, cs, hT, cT of the plain twin against the Pallas
    train kernel, which also emits the cell sequence."""
    args, _, mask = _inputs(True)
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = args
    xg = (x.reshape(T * B, -1) @ w_ih.T + b_ih).reshape(T, B, 4 * H)
    m8 = np.broadcast_to(mask[:, :, None], (T, B, 8))
    ref = lp.lstm_scan_fused(jnp.asarray(xg), jnp.asarray(w_hh.T),
                             jnp.asarray(b_hh[None]), jnp.asarray(m8),
                             jnp.asarray(h0), jnp.asarray(c0))
    got = lstm_train_cuda.lstm_scan_fused(
        *map(torch.from_numpy, (xg, w_hh, b_hh, h0, c0)),
        torch.from_numpy(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_lstm_train_plain_bf16_rounds_like_the_pallas_kernel():
    """In bf16 the plain twins round where the Pallas train kernels round
    (h before the product, ys, cs and du stored in bf16, fp32 carries):
    forward outputs and du within one bf16 step of the interpreted
    kernels."""
    args, dy, mask = _inputs(True)
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = args
    bf = jnp.bfloat16
    xg = (x.reshape(T * B, -1) @ w_ih.T + b_ih).reshape(T, B, 4 * H)
    m8 = jnp.broadcast_to(jnp.asarray(mask, bf)[:, :, None], (T, B, 8))
    jargs = (jnp.asarray(xg, bf), jnp.asarray(w_hh.T, bf),
             jnp.asarray(b_hh[None], bf), m8, jnp.asarray(h0, bf),
             jnp.asarray(c0, bf))
    ref, vjp = jax.vjp(lp.lstm_scan_fused, *jargs)
    cot = (jnp.asarray(dy, bf), jnp.zeros_like(ref[1]),
           jnp.zeros_like(ref[2]), jnp.zeros_like(ref[3]))
    du_ref = vjp(cot)[0]
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    b32 = tb(b_hh).float()
    fwd = lstm_train_cuda.lstm_train_fwd_plain(
        tb(xg), tb(w_hh), b32, torch.from_numpy(mask), tb(h0), tb(c0))
    for a, b in zip(fwd, ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=2 ** -9)
    du, _, _ = lstm_train_cuda.lstm_train_bwd_plain(
        tb(xg), tb(w_hh), b32, torch.from_numpy(mask), tb(h0), tb(c0),
        fwd[0], fwd[1], tb(dy), torch.zeros((B, H)).bfloat16(),
        torch.zeros((B, H)).bfloat16())
    np.testing.assert_allclose(du.float().numpy(),
                               np.asarray(du_ref.astype(jnp.float32)),
                               rtol=2 ** -6, atol=2 ** -9)
