"""The port's LSTM recurrences (bayeslms_tpu_torch.ops) against the JAX
package: the plain twin of the fused 2-layer CUDA kernel against the Pallas
kernel it replaces (interpret mode), and the single-layer scan against the
JAX scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm as jlstm
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.ops import lstm_cuda

T, B, E, H = 12, 8, 16, 16
CASES = [(False, False), (True, False), (True, True)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(lp, "_INTERPRET", True)


def _params(rng, IN, scale=0.1):
    return [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((4 * H, IN), scale), ((4 * H, H), scale), ((4 * H,), 0.1),
        ((4 * H,), 0.1))]


def _inputs(masked, reset, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    p1, p2 = _params(rng, E), _params(rng, H)
    h0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.1
    mask = rmask = rsrc = None
    if masked:
        mask = np.ones((T, B), np.float32)
        mask[7:, 1:4] = 0.0
        mask[:2, 6] = 0.0
    if reset:
        rmask = np.zeros((T, B), np.float32)
        rmask[5, :4] = 1.0
        rmask[8, 4:] = 1.0
        rmask[10, 2] = 1.0
        rsrc = ((np.arange(B) // 4) * 4).astype(np.int32)
        rsrc[[2, 7]] = -1  # zero-state resets
    return x, p1, p2, h0, c0, mask, rmask, rsrc


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked,reset", CASES)
def test_lstm2_plain_matches_pallas_kernel(masked, reset):
    x, p1, p2, h0, c0, mask, rmask, rsrc = _inputs(masked, reset)
    ys, (hA, hB), (cA, cB) = lp.lstm2_layer_pallas(
        jnp.asarray(x), h0[0], c0[0], h0[1], c0[1], *map(jnp.asarray, p1),
        *map(jnp.asarray, p2), _j(mask), _j(rmask), _j(rsrc))
    got = tlstm.lstm_stack2(
        torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(c0),
        tlstm.LSTMParams(*map(torch.from_numpy, p1)),
        tlstm.LSTMParams(*map(torch.from_numpy, p2)),
        _t(mask), _t(rmask), _t(rsrc))
    for g, r in zip((got[0], *got[1], *got[2]), (ys, hA, hB, cA, cB)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked,reset", CASES)
def test_lstm_layer_matches_jax_scan(masked, reset):
    x, p1, _, h0, c0, mask, rmask, rsrc = _inputs(masked, reset, seed=4)
    ys, hT, cT = jlstm.lstm_layer(
        jnp.asarray(x), jnp.asarray(h0[0]), jnp.asarray(c0[0]),
        jlstm.LSTMParams(*map(jnp.asarray, p1)), step_mask=_j(mask),
        reset_mask=_j(rmask), reset_src=_j(rsrc))
    got = tlstm.lstm_layer(
        torch.from_numpy(x), torch.from_numpy(h0[0]), torch.from_numpy(c0[0]),
        tlstm.LSTMParams(*map(torch.from_numpy, p1)), _t(mask), _t(rmask),
        _t(rsrc))
    for g, r in zip(got, (ys, hT, cT)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_lstm2_wrapper_counts_no_cpu_launch():
    """CPU tensors take the plain version; only kernel launches count."""
    x, p1, p2, h0, c0, mask, rmask, rsrc = _inputs(True, True)
    before = lstm_cuda.launches
    tlstm.lstm_stack2(torch.from_numpy(x), torch.from_numpy(h0),
                      torch.from_numpy(c0),
                      tlstm.LSTMParams(*map(torch.from_numpy, p1)),
                      tlstm.LSTMParams(*map(torch.from_numpy, p2)),
                      _t(mask), _t(rmask), _t(rsrc))
    assert lstm_cuda.launches == before


def test_lstm2_plain_bf16_rounds_like_the_tpu_kernel():
    """In bf16 the plain twin rounds the products' h operand and the outputs
    to bf16 while carrying fp32 state, as the Pallas kernel does. No resets
    here: at a reset the TPU kernel rounds the state to bf16 and the port,
    by design, does not."""
    x, p1, p2, h0, c0, mask, _, _ = _inputs(True, False, seed=9)
    bf = jnp.bfloat16
    ys, (hA, hB), (cA, cB) = lp.lstm2_layer_pallas(
        jnp.asarray(x, bf), h0[0], c0[0], h0[1], c0[1], *map(jnp.asarray, p1),
        *map(jnp.asarray, p2), _j(mask))
    got = tlstm.lstm_stack2(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(h0).bfloat16(),
        torch.from_numpy(c0).bfloat16(),
        tlstm.LSTMParams(*map(torch.from_numpy, p1)),
        tlstm.LSTMParams(*map(torch.from_numpy, p2)), _t(mask))
    for g, r in zip((got[0], *got[1], *got[2]), (ys, hA, hB, cA, cB)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=0, atol=2 ** -7)
