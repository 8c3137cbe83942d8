"""Kernel rows 3-4's plain twin (``ops.lstm_cuda.lstm_fwd_plain``, reached
through ``ops.lstm.lstm_layer_fwd`` and ``lstm_cuda.lstm_fwd`` on CPU
tensors) against the JAX package's ``lstm_layer_pallas`` in interpret mode:
with and without a step mask, with packed resets (-1 sources among them),
float32 at rtol 1e-5 / atol 1e-5; in bf16 without resets within one bf16
step, as the 2-layer kernel's twin is held."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.ops import lstm_cuda

T, B, E, H = 12, 8, 16, 16


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(lp, "_INTERPRET", True)


def _inputs(masked, reset, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    p = [rng.normal(size=s).astype(np.float32) * 0.2 for s in (
        (4 * H, E), (4 * H, H), (4 * H,), (4 * H,))]
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.3
    c0 = rng.normal(size=(B, H)).astype(np.float32) * 0.3
    mask = rmask = rsrc = None
    if masked:
        mask = np.ones((T, B), np.float32)
        mask[7:, 1:4] = 0.0
        mask[:2, 6] = 0.0
        mask[5, 0] = 0.0  # a masked reset step: the column keeps its source's state
    if reset:
        rmask = np.zeros((T, B), np.float32)
        rmask[5, :4] = 1.0
        rmask[8, 4:] = 1.0
        rmask[10, 2] = 1.0
        rsrc = ((np.arange(B) // 4) * 4).astype(np.int32)
        rsrc[[2, 7]] = -1  # zero-state resets
    return x, p, h0, c0, mask, rmask, rsrc


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("masked,reset", CASES)
def test_twin_matches_pallas_kernel(masked, reset):
    x, p, h0, c0, mask, rmask, rsrc = _inputs(masked, reset, seed=3)
    ref = lp.lstm_layer_pallas(jnp.asarray(x), jnp.asarray(h0),
                               jnp.asarray(c0), *map(jnp.asarray, p),
                               _j(mask), reset_mask=_j(rmask),
                               reset_src=_j(rsrc))
    before = dict(lstm_cuda.layer_launches)
    got = tlstm.lstm_layer_fwd(torch.from_numpy(x), torch.from_numpy(h0),
                               torch.from_numpy(c0),
                               tlstm.LSTMParams(*map(torch.from_numpy, p)),
                               _t(mask), _t(rmask), _t(rsrc))
    assert lstm_cuda.layer_launches == before  # CPU: the twin, no launch
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("masked,reset", CASES)
def test_twin_matches_the_scan(masked, reset):
    """In float32 the kernel's arithmetic and the JAX scan's (the port's
    ``lstm_layer`` on a CPU tensor) agree."""
    x, p, h0, c0, mask, rmask, rsrc = _inputs(masked, reset, seed=5)
    prm = tlstm.LSTMParams(*map(torch.from_numpy, p))
    args = (torch.from_numpy(x), torch.from_numpy(h0), torch.from_numpy(c0),
            prm, _t(mask), _t(rmask), _t(rsrc))
    for g, r in zip(tlstm.lstm_layer_fwd(*args),
                    tlstm.lstm_layer(*args, allow_kernel=True)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_twin_bf16_rounds_like_the_tpu_kernel(masked):
    """In bf16 the twin rounds the product's h operand, the bias and the
    outputs to bf16 while carrying fp32 state, as the Pallas kernel does.
    No resets here: at a reset the TPU kernel rounds the state to bf16
    and the port, by design, does not."""
    x, p, h0, c0, mask, _, _ = _inputs(masked, False, seed=9)
    bf = jnp.bfloat16
    ref = lp.lstm_layer_pallas(jnp.asarray(x, bf), jnp.asarray(h0),
                               jnp.asarray(c0), *map(jnp.asarray, p),
                               _j(mask))
    got = tlstm.lstm_layer_fwd(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(h0), torch.from_numpy(c0),
                               tlstm.LSTMParams(*map(torch.from_numpy, p)),
                               _t(mask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=0, atol=2 ** -7)


def test_reset_takes_the_fp32_source_state():
    """The deliberate difference at a reset: the twin (and the kernel)
    gather the source column's fp32 state; -1 gives zeros."""
    h = torch.tensor([[1.0 + 2 ** -12], [3.0]])
    got = lstm_cuda.apply_reset(h, torch.tensor([1, 1]),
                                torch.tensor([0, -1], dtype=torch.int32))
    assert got[0, 0] == 1.0 + 2 ** -12 and got[1, 0] == 0.0
