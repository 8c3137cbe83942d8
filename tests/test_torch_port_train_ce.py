"""The port's differentiable fused decoder CE
(``ops.ce_train_cuda.fused_decode_ce_train`` on its kernels' plain twins)
against the JAX package's ``fused_decode_ce_train`` in interpret mode, with
small tiles (8 tokens, 128 vocabulary rows) and ragged M = 15, V = 200:
value, dh, dE, db and the forward's statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu_torch.ops import ce_train_cuda

T, B, D, V = 5, 3, 16, 200


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM_TRAIN", 8)
    monkeypatch.setattr(cp, "_BV", 128)


def _inputs():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(T * B, D)).astype(np.float32)
    emb = rng.normal(size=(V, D)).astype(np.float32) * 0.3
    bias = rng.normal(size=(V,)).astype(np.float32) * 0.1
    tgt = rng.integers(0, V, size=(T * B,)).astype(np.int32)
    tgt[0] = V - 1  # the ragged last vocabulary tile
    w = rng.uniform(0.2, 1.0, size=(T * B,)).astype(np.float32)
    return h, emb, bias, tgt, w


# PLAIN_ROWS 4 puts the 15 tokens across four chunks of the plain twins
@pytest.mark.parametrize("rows", [4096, 4])
def test_fused_decode_ce_train_matches_jax(monkeypatch, rows):
    monkeypatch.setattr(ce_train_cuda, "PLAIN_ROWS", rows)
    h, emb, bias, tgt, w = _inputs()

    def loss(h, emb, bias):
        return (cp.fused_decode_ce_train(h, emb, bias, jnp.asarray(tgt))
                * w).sum()

    v_ref, g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias))
    th, te, tbias = (torch.tensor(a, requires_grad=True)
                     for a in (h, emb, bias))
    before = dict(ce_train_cuda.launches)
    ce = ce_train_cuda.fused_decode_ce_train(th, te, tbias,
                                             torch.from_numpy(tgt).long())
    v = (ce * torch.from_numpy(w)).sum()
    v.backward()
    assert ce_train_cuda.launches == before  # CPU: plain twins
    assert ce.dtype == torch.float32 and ce.shape == (T * B,)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    for a, b, name in zip((th.grad, te.grad, tbias.grad), g_ref,
                          ("dh", "dE", "db")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_ce_train_stats_match_pallas_kernel():
    """ce, max and sumexp of the forward twin against ``_run_fwd_stats``
    (inputs padded as the JAX package pads them)."""
    h, emb, bias, tgt, _ = _inputs()
    hf, embp, biasp, tf, M, _ = cp._pad_inputs(
        jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias),
        jnp.asarray(tgt), 8, 128)
    tgt8 = jnp.broadcast_to(tf[:, None], (tf.shape[0], 8))
    ref = cp._run_fwd_stats(hf, embp, biasp, tgt8, 8, 128)
    got = ce_train_cuda.ce_train_fwd(*map(torch.from_numpy, (h, emb, bias)),
                                      torch.from_numpy(tgt).long())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:M], rtol=1e-5,
                                   atol=1e-5)


def test_ce_train_plain_empty():
    z = torch.zeros((0, 8))
    out = ce_train_cuda.ce_train_fwd_plain(z, torch.ones((5, 8)),
                                           torch.zeros(5),
                                           torch.zeros(0, dtype=torch.long))
    assert [t.shape for t in out] == [(0,)] * 3
