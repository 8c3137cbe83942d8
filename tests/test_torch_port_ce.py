"""The plain twin of the port's fused decoder-CE CUDA kernel
(bayeslms_tpu_torch.ops.ce_cuda) against the Pallas kernel it replaces,
``bayeslms_tpu.ops.ce_pallas.fused_decode_ce``, in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu_torch.ops import ce_cuda


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM", 8)
    monkeypatch.setattr(cp, "_BV", 128)


# M and V off the tiles (8 tokens, 128 vocabulary rows) and, with the
# plain version's chunk cut to 16 tokens, across its chunk boundaries
@pytest.mark.parametrize("M,V,D", [(37, 200, 24), (1, 130, 16), (64, 128, 32)])
def test_ce_plain_matches_pallas_kernel(monkeypatch, M, V, D):
    monkeypatch.setattr(ce_cuda, "PLAIN_ROWS", 16)
    rng = np.random.default_rng(M + V)
    h = rng.normal(size=(M, D)).astype(np.float32)
    emb = rng.normal(size=(V, D)).astype(np.float32) * 0.3
    bias = rng.normal(size=(V,)).astype(np.float32) * 0.1
    tgt = rng.integers(0, V, size=(M,)).astype(np.int32)
    tgt[0] = V - 1  # the ragged last vocabulary tile
    ref = cp.fused_decode_ce(jnp.asarray(h), jnp.asarray(emb),
                             jnp.asarray(bias), jnp.asarray(tgt))
    before = ce_cuda.launches
    got = ce_cuda.fused_decode_ce(torch.from_numpy(h), torch.from_numpy(emb),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(tgt).long())
    assert ce_cuda.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (M,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_ce_plain_empty():
    out = ce_cuda.ce_plain(torch.zeros((0, 8)), torch.ones((5, 8)),
                           torch.zeros(5), torch.zeros(0, dtype=torch.long))
    assert out.shape == (0,)
