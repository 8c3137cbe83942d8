"""The port's gate-slice noise sampler (``ops.bayes_sample_cuda``: the plain
twin of ``csrc/bayes_sample.cu`` on the CPU) against its definition and the
JAX package's ``sample_noise``.

The TPU's generator bits cannot be reproduced (and are degenerate in
interpret mode), so the twin is held to its own definition (Philox4x32-10
against a pure-Python Philox with Python integers, the TPU's Box-Muller
arithmetic), to the moments of N(0, 1) within 5 sigma, and, beside the JAX
interpret-mode kernel, to the gradient identity d/dlgstd = noise. Float32;
tolerances are stated per check."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayeslms_tpu.ops import bayes_matmul as bm
from bayeslms_tpu_torch.ops import bayes_sample_cuda as bs

_U32 = 0xFFFFFFFF


def _philox_py(ctr, k0, k1=0):
    """Philox4x32-10 (Random123) with Python's unbounded integers."""
    c = [ctr, 0, 0, 0]
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _U32, (k1 + 0xBB67AE85) & _U32
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _U32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & _U32]
    return c


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def test_philox_matches_its_definition():
    # Random123's known answer for counter 0, key 0
    got = bs.philox4x32_10(torch.tensor([0]), torch.tensor([0]), 0)
    assert [int(w) for w in got] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64).tolist()
    key = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64).tolist()
    got = bs.philox4x32_10(torch.tensor(ctr), torch.tensor(key), 77)
    for i, (c, k) in enumerate(zip(ctr, key)):
        assert [int(w[i]) for w in got] == _philox_py(c, k, 77)


def test_uniforms_follow_the_tile_keyed_stream():
    """Element e of tile j takes Philox(seed + j, e // 2)'s words (0, 1) or
    (2, 3) by the parity of e, shifted to 24 bits; the seed sum wraps in
    uint32."""
    N, K = 300, 6  # a ragged last tile
    for s in (5, 2 ** 31 - 1):
        u1, u2 = bs.uniforms_plain(_seed(s), (N, K))
        for r, c in ((0, 0), (0, 5), (127, 3), (128, 0), (299, 5), (200, 1)):
            tile, off = divmod(r * K + c, 128 * K)
            w = _philox_py(off // 2, (s + tile) & _U32)
            w1, w2 = (w[0], w[1]) if off % 2 == 0 else (w[2], w[3])
            assert float(u1[r, c]) == np.float32(
                np.float32(w1 >> 8) * np.float32(2 ** -24)
                + np.float32(1e-12))
            assert float(u2[r, c]) == np.float32(w2 >> 8) * np.float32(
                2 ** -24)
        assert 0 < float(u1.min()) and float(u1.max()) <= 1
        assert 0 <= float(u2.min()) and float(u2.max()) < 1


def test_twin_is_deterministic_per_seed_and_tiles_differ():
    a = bs.normal_plain(_seed(11), (512, 256))
    b = bs.normal_plain(_seed(11), (512, 256))
    c = bs.normal_plain(_seed(12), (512, 256))
    assert torch.equal(a, b)
    n = 128 * 256
    bound = 5 / math.sqrt(n)
    for x, y in ((a[:128], a[128:256]), (a[256:384], a[384:]),
                 (a[:128], c[:128])):
        r = float(torch.corrcoef(torch.stack([x.reshape(-1),
                                              y.reshape(-1)]))[0, 1])
        assert abs(r) < bound, (r, bound)
    # seed s, tile j+1 is seed s+1, tile j: the TPU's seed + tile key
    assert torch.equal(a[128:256], c[:128])
    # the draw of a row block does not depend on the shape it is drawn in
    assert torch.equal(bs.normal_plain(_seed(11), (256, 256)), a[:256])


def test_moments_of_a_full_slice_within_5_sigma():
    n = 1024 * 1024
    eps = bs.normal_plain(_seed(2024), (1024, 1024)).double().reshape(-1)
    assert torch.isfinite(eps).all()
    mean, var = float(eps.mean()), float(eps.var())
    kurt = float(((eps - mean) ** 4).mean()) / var ** 2
    assert abs(mean) < 5 / math.sqrt(n)
    assert abs(var - 1) < 5 * math.sqrt(2 / n)
    assert abs(kurt - 3) < 5 * math.sqrt(24 / n)


def test_sample_weights_is_mean_plus_scaled_eps():
    rng = np.random.default_rng(3)
    mean = torch.from_numpy(rng.normal(size=(256, 384)).astype(np.float32))
    lg = torch.from_numpy(rng.uniform(-4, 0, size=(256, 384))
                          .astype(np.float32))
    eps = bs.normal_plain(_seed(9), (256, 384))
    got = bs.sample_weights(mean, lg, _seed(9))
    torch.testing.assert_close(got, mean + torch.exp(lg) * eps, rtol=0,
                               atol=0)
    torch.testing.assert_close(bs.sample_weights(None, lg, _seed(9)),
                               torch.exp(lg) * eps, rtol=0, atol=0)
    assert bs.launches == 0  # CPU tensors never reach the kernel


def test_sample_noise_gradient_is_the_noise(monkeypatch):
    """d/dlgstd sum(n^2)/2 = n^2, the identity the JAX interpret-mode
    kernel shows (tests/test_pallas_kernels.py), run beside it; rtol 1e-5
    as there."""
    monkeypatch.setattr(bm, "_INTERPRET", pltpu.InterpretParams())
    lg_np = np.full((128, 128), -0.7, np.float32)
    jseed = jnp.asarray([3], jnp.int32)
    jn = bm.sample_noise(jnp.asarray(lg_np), jseed)
    jg = jax.grad(lambda lg: jnp.sum(bm.sample_noise(lg, jseed) ** 2) / 2)(
        jnp.asarray(lg_np))
    np.testing.assert_allclose(np.asarray(jg), np.asarray(jn) ** 2, rtol=1e-5)

    lg = torch.from_numpy(lg_np).requires_grad_(True)
    n = bs.sample_noise(lg, _seed(3))
    (n ** 2 / 2).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), n.detach().numpy() ** 2,
                               rtol=1e-5)
    torch.testing.assert_close(n.detach(), torch.exp(lg.detach()) *
                               bs.normal_plain(_seed(3), (128, 128)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1024, 1024), (256, 384), (1024,),
                                   (100, 128), (128, 100), (128, 128, 2)])
def test_gate_admits_the_shapes_the_jax_gate_admits(shape, monkeypatch):
    """The shape rule equals the JAX gate's on a TPU (its platform faked);
    a CPU tensor is never admitted, so the CPU model draws with
    ``gaussian.sample_diff``, as the JAX package does off the TPU."""
    from types import SimpleNamespace

    monkeypatch.setattr(bm.jax, "devices",
                        lambda: [SimpleNamespace(platform="tpu")])
    assert bs.tile_shape_ok(shape) == bm.sample_noise_ok(shape)
    assert not bs.sample_noise_ok(torch.zeros(shape))


# ------------------------------------------------ a step's slices at once

def _slices(seed):
    """Four slices of the shapes a table takes: two 128-row tiles, a
    ragged last tile, a slice whose count ends in a pair (N K % 4 = 2)."""
    rng = np.random.default_rng(seed)
    shapes = ((256, 384), (128, 128), (300, 6), (3, 2))
    lgs = [torch.from_numpy(rng.uniform(-4, 0, size=s).astype(np.float32))
           for s in shapes]
    means = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
             if i % 2 else None for i, s in enumerate(shapes)]
    seeds = torch.tensor([7, 2 ** 31 - 2, 0, 123], dtype=torch.int32)
    return lgs, means, seeds


def test_slices_twin_is_each_slice_drawn_alone():
    """Slice i of a table is ``sample_weights_plain`` under ``seeds[i]``,
    bit for bit, with and without a mean; the CPU route takes the twin."""
    lgs, means, seeds = _slices(1)
    for ms in (None, means):
        got = bs.sample_slices(lgs, seeds, ms)
        for i, (lg, g) in enumerate(zip(lgs, got)):
            m = None if ms is None else ms[i]
            assert torch.equal(g, bs.sample_weights_plain(m, lg,
                                                          seeds[i:i + 1]))
            assert torch.equal(g, bs.sample_weights(m, lg, seeds[i:i + 1]))
    # the same slices under other seeds differ everywhere but by chance
    other = bs.sample_slices_plain(lgs, seeds + 1)
    for a, b in zip(other, bs.sample_slices_plain(lgs, seeds)):
        assert float((a != b).double().mean()) > 0.99
    assert bs.launches == 0  # CPU tensors never reach the kernel


def test_sample_noises_gradient_is_each_slices_noise():
    """d/dlgstd_i sum_j(g_j * n_j) = g_i * n_i exactly, as JAX's
    ``_sample_noise_bwd`` gives slice by slice; an unused output gives a
    zero gradient."""
    lgs, _, seeds = _slices(2)
    lgr = [lg.clone().requires_grad_(True) for lg in lgs]
    noises = bs.sample_noises(lgr, seeds)
    rng = np.random.default_rng(4)
    gs = [torch.from_numpy(rng.normal(size=lg.shape).astype(np.float32))
          for lg in lgs]
    sum((g * n).sum() for g, n in zip(gs[:3], noises[:3])).backward()
    for i, (lg, g, n) in enumerate(zip(lgr, gs, noises)):
        assert torch.equal(n.detach(), bs.sample_slices_plain(
            [lgs[i]], seeds[i:i + 1])[0])
        want = g * n.detach() if i < 3 else torch.zeros_like(n)
        assert torch.equal(lg.grad, want)
