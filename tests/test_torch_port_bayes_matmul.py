"""The port's Bayesian dense layer and the plain twin of kernel row 12
(``ops/bayes_matmul_cuda.py``) on the CPU, float32.

The TPU kernel's interpret-mode bits are degenerate (PERF.md section 6), so
the noise is compared by injection, not by bits: the twin against
x (mean + exp(lgstd) eps)^T with eps from the port's sampler twin; the
three gradients against the JAX ``_bayes_matmul_bwd`` formula handed the
same W (its ``sample_weights`` replaced by the port's twin); ``BayesDense``
against the JAX layer with the same injected eps. Tolerance rtol 2e-4 /
atol 1e-5 (the golden tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu.ops.bayes_matmul as jbm
from bayeslms_tpu.models.layers import BayesDense as JBayesDense
from bayeslms_tpu.ops import gaussian as jgauss
from bayeslms_tpu_torch.core.checkpoint import params_to_jax
from bayeslms_tpu_torch.models.layers import BayesDense
from bayeslms_tpu_torch.ops import bayes_matmul_cuda as bmc
from bayeslms_tpu_torch.ops import bayes_sample_cuda as bsc

RTOL, ATOL = 2e-4, 1e-5


def _inputs(seed, M=24, N=256, K=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    mean = (rng.normal(size=(N, K)) * 0.1).astype(np.float32)
    lgstd = rng.uniform(-4, -2, size=(N, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    return x, mean, lgstd, g


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def test_twin_is_x_times_sampled_weights():
    x, mean, lgstd, _ = _inputs(0)
    seed = _seed(12345)
    eps = bsc.normal_plain(seed, mean.shape)
    w = torch.from_numpy(mean) + torch.exp(torch.from_numpy(lgstd)) * eps
    got = bmc.bayes_matmul_fwd(torch.from_numpy(x), torch.from_numpy(mean),
                               torch.from_numpy(lgstd), seed)
    np.testing.assert_allclose(got.numpy(), (torch.from_numpy(x) @ w.t())
                               .numpy(), rtol=RTOL, atol=ATOL)
    # the W of a matmul is the sampler's own draw, bit for bit
    np.testing.assert_array_equal(
        bsc.sample_weights(torch.from_numpy(mean), torch.from_numpy(lgstd),
                           seed).numpy(), w.numpy())
    other = bmc.bayes_matmul_fwd(torch.from_numpy(x), torch.from_numpy(mean),
                                 torch.from_numpy(lgstd), _seed(7))
    assert float((other - got).abs().max()) > 1e-3


def test_gradients_match_jax_formula(monkeypatch):
    """The autograd Function's dx, dmean and dlgstd against JAX's
    ``_bayes_matmul_bwd`` given the same W; the backward draws W again from
    the seed."""
    x, mean, lgstd, g = _inputs(1)
    seed = _seed(99)
    w = bsc.sample_weights_plain(torch.from_numpy(mean),
                                 torch.from_numpy(lgstd), seed)
    monkeypatch.setattr(jbm, "sample_weights",
                        lambda m, l, s: jnp.asarray(w.numpy()))
    ref = jbm._bayes_matmul_bwd(
        (jnp.asarray(x), jnp.asarray(mean), jnp.asarray(lgstd),
         jnp.asarray([99], jnp.int32)), jnp.asarray(g))
    tx, tm, tl = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, mean, lgstd))
    y = bmc.bayes_matmul(tx, tm, tl, seed)
    (y * torch.from_numpy(g)).sum().backward()
    for got, r, name in ((tx.grad, ref[0], "dx"), (tm.grad, ref[1], "dmean"),
                         (tl.grad, ref[2], "dlgstd")):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert ref[3] is None


def test_backward_regenerates_the_forward_noise(monkeypatch):
    """The backward's W is the forward's: it asks the sampler for the draw
    of the forward's seed (and the result equals the closed form with that
    W), never for another."""
    x, mean, lgstd, g = _inputs(2)
    seed = _seed(2 ** 31 - 5)
    seen = []
    real = bsc.sample_weights

    def spy(m, l, s):
        seen.append(int(s))
        return real(m, l, s)

    monkeypatch.setattr(bsc, "sample_weights", spy)
    tx, tm, tl = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, mean, lgstd))
    y = bmc.bayes_matmul(tx, tm, tl, seed)
    w = real(tm.detach(), tl.detach(), seed)
    np.testing.assert_allclose(y.detach().numpy(),
                               (tx.detach() @ w.t()).numpy(), rtol=RTOL,
                               atol=ATOL)
    (y * torch.from_numpy(g)).sum().backward()
    assert seen == [2 ** 31 - 5]
    dw = torch.from_numpy(g).t() @ tx.detach()
    np.testing.assert_allclose(tl.grad.numpy(),
                               (dw * (w - tm.detach())).numpy(), rtol=RTOL,
                               atol=ATOL)


def test_gate_matches_jax_rule():
    x = torch.zeros((24, 128))
    assert not bmc.bayes_matmul_ok(x, 256, 128)  # a CPU tensor


@pytest.fixture
def inject(monkeypatch):
    """The JAX ``gaussian.sample_diff`` hands out the given draws in call
    order."""
    def install(draws):
        it = iter(draws)

        def sample_diff(key, lgstd, scale=1.0):
            return scale * jnp.asarray(next(it)) * jnp.exp(lgstd)
        monkeypatch.setattr(jgauss, "sample_diff", sample_diff)
    return install


def test_bayes_dense_matches_jax(inject):
    """Posterior mean, a training draw with injected eps and its gradients,
    and the KL with and without a prior mean."""
    K, N = 20, 12
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 2, K)).astype(np.float32)
    eps = rng.normal(size=(N, K)).astype(np.float32)
    wout = rng.normal(size=(5, 2, N)).astype(np.float32)
    prior = rng.normal(size=(N, K)).astype(np.float32)
    layer = BayesDense(K, N)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    tree = params_to_jax(layer)
    jl = JBayesDense(K, N)
    jp = jax.tree.map(jnp.asarray, tree)
    assert jax.tree.map(np.shape, jl.init(jax.random.key(0),
                                          jnp.asarray(x))["params"]) \
        == jax.tree.map(np.shape, tree)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jl.apply({"params": jp}, jnp.asarray(x))), rtol=RTOL, atol=ATOL)

    inject([eps])

    def jloss(p):
        y = jl.apply({"params": p}, jnp.asarray(x), deterministic=False,
                     rngs={"sample": jax.random.key(1)})
        kl = jl.apply({"params": p}, method=JBayesDense.kl)
        return jnp.sum(y * wout) + kl, y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    y = layer(torch.from_numpy(x), deterministic=False,
              eps=torch.from_numpy(eps))
    ((y * torch.from_numpy(wout)).sum() + layer.kl()).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for pm in (None, prior):
        ref = jl.apply({"params": jp},
                       None if pm is None else jnp.asarray(pm),
                       method=JBayesDense.kl)
        got = layer.kl(None if pm is None else torch.from_numpy(pm))
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=RTOL,
                                   atol=ATOL)


def test_bayes_dense_fused_route(monkeypatch):
    """``use_fused`` None or False keeps the plain path; True takes row 12
    where ``bayes_matmul_ok`` admits the shape (forced here: a CPU tensor
    fails the gate), with a seed drawn from the generator, and the result is
    x W^T with the sampler's W for that seed."""
    K, N = 128, 128
    layer = BayesDense(K, N)
    layer.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(8, K))
                         .astype(np.float32))
    calls = []
    real = bmc.bayes_matmul

    def spy(*a):
        calls.append(int(a[3]))
        return real(*a)

    monkeypatch.setattr(bmc, "bayes_matmul", spy)
    for fused in (None, False, True):
        layer.use_fused = fused
        layer(x, deterministic=False, generator=torch.Generator())
    assert calls == []  # the CPU tensor fails the gate
    monkeypatch.setattr(bmc, "bayes_matmul_ok", lambda x2, n, k: True)
    gen = torch.Generator().manual_seed(5)
    y = layer(x, deterministic=False, generator=gen)
    assert len(calls) == 1
    seed = _seed(calls[0])
    w = bsc.sample_weights(layer.weight_mean.detach(),
                           layer.weight_lgstd.detach(), seed)
    np.testing.assert_allclose(y.detach().numpy(), (x @ w.t()).numpy(),
                               rtol=RTOL, atol=ATOL)
    layer.use_fused = False
    layer(x, deterministic=False, generator=gen)
    assert len(calls) == 1
