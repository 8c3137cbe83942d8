"""The vocabulary-sharded CE (``ops/ce_train_cuda.py`` ``shard_lse_t``,
``local_targets``, ``merge_partials``) against the JAX package's
``_shard_lse_t`` and ``fused_decode_ce_train_spmd`` (``ops/ce_pallas.py``,
its Pallas kernels in interpret mode), with no processes: the port loops
over the shards where JAX runs its shard_map. Also the plain twins of rows
9-11 with -1 targets, which hit no word. Tolerance rtol 2e-4 / atol 1e-5
(the golden tests')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import ce_pallas as cp
from bayeslms_tpu.parallel.mesh import make_mesh
from bayeslms_tpu_torch.ops import ce_train_cuda as ctc

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(cp, "_INTERPRET", True)
    monkeypatch.setattr(cp, "_BM_TRAIN", 8)
    monkeypatch.setattr(cp, "_BV", 128)


def _inputs(seed, M, D, V):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, D)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32) * 0.5,
            rng.normal(size=(V,)).astype(np.float32),
            rng.integers(0, V, M).astype(np.int32),
            rng.normal(size=(M,)).astype(np.float32),
            rng.normal(size=(M,)).astype(np.float32))


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_shard_partials_and_their_vjp_match_jax(shard, interpret):
    """One shard's (lse, t) with real off-shard targets, and the backward's
    dh, dE, db for random cotangents (d_lse, d_t): rows 10-11's (a, b)
    form."""
    M, D, V, tp = 21, 16, 60, 3
    h, emb, bias, tgt, g_lse, g_t = _inputs(shard, M, D, V)
    v_loc = V // tp
    rows = slice(shard * v_loc, (shard + 1) * v_loc)
    tl = ctc.local_targets(torch.from_numpy(tgt), shard, v_loc)
    assert bool((tl == -1).any()) and bool((tl >= 0).any())

    def jfn(h_, e_, b_):
        lse, t = cp._shard_lse_t(h_, e_, b_, jnp.asarray(tl.numpy(),
                                                          jnp.int32))
        return jnp.sum(lse * g_lse) + jnp.sum(t * g_t), (lse, t)

    (_, (rl, rt)), rg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(h), jnp.asarray(emb[rows]), jnp.asarray(bias[rows]))
    th, te, tb = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
                  for a in (h, emb[rows], bias[rows]))
    lse, t = ctc.shard_lse_t(th, te, tb, tl)
    ((lse * torch.from_numpy(g_lse)).sum()
     + (t * torch.from_numpy(g_t)).sum()).backward()
    for got, ref, name in ((lse, rl, "lse"), (t, rt, "t"),
                           (th.grad, rg[0], "dh"), (te.grad, rg[1], "dE"),
                           (tb.grad, rg[2], "db")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert float(t.detach()[tl < 0].abs().max()) == 0.0


def test_merged_partials_match_jax_spmd_on_a_2x2_mesh(interpret):
    """``fused_decode_ce_train_spmd`` on a (2, 2) mesh (as
    tests/test_multichip.py runs it) against the port's shard loop: each dp
    block's tokens, each tp shard's rows, the partials merged; the value
    and dh, dE, db of sum(ce * w)."""
    T, B, D, V = 6, 8, 32, 96
    rng = np.random.default_rng(5)
    h = rng.normal(size=(T, B, D)).astype(np.float32)
    emb = rng.normal(size=(V, D)).astype(np.float32)
    bias = rng.normal(size=(V,)).astype(np.float32)
    tgt = rng.integers(0, V, (T, B)).astype(np.int32)
    w = rng.normal(size=(T, B)).astype(np.float32)
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])

    def spmd_loss(h_, e_, b_):
        ce = cp.fused_decode_ce_train_spmd(h_, e_, b_, jnp.asarray(tgt), mesh)
        return (ce * w).sum()

    with mesh:
        ref_v, ref_g = jax.value_and_grad(spmd_loss, argnums=(0, 1, 2))(
            jnp.asarray(h), jnp.asarray(emb), jnp.asarray(bias))

    dp, tp = 2, 2
    th = torch.from_numpy(h).requires_grad_()
    shards = [(torch.from_numpy(emb[k * V // tp:(k + 1) * V // tp])
               .requires_grad_(),
               torch.from_numpy(bias[k * V // tp:(k + 1) * V // tp])
               .requires_grad_()) for k in range(tp)]
    loss = 0.0
    for d in range(dp):
        cols = slice(d * B // dp, (d + 1) * B // dp)
        hb = th[:, cols].reshape(-1, D)
        tb = torch.from_numpy(tgt[:, cols].reshape(-1))
        parts = [ctc.shard_lse_t(hb, e, b, ctc.local_targets(tb, k, V // tp))
                 for k, (e, b) in enumerate(shards)]
        ce = ctc.merge_partials(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
        loss = loss + (ce.reshape(T, -1) * torch.from_numpy(w[:, cols])).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_v), rtol=1e-5)
    got = (th.grad, torch.cat([e.grad for e, _ in shards]),
           torch.cat([b.grad for _, b in shards]))
    for g, r, name in zip(got, ref_g, ("dh", "dE", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_plain_twins_never_hit_a_minus_one_target():
    """A -1 target hits no word in the forward (its logit counts as 0, ce =
    lse) and the backward (b is not added anywhere; before, the twin's
    index wrapped to the last row), against float64 on the same inputs."""
    M, D, V = 9, 256, 7
    h, emb, bias, tgt, a, b = _inputs(3, M, D, V)
    tgt[::2] = -1
    H, E, Bv = (torch.from_numpy(x) for x in (h, emb, bias))
    t = torch.from_numpy(tgt)
    ce, mx, se = ctc.ce_train_fwd_plain(H, E, Bv, t)
    s = h.astype(np.float64) @ emb.T.astype(np.float64) + bias
    lse = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    hit = tgt >= 0
    tl = np.where(hit, s[np.arange(M), np.clip(tgt, 0, None)], 0.0)
    np.testing.assert_allclose(ce.numpy(), lse - tl, rtol=1e-5, atol=1e-5)
    p = np.exp(s - lse[:, None])
    d = a[:, None] * p
    d[np.arange(M)[hit], tgt[hit]] += b[hit]
    A, Bt = torch.from_numpy(a), torch.from_numpy(b)
    dh = ctc.ce_train_dh_plain(H, E, Bv, t, mx, se, A, Bt)
    de, db = ctc.ce_train_de_plain(H, E, Bv, t, mx, se, A, Bt)
    np.testing.assert_allclose(dh.numpy(), d @ emb, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(de.numpy(), d.T @ h, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(db.numpy(), d.sum(0), rtol=RTOL, atol=ATOL)
    # the last row takes no b from the -1 targets
    only = np.where(hit, 0.0, 1.0).astype(np.float32)
    _, db0 = ctc.ce_train_de_plain(H, E, Bv, t, mx, se,
                                   torch.zeros(M), torch.from_numpy(only))
    assert float(db0.abs().max()) == 0.0
