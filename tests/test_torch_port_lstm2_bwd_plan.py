"""The fused 2-layer LSTM training backward's designs (kernel row 8,
``csrc/lstm2_train.cu``) on the CPU.

- The rule ``_design(B, H, n_sm, T)`` that picks the persistent design
  (the gate GEMM, then one cooperative launch) or the per-step kernels,
  and the persistent plan: CTAs, units, the recurrence's shared memory
  within the 232,448 bytes a CTA may take, the GEMM's grid, every hidden
  unit owned once.
- A Python model of the persistent design: the three gate products for all
  T steps first (stage 1), then the recurrence with layer 2 one step ahead
  of layer 1 (iteration k runs layer 2 at t = T - 1 - k and layer 1 at
  t + 1, on the inj and dh carries of iteration k - 1), the dh and inj
  products CTA by CTA on the resident column slices. In float32 it equals
  the JAX package's ``_train2_bwd_run`` in interpret mode, masked and
  dropped, and the plain twin ``lstm2_train_bwd_plain``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
from bayeslms_tpu_torch.ops.lstm_train_cuda import cell_grads

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448
RTOL, ATOL = 2e-4, 1e-5


@pytest.mark.parametrize("B,H", [(32, 1024), (20, 1024), (32, 512),
                                 (1, 32), (32, 1056)])
def test_persistent_design_where_it_fits(B, H):
    plan = l2c._design(B, H, N_SM, T=100)
    assert plan["design"] == "persistent"
    assert plan["units"] == 8 and plan["ctas"] == H // 8 <= N_SM
    assert plan["grid"] == (H // 8,) and plan["threads"] == 512
    assert plan["smem_bytes"] == l2c.persist_smem(H) <= SMEM_LIMIT
    assert plan["gemm_grid"] == (4 * H // 128, -(-100 * B // 128), 2)
    assert plan["gemm_smem_bytes"] <= SMEM_LIMIT
    assert plan["launches"] == 2 and plan["barriers"] == 101
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once, both layers


def test_persistent_plan_at_the_training_shape():
    # T 100, B 32, H 1,024: 128 CTAs; W_hh2's, W_ih2's and W_hh1's 4H x 8
    # column slices 66 KB each, the two warp groups' partial tiles 24 KB;
    # the GEMM 32 x 25 tiles of 128 x 128 for each layer, six 32 KB stages
    plan = l2c._design(32, 1024, N_SM, T=100)
    assert (plan["ctas"], plan["smem_bytes"]) == (128, 222720)
    assert l2c.persist_smem(1024) == 3 * 8 * 4128 * 2 + 8 * 32 * 24 * 4
    assert plan["gemm_grid"] == (32, 25, 2)
    assert plan["gemm_smem_bytes"] == 1024 + 6 * 32768 + 96 == 197728


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (37, 64, N_SM),     # the card test's shape
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs: more than the SMs
    (32, 2048, N_SM),   # 256 CTAs, and 418 KB a CTA
    (32, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs at once
])
def test_per_step_design_takes_the_rest(B, H, n_sm):
    plan = l2c._design(B, H, n_sm, T=100)
    assert plan["design"] == "per_step"
    assert plan["grid"] == (-(-B // 32), H // 32)
    assert plan["launches"] == 400 and plan["barriers"] == 0
    assert plan["gemm_grid"] is None


def test_persistent_shared_memory_bounds_the_width():
    # the widest H whose CTA fits 232,448 bytes, on a card with SMs enough
    widest = max(H for H in range(8, 4096, 8)
                 if l2c.persist_smem(H) <= SMEM_LIMIT)
    assert widest == 1072
    assert l2c._design(32, widest, 1000)["design"] == "persistent"
    assert l2c._design(32, widest + 8, 1000)["design"] == "per_step"


def persistent_model(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01,
                     c01, h02, c02, ys1, cs1, ys2, cs2, dy1, dy2, dhT1, dcT1,
                     dhT2, dcT2, units=8):
    """Row 8's persistent design in PyTorch: stage (1), G1 = (xg1 + h1p
    W_hh1^T) + b_hh1 and G2 = (h1d W_ih2^T + h2p W_hh2^T) + b2 for every
    step, from ``lstm2_bwd_operands``; stage (2), iterations k = 0..T, each
    (a) the two layers' cell backward (layer 2 at t = T - 1 - k, layer 1 at
    t + 1) on what the owners hold, then, past the grid barrier, (b) CTA by
    CTA (units [c, c + units)) the products on their column slices: dh2 and
    inj from all of du2[t], dh1 from all of du1[t + 1]."""
    T, B, G = xg1.shape
    H = G // 4
    dtype, f32 = w_hh1.dtype, torch.float32
    w1, wi2, w2 = (w.to(f32) for w in (w_hh1, w_ih2, w_hh2))
    h1p, h1d, h2p = (o.to(f32) for o in l2c.lstm2_bwd_operands(
        dm, h01, h02, ys1, ys2))
    M = T * B
    g1 = ((xg1.reshape(M, G).to(f32) + h1p @ w1.t()) + b_hh1).reshape(T, B, G)
    g2 = ((h1d @ wi2.t() + h2p @ w2.t()) + b2).reshape(T, B, G)

    dh1, dc1, dh2, dc2 = (s.to(f32).clone() for s in (dhT1, dcT1, dhT2,
                                                      dcT2))
    du1 = torch.empty((T, B, G), dtype=dtype)
    du2 = torch.empty_like(du1)
    inj = torch.zeros((B, H))
    carry1 = carry2 = None

    def keep(s):
        return (torch.ones(B, 1) if mask is None
                else mask[s].to(f32)[:, None])

    def c_prev(s, c0, cs):
        return (c0 if s == 0 else cs[s - 1]).to(f32)

    for k in range(T + 1):
        t = T - 1 - k
        if t >= 0:  # (a) layer 2 at t
            tot = dh2 + dy2[t].to(f32)
            du2[t], dc2 = cell_grads(g2[t], c_prev(t, c02, cs2), keep(t), tot,
                                     dc2, dtype)
            carry2 = (1.0 - keep(t)) * tot
        if t + 1 < T:  # (a) layer 1 at t + 1, with inj of iteration k - 1
            s = t + 1
            tot = dh1 + (dy1[s].to(f32) + inj)
            du1[s], dc1 = cell_grads(g1[s], c_prev(s, c01, cs1), keep(s), tot,
                                     dc1, dtype)
            carry1 = (1.0 - keep(s)) * tot
        # (b) past the barrier: every CTA reads all of du2[t] and du1[t + 1]
        for c0 in range(0, H, units):
            cols = slice(c0, c0 + units)
            if t >= 0:
                a = du2[t].to(f32)
                dh2[:, cols] = a @ w2[:, cols] + carry2[:, cols]
                inj[:, cols] = (a @ wi2[:, cols]) * dm[t][:, cols].to(f32)
            if t + 1 < T:
                dh1[:, cols] = du1[t + 1].to(f32) @ w1[:, cols] \
                    + carry1[:, cols]
    return (du1, du2, *(s.to(dtype) for s in (dh1, dc1, dh2, dc2)))


def _inputs(T, B, H, masked, dropped, seed):
    """Float32 arguments of ``lstm2_train_bwd``: the forward twin's outputs
    on random weights, random dy and final-state gradients."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    sw = H ** -0.5
    G = 4 * H
    xg1 = r(T, B, G)
    dm = torch.from_numpy(((rng.uniform(size=(T, B, H)) < 0.8) / 0.8)
                          .astype(np.float32)) if dropped \
        else torch.ones((T, B, H))
    w_hh1, b_hh1, w_ih2, w_hh2, b2 = (r(G, H, sc=sw), r(G, sc=0.1),
                                      r(G, H, sc=sw), r(G, H, sc=sw),
                                      r(G, sc=0.1))
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    states = [r(B, H, sc=0.5) for _ in range(4)]
    fwd = l2c.lstm2_train_fwd_plain(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2,
                                    mask, *states)
    grads = [r(T, B, H), r(T, B, H)] + [r(B, H, sc=0.5) for _ in range(4)]
    return [xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, *states,
            *fwd[:4], *grads]


def _pallas_bwd(args):
    """``_train2_bwd_run`` of the JAX package on the same arguments (its
    layout: transposed weights, (1, 4H) biases, the mask as (T, B, 8),
    h_{t-1} and c_{t-1} sequences)."""
    (xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01, h02, c02, ys1,
     cs1, ys2, cs2, dy1, dy2, dhT1, dcT1, dhT2, dcT2) = \
        [None if a is None else a.numpy() for a in args]
    T, B, G = xg1.shape
    m = np.ones((T, B), np.float32) if mask is None else mask.astype(
        np.float32)
    prev = lambda s0, seq: np.concatenate([s0[None], seq[:-1]])  # noqa: E731
    out = lp._train2_bwd_run(*map(jnp.asarray, (
        xg1, ys1, dm, prev(h01, ys1), prev(c01, cs1), prev(h02, ys2),
        prev(c02, cs2), dy1, dy2, np.broadcast_to(m[:, :, None], (T, B, 8)),
        w_hh1.T, b_hh1[None], w_ih2.T, w_hh2.T, b2[None], dhT1, dcT1, dhT2,
        dcT2)))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("T,B,H,masked,dropped", [
    (6, 4, 16, True, True), (5, 3, 24, False, True), (7, 5, 8, True, False),
    (4, 6, 32, False, False), (1, 2, 16, True, True)])
def test_persistent_model_equals_the_pallas_kernel(monkeypatch, T, B, H,
                                                   masked, dropped):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    args = _inputs(T, B, H, masked, dropped, seed=T * B + H)
    got = persistent_model(*args)
    ref = _pallas_bwd(args)
    names = ("du1", "du2", "dh01", "dc01", "dh02", "dc02")
    for g, r, name in zip(got, ref, names):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("units", [8, 16])
def test_persistent_model_equals_the_plain_twin(units):
    args = _inputs(9, 7, 32, True, True, seed=3)
    got = persistent_model(*args, units=units)
    ref = l2c.lstm2_train_bwd_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_bf16_operands_round_as_the_twin():
    # in bf16 the model's hoisted products and the twin's step products
    # see the same rounded operands; only the fp32 sums' order differs
    args = _inputs(6, 5, 16, True, True, seed=11)
    bf = torch.bfloat16
    for i, a in enumerate(args):
        if i not in (3, 6, 7):  # the float32 biases, the mask
            args[i] = a.to(bf)
    got = persistent_model(*args)
    ref = l2c.lstm2_train_bwd_plain(*args)
    for g, r in zip(got, ref):
        assert g.dtype == bf
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -6,
                                   atol=1e-5)
