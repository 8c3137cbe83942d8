"""The gate-6 GP-LSTM training backward's designs (kernel row 19,
``csrc/gp6_lstm.cu``, its persistent design in ``csrc/gp_persist.cuh``) on
the CPU.

- The rule ``_design(B, H, n_sm, T, row=19)`` that picks the persistent
  design (the GEMM P = hprev W'^T, then one cooperative launch) or the
  two-launch kernels, and the persistent plan: CTAs, units, the shared
  memory within the 232,448 bytes a CTA may take, the GEMM's grid, every
  hidden unit owned once.
- A Python model of the persistent design: the product on h_{t-1} for all
  T steps first, in float32 and in 64-deep chunks as the GEMM adds them;
  then, step by step, CTA by CTA (units [c, c + 8)), pre = P + b' and the
  gates xg + sum_a coef[a] act_a(pre) of its units' four gate columns, dux
  and dupre rounded to the compute dtype, the 3 x 4 dcoef terms of each
  unit summed over the batch in order and then over the steps; past the
  barrier, each CTA's dh columns from all of dupre[t]. In float32 it equals
  the JAX package's ``_gp_bwd_run`` in interpret mode (rtol 2e-4, atol
  1e-5: sums in other orders), masked and not, and the plain twin
  ``gp6_bwd_plain`` (rtol 1e-5, atol 1e-6); in bf16 the twin within one
  bf16 step (2^-6 of the value, 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import gp_lstm_pallas as gpl
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448
RTOL, ATOL = 2e-4, 1e-5
NAMES = ("dux", "dupre", "dcoef", "dh0", "dc0")


@pytest.mark.parametrize("B,H", [(32, 1024), (20, 1024), (32, 512),
                                 (1, 32), (32, 1056)])
def test_persistent_design_where_it_fits(B, H):
    plan = gpc._design(B, H, N_SM, T=100, row=19)
    assert plan["design"] == "persistent"
    assert plan["units"] == 8 and plan["ctas"] == H // 8 <= N_SM
    assert plan["grid"] == (H // 8,) and plan["threads"] == 512
    assert plan["smem_bytes"] == gpc.persist_smem(H, 19) <= SMEM_LIMIT
    assert plan["gemm_grid"] == (-(-4 * H // 128), -(-100 * B // 128), 1)
    assert plan["gemm_smem_bytes"] <= SMEM_LIMIT
    assert plan["launches"] == 2 and plan["barriers"] == 100
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once


def test_persistent_plan_at_the_training_shape():
    # T 100, B 32, H 1,024: 128 CTAs; W''s 4H x 8 column slice (rows of
    # 4H + 32 bf16) 66,048 bytes and the 16 warps' partial dh tiles 16,384,
    # which the 3 x 4 x 256 dcoef terms (12,288 bytes) reuse; the GEMM
    # 32 x 25 tiles of 128 x 128
    plan = gpc._design(32, 1024, N_SM, T=100, row=19)
    assert (plan["ctas"], plan["smem_bytes"]) == (128, 82432)
    assert gpc.persist_smem(1024, 19) == 8 * 4128 * 2 + 16 * 32 * 8 * 4
    assert 3 * 4 * 32 * 8 * 4 <= 16 * 32 * 8 * 4
    assert plan["gemm_grid"] == (32, 25, 1)


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (40, 64, N_SM),     # the card test's shape
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs: more than the SMs
    (32, 1020, N_SM),   # H not a multiple of 8
    (32, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs at once
])
def test_two_launch_design_takes_the_rest(B, H, n_sm):
    plan = gpc._design(B, H, n_sm, T=100, row=19)
    assert plan["design"] == "two_launch"
    assert plan["grid"] == (-(-B // 32), H // 32)
    assert plan["launches"] == 201 and plan["barriers"] == 0
    assert plan["gemm_grid"] is None and plan["smem_bytes"] is None


def test_persistent_shared_memory_bounds_the_width():
    # the widest H whose CTA fits 232,448 bytes, on a card with SMs enough
    widest = max(H for H in range(8, 8192, 8)
                 if gpc.persist_smem(H, 19) <= SMEM_LIMIT)
    assert widest == 3368
    assert gpc._design(32, widest, 1000, row=19)["design"] == "persistent"
    assert gpc._design(32, widest + 8, 1000, row=19)["design"] == "two_launch"


def hoisted_product(hprev, w, chunk=64):
    """P = hprev W^T in float32, the contraction in 64-deep chunks, each
    chunk's product added to the running sum (the GEMM's order)."""
    P = torch.zeros((hprev.shape[0], w.shape[0]))
    for k in range(0, hprev.shape[1], chunk):
        P = P + hprev[:, k:k + chunk] @ w[:, k:k + chunk].t()
    return P


def batch_sum(terms):
    """Sum over the batch (dim 0), rows added in order (b = 0, 1, ..)."""
    s = torch.zeros(terms.shape[1:])
    for row in terms:
        s = s + row
    return s


def persistent_model(xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT,
                     units=8):
    """Row 19's persistent design in PyTorch: (1) P = hprev W'^T for every
    step; (2) steps t = T-1..0, each (a) CTA by CTA (units [c, c + units))
    the cell's gradients of its units from pre = P + b' and gates = xg +
    sum_a coef[a] act_a(pre) in its four gate columns q H + j, dux and
    dupre stored in the compute dtype, the dcoef terms du act_a(pre)
    summed over the batch and added to the CTA's totals; then, past the
    grid barrier, (b) each CTA's dh columns from all of dupre[t] on its
    column slice, plus (1 - keep) dh_tot."""
    T, B, G = xg.shape
    H = G // 4
    dtype, f32 = w.dtype, torch.float32
    wf, bf = w.to(f32), b.to(f32)
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, H).to(f32)
    P = hoisted_product(hprev, wf).reshape(T, B, G)
    dh, dc = dhT.to(f32).clone(), dcT.to(f32).clone()
    dux = torch.empty((T, B, G), dtype=dtype)
    dupre = torch.empty_like(dux)
    dcoef = torch.zeros(coef.shape)
    for t in reversed(range(T)):
        keep = (torch.ones(B, 1) if mask is None
                else mask[t].to(f32)[:, None])
        cp = (c0 if t == 0 else cs[t - 1]).to(f32)
        dh_tot = dh + dy[t].to(f32)
        carry = (1.0 - keep) * dh_tot
        for c0_ in range(0, H, units):
            j = slice(c0_, c0_ + units)
            cols = [slice(q * H + c0_, q * H + c0_ + units) for q in range(4)]
            pre = [P[t][:, n] + bf[n] for n in cols]
            acts = [(torch.sigmoid(p), torch.tanh(p), torch.relu(p))
                    for p in pre]
            gates = [xg[t][:, n].to(f32) + (coef[0][n] * s + coef[1][n] * th
                                            + coef[2][n] * r)
                     for n, (s, th, r) in zip(cols, acts)]
            i, f, o = (torch.sigmoid(gates[q]) for q in (0, 1, 3))
            g = torch.tanh(gates[2])
            tc = torch.tanh(f * cp[:, j] + i * g)
            dhn, dcn = keep * dh_tot[:, j], keep * dc[:, j]
            d_o = dhn * tc
            dcc = dcn + dhn * o * (1.0 - tc * tc)
            dc[:, j] = dcc * f + (1.0 - keep) * dc[:, j]
            du = [dcc * g * i * (1.0 - i), dcc * cp[:, j] * f * (1.0 - f),
                  dcc * i * (1.0 - g * g), d_o * o * (1.0 - o)]
            for q, n in enumerate(cols):
                s, th, r = acts[q]
                for a, av in enumerate((s, th, r)):
                    dcoef[a][n] = dcoef[a][n] + batch_sum(du[q] * av)
                dpre = du[q] * (coef[0][n] * s * (1.0 - s)
                                + coef[1][n] * (1.0 - th * th)
                                + coef[2][n] * (pre[q] > 0.0).to(f32))
                dux[t][:, n] = du[q].to(dtype)
                dupre[t][:, n] = dpre.to(dtype)
        # (b) past the barrier: every CTA reads all of dupre[t]
        a = dupre[t].to(f32)
        for c0_ in range(0, H, units):
            j = slice(c0_, c0_ + units)
            dh[:, j] = a @ wf[:, j] + carry[:, j]
    return dux, dupre, dcoef, dh.to(dtype), dc.to(dtype)


def _inputs(T, B, H, masked, seed):
    """Float32 arguments of ``gp6_bwd``: the forward twin's outputs on
    random weights, random dy and final-state gradients."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    G = 4 * H
    xg, w, b = r(T, B, G), r(G, H, sc=H ** -0.5), r(G, sc=0.3)
    coef = r(3, G)
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    h0, c0 = r(B, H, sc=0.5), r(B, H, sc=0.5)
    ys, cs, _, _ = gpc.gp6_fwd_plain(xg, w, b, coef, mask, h0, c0)
    return [xg, w, b, coef, mask, h0, c0, ys, cs, r(T, B, H),
            r(B, H, sc=0.5), r(B, H, sc=0.5)]


def _pallas_bwd(args):
    """``_gp_bwd_run`` of the JAX package on the same arguments (its
    layout: W' transposed, (1, 4H) b', coef padded to 8 rows, the mask as
    (T, B, 8), h_{t-1} and c_{t-1} sequences)."""
    (xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT) = \
        [None if a is None else a.numpy() for a in args]
    T, B, G = xg.shape
    m = np.ones((T, B), np.float32) if mask is None \
        else mask.astype(np.float32)
    coef8 = np.zeros((8, G), np.float32)
    coef8[:3] = coef
    prev = lambda s0, seq: np.concatenate([s0[None], seq[:-1]])  # noqa: E731
    out = gpl._gp_bwd_run(*map(jnp.asarray, (
        xg, prev(h0, ys), prev(c0, cs), dy,
        np.broadcast_to(m[:, :, None], (T, B, 8)), w.T, b[None], coef8,
        dhT, dcT)))
    dux, dupre, dcoef8, dh0, dc0 = (np.asarray(o) for o in out)
    return [dux, dupre, dcoef8[:3], dh0, dc0]


@pytest.mark.parametrize("T,B,H,masked", [
    (6, 4, 16, True), (5, 3, 24, False), (7, 5, 8, True), (4, 6, 32, False),
    (1, 2, 16, True)])
def test_persistent_model_equals_the_pallas_kernel(monkeypatch, T, B, H,
                                                   masked):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    args = _inputs(T, B, H, masked, seed=T * B + H)
    got = persistent_model(*args)
    ref = _pallas_bwd(args)
    assert np.abs(ref[2]).max() > 0  # dcoef
    for g, r, name in zip(got, ref, NAMES):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("units", [8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_persistent_model_equals_the_plain_twin(masked, units):
    args = _inputs(9, 7, 32, masked, seed=3 + masked)
    got = persistent_model(*args, units=units)
    ref = gpc.gp6_bwd_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_bf16_operands_round_as_the_twin():
    # in bf16 the model's hoisted product and the twin's step products
    # see the same rounded operands (h, W', b'); only the fp32 sums' order
    # differs
    args = _inputs(6, 5, 16, True, seed=11)
    bf = torch.bfloat16
    for i, a in enumerate(args):
        if i not in (3, 4):  # coef (float32), mask
            args[i] = a.to(bf)
    got = persistent_model(*args)
    ref = gpc.gp6_bwd_plain(*args)
    for g, r, name in zip(got, ref, NAMES):
        assert g.dtype == r.dtype, name
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -6,
                                   atol=1e-5, msg=name)
