"""The gate-replacement GP-LSTM training backward's designs (kernel row 21,
``csrc/gp_lstm.cu``, its persistent design in ``csrc/gp_persist.cuh``) on
the CPU.

- The rule ``_design(B, H, n_sm, T, row=21)`` that picks the persistent
  design (the GEMM P = hprev W5^T, then one cooperative launch) or the
  two-launch kernels, and the persistent plan: CTAs, units, the shared
  memory of both kernels within the 232,448 bytes a CTA may take, the
  GEMM's grid, every hidden unit owned once.
- A Python model of the persistent design: the product on h_{t-1} for all
  T steps first, in float32 and in 64-deep chunks as the GEMM adds them;
  then, step by step, CTA by CTA (units [c, c + 8)), the cell's gradients
  of its units with du5 rounded to the compute dtype, the dcoef terms
  summed over the batch in order and then over the steps; past the
  barrier, each CTA's dh columns from all of du5[t]. In float32 it equals
  the JAX package's ``_make_gpg(gate, acts)`` backward in interpret mode
  (rtol 2e-4, atol 1e-5, the other plan tests' bound: sums in other
  orders) for gates 1-4, both act sets, masked and not, and the plain twin
  ``gpg_bwd_plain`` (rtol 1e-5, atol 1e-6); in bf16 the twin within one
  bf16 step (2^-6 of the value, 1e-5)."""

import jax
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


@pytest.mark.parametrize("B,H", [(32, 1024), (20, 1024), (32, 512),
                                 (1, 32), (32, 1056)])
def test_persistent_design_where_it_fits(B, H):
    plan = gpc._design(B, H, N_SM, T=100, row=21)
    assert plan["design"] == "persistent"
    assert plan["units"] == 8 and plan["ctas"] == H // 8 <= N_SM
    assert plan["grid"] == (H // 8,) and plan["threads"] == 512
    assert plan["smem_bytes"] == gpc.persist_smem(H, 21) <= SMEM_LIMIT
    assert plan["gemm_grid"] == (-(-5 * H // 128), -(-100 * B // 128), 1)
    assert plan["gemm_smem_bytes"] <= SMEM_LIMIT
    assert plan["launches"] == 2 and plan["barriers"] == 100
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once


def test_persistent_plan_at_the_training_shape():
    # T 100, B 32, H 1,024: 128 CTAs; W5's 5H x 8 column slice (rows of
    # 5H + 32 bf16) 82,432 bytes and the 16 warps' partial dh tiles 16,384;
    # the GEMM 40 x 25 tiles of 128 x 128, six 32 KB stages
    plan = gpc._design(32, 1024, N_SM, T=100, row=21)
    assert (plan["ctas"], plan["smem_bytes"]) == (128, 98816)
    assert gpc.persist_smem(1024, 21) == 8 * 5152 * 2 + 16 * 32 * 8 * 4
    assert plan["gemm_grid"] == (40, 25, 1)
    assert plan["gemm_smem_bytes"] == 1024 + 6 * 32768 + 96 == 197728


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (40, 64, N_SM),     # the card test's shape
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs: more than the SMs
    (32, 1028, N_SM),   # H not a multiple of 8
    (32, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs at once
])
def test_two_launch_design_takes_the_rest(B, H, n_sm):
    plan = gpc._design(B, H, n_sm, T=100, row=21)
    assert plan["design"] == "two_launch"
    assert plan["grid"] == (-(-B // 32), H // 32)
    assert plan["launches"] == 201 and plan["barriers"] == 0
    assert plan["gemm_grid"] is None and plan["smem_bytes"] is None


def test_persistent_shared_memory_bounds_the_width():
    # the widest H whose CTA fits 232,448 bytes, on a card with SMs enough
    widest = max(H for H in range(8, 4096, 8)
                 if gpc.persist_smem(H, 21) <= SMEM_LIMIT)
    assert widest == 2688
    assert gpc._design(32, widest, 1000, row=21)["design"] == "persistent"
    assert gpc._design(32, widest + 8, 1000, row=21)["design"] == "two_launch"


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


def persistent_model(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT,
                     dcT, gate, units=8):
    """Row 21's persistent design in PyTorch: (1) P = hprev W5^T for every
    step; (2) steps t = T-1..0, each (a) CTA by CTA (units [c, c + units))
    the cell's gradients of its units, gates = (xg + P[:, :4H]) + b_ih and
    pre = gpx + P[:, 4H:], du5 stored in the compute dtype, the dcoef terms
    dgp act_a(pre) summed over the batch and added to the CTA's totals;
    then, past the grid barrier, (b) each CTA's dh columns from all of
    du5[t] on its column slice, plus (1 - keep) dh_tot."""
    T, B, G = xg.shape
    H = G // 4
    dtype, f32 = w5.dtype, torch.float32
    names = gpc.ACT_SETS[coef.shape[0]]
    w = w5.to(f32)
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, H).to(f32)
    P = hoisted_product(hprev, w).reshape(T, B, 5 * H)
    dh, dc = dhT.to(f32).clone(), dcT.to(f32).clone()
    du5 = torch.empty((T, B, 5 * H), dtype=dtype)
    dcoef = torch.zeros(coef.shape)
    for t in reversed(range(T)):
        keep = (torch.ones(B, 1) if mask is None
                else mask[t].to(f32)[:, None])
        cp = (c0 if t == 0 else cs[t - 1]).to(f32)
        dh_tot = dh + dy[t].to(f32)
        carry = (1.0 - keep) * dh_tot
        for c0_ in range(0, H, units):
            j = slice(c0_, c0_ + units)
            gq = [(xg[t][:, q * H:(q + 1) * H][:, j].to(f32)
                   + P[t][:, q * H:(q + 1) * H][:, j]) + bih[q * H:][j]
                  for q in range(4)]
            pre = gpx[t][:, j].to(f32) + P[t][:, 4 * H:][:, j]
            avals = [gpc._ACT[a](pre) for a in names]
            gp = coef[0][j] * avals[0]
            for a in range(1, len(avals)):
                gp = gp + coef[a][j] * avals[a]
            i, f, o = (torch.sigmoid(gq[q]) for q in (0, 1, 3))
            g = torch.tanh(gq[2])
            i, f, g, o = (gp if gate == k + 1 else v
                          for k, v in enumerate((i, f, g, o)))
            tc = torch.tanh(f * cp[:, j] + i * g)
            dhn, dcn = keep * dh_tot[:, j], keep * dc[:, j]
            d_o = dhn * tc
            dcc = dcn + dhn * o * (1.0 - tc * tc)
            d = (dcc * g, dcc * cp[:, j], dcc * i, d_o)
            dc[:, j] = dcc * f + (1.0 - keep) * dc[:, j]
            du = [d[0] * i * (1.0 - i), d[1] * f * (1.0 - f),
                  d[2] * (1.0 - g * g), d[3] * o * (1.0 - o)]
            dgp = d[gate - 1]
            du[gate - 1] = torch.zeros_like(dgp)
            dmix = torch.zeros_like(pre)
            for a, (name, av) in enumerate(zip(names, avals)):
                dcoef[a][j] = dcoef[a][j] + batch_sum(dgp * av)
                dmix = dmix + coef[a][j] * gpc._act_d(name, pre, av)
            for q, v in enumerate([*du, dgp * dmix]):
                du5[t][:, q * H:(q + 1) * H][:, j] = v.to(dtype)
        # (b) past the barrier: every CTA reads all of du5[t]
        a = du5[t].to(f32)
        for c0_ in range(0, H, units):
            j = slice(c0_, c0_ + units)
            dh[:, j] = a @ w[:, j] + carry[:, j]
    return du5, dcoef, dh.to(dtype), dc.to(dtype)


def _inputs(T, B, H, gate, nact, masked, seed):
    """Float32 arguments of ``gpg_bwd``: the forward twin's outputs on
    random weights, random dy and final-state gradients."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    sw = H ** -0.5
    xg, gpx = r(T, B, 4 * H), r(T, B, H)
    w5, bih = r(5 * H, H, sc=sw), r(4 * H, sc=0.1)
    coef = r(nact, H)
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    h0, c0 = r(B, H, sc=0.5), r(B, H, sc=0.5)
    ys, cs, _, _ = gpc.gpg_fwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0,
                                     gate)
    return [xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, r(T, B, H),
            r(B, H, sc=0.5), r(B, H, sc=0.5), gate]


def _pallas_bwd(args):
    """The backward of the JAX package's ``_make_gpg(gate, acts)`` on the
    same arguments, through ``jax.vjp`` (its layout: W5 transposed, (1, 4H)
    b_ih, coef padded to 8 rows, the mask as (T, B, 8)): du5, dcoef, dh0,
    dc0."""
    (xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT, dcT, gate) = args
    T, B, G = xg.shape
    H = G // 4
    k = coef.shape[0]
    m = np.ones((T, B), np.float32) if mask is None \
        else mask.numpy().astype(np.float32)
    coef8 = np.zeros((8, H), np.float32)
    coef8[:k] = coef.numpy()
    fn = gpl._make_gpg(gate, gpc.ACT_SETS[k])
    primals = [jnp.asarray(a) for a in (
        xg.numpy(), gpx.numpy(), w5.numpy().T, bih.numpy()[None], coef8,
        np.broadcast_to(m[:, :, None], (T, B, 8)), h0.numpy(), c0.numpy())]
    out, vjp = jax.vjp(fn, *primals)
    grads = vjp((jnp.asarray(dy.numpy()), jnp.zeros_like(out[1]),
                 jnp.asarray(dhT.numpy()), jnp.asarray(dcT.numpy())))
    dxg, dgpx, dcoef8, dh0, dc0 = (np.asarray(grads[i])
                                   for i in (0, 1, 4, 6, 7))
    return [np.concatenate([dxg, dgpx], axis=-1), dcoef8[:k], dh0, dc0]


NAMES = ("du5", "dcoef", "dh0", "dc0")


@pytest.mark.parametrize("nact", [1, 3])
@pytest.mark.parametrize("gate", [1, 2, 3, 4])
def test_persistent_model_equals_the_pallas_kernel(monkeypatch, gate, nact):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, H = 5, 3 + gate, 16
    masked = (gate + nact) % 2 == 0
    args = _inputs(T, B, H, gate, nact, masked, seed=10 * gate + nact)
    got = persistent_model(*args)
    ref = _pallas_bwd(args)
    assert np.abs(ref[1]).max() > 0  # dcoef
    for g, r, name in zip(got, ref, NAMES):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_persistent_model_equals_the_pallas_kernel_at_t1(monkeypatch,
                                                        masked):
    # one step: the recurrence's first step is its last, P[0] from h0
    monkeypatch.setattr(lp, "_INTERPRET", True)
    args = _inputs(1, 2, 16, 1, 3, masked, seed=5)
    for g, r, name in zip(persistent_model(*args), _pallas_bwd(args),
                          NAMES):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("units", [8, 16])
@pytest.mark.parametrize("gate,nact", [(1, 3), (2, 1), (4, 3)])
def test_persistent_model_equals_the_plain_twin(gate, nact, units):
    args = _inputs(9, 7, 32, gate, nact, True, seed=3 + gate)
    got = persistent_model(*args, units=units)
    ref = gpc.gpg_bwd_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_bf16_operands_round_as_the_twin():
    # in bf16 the model's hoisted product and the twin's step products
    # see the same rounded operands; only the fp32 sums' order differs
    args = _inputs(6, 5, 16, 3, 3, True, seed=11)
    bf = torch.bfloat16
    for i, a in enumerate(args):
        if i not in (3, 4, 5, 13):  # b_ih, coef (float32), mask, gate
            args[i] = a.to(bf)
    got = persistent_model(*args)
    ref = gpc.gpg_bwd_plain(*args)
    for g, r, name in zip(got, ref, NAMES):
        assert g.dtype == r.dtype, name
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -6,
                                   atol=1e-5, msg=name)


def test_replaced_gate_slice_is_exactly_zero():
    # (b) contracts the replaced gate's group of du5 too: exact zeros
    args = _inputs(4, 3, 16, 2, 1, False, seed=2)
    du5 = persistent_model(*args)[0]
    assert torch.count_nonzero(du5[..., 16:32]) == 0
    assert torch.count_nonzero(du5[..., :16]) > 0
