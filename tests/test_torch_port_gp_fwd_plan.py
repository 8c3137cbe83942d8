"""The persistent designs of the GP-LSTM's training forwards, kernel rows 20
(gates 1-4, ``csrc/gp_lstm.cu``) and 18 (gate 6, ``csrc/gp6_lstm.cu``), on
the CPU. Both run rows 4, 5 and 7's persistent step
(``csrc/lstm_persist.cuh``) with the row's cell: one cooperative launch of
H / 8 CTAs, each keeping its 5 x 8 rows of W5 = [W_hh; w_h] (row 20) or
4 x 8 rows of W' (row 18) resident, a grid barrier a step.

- The rule ``gp_lstm_cuda._design_fwd(B, H, n_sm, T, row)`` at the main
  path's calls (the training step, an ``evaluate`` window, the short-T
  calls of gates 2-4, the trained ``13`` checkpoint's width) and where it
  must refuse the persistent design; the plans' shared memory within the
  232,448 bytes a CTA may take.
- A Python model of each schedule, CTA by CTA: what crosses CTAs is only
  what the kernel stores before a grid barrier (ys in the weights'
  dtype). In float32 each equals its plain twin to 1e-6; in bf16 within
  one bf16 step. A schedule whose product reads h0 at every step (the
  planted build fault 4 of both rows) is far from the twin from a carried
  state.
- Each twin and each model against the JAX package's kernel in interpret
  mode (``_make_gpg(gate, acts)``'s forward for row 20, ``_gp_fwd_run`` for
  row 18) at rtol 2e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import gp_lstm_pallas as gpl
from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import gp_lstm_cuda as gpc
from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448
RTOL, ATOL = 2e-4, 1e-5
# (T, B, H): a training step, an ``evaluate`` window at eval batch 20,
# chip_smoke.py's short-T calls of gates 2-4, the ``13`` checkpoint's
# evaluate window
STEP, EVALUATE, SHORT, TRAINED = ((100, 32, 1024), (100, 20, 1024),
                                  (10, 32, 1024), (100, 20, 128))


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("row", [18, 20])
@pytest.mark.parametrize("T,B,H", [STEP, EVALUATE, SHORT, TRAINED])
def test_persistent_at_the_main_path_calls(row, T, B, H):
    plan = gpc._design_fwd(B, H, N_SM, T=T, row=row)
    assert plan["design"] == "persistent"
    assert (plan["ctas"], plan["units"], plan["threads"]) == (H // 8, 8, 512)
    assert plan["grid"] == (H // 8,)
    assert plan["launches"] == 1 and plan["barriers"] == T - 1
    assert plan["smem_bytes"] == gpc.fwd_persist_smem(H, row) <= SMEM_LIMIT
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once


def test_shared_memory_at_the_training_width():
    # row 20: W5's 40 rows of 1,024 + 32 bf16 and the 16 warps' 32 x 40
    # fp32 partial tiles; row 18: row 5's CTA (32 rows, 32 x 32 tiles)
    assert gpc.fwd_persist_smem(1024, 20) == 40 * 1056 * 2 + 16 * 32 * 40 * 4 \
        == 84480 + 81920 == 166400
    assert gpc.fwd_persist_smem(1024, 18) == ltc.fwd_persist_smem(1024) \
        == 133120
    assert gpc._design_fwd(1, 32, N_SM, T=1, row=20)["barriers"] == 0


@pytest.mark.parametrize("row", [18, 20])
@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (40, 64, N_SM),     # the card tests' per-step shape
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs: more than the SMs
    (32, 1028, N_SM),   # H not a multiple of 8
    (20, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs at once
])
def test_per_step_design_takes_the_rest(row, B, H, n_sm):
    plan = gpc._design_fwd(B, H, n_sm, T=100, row=row)
    assert plan["design"] == "per_step"
    assert plan["grid"] == (-(-B // 32), H // 32)
    assert plan["launches"] == 100 and plan["barriers"] == 0
    assert plan["smem_bytes"] is None and plan["threads"] is None


@pytest.mark.parametrize("row,widest", [(20, 1848), (18, 2576)])
def test_persistent_shared_memory_bounds_the_width(row, widest):
    # the widest H whose CTA fits 232,448 bytes, on a card with SMs enough
    assert widest == max(H for H in range(8, 4096, 8)
                         if gpc.fwd_persist_smem(H, row) <= SMEM_LIMIT)
    assert gpc._design_fwd(32, widest, 1000, row=row)["design"] \
        == "persistent"
    assert gpc._design_fwd(32, widest + 8, 1000, row=row)["design"] \
        == "per_step"


# ------------------------------------------------------------------ models

def _steps(T, B, mask):
    for t in range(T):
        yield t, (torch.ones(B, 1, dtype=torch.bool) if mask is None
                  else mask[t].bool()[:, None])


def row20_model(xg, gpx, w5, bih, coef, mask, h0, c0, gate, units=8,
                h0_always=False):
    """Row 20's persistent schedule, CTA by CTA (CTA k owns units
    [k, k + units)): the product of h_{t-1} = ys[t-1] (bf16(h0) at t = 0;
    at every step where ``h0_always``, the planted fault 4) with the CTA's
    rows of W5 (q H + k + u, q = 0..4), gates = (xg + the first four) +
    b_ih, pre = gpx + the fifth, gate ``gate`` replaced by the mixture; h
    and c carried in float32, ys and cs stored in the weights' dtype.
    Returns ``gpg_fwd_plain``'s outputs."""
    T, B, G = xg.shape
    H = G // 4
    dtype, f32 = w5.dtype, torch.float32
    wf = w5.to(f32)
    names = gpc.ACT_SETS[coef.shape[0]]
    h, c = h0.to(f32).clone(), c0.to(f32).clone()
    ys = torch.empty((T, B, H), dtype=dtype)
    cs = torch.empty_like(ys)
    for t, keep in _steps(T, B, mask):
        a = (h0 if t == 0 or h0_always else ys[t - 1]).to(dtype).to(f32)
        for k in range(0, H, units):
            j = slice(k, k + units)
            rows = torch.cat([torch.arange(q * H + k, q * H + k + units)
                              for q in range(5)])
            s = (a @ wf[rows].t()).split(units, dim=-1)
            g = [(xg[t][:, q * H:(q + 1) * H][:, j].to(f32) + s[q])
                 + bih[q * H:(q + 1) * H][j] for q in range(4)]
            pre = gpx[t][:, j].to(f32) + s[4]
            gp = coef[0][j] * gpc._ACT[names[0]](pre)
            for n in range(1, len(names)):
                gp = gp + coef[n][j] * gpc._ACT[names[n]](pre)
            i, f, gg, o = (torch.sigmoid(g[0]), torch.sigmoid(g[1]),
                           torch.tanh(g[2]), torch.sigmoid(g[3]))
            i, f, gg, o = (gp if gate == q + 1 else v
                           for q, v in enumerate((i, f, gg, o)))
            cn = f * c[:, j] + i * gg
            hn = o * torch.tanh(cn)
            h[:, j] = torch.where(keep, hn, h[:, j])
            c[:, j] = torch.where(keep, cn, c[:, j])
            ys[t][:, j] = h[:, j].to(dtype)
            cs[t][:, j] = c[:, j].to(dtype)
    return ys, cs, h.to(dtype), c.to(dtype)


def row18_model(xg, w, b, coef, mask, h0, c0, units=8, h0_always=False):
    """Row 18's persistent schedule, CTA by CTA: the product of h_{t-1}
    with the CTA's rows of W' (q H + k + u, q = 0..3), pre = that + b',
    gates = xg + sum_a coef[a] act_a(pre), the standard cell. Returns
    ``gp6_fwd_plain``'s outputs."""
    T, B, G = xg.shape
    H = G // 4
    dtype, f32 = w.dtype, torch.float32
    wf, bf = w.to(f32), b.to(f32)
    h, c = h0.to(f32).clone(), c0.to(f32).clone()
    ys = torch.empty((T, B, H), dtype=dtype)
    cs = torch.empty_like(ys)
    for t, keep in _steps(T, B, mask):
        a = (h0 if t == 0 or h0_always else ys[t - 1]).to(dtype).to(f32)
        for k in range(0, H, units):
            j = slice(k, k + units)
            rows = torch.cat([torch.arange(q * H + k, q * H + k + units)
                              for q in range(4)])
            pre = a @ wf[rows].t() + bf[rows]
            s, th, r = torch.sigmoid(pre), torch.tanh(pre), torch.relu(pre)
            g = (xg[t][:, rows].to(f32)
                 + (coef[0][rows] * s + coef[1][rows] * th
                    + coef[2][rows] * r)).split(units, dim=-1)
            cn = torch.sigmoid(g[1]) * c[:, j] \
                + torch.sigmoid(g[0]) * torch.tanh(g[2])
            hn = torch.sigmoid(g[3]) * torch.tanh(cn)
            h[:, j] = torch.where(keep, hn, h[:, j])
            c[:, j] = torch.where(keep, cn, c[:, j])
            ys[t][:, j] = h[:, j].to(dtype)
            cs[t][:, j] = c[:, j].to(dtype)
    return ys, cs, h.to(dtype), c.to(dtype)


def _row20_inputs(T, B, H, nact, masked, seed):
    """Float32 arguments of ``gpg_fwd`` without the gate: h0, c0 uniform
    in +-0.5, a carried state."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    return [r(T, B, 4 * H), r(T, B, H), r(5 * H, H, sc=H ** -0.5),
            r(4 * H, sc=0.1), r(nact, H), mask, r(B, H, sc=0.5),
            r(B, H, sc=0.5)]


def _row18_inputs(T, B, H, masked, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    return [r(T, B, 4 * H), r(4 * H, H, sc=H ** -0.5), r(4 * H, sc=0.5),
            r(3, 4 * H), mask, r(B, H, sc=0.5), r(B, H, sc=0.5)]


NAMES = ("ys", "cs", "hT", "cT")


@pytest.mark.parametrize("nact", [1, 3])
@pytest.mark.parametrize("gate", [1, 2, 3, 4])
def test_row20_schedule_equals_the_plain_twin(gate, nact):
    masked = (gate + nact) % 2 == 1
    args = _row20_inputs(9, 12, 32, nact, masked, seed=10 * gate + nact)
    got = row20_model(*args, gate)
    ref = gpc.gpg_fwd_plain(*args, gate)
    for g, r, name in zip(got, ref, NAMES):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("T,B,H,masked,units", [
    (7, 12, 32, True, 16), (1, 5, 16, True, 8), (1, 7, 32, False, 16),
    (6, 3, 24, False, 8)])
def test_row20_schedule_at_other_shapes(T, B, H, masked, units):
    # 16 units a CTA; T = 1 (no barrier); H = 24, three CTAs of 8
    args = _row20_inputs(T, B, H, 3, masked, seed=T * B + H)
    got = row20_model(*args, 3, units=units)
    ref = gpc.gpg_fwd_plain(*args, 3)
    for g, r, name in zip(got, ref, NAMES):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("T,B,H,masked,units", [
    (9, 12, 32, True, 8), (6, 5, 16, False, 8), (7, 12, 32, True, 16),
    (1, 7, 24, True, 8), (1, 4, 32, False, 16)])
def test_row18_schedule_equals_the_plain_twin(T, B, H, masked, units):
    args = _row18_inputs(T, B, H, masked, seed=T * B + H)
    got = row18_model(*args, units=units)
    ref = gpc.gp6_fwd_plain(*args)
    for g, r, name in zip(got, ref, NAMES):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6, msg=name)


def test_row20_schedule_in_bf16_rounds_as_the_twin():
    # xg, gpx, W5 and the state in bf16, b_ih and coef in float32 as the
    # wrapper hands them: only the fp32 sums' order differs, one bf16 step
    args = _row20_inputs(8, 12, 32, 3, True, seed=5)
    bf = torch.bfloat16
    for i in (0, 1, 2, 6, 7):
        args[i] = args[i].to(bf)
    got = row20_model(*args, 1)
    ref = gpc.gpg_fwd_plain(*args, 1)
    for g, r, name in zip(got, ref, NAMES):
        assert g.dtype == r.dtype == bf, name
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6, msg=name)


def test_row18_schedule_in_bf16_rounds_as_the_twin():
    # xg, W', b' and the state in bf16, coef in float32
    args = _row18_inputs(8, 12, 32, True, seed=6)
    bf = torch.bfloat16
    for i in (0, 1, 2, 5, 6):
        args[i] = args[i].to(bf)
    got = row18_model(*args)
    ref = gpc.gp6_fwd_plain(*args)
    for g, r, name in zip(got, ref, NAMES):
        assert g.dtype == r.dtype == bf, name
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6, msg=name)


def test_a_product_on_h0_at_every_step_is_far_from_the_twins():
    # what the planted faults -DGP_LSTM_FAULT=4 and -DGP6_FAULT=4 do, from
    # a carried state: far from the twin, where the schedule is not
    args = _row20_inputs(6, 5, 16, 3, False, seed=2)
    ref = gpc.gpg_fwd_plain(*args, 1)
    assert float((row20_model(*args, 1, h0_always=True)[0]
                  - ref[0]).abs().max()) > 1e-2
    args6 = _row18_inputs(6, 5, 16, False, seed=2)
    ref6 = gpc.gp6_fwd_plain(*args6)
    assert float((row18_model(*args6, h0_always=True)[0]
                  - ref6[0]).abs().max()) > 1e-2


# ------------------------------------------------- the twins against JAX

def _mask8(mask, T, B):
    m = np.ones((T, B), np.float32) if mask is None \
        else mask.numpy().astype(np.float32)
    return np.broadcast_to(m[:, :, None], (T, B, 8))


@pytest.mark.parametrize("nact", [1, 3])
@pytest.mark.parametrize("gate", [1, 2, 3, 4])
def test_row20_twin_equals_the_pallas_kernel(monkeypatch, gate, nact):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, H = 5, 3 + gate, 16
    masked = (gate + nact) % 2 == 0
    args = _row20_inputs(T, B, H, nact, masked, seed=40 + 10 * gate + nact)
    xg, gpx, w5, bih, coef, mask, h0, c0 = args
    coef8 = np.zeros((8, H), np.float32)
    coef8[:nact] = coef.numpy()
    fn = gpl._make_gpg(gate, gpc.ACT_SETS[nact])
    ref = fn(*map(jnp.asarray, (xg.numpy(), gpx.numpy(), w5.numpy().T,
                                bih.numpy()[None], coef8, _mask8(mask, T, B),
                                h0.numpy(), c0.numpy())))
    twin = gpc.gpg_fwd_plain(*args, gate)
    model = row20_model(*args, gate)
    for tw, mo, r, name in zip(twin, model, ref, NAMES):
        np.testing.assert_allclose(tw.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(mo.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T,masked", [(7, False), (7, True), (1, True)])
def test_row18_twin_equals_the_pallas_kernel(monkeypatch, T, masked):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    B, H = 6, 16
    args = _row18_inputs(T, B, H, masked, seed=50 + T + masked)
    xg, w, b, coef, mask, h0, c0 = args
    coef8 = np.zeros((8, 4 * H), np.float32)
    coef8[:3] = coef.numpy()
    ref = gpl._gp_fwd_run(*map(jnp.asarray, (
        xg.numpy(), w.numpy().T, b.numpy()[None], coef8, _mask8(mask, T, B),
        h0.numpy(), c0.numpy())))
    twin = gpc.gp6_fwd_plain(*args)
    model = row18_model(*args)
    for tw, mo, r, name in zip(twin, model, ref, NAMES):
        np.testing.assert_allclose(tw.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(mo.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
