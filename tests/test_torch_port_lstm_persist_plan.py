"""The persistent designs of kernel rows 4 (one LSTM layer's forward in
``evaluate``, ``csrc/lstm_fwd.cu``) and 7 (the fused 2-layer training
forward, ``csrc/lstm2_train.cu``) on the CPU. Both run row 5's persistent
step (``csrc/lstm_persist.cuh``): one cooperative launch of H / 8 CTAs,
each keeping its 4 x 8 gate rows of W_hh resident, a grid barrier a step.

- The rules: ``lstm_cuda._design_fwd(T, B, H, n_sm, resets)`` and the
  forward half of ``lstm2_train_cuda._design(B, H, n_sm, T)`` at the main
  path's calls and where they must refuse the persistent design; the
  plans' shared memory within the 232,448 bytes a CTA may take.
- A Python model of each new schedule, CTA by CTA: what crosses CTAs is
  only what the kernel stores before a grid barrier (ys in the weights'
  dtype). Row 7's model runs layer 1 (storing h1d = h1 dm from the float32
  h1), then the hoisted input product Q = h1d W_ih2^T for all T B rows at
  once in the GEMM's 64-deep chunks, then layer 2 on Q. In float32 each
  equals its plain twin to 1e-6; in bf16 within one bf16 step.
- Each twin against the JAX package's kernel in interpret mode (``_run``
  for row 4, ``_train2_fwd_run`` for row 7) at rtol 2e-4 / atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm2_train_cuda as l2c
from bayeslms_tpu_torch.ops import lstm_cuda as lc
from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448
RTOL, ATOL = 2e-4, 1e-5
# (T, B, H): an ``evaluate`` window at eval batch 20; a training step
EVALUATE, STEP = (100, 20, 1024), (100, 32, 1024)


# ------------------------------------------------------------------ rules

def test_row4_persistent_at_the_evaluate_call():
    plan = lc._design_fwd(*EVALUATE, N_SM)
    assert plan["design"] == "persistent"
    assert (plan["ctas"], plan["units"], plan["threads"]) == (128, 8, 512)
    assert plan["grid"] == (128,)
    assert plan["launches"] == 1 and plan["barriers"] == 99
    # the gate rows 32 x 1,056 bf16, the 16 warps' partial tiles 64 KB
    assert plan["smem_bytes"] == 32 * 1056 * 2 + 16 * 32 * 32 * 4 \
        == 133120 <= SMEM_LIMIT
    assert plan["smem_bytes"] == ltc.fwd_persist_smem(1024)


@pytest.mark.parametrize("T,B,H", [(1, 20, 1024), (9, 32, 512),
                                   (9, 1, 32), (6, 5, 64)])
def test_row4_persistent_where_it_fits(T, B, H):
    plan = lc._design_fwd(T, B, H, N_SM)
    assert plan["design"] == "persistent"
    assert plan["barriers"] == T - 1 and plan["smem_bytes"] <= SMEM_LIMIT
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once


@pytest.mark.parametrize("T,B,H,n_sm,resets", [
    (256, 400, 96, N_SM, True),     # resets off the streamed design's chunks
    (256, 600, 2048, N_SM, True),   # resets, 256 streamed CTAs: too many
    (100, 33, 1024, 114, False),    # past 32 columns on a card of 114 SMs
    (100, 20, 1088, N_SM, False),   # 136 CTAs: more than 132 SMs
    (100, 20, 1024, 114, False),    # a card of 114 SMs cannot hold 128
])
def test_row4_per_step_design_takes_the_rest(T, B, H, n_sm, resets):
    plan = lc._design_fwd(T, B, H, n_sm, resets=resets)
    assert plan["design"] == "per_step"
    assert plan["grid"] == (-(-B // 64), H // 32)
    assert plan["launches"] == T and plan["barriers"] == 0


def test_row7_persistent_at_the_training_step():
    plan = l2c._design(STEP[1], STEP[2], N_SM, T=STEP[0])
    assert (plan["fwd_design"], plan["design"]) == ("persistent",
                                                    "persistent")
    # two recurrences of row 5's CTA, and the input GEMM: 32 gate-column
    # tiles x 25 row tiles of 128, one product
    assert plan["fwd_smem_bytes"] == 133120 <= SMEM_LIMIT
    assert l2c.gemm_smem() <= SMEM_LIMIT
    assert plan["fwd_gemm_grid"] == (32, 25, 1)
    assert plan["fwd_launches"] == 3 and plan["fwd_barriers"] == 198


@pytest.mark.parametrize("T,B,H", [(7, 32, 1024), (1, 32, 1024),
                                   (5, 7, 544), (9, 20, 1024)])
def test_row7_persistent_at_ragged_calls(T, B, H):
    # the fit's tail window (T < 100), a GEMM whose T B rows are not a
    # multiple of 128 and a width off its 64-deep chunks
    plan = l2c._design(B, H, N_SM, T=T)
    assert plan["fwd_design"] == "persistent"
    assert plan["fwd_gemm_grid"] == (-(-4 * H // 128), -(-T * B // 128), 1)
    assert plan["fwd_barriers"] == 2 * (T - 1)


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (64, 1024, N_SM),
    (32, 1088, N_SM),   # 136 CTAs
    (32, 1024, 114),    # more CTAs than SMs
])
def test_row7_per_step_design_takes_the_rest(B, H, n_sm):
    plan = l2c._design(B, H, n_sm, T=100)
    assert plan["fwd_design"] == "per_step"
    assert plan["fwd_launches"] == 200 and plan["fwd_barriers"] == 0
    assert plan["fwd_gemm_grid"] is None


# ------------------------------------------------------------------ models

def persist_model(x, w, bias, mask, h0, h, c, dm=None, units=8):
    """csrc/lstm_persist.cuh's schedule, CTA by CTA (CTA k owns units
    [k, k + units)). x (T, B, 4H), bf16-like or float32 (the fp32 Q);
    ``h0`` the first step's product operand in the weights' dtype; h, c
    the float32 carries. Returns ys, cs (and hd where ``dm`` is given) in
    the weights' dtype and the final float32 h, c."""
    T, B, G = x.shape
    H = G // 4
    dtype, f32 = w.dtype, torch.float32
    wf = w.to(f32)
    h, c = h.to(f32).clone(), c.to(f32).clone()
    ys = torch.empty((T, B, H), dtype=dtype)
    cs = torch.empty_like(ys)
    hd = torch.empty_like(ys)
    for t in range(T):
        a = (h0 if t == 0 else ys[t - 1]).to(f32)  # stored before the barrier
        keep = (torch.ones(B, 1, dtype=torch.bool) if mask is None
                else mask[t].bool()[:, None])
        for k in range(0, H, units):
            rows = torch.cat([torch.arange(q * H + k, q * H + k + units)
                              for q in range(4)])
            cols = slice(k, k + units)
            pre = (x[t].to(f32)[:, rows] + a @ wf[rows].t()) + bias[rows]
            i, f, g, o = pre.chunk(4, dim=-1)
            cn = (torch.sigmoid(f) * c[:, cols]
                  + torch.sigmoid(i) * torch.tanh(g))
            hn = torch.sigmoid(o) * torch.tanh(cn)
            h[:, cols] = torch.where(keep, hn, h[:, cols])
            c[:, cols] = torch.where(keep, cn, c[:, cols])
            ys[t][:, cols] = h[:, cols].to(dtype)
            cs[t][:, cols] = c[:, cols].to(dtype)
            if dm is not None:
                hd[t][:, cols] = (h[:, cols]
                                  * dm[t][:, cols].to(f32)).to(dtype)
    return ys, cs, hd, h, c


def row4_model(xg, whh, bhh, h0, c0, step_mask=None):
    """Row 4's persistent design: the fp32 state in and out, bf16(h0) the
    first step's operand; returns ys, hT, cT as ``lstm_fwd_plain``."""
    dtype = whh.dtype
    ys, _, _, h, c = persist_model(xg, whh, bhh, step_mask, h0.to(dtype),
                                   h0, c0)
    return ys, h.to(dtype), c.to(dtype)


def chunked_product(a, w, depth=64):
    """a w^T in float32 as the input GEMM sums it: 64-deep chunks, each
    chunk's product added into the running sum."""
    f32 = torch.float32
    out = torch.zeros((a.shape[0], w.shape[0]), dtype=f32)
    for k in range(0, a.shape[1], depth):
        out += a[:, k:k + depth].to(f32) @ w[:, k:k + depth].to(f32).t()
    return out


def row7_model(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01,
               h02, c02, units=8):
    """Row 7's persistent design: (1) layer 1 storing h1d; (2) Q = h1d
    W_ih2^T for all T B rows at once; (3) layer 2 on Q. Returns the
    outputs of ``lstm2_train_fwd_plain``."""
    T, B, G = xg1.shape
    dtype = w_hh1.dtype
    ys1, cs1, hd, h1, c1 = persist_model(xg1, w_hh1, b_hh1, mask, h01, h01,
                                         c01, dm=dm, units=units)
    q = chunked_product(hd.reshape(T * B, -1), w_ih2).reshape(T, B, G)
    ys2, cs2, _, h2, c2 = persist_model(q, w_hh2, b2, mask, h02, h02, c02,
                                        units=units)
    return (ys1, cs1, ys2, cs2, *(s.to(dtype) for s in (h1, c1, h2, c2)))


def _row4_inputs(T, B, H, masked, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    args = [r(T, B, 4 * H), r(4 * H, H, sc=H ** -0.5), r(4 * H, sc=0.1),
            r(B, H, sc=0.5), r(B, H, sc=0.5)]
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.8)
                            .astype(np.uint8)) if masked else None
    return args, mask


def _row7_inputs(T, B, H, masked, dropped, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    sw, G = H ** -0.5, 4 * H
    dm = torch.from_numpy(((rng.uniform(size=(T, B, H)) < 0.8) / 0.8)
                          .astype(np.float32)) if dropped \
        else torch.ones((T, B, H))
    w_hh1, b_hh1, w_ih2, w_hh2, b2 = (r(G, H, sc=sw), r(G, sc=0.1),
                                      r(G, H, sc=sw), r(G, H, sc=sw),
                                      r(G, sc=0.1))
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.75)
                            .astype(np.uint8)) if masked else None
    return [r(T, B, G), dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask,
            *(r(B, H, sc=0.5) for _ in range(4))]


@pytest.mark.parametrize("T,B,H,masked,units", [
    (9, 12, 32, True, 8), (6, 5, 16, False, 8), (1, 7, 24, True, 8),
    (7, 12, 32, True, 16)])
def test_row4_schedule_equals_the_plain_twin(T, B, H, masked, units):
    args, mask = _row4_inputs(T, B, H, masked, seed=T * B + H)
    dtype = args[1].dtype
    ys, _, _, h, c = persist_model(args[0], args[1], args[2], mask,
                                   args[3].to(dtype), args[3], args[4],
                                   units=units)
    got = (ys, h.to(dtype), c.to(dtype))
    ref = lc.lstm_fwd_plain(*args, mask)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_row4_schedule_in_bf16_rounds_as_the_twin():
    # weights, xg and the products' operands in bf16, the state in float32
    # as ``evaluate`` hands it: one bf16 step where the fp32 sums' order
    # moves a rounding
    args, mask = _row4_inputs(8, 12, 32, True, seed=5)
    bf = torch.bfloat16
    args[0], args[1] = args[0].to(bf), args[1].to(bf)
    got = row4_model(*args, mask)
    ref = lc.lstm_fwd_plain(*args, mask)
    for g, r in zip(got, ref):
        assert g.dtype == bf
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("T,B,H,masked,dropped", [
    (9, 12, 32, True, True), (6, 5, 16, False, True),
    (7, 9, 24, True, False), (1, 4, 16, True, True), (5, 3, 80, False,
                                                       False)])
def test_row7_schedule_equals_the_plain_twin(T, B, H, masked, dropped):
    # H = 80: the hoisted product's last 64-deep chunk half full
    args = _row7_inputs(T, B, H, masked, dropped, seed=T * B + H)
    got = row7_model(*args)
    ref = l2c.lstm2_train_fwd_plain(*args)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_row7_schedule_in_bf16_rounds_as_the_twin():
    # in bf16 the model's hoisted Q and the twin's step product see the
    # same rounded h1d; only the fp32 sums' order differs: one bf16 step
    args = _row7_inputs(8, 12, 32, True, True, seed=11)
    bf = torch.bfloat16
    for i, a in enumerate(args):
        if i not in (3, 6, 7):  # the float32 biases, the mask
            args[i] = a.to(bf)
    got = row7_model(*args)
    ref = l2c.lstm2_train_fwd_plain(*args)
    for g, r in zip(got, ref):
        assert g.dtype == bf
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6)


def test_row7_hoisted_q_reads_each_steps_own_input():
    # what the planted fault -DLSTM2_TRAIN_FAULT=4 does (layer 2 reads Q of
    # step t + 1): far from the twin, where the model is not
    args = _row7_inputs(6, 5, 16, False, True, seed=2)
    T, B, G = args[0].shape
    ys1, cs1, hd, h1, c1 = persist_model(args[0], args[2], args[3], None,
                                         args[8], args[8], args[9],
                                         dm=args[1])
    q = chunked_product(hd.reshape(T * B, -1), args[4]).reshape(T, B, G)
    shifted = torch.cat([q[1:], q[:1]])
    ys2 = persist_model(shifted, args[5], args[6], None, args[10], args[10],
                        args[11])[0]
    ref = l2c.lstm2_train_fwd_plain(*args)
    assert float((ys2 - ref[2]).abs().max()) > 1e-2
    torch.testing.assert_close(row7_model(*args)[2], ref[2], rtol=0,
                               atol=1e-6)


# ------------------------------------------------- the twins against JAX

@pytest.mark.parametrize("masked", [False, True])
def test_row4_twin_equals_the_pallas_kernel(monkeypatch, masked):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, H = 9, 12, 32
    args, mask = _row4_inputs(T, B, H, masked, seed=17 + masked)
    xg, whh, bhh, h0, c0 = (a.numpy() for a in args)
    m = np.ones((T, B), np.float32) if mask is None \
        else mask.numpy().astype(np.float32)
    ref = lp._run(jnp.asarray(xg), jnp.asarray(whh.T), jnp.asarray(bhh[None]),
                  jnp.asarray(np.broadcast_to(m[:, :, None], (T, B, 8))),
                  jnp.asarray(h0), jnp.asarray(c0), masked=masked)
    twin = lc.lstm_fwd_plain(*args, mask)
    model = row4_model(*args, mask)
    for tw, mo, r in zip(twin, model, ref):
        np.testing.assert_allclose(tw.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(mo.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("masked,dropped", [(False, False), (True, True),
                                            (True, False)])
def test_row7_twin_equals_the_pallas_kernel(monkeypatch, masked, dropped):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, H = 7, 6, 32
    args = _row7_inputs(T, B, H, masked, dropped, seed=23 + 2 * masked
                        + dropped)
    (xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01, h02,
     c02) = [None if a is None else a.numpy() for a in args]
    m = np.ones((T, B), np.float32) if mask is None else mask.astype(
        np.float32)
    ref = lp._train2_fwd_run(*map(jnp.asarray, (
        xg1, dm, w_hh1.T, b_hh1[None], w_ih2.T, w_hh2.T, b2[None],
        np.broadcast_to(m[:, :, None], (T, B, 8)), h01, c01, h02, c02)))
    twin = l2c.lstm2_train_fwd_plain(*args)
    model = row7_model(*args)
    names = ("ys1", "cs1", "ys2", "cs2", "hT1", "cT1", "hT2", "cT2")
    for tw, mo, r, name in zip(twin, model, ref, names):
        np.testing.assert_allclose(tw.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(mo.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
