"""The LSTM forward recurrences' designs on the CPU: kernel row 1 (the
2-layer scoring recurrence, ``csrc/lstm2_fwd.cu``) and row 5 (the training
forward, ``csrc/lstm_train.cu``).

- The rules: ``lstm_cuda._design(T, B, H, n_sm)`` and the forward half of
  ``lstm_train_cuda._design(B, H, n_sm, T)`` at the main path's calls (the
  scoring pass, ``evaluate``, the width-96 pass, a training step) and where
  they must refuse the persistent design.
- The plans: every hidden unit owned once, a CTA's shared memory within
  the 232,448 bytes it may take, the CTA counts.
- A Python model of row 1's persistent schedule, CTA by CTA: the one-step
  skew (phase t runs layer 1 at step t and layer 2 at step t - 1 on what
  was stored before the last grid barrier), the products on the raw states
  (h1 and ys), the reset applied by the owner to the product rows and fp32
  carries it gathers, and the raw h1_t kept for layer 2. In float32 it
  equals ``lstm2_plain`` on random masked, resetting inputs with -1
  sources; ``lstm2_plain`` equals the JAX package's ``lstm2_layer_pallas``
  in interpret mode on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm as tlstm
from bayeslms_tpu_torch.ops import lstm_cuda as lc
from bayeslms_tpu_torch.ops import lstm_train_cuda as ltc

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448

# (T, B, H) of the main path's row-1 calls: the LSTM scoring pass's chunk,
# an ``evaluate`` window at eval batch 20, chip_smoke.py's width-96 pass
SCORING, EVALUATE, NARROW = (256, 600, 1024), (100, 20, 1024), (256, 400, 96)


@pytest.mark.parametrize("T,B,H", [SCORING, EVALUATE, (9, 70, 64),
                                   (6, 130, 256), (7, 33, 512)])
def test_row1_persistent_where_it_fits(T, B, H):
    plan = lc._design(T, B, H, N_SM)
    assert plan["design"] == "persistent"
    assert plan["units"] == 8 and plan["ctas"] == H // 8 <= N_SM
    assert plan["grid"] == (H // 8,) and plan["threads"] == 288
    assert plan["m_tiles"] == -(-B // 64)
    assert plan["launches"] == 1 and plan["barriers"] == T
    assert 2 <= plan["stages"] <= 8
    assert plan["smem_bytes"] == lc.persist_smem(H, plan["stages"]) \
        <= SMEM_LIMIT
    # a stage more would not fit, unless the ring is at its most
    assert plan["stages"] == 8 \
        or lc.persist_smem(H, plan["stages"] + 1) > SMEM_LIMIT
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(8 * c, 8 * c + plan["units"]))
    assert owned == list(range(H))  # every unit once, both layers


def test_row1_plan_at_the_scoring_call():
    # 128 CTAs; the three matrices' 4 x 8 gate rows 192 KB a CTA, four ring
    # stages of one m64 x 64 bf16 tile (8 KB), ten m tiles of B = 600
    plan = lc._design(*SCORING, N_SM)
    assert (plan["ctas"], plan["stages"], plan["m_tiles"]) == (128, 4, 10)
    assert plan["smem_bytes"] == 1024 + 3 * 32 * 1024 * 2 + 4 * 8192 + 256 \
        + 64 == 230720


@pytest.mark.parametrize("T,B,H,n_sm", [
    (*NARROW, N_SM),          # H not a multiple of 64
    (256, 600, 2048, N_SM),   # 256 CTAs, and 384 KB of rows a CTA
    (256, 600, 1024, 114),    # a card of 114 SMs cannot hold 128 CTAs
    (100, 20, 1152, 1000),    # the rows leave room for one stage only
])
def test_row1_per_step_design_takes_the_rest(T, B, H, n_sm):
    plan = lc._design(T, B, H, n_sm)
    assert plan["design"] == "per_step"
    assert plan["grid"] == (-(-B // 64), H // 32)
    assert plan["launches"] == 2 * T and plan["barriers"] == 0


def test_row1_shared_memory_bounds_the_width():
    widest = max(H for H in range(64, 4096, 64)
                 if lc._design(1, 1, H, 1000)["design"] == "persistent")
    assert widest == 1088  # two stages: 226,592 bytes
    assert lc._design(1, 1, widest, 1000)["stages"] == 2


@pytest.mark.parametrize("B,H", [(32, 1024), (20, 1024), (32, 512),
                                 (1, 32)])
def test_row5_persistent_where_it_fits(B, H):
    plan = ltc._design(B, H, N_SM, T=100)
    assert plan["fwd_design"] == "persistent"
    assert plan["fwd_launches"] == 1 and plan["fwd_barriers"] == 99
    assert plan["fwd_smem_bytes"] == ltc.fwd_persist_smem(H) <= SMEM_LIMIT


def test_row5_plan_at_the_training_step():
    # 128 CTAs of 8 units: the gate rows 66 KB, the partial tiles 64 KB
    plan = ltc._design(32, 1024, N_SM, T=100)
    assert (plan["fwd_design"], plan["design"]) == ("persistent",
                                                    "persistent")
    assert plan["fwd_smem_bytes"] == 32 * 1056 * 2 + 16 * 32 * 32 * 4 \
        == 133120


@pytest.mark.parametrize("B,H,n_sm", [
    (33, 1024, N_SM),   # a batch past the two m16 row tiles
    (32, 2048, N_SM),   # 256 CTAs
    (32, 1024, 114),    # more CTAs than SMs
])
def test_row5_per_step_design_takes_the_rest(B, H, n_sm):
    plan = ltc._design(B, H, n_sm, T=100)
    assert plan["fwd_design"] == "per_step"
    assert plan["fwd_launches"] == 100 and plan["fwd_barriers"] == 0


def persistent_model(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
                     step_mask=None, reset_mask=None, reset_src=None,
                     units=8):
    """Row 1's persistent kernel in PyTorch, phase by phase and CTA by CTA
    (CTA c owns units [8c, 8c + 8) of both layers). What crosses CTAs is
    only what the kernel stores before a grid barrier: the raw h1 of a step
    in the weights' dtype (its ping-pong), and ys (h02 in front)."""
    T, B, G = xg1.shape
    H = G // 4
    dtype, f32 = whh1.dtype, torch.float32
    wa = torch.cat([whh1, wih2]).to(f32)  # h1's resident rows, all CTAs
    wb = whh2.to(f32)
    r1 = {-1: h01.to(dtype)}
    y = {-1: h02.to(dtype)}
    h1, c1 = {-1: h01.to(f32)}, {-1: c01.to(f32)}
    h2, c2 = {-1: h02.to(f32)}, {-1: c02.to(f32)}

    def sources(step):
        s = torch.arange(B)
        if reset_mask is None:
            return s
        return torch.where(reset_mask[step].bool(), reset_src.long(), s)

    def gather(rows, s):
        out = rows[s.clamp(min=0)]
        return torch.where((s >= 0)[:, None], out, torch.zeros_like(out))

    def cells(pre, hp, cp, keep):
        i, f, g, o = pre.chunk(4, dim=-1)
        cn = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(g)
        hn = torch.sigmoid(o) * torch.tanh(cn)
        return torch.where(keep, hn, hp), torch.where(keep, cn, cp)

    for t in range(T + 1):
        for step in (t, t - 1):
            if not 0 <= step < T:
                continue
            layer1 = step == t
            s = sources(step)
            keep = (torch.ones(B, 1, dtype=torch.bool) if step_mask is None
                    else step_mask[step].bool()[:, None])
            h_new = torch.empty(B, H)
            c_new = torch.empty(B, H)
            for c0 in range(0, H, units):
                # the CTA's gate rows q H + c0 + u, gate-major
                rows = torch.cat([torch.arange(q * H + c0, q * H + c0 + units)
                                  for q in range(4)])
                cols = slice(c0, c0 + units)
                if layer1:
                    prod = r1[t - 1].to(f32) @ wa[rows].t()
                    pre = (xg1[t].to(f32)[:, rows] + gather(prod, s)) \
                        + bhh1[rows]
                    hp, cp = gather(h1[t - 1], s), gather(c1[t - 1], s)
                else:
                    q_in = r1[t - 1].to(f32) @ wa[G + rows].t()
                    rec = y[t - 2].to(f32) @ wb[rows].t()
                    pre = (q_in + gather(rec, s)) + b2[rows]
                    hp, cp = gather(h2[t - 2], s), gather(c2[t - 2], s)
                hn, cn = cells(pre, hp[:, cols], cp[:, cols], keep)
                h_new[:, cols], c_new[:, cols] = hn, cn
            if layer1:
                h1[t], c1[t], r1[t] = h_new, c_new, h_new.to(dtype)
            else:
                h2[step], c2[step], y[step] = h_new, c_new, h_new.to(dtype)
    # stored before the next phase's products read them: the grid barrier
    ys = torch.stack([y[s] for s in range(T)])
    return (ys, (h1[T - 1].to(dtype), h2[T - 1].to(dtype)),
            (c1[T - 1].to(dtype), c2[T - 1].to(dtype)))


def _inputs(T, B, H, seed):
    """Float32 inputs: the step mask drops a fifth of the (step, column)
    pairs, a quarter of them reset, sources in blocks of 4 columns and -1
    (a zero state) on every fifth."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    sw = H ** -0.5
    args = [r(T, B, 4 * H), r(4 * H, H, sc=sw), r(4 * H, sc=0.1),
            r(4 * H, H, sc=sw), r(4 * H, H, sc=sw), r(4 * H, sc=0.1)]
    args += [r(B, H, sc=0.5) for _ in range(4)]
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.8)
                            .astype(np.uint8))
    reset = torch.from_numpy((rng.uniform(size=(T, B)) < 0.25)
                             .astype(np.uint8))
    src = torch.from_numpy(((np.arange(B) // 4) * 4).astype(np.int32))
    src[::5] = -1
    return args, mask, reset, src


@pytest.mark.parametrize("T,B,H,masked,reset", [
    (9, 12, 16, True, True), (6, 70, 32, True, True),
    (5, 8, 24, False, True), (7, 10, 16, True, False),
    (1, 6, 16, True, True), (4, 5, 16, False, False)])
def test_persistent_schedule_equals_the_plain_twin(T, B, H, masked, reset):
    args, mask, rst, src = _inputs(T, B, H, seed=T * B + H)
    kw = dict(step_mask=mask if masked else None,
              reset_mask=rst if reset else None,
              reset_src=src if reset else None)
    got = persistent_model(*args, **kw)
    ref = lc.lstm2_plain(*args, **kw)
    for g, r in zip((got[0], *got[1], *got[2]), (ref[0], *ref[1], *ref[2])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_persistent_schedule_in_bf16_rounds_as_the_twin():
    # weights and states in bf16: the products take the raw h rounded to
    # bf16, as the twin rounds the gathered h
    args, mask, rst, src = _inputs(6, 12, 16, seed=5)
    bf = torch.bfloat16
    for i in (0, 1, 3, 4, 6, 7, 8, 9):
        args[i] = args[i].to(bf)
    got = persistent_model(*args, mask, rst, src)
    ref = lc.lstm2_plain(*args, mask, rst, src)
    for g, r in zip((got[0], *got[1], *got[2]), (ref[0], *ref[1], *ref[2])):
        assert g.dtype == bf
        # one bf16 step where the fp32 sums' order moves a rounding
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6)


def test_the_twin_equals_the_pallas_kernel_on_the_models_inputs(monkeypatch):
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, E, H = 9, 12, 16, 16
    rng = np.random.default_rng(7)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    p1 = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((4 * H, E), 0.3), ((4 * H, H), 0.3), ((4 * H,), 0.1),
        ((4 * H,), 0.1))]
    p2 = [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((4 * H, H), 0.3), ((4 * H, H), 0.3), ((4 * H,), 0.1),
        ((4 * H,), 0.1))]
    h0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.5
    c0 = rng.normal(size=(2, B, H)).astype(np.float32) * 0.5
    mask = (rng.uniform(size=(T, B)) < 0.8).astype(np.float32)
    rmask = (rng.uniform(size=(T, B)) < 0.25).astype(np.float32)
    rsrc = ((np.arange(B) // 4) * 4).astype(np.int32)
    rsrc[::5] = -1
    ys, (hA, hB), (cA, cB) = lp.lstm2_layer_pallas(
        jnp.asarray(x), h0[0], c0[0], h0[1], c0[1], *map(jnp.asarray, p1),
        *map(jnp.asarray, p2), jnp.asarray(mask), jnp.asarray(rmask),
        jnp.asarray(rsrc))
    t = torch.from_numpy
    got = tlstm.lstm_stack2(t(x), t(h0), t(c0),
                            tlstm.LSTMParams(*map(t, p1)),
                            tlstm.LSTMParams(*map(t, p2)), t(mask), t(rmask),
                            t(rsrc))
    for g, r in zip((got[0], *got[1], *got[2]), (ys, hA, hB, cA, cB)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    # and the persistent schedule on the twin's own arguments
    xg1 = t(x) @ t(p1[0]).t() + t(p1[2])
    args = [xg1, t(p1[1]), t(p1[3]), t(p2[0]), t(p2[1]), t(p2[2] + p2[3]),
            t(h0[0]), t(c0[0]), t(h0[1]), t(c0[1])]
    kw = dict(step_mask=t(mask), reset_mask=t(rmask), reset_src=t(rsrc))
    model = persistent_model(*args, **kw)
    plain = lc.lstm2_plain(*args, **kw)
    for g, r in zip((model[0], *model[1], *model[2]),
                    (plain[0], *plain[1], *plain[2])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)
