"""Kernel row 3's streamed design (one LSTM layer with packed resets,
``csrc/lstm_fwd.cu`` ``lstm_layer_stream``, on row 1's ring and products in
``csrc/lstm_stream.cuh``) on the CPU.

- The rule: ``lstm_cuda._design_fwd(T, B, H, n_sm, resets)`` sends the
  GP packed-carry pass's call (T 256, B 600, H 1,024, resets) and every
  call with resets or past 32 columns to the streamed design where it
  fits, keeps row 4's persistent design for ``evaluate``'s calls, and
  leaves the per-step kernel the widths and cards the streamed design
  refuses.
- The plan: every hidden unit owned once, the shared memory within the
  232,448 bytes a CTA may take, two rings of up to 8 stages.
- ``_marks``: the columns whose product rows the owners store.
- A Python model of the streamed schedule, phase by phase and CTA by CTA:
  the product on the raw (un-gathered) h of the step before in the
  weights' dtype, the own columns' cells from it, the reset columns' from
  their sources' product rows and fp32 carries, -1 sources from zeros. In
  float32 it equals ``lstm_fwd_plain`` to 1e-6 on masked, resetting inputs
  with -1 sources, from a carried state; in bf16 within one bf16 step; and
  it equals the JAX package's ``lstm_layer_pallas`` with resets in
  interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayeslms_tpu.ops import lstm_pallas as lp
from bayeslms_tpu_torch.ops import lstm_cuda as lc

N_SM = 132  # the H100 SXM's SMs
SMEM_LIMIT = 232448
# (T, B, H): the GP packed-carry pass's call; an ``evaluate`` window
PASS, EVALUATE = (256, 600, 1024), (100, 20, 1024)


# ------------------------------------------------------------------ rules

def test_row3_streamed_at_the_pass_call():
    plan = lc._design_fwd(*PASS, N_SM, resets=True)
    assert plan["design"] == "streamed"
    U = plan["units"]
    assert U == lc.S_UNITS and plan["ctas"] == 1024 // U <= N_SM
    assert plan["grid"] == (1024 // U,) and plan["threads"] == 288
    assert plan["m_tiles"] == 10
    assert plan["launches"] == 1 and plan["barriers"] == 255
    # the 4U gate rows of W_hh (16 chunks of 4U rows x 128 bytes), the
    # ring, the biases and the ring's barriers
    assert plan["smem_bytes"] == 1024 + 16 * 4 * U * 128 \
        + plan["stages"] * 8192 + 16 * U + 16 * plan["stages"] \
        <= SMEM_LIMIT
    # two rings of 8 stages, one for each consumer warpgroup: the depth
    # that timed fastest
    assert plan["stages"] == lc.S_MAX_NST == 16


@pytest.mark.parametrize("T,B,H,resets", [
    (*EVALUATE, True),      # resets at evaluate's batch: not row 4's design
    (9, 70, 64, True),      # B off the 64-row m tile
    (6, 130, 256, True),
    (7, 33, 512, True),
    (100, 33, 1024, False),  # past the persistent design's 32 columns
    (*PASS, False),
])
def test_row3_streamed_where_it_fits(T, B, H, resets):
    plan = lc._design_fwd(T, B, H, N_SM, resets=resets)
    assert plan["design"] == "streamed"
    assert plan["smem_bytes"] == lc.stream_smem(H, plan["stages"]) \
        <= SMEM_LIMIT
    assert plan["stages"] >= 4 and plan["stages"] % 2 == 0
    assert plan["m_tiles"] == -(-B // 64)
    assert plan["barriers"] == T - 1
    owned = sorted(u for c in range(plan["ctas"])
                   for u in range(plan["units"] * c,
                                  plan["units"] * (c + 1)))
    assert owned == list(range(H))  # every unit once


@pytest.mark.parametrize("T,B,H,n_sm,resets", [
    (256, 400, 96, N_SM, True),     # a width off the 64-column chunks
    (256, 600, 2048, N_SM, True),   # more CTAs than SMs
    (256, 600, 1024, 100, True),    # a card too small for the grid
    (100, 40, 96, N_SM, False),     # past 32 columns, off the chunks
])
def test_row3_per_step_where_the_streamed_design_refuses(T, B, H, n_sm,
                                                        resets):
    plan = lc._design_fwd(T, B, H, n_sm, resets=resets)
    assert plan["design"] == "per_step"
    assert plan["launches"] == T and plan["barriers"] == 0
    assert lc._stream_plan(T, B, H, n_sm) is None


@pytest.mark.parametrize("T,B,H", [EVALUATE, (1, 20, 1024), (9, 32, 512)])
def test_row4_keeps_its_persistent_design_without_resets(T, B, H):
    assert lc._design_fwd(T, B, H, N_SM)["design"] == "persistent"


def test_shared_memory_bounds_the_streamed_width():
    widest = max(H for H in range(64, 8192, 64)
                 if lc._stream_plan(1, 1, H, 10 ** 4) is not None)
    plan = lc._stream_plan(1, 1, widest, 10 ** 4)
    assert plan["stages"] == 4  # two rings of two stages
    assert lc._stream_plan(1, 1, widest + 64, 10 ** 4) is None
    assert widest == 3072 and lc.stream_smem(widest, 4) <= SMEM_LIMIT


def test_marks_are_the_columns_others_take():
    T, B = 6, 12
    g = torch.Generator().manual_seed(0)
    reset = (torch.rand((T, B), generator=g) < 0.4).to(torch.uint8)
    src = ((torch.arange(B) // 4) * 4).to(torch.int32)
    src[::5] = -1
    marks = lc._marks(reset, src)
    want = torch.zeros((T, B), dtype=torch.uint8)
    for t in range(T):
        for b in range(B):
            s = int(src[b])
            if reset[t, b] and s >= 0 and s != b:
                want[t, s] = 1
    assert torch.equal(marks, want)
    assert lc._marks(None, None) is None


# ------------------------------------------------------------------ model

def stream_model(xg, whh, bhh, h0, c0, step_mask=None, reset_mask=None,
                 reset_src=None, units=lc.S_UNITS):
    """The streamed kernel in PyTorch, phase by phase and CTA by CTA (CTA k
    owns units [units k, units (k + 1))). What crosses CTAs is only what the
    kernel stores before a grid barrier: ys in the weights' dtype, bf16(h0)
    in front. Each CTA's product takes the raw ys of the step before; the
    columns whose source is themselves run their cells from it, the reset
    columns from their source's product row and fp32 carries."""
    T, B, G = xg.shape
    H = G // 4
    dtype, f32 = whh.dtype, torch.float32
    w = whh.to(f32)
    y = {-1: h0.to(dtype)}
    h, c = {-1: h0.to(f32)}, {-1: c0.to(f32)}

    def gather(rows, s):
        out = rows[s.clamp(min=0)]
        return torch.where((s >= 0)[:, None], out, torch.zeros_like(out))

    for t in range(T):
        s = torch.arange(B)
        if reset_mask is not None:
            s = torch.where(reset_mask[t].bool(), reset_src.long(), s)
        keep = (torch.ones(B, 1, dtype=torch.bool) if step_mask is None
                else step_mask[t].bool()[:, None])
        h_new, c_new = torch.empty(B, H), torch.empty(B, H)
        for j0 in range(0, H, units):
            rows = torch.cat([torch.arange(q * H + j0, q * H + j0 + units)
                              for q in range(4)])
            cols = slice(j0, j0 + units)
            prod = y[t - 1].to(f32) @ w[rows].t()  # the raw h, all columns
            pre = (xg[t].to(f32)[:, rows] + gather(prod, s)) + bhh[rows]
            hp, cp = gather(h[t - 1], s)[:, cols], gather(c[t - 1], s)[:, cols]
            i, f, gg, o = pre.chunk(4, dim=-1)
            cn = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(gg)
            hn = torch.sigmoid(o) * torch.tanh(cn)
            h_new[:, cols] = torch.where(keep, hn, hp)
            c_new[:, cols] = torch.where(keep, cn, cp)
        h[t], c[t], y[t] = h_new, c_new, h_new.to(dtype)
    ys = torch.stack([y[t] for t in range(T)])
    return ys, h[T - 1].to(dtype), c[T - 1].to(dtype)


def _inputs(T, B, H, seed):
    """Float32 inputs: W scaled by 1 / sqrt(H), a carried state in +-0.5,
    the step mask drops a fifth of the (step, column) pairs, a quarter of
    them reset, sources in blocks of 4 columns and -1 (a zero state) on
    every fifth."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.uniform(-1, 1, size=s) * sc).astype(np.float32))
    args = [r(T, B, 4 * H), r(4 * H, H, sc=H ** -0.5), r(4 * H, sc=0.1),
            r(B, H, sc=0.5), r(B, H, sc=0.5)]
    mask = torch.from_numpy((rng.uniform(size=(T, B)) < 0.8)
                            .astype(np.uint8))
    reset = torch.from_numpy((rng.uniform(size=(T, B)) < 0.25)
                             .astype(np.uint8))
    src = torch.from_numpy(((np.arange(B) // 4) * 4).astype(np.int32))
    src[::5] = -1
    return args, mask, reset, src


@pytest.mark.parametrize("T,B,H,masked,reset", [
    (9, 12, 16, True, True), (6, 70, 32, True, True),
    (5, 8, 40, True, True), (7, 10, 16, False, True),
    (4, 9, 24, True, False), (1, 6, 16, True, True)])
def test_stream_schedule_equals_the_plain_twin(T, B, H, masked, reset):
    args, mask, rst, src = _inputs(T, B, H, seed=T * B + H)
    kw = dict(step_mask=mask if masked else None,
              reset_mask=rst if reset else None,
              reset_src=src if reset else None)
    got = stream_model(*args, **kw)
    ref = lc.lstm_fwd_plain(*args, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


def test_stream_schedule_in_bf16_rounds_as_the_twin():
    # weights, xg and the carried state in bf16: the product takes the raw
    # h rounded to bf16, as the twin rounds the gathered h
    args, mask, rst, src = _inputs(6, 12, 16, seed=5)
    bf = torch.bfloat16
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(bf)
    got = stream_model(*args, mask, rst, src)
    ref = lc.lstm_fwd_plain(*args, mask, rst, src)
    for g, r in zip(got, ref):
        assert g.dtype == bf
        # one bf16 step where the fp32 sums' order moves a rounding
        torch.testing.assert_close(g.float(), r.float(), rtol=2 ** -7,
                                   atol=1e-6)


def test_stream_schedule_equals_the_pallas_kernel(monkeypatch):
    """The model on the twin's arguments against ``lstm_layer_pallas`` with
    resets (``_run_reset``) in interpret mode, float32."""
    monkeypatch.setattr(lp, "_INTERPRET", True)
    T, B, E, H = 9, 12, 16, 16
    rng = np.random.default_rng(11)
    x = rng.normal(size=(T, B, E)).astype(np.float32)
    w_ih, w_hh, b_ih, b_hh = (rng.normal(size=s).astype(np.float32) * sc
                              for s, sc in (((4 * H, E), 0.3),
                                            ((4 * H, H), 0.3), ((4 * H,), 0.1),
                                            ((4 * H,), 0.1)))
    h0 = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    c0 = rng.normal(size=(B, H)).astype(np.float32) * 0.5
    mask = (rng.uniform(size=(T, B)) < 0.8).astype(np.float32)
    rmask = (rng.uniform(size=(T, B)) < 0.25).astype(np.float32)
    rsrc = ((np.arange(B) // 4) * 4).astype(np.int32)
    rsrc[::5] = -1
    ref = lp.lstm_layer_pallas(
        jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(w_ih),
        jnp.asarray(w_hh), jnp.asarray(b_ih), jnp.asarray(b_hh),
        jnp.asarray(mask), reset_mask=jnp.asarray(rmask),
        reset_src=jnp.asarray(rsrc))
    t = torch.from_numpy
    xg = t(x) @ t(w_ih).t() + t(b_ih)
    got = stream_model(xg, t(w_hh), t(b_hh), t(h0), t(c0), t(mask),
                       t(rmask), t(rsrc))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
