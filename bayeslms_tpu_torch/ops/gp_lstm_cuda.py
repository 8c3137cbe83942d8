"""GP-LSTM recurrences with gradients: the CUDA kernels' wrappers, their
plain twins and the autograd Functions behind ``gpg_layer_fused`` (GP gates
1-4) and ``gp6_layer_fused`` (GP gate 6).

Replaces ``bayeslms_tpu/ops/gp_lstm_pallas.py`` ``gpg_layer_fused`` (its
``_gpg_fwd_kernel`` and ``_gpg_bwd_kernel`` Pallas bodies, kernel rows 20
and 21) and ``gpg_pallas_ok``, and ``gp6_layer_fused`` (``_gp_fwd_kernel``
and ``_gp_bwd_kernel``, rows 18 and 19) and ``gp6_pallas_ok``. The kernels
are in ``csrc/gp_lstm.cu`` and ``csrc/gp6_lstm.cu`` (their forwards'
persistent design in ``csrc/lstm_persist.cuh``, their backwards' in
``csrc/gp_persist.cuh``), whose headers say what they compute term for
term, what bounds them on the H100 and how their designs answer that; each
forward has two designs, picked by ``_design_fwd``, and each backward two,
picked by ``_design``. ``gpg_fwd``, ``gpg_bwd``, ``gp6_fwd`` and
``gp6_bwd`` launch them for CUDA tensors and raise on what they do not
take; for CPU tensors they run their ``_plain`` twins, which repeat the
kernels' arithmetic step by step.

Gates 1-4 (kernels and plain alike), with ``dtype`` the weights' dtype:
h and c are carried in float32; one product h_{t-1} W5^T takes h rounded
to ``dtype``, W5 (5H, H) = [W_hh; w_h]; gates = (xg_t + h W_hh^T) + b_ih and
pre = gpx_t + h w_h^T in float32; gate ``gate`` of [i, f, g, o] is replaced
by sum_a coef[a] act_a(pre), the act set (sigmoid,) or (sigmoid, tanh,
relu) by the number of coef rows; ys and cs are stored in ``dtype``. The
backward recomputes each step from xg_t, gpx_t, ys_{t-1} and cs_{t-1} (in
``dtype``), stores du5 = [du (replaced slice zero), dpre] in ``dtype``,
takes the dh product on that rounded du5 and sums dcoef in float32 (the
kernels in a fixed order: the two-launch design a column block at a time,
the persistent one over the batch and then over the steps, each CTA its
own units, so repeat calls agree bit for bit). The persistent design takes
the product on h_{t-1} for all steps at once, before the recurrence, in
float32 (64-deep chunks added to nearest, where the per-step tiles' tensor
cores truncate); the twins take it a step at a time.

Gate 6: pre = h_{t-1} W'^T + b' with h rounded to ``dtype`` and b' stored
in ``dtype``; gates = xg_t + sum_a coef[a] act_a(pre) over (sigmoid, tanh,
relu), coef float32, no second bias; the standard cell. The backward
stores dux = du and dupre = dpre in ``dtype``, takes the dh product on the
rounded dupre and sums dcoef (3, 4H) in float32 as gates 1-4 do; dW' and
db' are float32 products and sums outside, rounded to W's and b''s dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from .lstm2_train_cuda import GEMM_TILE, gemm_smem
from .lstm_cuda import cell_update, est_vmem
from .lstm_train_cuda import (P_PAD, P_ROWS, P_THREADS, P_UNITS, SMEM_LIMIT,
                              TILE, _check, _ptr)

# kernel launches, one per call that reaches a kernel (forward, a call
# runs 1 cooperative launch in the persistent design or T step launches in
# the per-step one; backward, 2 in the persistent design or 2T + 1 in the
# two-launch one), and the calls by design; reset by callers that read
# them, such as chip_smoke.py
launches = {"gpg_fwd": 0, "gpg_bwd": 0, "gp6_fwd": 0, "gp6_bwd": 0}
design_launches = {"gpg_fwd": {"persistent": 0, "per_step": 0},
                   "gpg_bwd": {"persistent": 0, "two_launch": 0},
                   "gp6_fwd": {"persistent": 0, "per_step": 0},
                   "gp6_bwd": {"persistent": 0, "two_launch": 0}}

# act sets the kernels take, by the number of coef rows
ACT_SETS = {1: ("sigmoid",), 3: ("sigmoid", "tanh", "relu")}
_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu}

# the JAX gate (gp_lstm_pallas.py `gpg_pallas_ok`): the resident (H, 5H)
# block within 10 MiB, the U = 1 backward block set within the VMEM budget
_W5_MAX_BYTES = 10 * 1024 * 1024
_ROWS_GPG_BWD = 13
_VMEM_BUDGET = int(0.9 * 100 * 1024 * 1024)

# the gate-6 JAX gate (`gp6_pallas_ok`): the resident (H, 4H) W' within
# 8 MiB, the U = 1 backward block set within the same budget
_W6_MAX_BYTES = 8 * 1024 * 1024
_ROWS_GP6_BWD = 15
# the gate-6 unit's act set, the only one its kernels take
GP6_ACTS = ("sigmoid", "tanh", "relu")

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 16 + [ctypes.c_int] * 5 + [_P]
_GP6_FWD_ARGTYPES = [_P] * 10 + [ctypes.c_int] * 3 + [_P]
_GP6_BWD_ARGTYPES = [_P] * 16 + [ctypes.c_int] * 3 + [_P]
_PERSIST_ARGTYPES = [_P] * 16 + [ctypes.c_int] * 5 + [_P]
_GP6_PERSIST_ARGTYPES = [_P] * 16 + [ctypes.c_int] * 3 + [_P]
_FWD_PERSIST_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 5 + [_P]
_GP6_FWD_PERSIST_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 3 + [_P]

# The persistent designs' row groups of the recurrent weight (and of the
# product on h_{t-1}): W5 = [W_hh; w_h] (5H, H) for rows 20 (forward) and
# 21 (backward), W' (4H, H) for rows 18 and 19; warps a CTA, whose partial
# tiles (32 x 8 fp32 for each group in a forward, one 32 x 8 tile in a
# backward) share the CTA's shared memory with the weight's rows or
# column slice
GROUPS = {21: 5, 19: 4, 20: 5, 18: 4}
P_WARPS = P_THREADS // 32


def persist_smem(H: int, row: int = 21) -> int:
    """Dynamic shared memory of a persistent backward CTA of ``row`` (19 or
    21) at width H, bytes: the transposed column slice of the recurrent
    weight (8 rows of GROUPS[row] H + P_PAD bf16) and the 16 warps' partial
    dh tiles (32 x 8 fp32), which the step's dcoef terms reuse."""
    return P_UNITS * (GROUPS[row] * H + P_PAD) * 2 \
        + P_WARPS * P_ROWS * P_UNITS * 4


def _design(B: int, H: int, n_sm: int, T: int = 1, row: int = 21) -> dict:
    """The design of row ``row``'s backward (21: ``gpg_bwd``, 19:
    ``gp6_bwd``) for batch B and width H on a card of ``n_sm`` SMs.
    "persistent" (the GEMM P = hprev W^T for all T steps, then one
    cooperative launch of H / 8 CTAs, each owning 8 units with W's
    transposed column slice in shared memory, a grid barrier a step) where
    B <= 32, H is a multiple of 8, the CTAs number no more than the SMs
    (one a SM) and both kernels' shared memory fits; otherwise
    "two_launch" (the gates and dh kernels a step on (ceil(B / 32), H / 32)
    blocks, then the dcoef sum). An explicit rule: the chosen design runs
    or raises. Returns a dict with the design, recurrence grid, CTAs, units
    a CTA, threads and shared memory bytes, the GEMM's grid (output column
    tiles, row tiles, 1) and shared memory, and launches and grid barriers
    of a call of T steps."""
    smem = persist_smem(H, row)
    if B <= P_ROWS and H % P_UNITS == 0 and 0 < H // P_UNITS <= n_sm \
            and smem <= SMEM_LIMIT and gemm_smem() <= SMEM_LIMIT:
        ctas = H // P_UNITS
        gemm = (-(-GROUPS[row] * H // GEMM_TILE), -(-T * B // GEMM_TILE), 1)
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=P_UNITS, threads=P_THREADS, smem_bytes=smem,
                    gemm_grid=gemm, gemm_smem_bytes=gemm_smem(), launches=2,
                    barriers=T)
    blocks = (-(-B // TILE), H // TILE)
    return dict(design="two_launch", grid=blocks, ctas=blocks[0] * blocks[1],
                units=TILE, threads=None, smem_bytes=None, gemm_grid=None,
                gemm_smem_bytes=None, launches=2 * T + 1, barriers=0)


def fwd_persist_smem(H: int, row: int = 20) -> int:
    """Dynamic shared memory of a persistent forward CTA of ``row`` (18 or
    20) at width H, bytes: the weight's rows of the CTA's 8 units in each
    of its GROUPS[row] groups (8 GROUPS[row] rows of H + P_PAD bf16) and
    the 16 warps' partial product tiles (32 x 8 GROUPS[row] fp32)."""
    n = P_UNITS * GROUPS[row]
    return n * (H + P_PAD) * 2 + P_WARPS * P_ROWS * n * 4


def _design_fwd(B: int, H: int, n_sm: int, T: int = 1,
                row: int = 20) -> dict:
    """The design of row ``row``'s forward (20: ``gpg_fwd``, 18:
    ``gp6_fwd``) for batch B and width H on a card of ``n_sm`` SMs.
    "persistent" (one cooperative launch of H / 8 CTAs, each owning 8 units
    with their rows of the recurrent weight in shared memory, a grid
    barrier a step) where B <= 32, H is a multiple of 8, the CTAs number no
    more than the SMs (one a SM) and a CTA's shared memory fits; otherwise
    "per_step" (``gpg_fwd_step`` / ``gp6_fwd_step`` a step on (ceil(B /
    32), H / 32) blocks). An explicit rule: the chosen design runs or
    raises. Returns a dict with the design, grid, CTAs, units a CTA,
    threads, shared memory bytes, and launches and grid barriers of a call
    of T steps."""
    smem = fwd_persist_smem(H, row)
    if B <= P_ROWS and H % P_UNITS == 0 and 0 < H // P_UNITS <= n_sm \
            and smem <= SMEM_LIMIT:
        ctas = H // P_UNITS
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=P_UNITS, threads=P_THREADS, smem_bytes=smem,
                    launches=1, barriers=max(T - 1, 0))
    blocks = (-(-B // TILE), H // TILE)
    return dict(design="per_step", grid=blocks, ctas=blocks[0] * blocks[1],
                units=TILE, threads=None, smem_bytes=None, launches=T,
                barriers=0)


def _card_design(dev, B, H, T, row):
    n_sm = _build.sm_count(dev.index)
    if row in (18, 20):
        return _design_fwd(B, H, n_sm, T, row)
    return _design(B, H, n_sm, T, row)


def gpg_kernel_ok(x: torch.Tensor, nhid: int) -> bool:
    """``gpg_pallas_ok(nhid, x.dtype, batch=x.shape[1])`` with a CUDA
    tensor in place of the TPU platform."""
    itemsize = x.element_size()
    return (x.is_cuda and nhid * 5 * nhid * itemsize <= _W5_MAX_BYTES
            and est_vmem(1, x.shape[1], nhid, _ROWS_GPG_BWD * nhid,
                         itemsize) <= _VMEM_BUDGET)


def _mixture(pre, coef):
    """sum_a coef[a] act_a(pre) and the acts, in the kernels' order."""
    avals = [_ACT[a](pre) for a in ACT_SETS[coef.shape[0]]]
    gp = coef[0] * avals[0]
    for a in range(1, len(avals)):
        gp = gp + coef[a] * avals[a]
    return gp, avals


def _step(xg_t, gpx_t, h, w_t, bih, coef, gate, dtype):
    """One step's (pre, acts, [i, f, g, o]) from h_{t-1} (float32 or
    ``dtype``), as the kernels compute them."""
    H = w_t.shape[0]
    hw = h.to(dtype).float() @ w_t
    gates = (xg_t.float() + hw[:, :4 * H]) + bih
    pre = gpx_t.float() + hw[:, 4 * H:]
    gp, avals = _mixture(pre, coef)
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    acts = [gp if gate == 1 else torch.sigmoid(gi),
            gp if gate == 2 else torch.sigmoid(gf),
            gp if gate == 3 else torch.tanh(gg),
            gp if gate == 4 else torch.sigmoid(go)]
    return pre, avals, acts


def gpg_fwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, gate):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``gpg_fwd``."""
    dtype = w5.dtype
    w_t = w5.float().t()
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(xg.shape[0]):
        _, _, (i, f, g, o) = _step(xg[t], gpx[t], h, w_t, bih, coef, gate,
                                   dtype)
        cn = f * c + i * g
        hn = o * torch.tanh(cn)
        if mask is not None:
            keep = mask[t].bool()[:, None]
            hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
        h, c = hn, cn
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    return torch.stack(ys), torch.stack(cs), h.to(dtype), c.to(dtype)


def _act_d(name, pre, av):
    if name == "sigmoid":
        return av * (1.0 - av)
    if name == "tanh":
        return 1.0 - av * av
    return (pre > 0.0).float()


def gpg_bwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT,
                  dcT, gate):
    """Plain PyTorch version of the backward kernel, same arguments as
    ``gpg_bwd``."""
    dtype = w5.dtype
    w = w5.float()
    w_t = w.t()
    names = ACT_SETS[coef.shape[0]]
    dh, dc = dhT.float(), dcT.float()
    dcoef = torch.zeros(coef.shape, dtype=torch.float32, device=xg.device)
    T, B, G = xg.shape
    du5 = torch.empty((T, B, 5 * (G // 4)), dtype=dtype, device=xg.device)
    for t in reversed(range(T)):
        h_prev = h0 if t == 0 else ys[t - 1]
        c_prev = (c0 if t == 0 else cs[t - 1]).float()
        pre, avals, (i, f, g, o) = _step(xg[t], gpx[t], h_prev, w_t, bih,
                                         coef, gate, dtype)
        tc = torch.tanh(f * c_prev + i * g)
        keep = (torch.ones_like(dh[:, :1]) if mask is None
                else mask[t].to(torch.float32)[:, None])
        dh_tot = dh + dy[t].float()
        dh_new = keep * dh_tot
        dc_new = keep * dc
        d_o = dh_new * tc
        dcc = dc_new + dh_new * o * (1.0 - tc * tc)
        d_i, d_f, d_g = dcc * g, dcc * c_prev, dcc * i
        dc = dcc * f + (1.0 - keep) * dc
        du = [d_i * i * (1.0 - i), d_f * f * (1.0 - f), d_g * (1.0 - g * g),
              d_o * o * (1.0 - o)]
        dgp = (d_i, d_f, d_g, d_o)[gate - 1]
        du[gate - 1] = torch.zeros_like(dgp)
        dmix = torch.zeros_like(pre)
        for a, (name, av) in enumerate(zip(names, avals)):
            dcoef[a] += (dgp * av).sum(0)
            dmix = dmix + coef[a] * _act_d(name, pre, av)
        du5[t] = torch.cat([*du, dgp * dmix], dim=-1).to(dtype)
        dh = du5[t].float() @ w + (1.0 - keep) * dh_tot
    return du5, dcoef, dh.to(dtype), dc.to(dtype)


def _checked(fn, xg, gpx, w5, bih, coef, mask, gate, states):
    """Validate the arguments both kernels take; returns (T, B, H, nact,
    mask as contiguous bytes or None)."""
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"{fn}: hidden size {G / 4} must be a multiple of "
                         f"32 (xg width {G})")
    if gate not in (1, 2, 3, 4) or coef.shape[0] not in ACT_SETS:
        raise ValueError(f"{fn}: gate {gate} with {coef.shape[0]} coef rows;"
                         f" the kernels take gates 1-4 and the act sets "
                         f"{list(ACT_SETS.values())}")
    nact = coef.shape[0]
    _check(fn, "xg", xg, bf16, (T, B, G), dev)
    _check(fn, "gpx", gpx, bf16, (T, B, H), dev)
    _check(fn, "w5", w5, bf16, (5 * H, H), dev)
    _check(fn, "bih", bih, torch.float32, (G,), dev)
    _check(fn, "coef", coef, torch.float32, (nact, H), dev)
    for name, s, shape in states:
        _check(fn, name, s, bf16, shape, dev)
    if mask is not None:
        mask = (mask != 0).to(torch.uint8).contiguous()
        _check(fn, "mask", mask, torch.uint8, (T, B), dev)
    return T, B, H, nact, mask


def _call(fn, argtypes, *args, entry=None):
    f = getattr(_build.load("gp6_lstm" if fn.startswith("gp6")
                            else "gp_lstm"), entry or fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: error {err}")
    launches[fn] += 1


def _chosen(fn, design, B, H, T, dev, row):
    """The design a call of row ``row`` takes: ``design``, or the one its
    rule (``_design_fwd`` for rows 18 and 20, ``_design`` for 19 and 21)
    picks where it is None; raises where the persistent design is asked for
    and does not take the shapes, or the design is not one of the row's."""
    plan = _card_design(dev, B, H, T, row)["design"]
    if design is None:
        return plan
    if design not in design_launches[fn]:
        raise ValueError(f"{fn}: no design {design!r}; its designs are "
                         f"{sorted(design_launches[fn])}")
    if design == "persistent" and plan != "persistent":
        raise ValueError(f"{fn}: the persistent design does not take B={B} "
                         f"H={H}")
    return design


def _persist_operands(h0, ys, G, dev):
    """The persistent backward's hprev = [h0, ys[:-1]] (T B, H), its fp32
    workspace P (T B, G) and the grid barrier's zeroed counter."""
    T, B, H = ys.shape
    hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, H)
    P = torch.empty((T * B, G), dtype=torch.float32, device=dev)
    return hprev, P, torch.zeros((1,), dtype=torch.int32, device=dev)


def gpg_fwd(xg: torch.Tensor, gpx: torch.Tensor, w5: torch.Tensor,
            bih: torch.Tensor, coef: torch.Tensor,
            mask: Optional[torch.Tensor], h0: torch.Tensor, c0: torch.Tensor,
            gate: int):
    """The recurrence over a (T, B) sequence, keeping the cell sequence.

    xg (T, B, 4H) = x W_ih^T + b_ih and gpx (T, B, H) = x w_x^T + b_gp in
    the compute dtype; w5 (5H, H), W_hh's rows then the GP weight's h part,
    in the compute dtype; bih (4H,) float32 (b_ih, added again each step);
    coef (k, H) float32, k = 1 or 3 acts; mask (T, B), nonzero = step, or
    None; h0, c0 (B, H) in the compute dtype; gate 1-4. Returns ys, cs
    (T, B, H), hT, cT (B, H) in the compute dtype. CUDA tensors launch the
    forward of ``csrc/gp_lstm.cu`` in the design ``_design_fwd`` picks
    (bf16 only); CPU tensors run ``gpg_fwd_plain``.
    """
    if not xg.is_cuda:
        return gpg_fwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, gate)
    return _gpg_fwd(None, xg, gpx, w5, bih, coef, mask, h0, c0, gate)


def _gpg_fwd(design, xg, gpx, w5, bih, coef, mask, h0, c0, gate):
    """``gpg_fwd`` on CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design_fwd`` picks where it is None;
    chip_smoke.py checks and times the per-step design on the persistent
    design's calls through it."""
    fn = "gpg_fwd"
    B, H = xg.shape[1], xg.shape[2] // 4
    T, B, H, nact, mask = _checked(fn, xg, gpx, w5, bih, coef, mask, gate, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H))))
    design = _chosen(fn, design, B, H, T, xg.device, 20)
    h = h0.float().contiguous()
    c = c0.float().contiguous()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xg.device)
    cs = torch.empty_like(ys)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    args = (_ptr(xg), _ptr(gpx), _ptr(w5), _ptr(bih), _ptr(coef),
            _ptr(mask), _ptr(h0), _ptr(h), _ptr(c), _ptr(ys), _ptr(cs))
    if design == "persistent":
        bar = torch.zeros((1,), dtype=torch.int32, device=xg.device)
        _call(fn, _FWD_PERSIST_ARGTYPES, *args, _ptr(bar), T, B, H, gate,
              nact, stream, entry="gpg_fwd_persist")
    else:
        _call(fn, _FWD_ARGTYPES, *args, T, B, H, gate, nact, stream)
    design_launches[fn][design] += 1
    return ys, cs, h.to(torch.bfloat16), c.to(torch.bfloat16)


def gpg_bwd(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT, dcT,
            gate):
    """Reverse-time gradients of ``gpg_fwd``.

    The forward's arguments and outputs ys, cs, with dy (T, B, H) and dhT,
    dcT (B, H), all in the compute dtype. Returns du5 (T, B, 5H) in the
    compute dtype, the gradient of [gates, pre] with the replaced gate's
    slice zero; dcoef (k, H) float32; dh0, dc0 (B, H) in the compute dtype.
    CUDA tensors launch the backward of ``csrc/gp_lstm.cu`` in the design
    ``_design`` picks (bf16 only); CPU tensors run ``gpg_bwd_plain``.
    """
    if not xg.is_cuda:
        return gpg_bwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs,
                             dy, dhT, dcT, gate)
    return _gpg_bwd(None, xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy,
                    dhT, dcT, gate)


def _gpg_bwd(design, xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT,
             dcT, gate):
    """``gpg_bwd`` on CUDA tensors in ``design`` ("persistent" or
    "two_launch"), or in the one ``_design`` picks where it is None;
    chip_smoke.py checks and times the two-launch design on the persistent
    design's calls through it."""
    fn = "gpg_bwd"
    T, B, G = xg.shape
    H = G // 4
    T, B, H, nact, mask = _checked(fn, xg, gpx, w5, bih, coef, mask, gate, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H)), ("ys", ys, (T, B, H)),
        ("cs", cs, (T, B, H)), ("dy", dy, (T, B, H)), ("dhT", dhT, (B, H)),
        ("dcT", dcT, (B, H))))
    dev = xg.device
    design = _chosen(fn, design, B, H, T, dev, 21)
    dh = dhT.float().contiguous()
    dc = dcT.float().contiguous()
    du5 = torch.empty((T, B, 5 * H), dtype=torch.bfloat16, device=dev)
    dcoef = torch.empty((nact, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if design == "persistent":
        hprev, P, bar = _persist_operands(h0, ys, 5 * H, dev)
        _call(fn, _PERSIST_ARGTYPES, _ptr(xg), _ptr(gpx), _ptr(w5),
              _ptr(bih), _ptr(coef), _ptr(mask), _ptr(hprev), _ptr(c0),
              _ptr(cs), _ptr(dy), _ptr(dh), _ptr(dc), _ptr(du5), _ptr(dcoef),
              _ptr(P), _ptr(bar), T, B, H, gate, nact, stream,
              entry="gpg_bwd_persist")
    else:
        acc = torch.zeros((-(-B // 32), nact, H), dtype=torch.float32,
                          device=dev)
        _call(fn, _BWD_ARGTYPES, _ptr(xg), _ptr(gpx), _ptr(w5), _ptr(bih),
              _ptr(coef), _ptr(mask), _ptr(h0), _ptr(c0), _ptr(ys), _ptr(cs),
              _ptr(dy), _ptr(dh), _ptr(dc), _ptr(du5), _ptr(acc),
              _ptr(dcoef), T, B, H, gate, nact, stream)
    design_launches[fn][design] += 1
    return du5, dcoef, dh.to(torch.bfloat16), dc.to(torch.bfloat16)


class _GPGFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, gpx, w5, bih, coef, h0, c0, mask, gate):
        b32, c32 = bih.float(), coef.float().contiguous()
        ys, cs, hT, cT = gpg_fwd(xg, gpx, w5, b32, c32, mask, h0, c0, gate)
        ctx.save_for_backward(xg, gpx, w5, b32, c32, h0, c0, ys, cs)
        ctx.mask, ctx.gate = mask, gate
        ctx.b_dtype, ctx.coef_dtype = bih.dtype, coef.dtype
        ctx.mark_non_differentiable(cs)
        return ys, cs, hT, cT

    @staticmethod
    def backward(ctx, dy, _dcs, dhT, dcT):
        xg, gpx, w5, b32, c32, h0, c0, ys, cs = ctx.saved_tensors
        dy = torch.zeros_like(ys) if dy is None else dy.contiguous()
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        du5, dcoef, dh0, dc0 = gpg_bwd(xg, gpx, w5, b32, c32, ctx.mask, h0,
                                       c0, ys, cs, dy, dhT, dcT, ctx.gate)
        # dW5 = du5^T hprev and db_ih = sum du5[:, :4H]: float32 products
        # and sums outside the kernel (the TPU package's XLA ops), rounded
        # to the operands' dtypes
        T, B, G5 = du5.shape
        G = 4 * (G5 // 5)
        hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, -1).float()
        du5f = du5.reshape(T * B, G5).float()
        dw5 = (du5f.t() @ hprev).to(w5.dtype)
        dbih = du5f[:, :G].sum(0).to(ctx.b_dtype)
        return (du5[..., :G].to(xg.dtype), du5[..., G:].to(gpx.dtype), dw5,
                dbih, dcoef.to(ctx.coef_dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype), None, None)


def gpg_layer_fused(xg: torch.Tensor, gpx: torch.Tensor, w_hh: torch.Tensor,
                    b_ih: torch.Tensor, w_h: torch.Tensor, coef: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor, gate: int,
                    acts: Sequence[str],
                    step_mask: Optional[torch.Tensor] = None):
    """Differentiable gate-replacement GP layer (the JAX package's
    ``gpg_layer_fused``): xg (T, B, 4H) = x W_ih^T + b_ih and gpx (T, B, H)
    = x w_x^T + b_gp in the compute dtype; w_hh (4H, H); b_ih (4H,), added
    again each step (the reference's quirk); w_h (H, H), the GP weight's h
    part; coef (k, H); h0, c0 (B, H); ``acts`` the GP unit's act set.
    Returns ys, (hT, cT) in the compute dtype; gradients flow to every
    tensor argument (not through the cell sequence, which no caller
    consumes)."""
    acts = tuple(acts)
    if ACT_SETS.get(coef.shape[0]) != acts:
        raise ValueError(f"gpg_layer_fused: act set {acts} with "
                         f"{coef.shape[0]} coef rows; the kernels take "
                         f"{list(ACT_SETS.values())}")
    dtype = xg.dtype
    w5 = torch.cat([w_hh.to(dtype), w_h.to(dtype)], dim=0).contiguous()
    ys, _cs, hT, cT = _GPGFused.apply(
        xg.contiguous(), gpx.contiguous(), w5, b_ih.to(dtype), coef,
        h0.to(dtype), c0.to(dtype), step_mask, int(gate))
    return ys, (hT, cT)


# ------------------------------------------------------------------ gate 6
def gp6_kernel_ok(x: torch.Tensor, nhid: int) -> bool:
    """``gp6_pallas_ok(nhid, x.dtype, batch=x.shape[1])`` with a CUDA
    tensor in place of the TPU platform: W' (4H, H) within 8 MiB (exactly
    8 MiB at H = 1,024 in bf16 is admitted) and the U = 1 backward block
    set within the VMEM budget."""
    itemsize = x.element_size()
    return (x.is_cuda and nhid * 4 * nhid * itemsize <= _W6_MAX_BYTES
            and est_vmem(1, x.shape[1], nhid, _ROWS_GP6_BWD * nhid,
                         itemsize) <= _VMEM_BUDGET)


def _gp6_step(xg_t, h, w_t, b32, coef, dtype):
    """One step's (pre, (sigmoid, tanh, relu) of pre, gate pre-activations)
    from h_{t-1} (float32 or ``dtype``), as the kernels compute them."""
    pre = h.to(dtype).float() @ w_t + b32
    avals = (torch.sigmoid(pre), torch.tanh(pre), torch.relu(pre))
    mix = coef[0] * avals[0] + coef[1] * avals[1] + coef[2] * avals[2]
    return pre, avals, xg_t.float() + mix


def gp6_fwd_plain(xg, w, b, coef, mask, h0, c0):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``gp6_fwd``."""
    dtype = w.dtype
    w_t, b32 = w.float().t(), b.float()
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(xg.shape[0]):
        gates = _gp6_step(xg[t], h, w_t, b32, coef, dtype)[2]
        h, c = cell_update(gates, h, c, None if mask is None else mask[t])
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    return torch.stack(ys), torch.stack(cs), h.to(dtype), c.to(dtype)


def gp6_bwd_plain(xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT):
    """Plain PyTorch version of the backward kernel, same arguments as
    ``gp6_bwd``."""
    dtype = w.dtype
    wf, b32 = w.float(), b.float()
    w_t = wf.t()
    dh, dc = dhT.float(), dcT.float()
    dcoef = torch.zeros(coef.shape, dtype=torch.float32, device=xg.device)
    dux = torch.empty(xg.shape, dtype=dtype, device=xg.device)
    dupre = torch.empty_like(dux)
    for t in reversed(range(xg.shape[0])):
        h_prev = h0 if t == 0 else ys[t - 1]
        c_prev = (c0 if t == 0 else cs[t - 1]).float()
        pre, (s, th, r), gates = _gp6_step(xg[t], h_prev, w_t, b32, coef,
                                           dtype)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        tc = torch.tanh(f * c_prev + i * g)
        keep = (torch.ones_like(dh[:, :1]) if mask is None
                else mask[t].to(torch.float32)[:, None])
        dh_tot = dh + dy[t].float()
        dh_new = keep * dh_tot
        dc_new = keep * dc
        d_o = dh_new * tc
        dcc = dc_new + dh_new * o * (1.0 - tc * tc)
        dc = dcc * f + (1.0 - keep) * dc
        du = torch.cat([dcc * g * i * (1.0 - i), dcc * c_prev * f * (1.0 - f),
                        dcc * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
        dcoef[0] += (du * s).sum(0)
        dcoef[1] += (du * th).sum(0)
        dcoef[2] += (du * r).sum(0)
        dpre = du * (coef[0] * s * (1.0 - s) + coef[1] * (1.0 - th * th)
                     + coef[2] * (pre > 0.0).float())
        dux[t] = du.to(dtype)
        dupre[t] = dpre.to(dtype)
        dh = dupre[t].float() @ wf + (1.0 - keep) * dh_tot
    return dux, dupre, dcoef, dh.to(dtype), dc.to(dtype)


def _gp6_checked(fn, xg, w, b, coef, mask, states):
    """Validate the arguments both gate-6 kernels take; returns (T, B, H,
    mask as contiguous bytes or None)."""
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"{fn}: hidden size {G / 4} must be a multiple of "
                         f"32 (xg width {G})")
    _check(fn, "xg", xg, bf16, (T, B, G), dev)
    _check(fn, "w", w, bf16, (G, H), dev)
    _check(fn, "b", b, bf16, (G,), dev)
    _check(fn, "coef", coef, torch.float32, (len(GP6_ACTS), G), dev)
    for name, s, shape in states:
        _check(fn, name, s, bf16, shape, dev)
    if mask is not None:
        mask = (mask != 0).to(torch.uint8).contiguous()
        _check(fn, "mask", mask, torch.uint8, (T, B), dev)
    return T, B, H, mask


def gp6_fwd(xg: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            coef: torch.Tensor, mask: Optional[torch.Tensor],
            h0: torch.Tensor, c0: torch.Tensor):
    """The gate-6 recurrence over a (T, B) sequence, keeping the cell
    sequence.

    xg (T, B, 4H) = x W_ih^T + b_ih in the compute dtype; w (4H, H), the
    drawn GP weight as stored, and b (4H,) in the compute dtype; coef
    (3, 4H) float32, the (sigmoid, tanh, relu) coefficients; mask (T, B),
    nonzero = step, or None; h0, c0 (B, H) in the compute dtype. Returns
    ys, cs (T, B, H), hT, cT (B, H) in the compute dtype. CUDA tensors
    launch the forward of ``csrc/gp6_lstm.cu`` in the design
    ``_design_fwd`` picks (bf16 only); CPU tensors run ``gp6_fwd_plain``.
    """
    if not xg.is_cuda:
        return gp6_fwd_plain(xg, w, b, coef, mask, h0, c0)
    return _gp6_fwd(None, xg, w, b, coef, mask, h0, c0)


def _gp6_fwd(design, xg, w, b, coef, mask, h0, c0):
    """``gp6_fwd`` on CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design_fwd`` picks where it is None;
    chip_smoke.py checks and times the per-step design on the persistent
    design's calls through it."""
    fn = "gp6_fwd"
    B, H = xg.shape[1], xg.shape[2] // 4
    T, B, H, mask = _gp6_checked(fn, xg, w, b, coef, mask, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H))))
    design = _chosen(fn, design, B, H, T, xg.device, 18)
    h = h0.float().contiguous()
    c = c0.float().contiguous()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xg.device)
    cs = torch.empty_like(ys)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    args = (_ptr(xg), _ptr(w), _ptr(b), _ptr(coef), _ptr(mask), _ptr(h0),
            _ptr(h), _ptr(c), _ptr(ys), _ptr(cs))
    if design == "persistent":
        bar = torch.zeros((1,), dtype=torch.int32, device=xg.device)
        _call(fn, _GP6_FWD_PERSIST_ARGTYPES, *args, _ptr(bar), T, B, H,
              stream, entry="gp6_fwd_persist")
    else:
        _call(fn, _GP6_FWD_ARGTYPES, *args, T, B, H, stream)
    design_launches[fn][design] += 1
    return ys, cs, h.to(torch.bfloat16), c.to(torch.bfloat16)


def gp6_bwd(xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT):
    """Reverse-time gradients of ``gp6_fwd``.

    The forward's arguments and outputs ys, cs, with dy (T, B, H) and dhT,
    dcT (B, H), all in the compute dtype. Returns dux, the gradient of the
    gate pre-activations (= d xg), and dupre, that of the GP unit's
    pre-activation, both (T, B, 4H) in the compute dtype; dcoef (3, 4H)
    float32; dh0, dc0 (B, H) in the compute dtype. CUDA tensors launch the
    backward of ``csrc/gp6_lstm.cu`` in the design ``_design`` picks (bf16
    only); CPU tensors run ``gp6_bwd_plain``.
    """
    if not xg.is_cuda:
        return gp6_bwd_plain(xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT,
                             dcT)
    return _gp6_bwd(None, xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT)


def _gp6_bwd(design, xg, w, b, coef, mask, h0, c0, ys, cs, dy, dhT, dcT):
    """``gp6_bwd`` on CUDA tensors in ``design`` ("persistent" or
    "two_launch"), or in the one ``_design`` picks where it is None;
    chip_smoke.py checks and times the two-launch design on the persistent
    design's calls through it."""
    fn = "gp6_bwd"
    T, B, G = xg.shape
    H = G // 4
    T, B, H, mask = _gp6_checked(fn, xg, w, b, coef, mask, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H)), ("ys", ys, (T, B, H)),
        ("cs", cs, (T, B, H)), ("dy", dy, (T, B, H)), ("dhT", dhT, (B, H)),
        ("dcT", dcT, (B, H))))
    dev = xg.device
    design = _chosen(fn, design, B, H, T, dev, 19)
    dh = dhT.float().contiguous()
    dc = dcT.float().contiguous()
    dux = torch.empty((T, B, G), dtype=torch.bfloat16, device=dev)
    dupre = torch.empty_like(dux)
    dcoef = torch.empty((len(GP6_ACTS), G), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if design == "persistent":
        hprev, P, bar = _persist_operands(h0, ys, G, dev)
        _call(fn, _GP6_PERSIST_ARGTYPES, _ptr(xg), _ptr(w), _ptr(b),
              _ptr(coef), _ptr(mask), _ptr(hprev), _ptr(c0), _ptr(cs),
              _ptr(dy), _ptr(dh), _ptr(dc), _ptr(dux), _ptr(dupre),
              _ptr(dcoef), _ptr(P), _ptr(bar), T, B, H, stream,
              entry="gp6_bwd_persist")
    else:
        acc = torch.zeros((-(-B // 32), len(GP6_ACTS), G),
                          dtype=torch.float32, device=dev)
        _call(fn, _GP6_BWD_ARGTYPES, _ptr(xg), _ptr(w), _ptr(b), _ptr(coef),
              _ptr(mask), _ptr(h0), _ptr(c0), _ptr(ys), _ptr(cs), _ptr(dy),
              _ptr(dh), _ptr(dc), _ptr(dux), _ptr(dupre), _ptr(acc),
              _ptr(dcoef), T, B, H, stream)
    design_launches[fn][design] += 1
    return dux, dupre, dcoef, dh.to(torch.bfloat16), dc.to(torch.bfloat16)


class _GP6Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, w, b, coef, h0, c0, mask):
        ys, cs, hT, cT = gp6_fwd(xg, w, b, coef, mask, h0, c0)
        ctx.save_for_backward(xg, w, b, coef, h0, c0, ys, cs)
        ctx.mask = mask
        ctx.mark_non_differentiable(cs)
        return ys, cs, hT, cT

    @staticmethod
    def backward(ctx, dy, _dcs, dhT, dcT):
        xg, w, b, coef, h0, c0, ys, cs = ctx.saved_tensors
        dy = torch.zeros_like(ys) if dy is None else dy.contiguous()
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        dux, dupre, dcoef, dh0, dc0 = gp6_bwd(xg, w, b, coef, ctx.mask, h0,
                                              c0, ys, cs, dy, dhT, dcT)
        # dW' = dupre^T hprev and db' = sum dupre: float32 products and sums
        # outside the kernel (the TPU package's XLA ops), rounded to W's and
        # b''s dtype (the compute dtype: b' entered in it)
        T, B, G = dupre.shape
        hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, -1).float()
        dpf = dupre.reshape(T * B, G).float()
        dw = (dpf.t() @ hprev).to(w.dtype)
        db = dpf.sum(0).to(b.dtype)
        return (dux.to(xg.dtype), dw, db, dcoef.to(coef.dtype),
                dh0.to(h0.dtype), dc0.to(c0.dtype), None)


def gp6_layer_fused(xg: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    coef: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                    step_mask: Optional[torch.Tensor] = None):
    """Differentiable gate-6 GP layer (the JAX package's
    ``gp6_layer_fused``): xg (T, B, 4H) = x W_ih^T + b_ih in the compute
    dtype; w (4H, H) the drawn GP weight, as stored; b (4H,); coef (3, 4H)
    over (sigmoid, tanh, relu); h0, c0 (B, H); step_mask (T, B) or None.
    W' and b' are cast to the compute dtype, coef to float32, as the JAX
    wrapper casts them. Returns ys, (hT, cT) in the compute dtype;
    gradients flow to every tensor argument (not through the cell
    sequence, which no caller consumes)."""
    if coef.shape[0] != len(GP6_ACTS):
        raise ValueError(f"gp6_layer_fused: {coef.shape[0]} coef rows; the "
                         f"kernels take the act set {GP6_ACTS}")
    dtype = xg.dtype
    ys, _cs, hT, cT = _GP6Fused.apply(
        xg.contiguous(), w.to(dtype).contiguous(), b.to(dtype),
        coef.float().contiguous(), h0.to(dtype).contiguous(),
        c0.to(dtype).contiguous(), step_mask)
    return ys, (hT, cT)
