"""GP-LSTM gate-replacement recurrence (GP gates 1-4) with gradients: the
CUDA kernels' wrappers, their plain twins and the autograd Function behind
``gpg_layer_fused``.

Replaces ``bayeslms_tpu/ops/gp_lstm_pallas.py`` ``gpg_layer_fused`` (its
``_gpg_fwd_kernel`` and ``_gpg_bwd_kernel`` Pallas bodies, kernel rows 20
and 21) and ``gpg_pallas_ok``. The kernels are in ``csrc/gp_lstm.cu``,
whose header says what they compute term for term, what bounds them on the
H100 and how their design answers that. ``gpg_fwd`` and ``gpg_bwd`` launch
them for CUDA tensors and raise on what they do not take; for CPU tensors
they run ``gpg_fwd_plain`` and ``gpg_bwd_plain``, which repeat the
kernels' arithmetic step by step.

Arithmetic (kernels and plain alike), with ``dtype`` the weights' dtype:
h and c are carried in float32; one product h_{t-1} W5^T takes h rounded
to ``dtype``, W5 (5H, H) = [W_hh; w_h]; gates = (xg_t + h W_hh^T) + b_ih and
pre = gpx_t + h w_h^T in float32; gate ``gate`` of [i, f, g, o] is replaced
by sum_a coef[a] act_a(pre), the act set (sigmoid,) or (sigmoid, tanh,
relu) by the number of coef rows; ys and cs are stored in ``dtype``. The
backward recomputes each step from xg_t, gpx_t, ys_{t-1} and cs_{t-1} (in
``dtype``), stores du5 = [du (replaced slice zero), dpre] in ``dtype``,
takes the dh product on that rounded du5 and sums dcoef in float32 (the
kernel a column block at a time in a fixed order, so repeat calls agree
bit for bit).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from .lstm_cuda import est_vmem
from .lstm_train_cuda import _check, _ptr

# kernel launches, one per call that reaches a kernel (a call runs T step
# launches forward, 2T + 1 backward); reset by callers that read them, such
# as chip_smoke.py
launches = {"gpg_fwd": 0, "gpg_bwd": 0}

# act sets the kernels take, by the number of coef rows
ACT_SETS = {1: ("sigmoid",), 3: ("sigmoid", "tanh", "relu")}
_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu}

# the JAX gate (gp_lstm_pallas.py `gpg_pallas_ok`): the resident (H, 5H)
# block within 10 MiB, the U = 1 backward block set within the VMEM budget
_W5_MAX_BYTES = 10 * 1024 * 1024
_ROWS_GPG_BWD = 13
_VMEM_BUDGET = int(0.9 * 100 * 1024 * 1024)

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 16 + [ctypes.c_int] * 5 + [_P]


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


def _call(fn, argtypes, *args):
    f = getattr(_build.load("gp_lstm"), fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: error {err}")
    launches[fn] += 1


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
    (T, B, H), hT, cT (B, H) in the compute dtype. CUDA tensors launch
    ``gpg_fwd`` of ``csrc/gp_lstm.cu`` (bf16 only); CPU tensors run
    ``gpg_fwd_plain``.
    """
    if not xg.is_cuda:
        return gpg_fwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, gate)
    fn = "gpg_fwd"
    B, H = xg.shape[1], xg.shape[2] // 4
    T, B, H, nact, mask = _checked(fn, xg, gpx, w5, bih, coef, mask, gate, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H))))
    h = h0.float().contiguous()
    c = c0.float().contiguous()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xg.device)
    cs = torch.empty_like(ys)
    _call(fn, _FWD_ARGTYPES, _ptr(xg), _ptr(gpx), _ptr(w5), _ptr(bih),
          _ptr(coef), _ptr(mask), _ptr(h0), _ptr(h), _ptr(c), _ptr(ys),
          _ptr(cs), T, B, H, gate, nact,
          torch.cuda.current_stream(xg.device).cuda_stream)
    return ys, cs, h.to(torch.bfloat16), c.to(torch.bfloat16)


def gpg_bwd(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs, dy, dhT, dcT,
            gate):
    """Reverse-time gradients of ``gpg_fwd``.

    The forward's arguments and outputs ys, cs, with dy (T, B, H) and dhT,
    dcT (B, H), all in the compute dtype. Returns du5 (T, B, 5H) in the
    compute dtype, the gradient of [gates, pre] with the replaced gate's
    slice zero; dcoef (k, H) float32; dh0, dc0 (B, H) in the compute dtype.
    CUDA tensors launch ``gpg_bwd`` of ``csrc/gp_lstm.cu`` (bf16 only); CPU
    tensors run ``gpg_bwd_plain``.
    """
    if not xg.is_cuda:
        return gpg_bwd_plain(xg, gpx, w5, bih, coef, mask, h0, c0, ys, cs,
                             dy, dhT, dcT, gate)
    fn = "gpg_bwd"
    T, B, G = xg.shape
    H = G // 4
    T, B, H, nact, mask = _checked(fn, xg, gpx, w5, bih, coef, mask, gate, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H)), ("ys", ys, (T, B, H)),
        ("cs", cs, (T, B, H)), ("dy", dy, (T, B, H)), ("dhT", dhT, (B, H)),
        ("dcT", dcT, (B, H))))
    dev = xg.device
    dh = dhT.float().contiguous()
    dc = dcT.float().contiguous()
    du5 = torch.empty((T, B, 5 * H), dtype=torch.bfloat16, device=dev)
    acc = torch.zeros((-(-B // 32), nact, H), dtype=torch.float32, device=dev)
    dcoef = torch.empty((nact, H), dtype=torch.float32, device=dev)
    _call(fn, _BWD_ARGTYPES, _ptr(xg), _ptr(gpx), _ptr(w5), _ptr(bih),
          _ptr(coef), _ptr(mask), _ptr(h0), _ptr(c0), _ptr(ys), _ptr(cs),
          _ptr(dy), _ptr(dh), _ptr(dc), _ptr(du5), _ptr(acc), _ptr(dcoef),
          T, B, H, gate, nact, torch.cuda.current_stream(dev).cuda_stream)
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
