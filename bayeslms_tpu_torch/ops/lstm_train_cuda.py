"""Single-layer LSTM recurrence with gradients: the CUDA kernels' wrappers,
their plain twins and the autograd Function ``lstm_scan_fused``.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm_scan_fused`` (its
``_train_fwd_kernel`` and ``_train_bwd_kernel`` Pallas bodies). The kernels
are in ``csrc/lstm_train.cu``, whose header says what bounds them on the
H100 and how their design answers that. ``lstm_train_fwd`` and
``lstm_train_bwd`` launch them for CUDA tensors and raise on what they do
not take; for CPU tensors they run ``lstm_train_fwd_plain`` and
``lstm_train_bwd_plain``, which repeat the kernels' arithmetic step by step.

Arithmetic (kernels and plain alike), with ``dtype`` the weights' dtype:
h and c are carried in float32; the gates are (xg_t + h_{t-1} W_hh^T) + b_hh
with h_{t-1} rounded to ``dtype`` and a float32 bias; ys and cs are stored
in ``dtype``. The backward recomputes the gates from xg_t, ys_{t-1} and
cs_{t-1} (both in ``dtype``), stores du in ``dtype`` and takes the dh
product on that rounded du; its dh and dc carries are float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# kernel launches, one per call that reaches a kernel (a call runs T step
# launches forward, 2T backward); reset by callers that read them, such as
# chip_smoke.py
launches = {"lstm_train_fwd": 0, "lstm_train_bwd": 0}

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 3 + [_P]


def _gates(xg_t, h, w_t, b_hh, dtype):
    return (xg_t.float() + h.to(dtype).float() @ w_t) + b_hh


def lstm_train_fwd_plain(xg, w_hh, b_hh, mask, h0, c0):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``lstm_train_fwd``."""
    dtype = w_hh.dtype
    w_t = w_hh.float().t()
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(xg.shape[0]):
        i, f, g, o = _gates(xg[t], h, w_t, b_hh, dtype).chunk(4, dim=-1)
        cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hn = torch.sigmoid(o) * torch.tanh(cn)
        if mask is not None:
            keep = mask[t].bool()[:, None]
            hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
        h, c = hn, cn
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    return torch.stack(ys), torch.stack(cs), h.to(dtype), c.to(dtype)


def cell_grads(gates, c_prev, keep, dh_tot, dc_tot, dtype):
    """The cell's backward at one step, from its recomputed gate
    pre-activations [i, f, g, o], the float32 c_{t-1}, keep (B, 1) and the
    float32 dh_tot = dh + dy_t and dc_tot: (du in ``dtype``, the new dc)."""
    gi, gf, gg, go = gates.chunk(4, -1)
    i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
    g = torch.tanh(gg)
    tc = torch.tanh(f * c_prev + i * g)
    dh_new = keep * dh_tot
    dc_new = keep * dc_tot
    d_o = dh_new * tc
    dcc = dc_new + dh_new * o * (1.0 - tc * tc)
    du = torch.cat([dcc * g * i * (1.0 - i), dcc * c_prev * f * (1.0 - f),
                    dcc * i * (1.0 - g * g), d_o * o * (1.0 - o)],
                   dim=-1).to(dtype)
    return du, dcc * f + (1.0 - keep) * dc_tot


def lstm_train_bwd_plain(xg, w_hh, b_hh, mask, h0, c0, ys, cs, dy, dhT,
                         dcT):
    """Plain PyTorch version of the backward kernel, same arguments as
    ``lstm_train_bwd``."""
    dtype = w_hh.dtype
    w = w_hh.float()
    w_t = w.t()
    dh, dc = dhT.float(), dcT.float()
    du = torch.empty(xg.shape, dtype=dtype, device=xg.device)
    for t in reversed(range(xg.shape[0])):
        h_prev = h0 if t == 0 else ys[t - 1]
        c_prev = (c0 if t == 0 else cs[t - 1]).float()
        keep = (torch.ones_like(dh[:, :1]) if mask is None
                else mask[t].to(torch.float32)[:, None])
        dh_tot = dh + dy[t].float()
        du[t], dc = cell_grads(_gates(xg[t], h_prev, w_t, b_hh, dtype),
                               c_prev, keep, dh_tot, dc, dtype)
        dh = du[t].float() @ w + (1.0 - keep) * dh_tot
    return du, dh.to(dtype), dc.to(dtype)


def _check(fn, name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _checked(fn, xg, w_hh, b_hh, mask, states):
    """Validate the arguments both kernels take; returns (T, B, H, mask as
    contiguous bytes or None)."""
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"{fn}: hidden size {G / 4} must be a multiple of "
                         f"32 (xg width {G})")
    _check(fn, "xg", xg, bf16, (T, B, G), dev)
    _check(fn, "w_hh", w_hh, bf16, (G, H), dev)
    _check(fn, "b_hh", b_hh, torch.float32, (G,), dev)
    for name, s, shape in states:
        _check(fn, name, s, bf16, shape, dev)
    if mask is not None:
        mask = (mask != 0).to(torch.uint8).contiguous()
        _check(fn, "mask", mask, torch.uint8, (T, B), dev)
    return T, B, H, mask


def _call(fn, argtypes, *args):
    f = getattr(_build.load("lstm_train"), fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    launches[fn] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def lstm_train_fwd(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   mask: Optional[torch.Tensor], h0: torch.Tensor,
                   c0: torch.Tensor):
    """The recurrence over a (T, B) sequence, keeping the cell sequence.

    xg (T, B, 4H) = x W_ih^T + b_ih in the compute dtype; w_hh (4H, H)
    torch layout in the compute dtype; b_hh (4H,) float32; mask (T, B),
    nonzero = step, or None; h0, c0 (B, H) in the compute dtype. Returns
    ys, cs (T, B, H), hT, cT (B, H), in the compute dtype. CUDA tensors
    launch ``lstm_train_fwd`` of ``csrc/lstm_train.cu`` (bf16 only); CPU
    tensors run ``lstm_train_fwd_plain``.
    """
    if not xg.is_cuda:
        return lstm_train_fwd_plain(xg, w_hh, b_hh, mask, h0, c0)
    fn = "lstm_train_fwd"
    B, H = xg.shape[1], xg.shape[2] // 4
    T, B, H, mask = _checked(fn, xg, w_hh, b_hh, mask,
                             (("h0", h0, (B, H)), ("c0", c0, (B, H))))
    h = h0.float().contiguous()
    c = c0.float().contiguous()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xg.device)
    cs = torch.empty_like(ys)
    _call(fn, _FWD_ARGTYPES, _ptr(xg), _ptr(w_hh), _ptr(b_hh),
          _ptr(mask), _ptr(h0), _ptr(h), _ptr(c), _ptr(ys), _ptr(cs), T, B, H,
          torch.cuda.current_stream(xg.device).cuda_stream)
    return ys, cs, h.to(torch.bfloat16), c.to(torch.bfloat16)


def lstm_train_bwd(xg, w_hh, b_hh, mask, h0, c0, ys, cs, dy, dhT, dcT):
    """Reverse-time gate gradients of ``lstm_train_fwd``.

    The forward's arguments and outputs ys, cs, with dy (T, B, H) and dhT,
    dcT (B, H), all in the compute dtype. Returns du (T, B, 4H), the
    gradient of the gate pre-activations, and dh0, dc0 (B, H), in the
    compute dtype. CUDA tensors launch ``lstm_train_bwd`` of
    ``csrc/lstm_train.cu`` (bf16 only); CPU tensors run
    ``lstm_train_bwd_plain``.
    """
    if not xg.is_cuda:
        return lstm_train_bwd_plain(xg, w_hh, b_hh, mask, h0, c0, ys, cs, dy,
                                    dhT, dcT)
    fn = "lstm_train_bwd"
    T, B, G = xg.shape
    H = G // 4
    T, B, H, mask = _checked(fn, xg, w_hh, b_hh, mask, (
        ("h0", h0, (B, H)), ("c0", c0, (B, H)), ("ys", ys, (T, B, H)),
        ("cs", cs, (T, B, H)), ("dy", dy, (T, B, H)), ("dhT", dhT, (B, H)),
        ("dcT", dcT, (B, H))))
    dh = dhT.float().contiguous()
    dc = dcT.float().contiguous()
    du = torch.empty((T, B, G), dtype=torch.bfloat16, device=xg.device)
    _call(fn, _BWD_ARGTYPES, _ptr(xg), _ptr(w_hh), _ptr(b_hh),
          _ptr(mask), _ptr(h0), _ptr(c0), _ptr(ys), _ptr(cs), _ptr(dy),
          _ptr(dh), _ptr(dc), _ptr(du), T, B, H,
          torch.cuda.current_stream(xg.device).cuda_stream)
    return du, dh.to(torch.bfloat16), dc.to(torch.bfloat16)


class _LSTMScanFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0, c0, mask):
        b32 = b_hh.float()
        ys, cs, hT, cT = lstm_train_fwd(xg, w_hh, b32, mask, h0, c0)
        ctx.save_for_backward(xg, w_hh, b32, h0, c0, ys, cs)
        ctx.mask = mask
        ctx.b_dtype = b_hh.dtype
        ctx.mark_non_differentiable(cs)
        return ys, cs, hT, cT

    @staticmethod
    def backward(ctx, dy, _dcs, dhT, dcT):
        xg, w_hh, b32, h0, c0, ys, cs = ctx.saved_tensors
        dy = torch.zeros_like(ys) if dy is None else dy.contiguous()
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        du, dh0, dc0 = lstm_train_bwd(xg, w_hh, b32, ctx.mask, h0, c0, ys,
                                      cs, dy, dhT, dcT)
        # gates += h_{t-1} W_hh^T, so dW_hh = du^T hprev and db_hh = sum du,
        # as float32 products outside the kernel (the TPU package's XLA
        # matmuls), rounded to the weights' dtype
        T, B, G = du.shape
        hprev = torch.cat([h0[None], ys[:-1]]).reshape(T * B, -1).float()
        duf = du.reshape(T * B, G).float()
        dw = (duf.t() @ hprev).to(w_hh.dtype)
        db = duf.sum(0).to(ctx.b_dtype)
        return du.to(xg.dtype), dw, db, dh0.to(h0.dtype), dc0.to(c0.dtype), None


def lstm_scan_fused(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    h0: torch.Tensor, c0: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """Differentiable LSTM recurrence over precomputed input projections
    (the JAX package's ``lstm_scan_fused``, torch layout): xg (T, B, 4H),
    w_hh (4H, H), b_hh (4H,), h0, c0 (B, H), all in the compute dtype;
    mask (T, B) or None. Returns (ys, cs, hT, cT); gradients flow to xg,
    w_hh, b_hh, h0 and c0 (not through cs, which no caller consumes)."""
    return _LSTMScanFused.apply(xg, w_hh, b_hh, h0, c0, mask)
