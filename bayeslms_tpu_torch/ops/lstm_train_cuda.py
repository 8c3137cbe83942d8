"""Single-layer LSTM recurrence with gradients: the CUDA kernels' wrappers,
their plain twins and the autograd Function ``lstm_scan_fused``.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm_scan_fused`` (its
``_train_fwd_kernel`` and ``_train_bwd_kernel`` Pallas bodies). The kernels
are in ``csrc/lstm_train.cu``, whose header says what bounds them on the
H100 and how their designs answer that; the forward and the backward have
two each, picked by ``_design``. ``lstm_train_fwd`` and
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

# kernel launches, one per call that reaches a kernel (a call runs one
# cooperative launch in a persistent design, T step launches in the
# forward's per-step design, 2T in the backward's two-launch design), and
# the calls by design, the backward's and the forward's; reset by callers
# that read them, such as chip_smoke.py
launches = {"lstm_train_fwd": 0, "lstm_train_bwd": 0}
design_launches = {"persistent": 0, "two_launch": 0}
fwd_design_launches = {"persistent": 0, "per_step": 0}

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 3 + [_P]
_PERSIST_ARGTYPES = [_P] * 13 + [ctypes.c_int] * 3 + [_P]
_FWD_PERSIST_ARGTYPES = [_P] * 10 + [ctypes.c_int] * 3 + [_P]

# The persistent backward's geometry (csrc/lstm_train.cu): hidden units a
# CTA, batch columns at most (two m16 row tiles), threads a CTA (16 warps),
# the bf16 padding of a shared weight row, the shared memory a CTA may take
P_UNITS = 8
P_ROWS = 32
P_THREADS = 512
P_PAD = 32
SMEM_LIMIT = 232448
# the two-launch backward's tiles: batch columns, units (both kernels)
TILE = 32


def persist_smem(H: int) -> int:
    """Dynamic shared memory of a persistent CTA at width H, bytes: the
    gate rows (32 x (H + P_PAD) bf16), the column slice (8 x (4H + P_PAD)
    bf16) and the 16 warps' partial tiles (32 x 32 and 32 x 8 fp32)."""
    return (32 * (H + P_PAD) + 8 * (4 * H + P_PAD)) * 2 \
        + (P_THREADS // 32) * P_ROWS * (32 + 8) * 4


def fwd_persist_smem(H: int) -> int:
    """Dynamic shared memory of a persistent forward CTA at width H, bytes:
    the gate rows (32 x (H + P_PAD) bf16) and the 16 warps' partial gate
    tiles (32 x 32 fp32)."""
    return 32 * (H + P_PAD) * 2 + (P_THREADS // 32) * P_ROWS * 32 * 4


def _fits(B: int, H: int, n_sm: int, smem: int) -> bool:
    return B <= P_ROWS and H % P_UNITS == 0 and 0 < H // P_UNITS <= n_sm \
        and smem <= SMEM_LIMIT


def _design(B: int, H: int, n_sm: int, T: int = 1) -> dict:
    """The designs of the forward (row 5) and the backward (row 6) for
    batch B and width H on a card of ``n_sm`` SMs. "persistent" (one
    cooperative launch of H / 8 CTAs, each owning 8 hidden units with its
    W_hh slices in shared memory, a grid barrier a step) where B <= 32, H
    is a multiple of 8, the CTAs number no more than the SMs (one a SM:
    its shared memory takes most of one) and a CTA's shared memory fits;
    otherwise the forward's "per_step" (``lstm_fwd_step``, T launches) and
    the backward's "two_launch" (``lstm_bwd_gates`` and ``lstm_bwd_dh``, 2T
    launches), on (ceil(B / 32), H / 32) blocks. An explicit rule: the
    chosen design runs or raises. Returns a dict with the backward's
    design, grid, CTAs, units a CTA, threads, shared memory bytes,
    launches and barriers for T steps, and the forward's as ``fwd_design``,
    ``fwd_smem_bytes``, ``fwd_launches`` and ``fwd_barriers``."""
    blocks = (-(-B // TILE), H // TILE)
    if _fits(B, H, n_sm, fwd_persist_smem(H)):
        fwd = dict(fwd_design="persistent", fwd_smem_bytes=fwd_persist_smem(H),
                   fwd_launches=1, fwd_barriers=max(T - 1, 0))
    else:
        fwd = dict(fwd_design="per_step", fwd_smem_bytes=None,
                   fwd_launches=T, fwd_barriers=0)
    smem = persist_smem(H)
    if _fits(B, H, n_sm, smem):
        ctas = H // P_UNITS
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=P_UNITS, threads=P_THREADS, smem_bytes=smem,
                    launches=1, barriers=T, **fwd)
    return dict(design="two_launch", grid=blocks,
                ctas=blocks[0] * blocks[1], units=TILE, threads=None,
                smem_bytes=None, launches=2 * T, barriers=0, **fwd)


def _card_design(dev, B, H, T=1):
    return _design(B, H, _build.sm_count(dev.index), T)


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
    _build.refuse_float32(fn, xg, "rows 5-6")
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


def _call(fn, argtypes, *args, entry=None):
    f = getattr(_build.load("lstm_train"), entry or fn)
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
    launch the forward of ``csrc/lstm_train.cu`` in the design ``_design``
    picks (bf16 only); CPU tensors run ``lstm_train_fwd_plain``.
    """
    if not xg.is_cuda:
        return lstm_train_fwd_plain(xg, w_hh, b_hh, mask, h0, c0)
    return _train_fwd(None, xg, w_hh, b_hh, mask, h0, c0)


def _train_fwd(design, xg, w_hh, b_hh, mask, h0, c0):
    """``lstm_train_fwd`` on CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design`` picks where it is None;
    chip_smoke.py times the per-step design on the persistent design's
    calls through it. A design that does not take the shapes raises."""
    fn = "lstm_train_fwd"
    B, H = xg.shape[1], xg.shape[2] // 4
    T, B, H, mask = _checked(fn, xg, w_hh, b_hh, mask,
                             (("h0", h0, (B, H)), ("c0", c0, (B, H))))
    plan = _card_design(xg.device, B, H, T)["fwd_design"]
    if design is None:
        design = plan
    if design == "persistent" and plan != "persistent":
        raise ValueError(f"{fn}: the persistent design does not take B={B} "
                         f"H={H}")
    h = h0.float().contiguous()
    c = c0.float().contiguous()
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xg.device)
    cs = torch.empty_like(ys)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    args = (_ptr(xg), _ptr(w_hh), _ptr(b_hh), _ptr(mask), _ptr(h0), _ptr(h),
            _ptr(c), _ptr(ys), _ptr(cs))
    if design == "persistent":
        bar = torch.zeros((1,), dtype=torch.int32, device=xg.device)
        _call(fn, _FWD_PERSIST_ARGTYPES, *args, _ptr(bar), T, B, H, stream,
              entry="lstm_train_fwd_persistent")
    else:
        _call(fn, _FWD_ARGTYPES, *args, T, B, H, stream)
    fwd_design_launches[design] += 1
    return ys, cs, h.to(torch.bfloat16), c.to(torch.bfloat16)


def lstm_train_bwd(xg, w_hh, b_hh, mask, h0, c0, ys, cs, dy, dhT, dcT):
    """Reverse-time gate gradients of ``lstm_train_fwd``.

    The forward's arguments and outputs ys, cs, with dy (T, B, H) and dhT,
    dcT (B, H), all in the compute dtype. Returns du (T, B, 4H), the
    gradient of the gate pre-activations, and dh0, dc0 (B, H), in the
    compute dtype. CUDA tensors launch the backward of
    ``csrc/lstm_train.cu`` in the design ``_design`` picks (bf16 only);
    CPU tensors run ``lstm_train_bwd_plain``.
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
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    args = (_ptr(xg), _ptr(w_hh), _ptr(b_hh), _ptr(mask), _ptr(h0), _ptr(c0),
            _ptr(ys), _ptr(cs), _ptr(dy), _ptr(dh), _ptr(dc), _ptr(du))
    design = _card_design(xg.device, B, H, T)["design"]
    if design == "persistent":
        bar = torch.zeros((1,), dtype=torch.int32, device=xg.device)
        _call(fn, _PERSIST_ARGTYPES, *args, _ptr(bar), T, B, H, stream,
              entry="lstm_train_bwd_persistent")
    else:
        _call(fn, _BWD_ARGTYPES, *args, T, B, H, stream)
    design_launches[design] += 1
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
