"""Fused 2-layer LSTM forward: the CUDA kernel's wrapper and its plain twin.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm2_layer_pallas`` (its
``_kernel2`` / ``_kernel2_reset`` Pallas bodies). The kernel is
``csrc/lstm2_fwd.cu``; its header says what bounds it on the H100 and how
its design answers that. ``lstm2_fwd`` launches it for CUDA tensors and
raises on what it does not take; for CPU tensors it runs ``lstm2_plain``,
which repeats the kernel's arithmetic step by step in PyTorch.

Arithmetic (kernel and plain alike): h and c are carried in float32; the
products take h rounded to the weights' dtype and accumulate in float32;
the gate pre-activations add ``xg1`` (layer 1) and a float32 bias. At a
reset step a column takes its source column's float32 state (source -1:
zeros). The TPU kernel instead selects through ``pmat @ s.astype(bf16)``,
which rounds h and c to bf16 at each reset; the JAX scan path does not.
Outputs are in the weights' dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# kernel launches (one per call that reaches the kernel); reset by callers
# that read it, such as chip_smoke.py
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 14 + [ctypes.c_int] * 3 + [_P]


def apply_reset(state, reset_t, reset_src):
    """Columns with ``reset_t`` set take column ``reset_src``'s state (their
    chain's first hypothesis); zeros where the source is -1."""
    src = state.index_select(0, reset_src.clamp(min=0).long())
    src = src * (reset_src >= 0).to(state.dtype)[:, None]
    return torch.where(reset_t.bool()[:, None], src, state)


def cell_update(gates, h, c, keep=None):
    """LSTM cell from its gate pre-activations [i, f, g, o]; columns whose
    ``keep`` is 0 keep their previous (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    hn = torch.sigmoid(o) * torch.tanh(cn)
    if keep is None:
        return hn, cn
    keep = keep.bool()[:, None]
    return torch.where(keep, hn, h), torch.where(keep, cn, c)


def lstm2_plain(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02, c02,
                step_mask=None, reset_mask=None, reset_src=None):
    """Plain PyTorch version of the kernel, same arguments as
    ``lstm2_fwd``."""
    dtype = whh1.dtype
    f32 = torch.float32
    w1, wi2, w2 = (w.to(f32).t() for w in (whh1, wih2, whh2))
    h1, c1, h2, c2 = (s.to(f32) for s in (h01, c01, h02, c02))
    ys = []
    for t in range(xg1.shape[0]):
        if reset_mask is not None:
            h1, c1, h2, c2 = (apply_reset(s, reset_mask[t], reset_src)
                              for s in (h1, c1, h2, c2))
        keep = None if step_mask is None else step_mask[t]
        g1 = xg1[t].to(f32) + h1.to(dtype).to(f32) @ w1 + bhh1
        h1, c1 = cell_update(g1, h1, c1, keep)
        g2 = (h1.to(dtype).to(f32) @ wi2 + h2.to(dtype).to(f32) @ w2 + b2)
        h2, c2 = cell_update(g2, h2, c2, keep)
        ys.append(h2.to(dtype))
    return (torch.stack(ys), (h1.to(dtype), h2.to(dtype)),
            (c1.to(dtype), c2.to(dtype)))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"lstm2_fwd: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def lstm2_fwd(xg1: torch.Tensor, whh1: torch.Tensor, bhh1: torch.Tensor,
              wih2: torch.Tensor, whh2: torch.Tensor, b2: torch.Tensor,
              h01: torch.Tensor, c01: torch.Tensor, h02: torch.Tensor,
              c02: torch.Tensor, step_mask: Optional[torch.Tensor] = None,
              reset_mask: Optional[torch.Tensor] = None,
              reset_src: Optional[torch.Tensor] = None):
    """Both layers of a 2-layer LSTM over a (T, B) sequence.

    xg1 (T, B, 4H): x W_ih1^T + b_ih1 in the compute dtype; whh1, wih2,
    whh2 (4H, H) torch layout in the compute dtype; bhh1 = b_hh1 and
    b2 = b_ih2 + b_hh2, (4H,) float32; h0/c0 (B, H) per layer; step_mask
    and reset_mask (T, B), nonzero = set; reset_src (B,) int, -1 = zero
    state. Returns ys2 (T, B, H), (hT1, hT2), (cT1, cT2), all in the
    compute dtype. CUDA tensors launch ``csrc/lstm2_fwd.cu`` (bf16 only);
    CPU tensors run ``lstm2_plain``. Each call that reaches the kernel adds
    one to the module's ``launches`` (the call itself runs 2T step
    launches).
    """
    if not xg1.is_cuda:
        return lstm2_plain(xg1, whh1, bhh1, wih2, whh2, b2, h01, c01, h02,
                           c02, step_mask, reset_mask, reset_src)
    T, B, G = xg1.shape
    H = G // 4
    dev = xg1.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"lstm2_fwd: hidden size {G // 4} must be a "
                         f"multiple of 32 (xg1 width {G})")
    _check("xg1", xg1, bf16, (T, B, G), dev)
    for name, w in (("whh1", whh1), ("wih2", wih2), ("whh2", whh2)):
        _check(name, w, bf16, (G, H), dev)
    for name, b in (("bhh1", bhh1), ("b2", b2)):
        _check(name, b, torch.float32, (G,), dev)
    for name, s in (("h01", h01), ("c01", c01), ("h02", h02), ("c02", c02)):
        if tuple(s.shape) != (B, H) or s.device != dev:
            raise ValueError(f"lstm2_fwd: {name} must be ({B}, {H}) on {dev}")
    if (reset_mask is None) != (reset_src is None):
        raise ValueError("lstm2_fwd: reset_mask and reset_src go together")

    states = []
    for s0 in ((h01, c01), (h02, c02)):
        pair = []
        for s in s0:
            buf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
            buf[0].copy_(s)
            pair.append(buf)
        states.append(pair)
    (h1, c1), (h2, c2) = states
    mask = None
    if step_mask is not None:
        mask = (step_mask != 0).to(torch.uint8).contiguous()
        _check("step_mask", mask, torch.uint8, (T, B), dev)
    reset = src = None
    if reset_mask is not None:
        reset = (reset_mask != 0).to(torch.uint8).contiguous()
        _check("reset_mask", reset, torch.uint8, (T, B), dev)
        src = reset_src.to(torch.int32).contiguous()
        _check("reset_src", src, torch.int32, (B,), dev)
    ys = torch.empty((T, B, H), dtype=bf16, device=dev)

    lib = _build.load("lstm2_fwd")
    fn = lib.lstm2_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(xg1), ptr(whh1), ptr(bhh1), ptr(wih2), ptr(whh2), ptr(b2),
             ptr(mask), ptr(reset), ptr(src), ptr(h1), ptr(c1), ptr(h2),
             ptr(c2), ptr(ys), T, B, H,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm2_fwd kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    f = T % 2
    return (ys, (h1[f].to(bf16), h2[f].to(bf16)),
            (c1[f].to(bf16), c2[f].to(bf16)))

