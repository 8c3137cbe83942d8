"""LSTM forward recurrences for scoring and eval: the CUDA kernels'
wrappers and their plain twins.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm2_layer_pallas`` (its
``_kernel2`` / ``_kernel2_reset`` Pallas bodies) with ``lstm2_fwd``
(``csrc/lstm2_fwd.cu``), and ``lstm_layer_pallas`` (``_kernel_reset`` and
``_kernel``, kernel rows 3 and 4) with ``lstm_fwd`` (``csrc/lstm_fwd.cu``);
``lstm_kernel_ok`` is ``pallas_lstm_ok``'s gate. The kernels' headers say
what bounds them on the H100 and how their designs answer that. The
wrappers launch them for CUDA tensors and raise on what they do not take;
for CPU tensors they run ``lstm2_plain`` and ``lstm_fwd_plain``, which
repeat the kernels' arithmetic step by step in PyTorch.

Arithmetic (kernels and plain alike): h and c are carried in float32; the
products take h rounded to the weights' dtype and accumulate in float32;
the gate pre-activations add ``xg`` (the first layer) and a float32 bias. At a
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
# the same for ``lstm_fwd``, by the TPU kernel a call replaces: row 3 (with
# resets) and row 4 (without)
layer_launches = {"lstm_fwd_reset": 0, "lstm_fwd": 0}

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 14 + [ctypes.c_int] * 3 + [_P]
_FWD_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 3 + [_P]

# The JAX gate's scoped-VMEM arithmetic (lstm_pallas.py `_est_vmem`,
# `_VMEM_LIMIT`, `_ROWS_FWD`, `_ROWS_TRAIN_BWD`): the largest W_hh and the
# U = 1 block set that its kernels take.
_VMEM_LIMIT = 100 * 1024 * 1024
_WHH_MAX_BYTES = 8 * 1024 * 1024
_ROWS_FWD = 5
_ROWS_TRAIN_BWD = 11


def est_vmem(U: int, B: int, H: int, row_elems: int, itemsize: int,
             reset: bool = False) -> int:
    """Upper-bound scoped-VMEM bytes of one grid step of the JAX package's
    LSTM kernels (``lstm_pallas._est_vmem``, term for term)."""
    G = 4 * H
    seq = 2 * U * B * row_elems * itemsize
    whh = 2 * H * G * itemsize
    fixed = (6 * B * H + G) * itemsize + 2 * B * H * 4 \
        + 2 * U * B * 8 * itemsize
    if reset:
        fixed += 2 * B * B * itemsize + 2 * U * B * 8 * itemsize
    return seq + whh + fixed


def lstm_kernel_ok(x: torch.Tensor, nhid: int, train: bool = False) -> bool:
    """The JAX package's ``pallas_lstm_ok(nhid, x.dtype, batch=B, train)``
    with a CUDA tensor in place of the TPU platform: W_hh within 8 MiB and
    the U = 1 block set within 0.9 of the VMEM budget (the reset kernel's
    for the forward, the backward's for training)."""
    itemsize = x.element_size()
    if not x.is_cuda or nhid * 4 * nhid * itemsize > _WHH_MAX_BYTES:
        return False
    rows = _ROWS_TRAIN_BWD if train else _ROWS_FWD
    return est_vmem(1, x.shape[1], nhid, rows * nhid, itemsize,
                    reset=not train) <= int(0.9 * _VMEM_LIMIT)


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


def _check(name, t, dtype, shape, device, fn="lstm2_fwd"):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
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



def lstm_fwd_plain(xg, whh, bhh, h0, c0, step_mask=None, reset_mask=None,
                   reset_src=None):
    """Plain PyTorch version of the kernel, same arguments as
    ``lstm_fwd``."""
    dtype = whh.dtype
    f32 = torch.float32
    w = whh.to(f32).t()
    h, c = h0.to(f32), c0.to(f32)
    ys = []
    for t in range(xg.shape[0]):
        if reset_mask is not None:
            h, c = (apply_reset(s, reset_mask[t], reset_src) for s in (h, c))
        keep = None if step_mask is None else step_mask[t]
        g = xg[t].to(f32) + h.to(dtype).to(f32) @ w + bhh
        h, c = cell_update(g, h, c, keep)
        ys.append(h.to(dtype))
    return torch.stack(ys), h.to(dtype), c.to(dtype)


def lstm_fwd(xg: torch.Tensor, whh: torch.Tensor, bhh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             step_mask: Optional[torch.Tensor] = None,
             reset_mask: Optional[torch.Tensor] = None,
             reset_src: Optional[torch.Tensor] = None):
    """One LSTM layer over a (T, B) sequence, forward only.

    xg (T, B, 4H): x W_ih^T + b_ih in the compute dtype; whh (4H, H) torch
    layout in the compute dtype; bhh (4H,) float32; h0, c0 (B, H);
    step_mask and reset_mask (T, B), nonzero = set; reset_src (B,) int,
    -1 = zero state. Returns ys (T, B, H), hT, cT (B, H), in the compute
    dtype. CUDA tensors launch ``csrc/lstm_fwd.cu`` (bf16 only; with resets
    kernel row 3's replacement, without row 4's); CPU tensors run
    ``lstm_fwd_plain``. Each call that reaches the kernel adds one to
    ``layer_launches`` (the call itself runs T step launches).
    """
    if not xg.is_cuda:
        return lstm_fwd_plain(xg, whh, bhh, h0, c0, step_mask, reset_mask,
                              reset_src)
    T, B, G = xg.shape
    H = G // 4
    dev = xg.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"lstm_fwd: hidden size {G / 4} must be a multiple "
                         f"of 32 (xg width {G})")
    _check("xg", xg, bf16, (T, B, G), dev, fn="lstm_fwd")
    _check("whh", whh, bf16, (G, H), dev, fn="lstm_fwd")
    _check("bhh", bhh, torch.float32, (G,), dev, fn="lstm_fwd")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (B, H) or s.device != dev:
            raise ValueError(f"lstm_fwd: {name} must be ({B}, {H}) on {dev}")
    if (reset_mask is None) != (reset_src is None):
        raise ValueError("lstm_fwd: reset_mask and reset_src go together")
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    c = torch.empty_like(h)
    h[0].copy_(h0)
    c[0].copy_(c0)
    mask = reset = src = None
    if step_mask is not None:
        mask = (step_mask != 0).to(torch.uint8).contiguous()
        _check("step_mask", mask, torch.uint8, (T, B), dev, fn="lstm_fwd")
    if reset_mask is not None:
        reset = (reset_mask != 0).to(torch.uint8).contiguous()
        _check("reset_mask", reset, torch.uint8, (T, B), dev, fn="lstm_fwd")
        src = reset_src.to(torch.int32).contiguous()
        _check("reset_src", src, torch.int32, (B,), dev, fn="lstm_fwd")
    ys = torch.empty((T, B, H), dtype=bf16, device=dev)
    fn = _build.load("lstm_fwd").lstm_fwd
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(ptr(xg), ptr(whh), ptr(bhh), ptr(mask), ptr(reset), ptr(src),
             ptr(h), ptr(c), ptr(ys), T, B, H,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed: CUDA error {err}")
    layer_launches["lstm_fwd_reset" if reset is not None else "lstm_fwd"] += 1
    f = T % 2
    return ys, h[f].to(bf16), c[f].to(bf16)
