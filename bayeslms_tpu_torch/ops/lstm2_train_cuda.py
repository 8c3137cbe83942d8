"""Fused 2-layer LSTM recurrence with gradients: the CUDA kernels' wrappers,
their plain twins, the autograd Function ``lstm2_scan_fused``, the layer
``lstm2_layer_train`` and the gate ``lstm2_kernel_ok``.

Replaces ``bayeslms_tpu/ops/lstm_pallas.py`` ``lstm2_scan_fused`` (its
``_train2_fwd_kernel`` and ``_train2_bwd_kernel`` Pallas bodies, kernel rows
7-8), ``lstm2_layer_pallas_train`` and ``pallas_lstm2_ok(..., train=True)``.
The kernels are in ``csrc/lstm2_train.cu``, whose header says what bounds
them on the H100 and how their designs answer that; the forward and the
backward have two each, picked by ``_design``. ``lstm2_train_fwd`` and
``lstm2_train_bwd`` launch them for CUDA tensors and raise on what they do
not take (bf16 only); for
CPU tensors they run ``lstm2_train_fwd_plain`` and
``lstm2_train_bwd_plain``, which repeat the kernels' arithmetic step by
step.

Arithmetic (kernels and plain alike), with ``dtype`` the weights' dtype:
the four states are carried in float32; layer 1's gates are
(xg1_t + h1_{t-1} W_hh1^T) + b_hh1, h1_{t-1} rounded to ``dtype``; layer 2's
input is h1d = h1 dm_t, h1 the float32 carry, rounded to ``dtype``, and its
gates (h1d W_ih2^T + h2_{t-1} W_hh2^T) + b2, the first product not rounded,
b2 = b_ih2 + b_hh2 summed before its rounding; biases are float32. ys1,
cs1, ys2, cs2 are stored in ``dtype``. The backward recomputes layer 2's
gates from ys1_t dm_t (the stored ``dtype`` ys1, not the forward's float32
h1), ys2_{t-1} and cs2_{t-1}; its du2 (stored in ``dtype``) gives
dh2 = du2 W_hh2 + (1 - keep) dh2_tot and, at the same t, the gradient
(du2 W_ih2) dm_t, added to dy1_t for layer 1's backward. dh and dc carries
are float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .lstm_cuda import cell_update
from .lstm_train_cuda import _check, _ptr, cell_grads, fwd_persist_smem

# kernel launches, one per call that reaches a kernel (forward, 3 launches
# a call in the persistent design or 2T in the per-step one; backward, the
# one launch of ``lstm2_bwd_operands``, then 4T in the per-step design or 2
# in the persistent one), and the calls by design, the backward's and the
# forward's; reset by callers that read them, such as chip_smoke.py
launches = {"lstm2_train_fwd": 0, "lstm2_train_bwd": 0}
design_launches = {"persistent": 0, "per_step": 0}
fwd_design_launches = {"persistent": 0, "per_step": 0}

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 19 + [ctypes.c_int] * 3 + [_P]
_FWD_PERSIST_ARGTYPES = [_P] * 21 + [ctypes.c_int] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 26 + [ctypes.c_int] * 3 + [_P]
_PERSIST_ARGTYPES = [_P] * 26 + [ctypes.c_int] * 3 + [_P]
_H1D_ARGTYPES = [_P] * 3 + [ctypes.c_longlong, _P]

# The persistent backward's geometry (csrc/lstm2_train.cu): hidden units a
# CTA, batch columns at most (two m16 row tiles), threads a CTA, the bf16
# padding of a shared weight row, the warps on each layer's du; the gate
# GEMM's tile (rows x gate columns) and ring stages of 32 KB; the shared
# memory a CTA may take. The per-step design's tiles: 32 batch columns x 32
# units.
P_UNITS = 8
P_ROWS = 32
P_THREADS = 512
P_PAD = 32
P_GROUP = 8
GEMM_TILE = 128
GEMM_STAGES = 6
SMEM_LIMIT = 232448
TILE = 32


def persist_smem(H: int) -> int:
    """Dynamic shared memory of a persistent recurrence CTA at width H,
    bytes: the three transposed column slices (W_hh2's and W_ih2's side by
    side, then W_hh1's: 24 rows of 4H + P_PAD bf16) and the two warp
    groups' partial tiles (8 warps x 32 x 16 fp32 for dh2 and inj, 8 x 32
    x 8 for dh1)."""
    return 24 * (4 * H + P_PAD) * 2 + P_GROUP * P_ROWS * (16 + 8) * 4


def gemm_smem() -> int:
    """Dynamic shared memory of a gate GEMM CTA, bytes: 1 KB of alignment,
    six 32 KB ring stages (a 64-deep chunk of 128 rows of the A operand and
    of the weight) and their full and empty barriers."""
    return 1024 + GEMM_STAGES * 2 * GEMM_TILE * 64 * 2 + 2 * GEMM_STAGES * 8


def _design(B: int, H: int, n_sm: int, T: int = 1) -> dict:
    """The designs of the backward (row 8) and the forward (row 7) for batch
    B and width H on a card of ``n_sm`` SMs. Both need B <= 32, H a
    multiple of 8 and the CTAs no more than the SMs (one a SM). The
    backward's "persistent" (the gate GEMM for all T steps, then one
    cooperative launch of H / 8 CTAs, each owning 8 units of both layers
    with three 4H x 8 weight slices in shared memory, a grid barrier an
    iteration) where its CTA's shared memory fits; the forward's
    "persistent" (layer 1's recurrence, one cooperative launch of H / 8
    CTAs with W_hh1's gate rows resident; the input GEMM Q = h1d W_ih2^T
    for all T steps; layer 2's recurrence on Q with W_hh2's gate rows
    resident) where its recurrence's and its GEMM's shared memory fit.
    Otherwise "per_step": four launches a step backward, two forward, on
    (ceil(B / 32), H / 32) blocks. An explicit rule: the chosen design
    runs or raises. Returns a dict with the backward's design, recurrence
    grid, CTAs, units a CTA, threads and shared memory bytes, gate GEMM
    grid (gate column tiles, row tiles, layers) and shared memory, and
    launches and grid barriers of a call of T steps; and the forward's as
    ``fwd_design``, ``fwd_smem_bytes``, ``fwd_gemm_grid``,
    ``fwd_launches`` and ``fwd_barriers``."""
    fits = B <= P_ROWS and H % P_UNITS == 0 and 0 < H // P_UNITS <= n_sm
    blocks = (-(-B // TILE), H // TILE)
    fsmem = fwd_persist_smem(H)
    if fits and fsmem <= SMEM_LIMIT and gemm_smem() <= SMEM_LIMIT:
        fwd = dict(fwd_design="persistent", fwd_smem_bytes=fsmem,
                   fwd_gemm_grid=(-(-4 * H // GEMM_TILE),
                                  -(-T * B // GEMM_TILE), 1),
                   fwd_launches=3, fwd_barriers=2 * max(T - 1, 0))
    else:
        fwd = dict(fwd_design="per_step", fwd_smem_bytes=None,
                   fwd_gemm_grid=None, fwd_launches=2 * T, fwd_barriers=0)
    smem = persist_smem(H)
    if fits and smem <= SMEM_LIMIT:
        ctas = H // P_UNITS
        gemm = (-(-4 * H // GEMM_TILE), -(-T * B // GEMM_TILE), 2)
        return dict(design="persistent", grid=(ctas,), ctas=ctas,
                    units=P_UNITS, threads=P_THREADS, smem_bytes=smem,
                    gemm_grid=gemm, gemm_smem_bytes=gemm_smem(), launches=2,
                    barriers=T + 1, **fwd)
    return dict(design="per_step", grid=blocks, ctas=blocks[0] * blocks[1],
                units=TILE, threads=None, smem_bytes=None, gemm_grid=None,
                gemm_smem_bytes=None, launches=4 * T, barriers=0, **fwd)


def _card_design(dev, B, H, T=1):
    return _design(B, H, _build.sm_count(dev.index), T)

# The JAX gate's arithmetic (lstm_pallas.py `_est_vmem2`, `_VMEM_LIMIT`,
# `_ROWS2_TRAIN_BWD`): each of the three resident weight blocks within
# 8 MiB, and the backward's U = 1 block set within 0.9 of the VMEM budget.
_VMEM_LIMIT = 100 * 1024 * 1024
_W_MAX_BYTES = 8 * 1024 * 1024
_ROWS2_TRAIN_BWD = 20


def est_vmem2(U: int, B: int, H: int, row_elems: int, itemsize: int,
              reset: bool = False) -> int:
    """Upper-bound scoped-VMEM bytes of one grid step of the JAX package's
    fused 2-layer kernels (``lstm_pallas._est_vmem2``, term for term; the
    reset kernel's block set with ``reset``, which the forward's gate
    ``lstm_cuda.lstm2_fwd_ok`` asks for)."""
    G = 4 * H
    seq = 2 * U * B * row_elems * itemsize
    res = 3 * 2 * H * G * itemsize
    fixed = (12 * B * H + 3 * G) * itemsize + 4 * B * H * 4 \
        + 2 * U * B * 8 * itemsize
    if reset:
        fixed += 2 * B * B * itemsize + 2 * U * B * 8 * itemsize
    return seq + res + fixed


def lstm2_kernel_ok(x: torch.Tensor, nhid: int) -> bool:
    """The JAX package's ``pallas_lstm2_ok(nhid, x.dtype, batch=B,
    train=True)`` with a CUDA tensor in place of the TPU platform. The
    wrappers then take bf16 only and raise for another dtype, as every
    kernel of the port does."""
    itemsize = x.element_size()
    if not x.is_cuda or nhid * 4 * nhid * itemsize > _W_MAX_BYTES:
        return False
    return est_vmem2(1, x.shape[1], nhid, _ROWS2_TRAIN_BWD * nhid,
                     itemsize) <= int(0.9 * _VMEM_LIMIT)


def _keep(mask, t, like):
    return (torch.ones_like(like[:, :1]) if mask is None
            else mask[t].to(torch.float32)[:, None])


def lstm2_train_fwd_plain(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask,
                          h01, c01, h02, c02):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``lstm2_train_fwd``."""
    dtype = w_hh1.dtype
    f32 = torch.float32
    w1, wi2, w2 = (w.to(f32).t() for w in (w_hh1, w_ih2, w_hh2))
    h1, c1, h2, c2 = (s.to(f32) for s in (h01, c01, h02, c02))
    outs = [], [], [], []
    for t in range(xg1.shape[0]):
        keep = None if mask is None else mask[t]
        g1 = (xg1[t].to(f32) + h1.to(dtype).to(f32) @ w1) + b_hh1
        h1, c1 = cell_update(g1, h1, c1, keep)
        h1d = (h1 * dm[t].to(f32)).to(dtype).to(f32)
        g2 = (h1d @ wi2 + h2.to(dtype).to(f32) @ w2) + b2
        h2, c2 = cell_update(g2, h2, c2, keep)
        for seq, s in zip(outs, (h1, c1, h2, c2)):
            seq.append(s.to(dtype))
    return (*(torch.stack(seq) for seq in outs),
            *(s.to(dtype) for s in (h1, c1, h2, c2)))


def lstm2_train_bwd_plain(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask,
                          h01, c01, h02, c02, ys1, cs1, ys2, cs2, dy1, dy2,
                          dhT1, dcT1, dhT2, dcT2):
    """Plain PyTorch version of the backward kernel, same arguments as
    ``lstm2_train_bwd``."""
    dtype = w_hh1.dtype
    f32 = torch.float32
    w1, wi2, w2 = (w.to(f32) for w in (w_hh1, w_ih2, w_hh2))
    dh1, dc1, dh2, dc2 = (s.to(f32) for s in (dhT1, dcT1, dhT2, dcT2))
    du1 = torch.empty(xg1.shape, dtype=dtype, device=xg1.device)
    du2 = torch.empty_like(du1)
    for t in reversed(range(xg1.shape[0])):
        keep = _keep(mask, t, dh1)
        dmt = dm[t].to(f32)
        h1p, c1p = (h01, c01) if t == 0 else (ys1[t - 1], cs1[t - 1])
        h2p, c2p = (h02, c02) if t == 0 else (ys2[t - 1], cs2[t - 1])
        h1d = (ys1[t].to(f32) * dmt).to(dtype).to(f32)
        g2 = (h1d @ wi2.t() + h2p.to(dtype).to(f32) @ w2.t()) + b2
        dh2_tot = dh2 + dy2[t].to(f32)
        du2[t], dc2 = cell_grads(g2, c2p.to(f32), keep, dh2_tot, dc2, dtype)
        dh2 = du2[t].to(f32) @ w2 + (1.0 - keep) * dh2_tot
        inj = (du2[t].to(f32) @ wi2) * dmt
        g1 = (xg1[t].to(f32) + h1p.to(dtype).to(f32) @ w1.t()) + b_hh1
        dh1_tot = dh1 + (dy1[t].to(f32) + inj)
        du1[t], dc1 = cell_grads(g1, c1p.to(f32), keep, dh1_tot, dc1, dtype)
        dh1 = du1[t].to(f32) @ w1 + (1.0 - keep) * dh1_tot
    return (du1, du2, *(s.to(dtype) for s in (dh1, dc1, dh2, dc2)))


def _checked(fn, xg1, dm, weights, biases, mask, states):
    """Validate the arguments both kernels take; returns (T, B, H, mask as
    contiguous bytes or None)."""
    _build.refuse_float32(fn, xg1, "rows 7-8")
    T, B, G = xg1.shape
    H = G // 4
    dev = xg1.device
    bf16 = torch.bfloat16
    if G != 4 * H or H % 32 != 0:
        raise ValueError(f"{fn}: hidden size {G / 4} must be a multiple of "
                         f"32 (xg1 width {G})")
    _check(fn, "xg1", xg1, bf16, (T, B, G), dev)
    _check(fn, "dm", dm, bf16, (T, B, H), dev)
    for name, w in weights:
        _check(fn, name, w, bf16, (G, H), dev)
    for name, b in biases:
        _check(fn, name, b, torch.float32, (G,), dev)
    for name, s, shape in states:
        _check(fn, name, s, bf16, shape, dev)
    if mask is not None:
        mask = (mask != 0).to(torch.uint8).contiguous()
        _check(fn, "mask", mask, torch.uint8, (T, B), dev)
    return T, B, H, mask


def _call(fn, argtypes, *args, entry=None):
    f = getattr(_build.load("lstm2_train"), entry or fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    if fn in launches:
        launches[fn] += 1


def lstm2_train_fwd(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01,
                    h02, c02):
    """Both layers' recurrence over a (T, B) sequence, keeping the cell
    sequences.

    xg1 (T, B, 4H) = x W_ih1^T + b_ih1 and dm (T, B, H), the inter-layer
    inverted-dropout mask (ones when not dropping), in the compute dtype;
    w_hh1, w_ih2, w_hh2 (4H, H) torch layout in the compute dtype; b_hh1 and
    b2 = b_ih2 + b_hh2 (4H,) float32; mask (T, B), nonzero = step, or None;
    h01, c01, h02, c02 (B, H) in the compute dtype. Returns ys1, cs1, ys2,
    cs2 (T, B, H) and hT1, cT1, hT2, cT2 (B, H), in the compute dtype. CUDA
    tensors launch the forward of ``csrc/lstm2_train.cu`` in the design
    ``_design`` picks (bf16 only); CPU tensors run
    ``lstm2_train_fwd_plain``.
    """
    args = (xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01, h02,
            c02)
    if not xg1.is_cuda:
        return lstm2_train_fwd_plain(*args)
    return _train_fwd(None, *args)


def _train_fwd(design, xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01,
               c01, h02, c02):
    """``lstm2_train_fwd`` on CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design`` picks where it is None;
    chip_smoke.py times the per-step design on the persistent design's
    calls through it. A design that does not take the shapes raises."""
    fn = "lstm2_train_fwd"
    B, H = xg1.shape[1], xg1.shape[2] // 4
    T, B, H, mask = _checked(
        fn, xg1, dm, (("w_hh1", w_hh1), ("w_ih2", w_ih2), ("w_hh2", w_hh2)),
        (("b_hh1", b_hh1), ("b2", b2)), mask,
        [(n, s, (B, H)) for n, s in (("h01", h01), ("c01", c01),
                                     ("h02", h02), ("c02", c02))])
    plan = _card_design(xg1.device, B, H, T)["fwd_design"]
    if design is None:
        design = plan
    if design == "persistent" and plan != "persistent":
        raise ValueError(f"{fn}: the persistent design does not take B={B} "
                         f"H={H}")
    dev = xg1.device
    bf16 = torch.bfloat16
    h1, c1, h2, c2 = (s.float().contiguous() for s in (h01, c01, h02, c02))
    seqs = [torch.empty((T, B, H), dtype=bf16, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (_ptr(xg1), _ptr(dm), _ptr(w_hh1), _ptr(b_hh1), _ptr(w_ih2),
            _ptr(w_hh2), _ptr(b2), _ptr(mask), _ptr(h01), _ptr(h02),
            _ptr(h1), _ptr(c1), _ptr(h2), _ptr(c2), *(_ptr(s) for s in seqs))
    if design == "persistent":
        # every step's layer-2 input, the fp32 input product Q for all
        # steps, and one barrier counter a recurrence
        h1d = torch.empty((T, B, H), dtype=bf16, device=dev)
        q = torch.empty((T * B, 4 * H), dtype=torch.float32, device=dev)
        bar = torch.zeros((2,), dtype=torch.int32, device=dev)
        _call(fn, _FWD_PERSIST_ARGTYPES, *ptrs, _ptr(h1d), _ptr(q),
              _ptr(bar), T, B, H, stream,
              entry="lstm2_train_fwd_persistent")
    else:
        h1d = torch.empty((B, H), dtype=bf16, device=dev)
        _call(fn, _FWD_ARGTYPES, *ptrs, _ptr(h1d), T, B, H, stream)
    fwd_design_launches[design] += 1
    return (*seqs, *(s.to(bf16) for s in (h1, c1, h2, c2)))


def lstm2_bwd_operands(dm, h01, h02, ys1, ys2):
    """The backward kernels' (T B, H) operands: h1p = [h01, ys1[:-1]],
    h1d = ys1 dm rounded to the compute dtype (layer 2's input, recomputed)
    and h2p = [h02, ys2[:-1]]. For CUDA tensors h1d is one launch of
    ``lstm2_h1d`` (bf16 only), for CPU tensors the product in torch."""
    T, B, H = ys1.shape
    h1p = torch.cat([h01[None], ys1[:-1]]).reshape(T * B, H)
    h2p = torch.cat([h02[None], ys2[:-1]]).reshape(T * B, H)
    if not ys1.is_cuda:
        return h1p, (ys1 * dm.to(ys1.dtype)).reshape(T * B, H), h2p
    fn = "lstm2_h1d"
    for name, t in (("ys1", ys1), ("dm", dm)):
        _check(fn, name, t, torch.bfloat16, (T, B, H), ys1.device)
    h1d = torch.empty((T * B, H), dtype=torch.bfloat16, device=ys1.device)
    _call(fn, _H1D_ARGTYPES, _ptr(ys1), _ptr(dm), _ptr(h1d), T * B * H,
          torch.cuda.current_stream(ys1.device).cuda_stream)
    return h1p, h1d, h2p


def lstm2_train_bwd(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01,
                    h02, c02, ys1, cs1, ys2, cs2, dy1, dy2, dhT1, dcT1, dhT2,
                    dcT2):
    """Reverse-time gate gradients of ``lstm2_train_fwd``.

    The forward's arguments and outputs ys1, cs1, ys2, cs2, with dy1, dy2
    (T, B, H) and dhT1, dcT1, dhT2, dcT2 (B, H), all in the compute dtype.
    Returns du1, du2 (T, B, 4H), the gradients of the two layers' gate
    pre-activations, and dh01, dc01, dh02, dc02 (B, H), in the compute
    dtype. CUDA tensors launch the backward of ``csrc/lstm2_train.cu`` in
    the design ``_design`` picks (bf16 only); CPU tensors run
    ``lstm2_train_bwd_plain``.
    """
    args = (xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, mask, h01, c01, h02,
            c02, ys1, cs1, ys2, cs2, dy1, dy2, dhT1, dcT1, dhT2, dcT2)
    if not xg1.is_cuda:
        return lstm2_train_bwd_plain(*args)
    return _train_bwd(None, *args)


def _train_bwd(design, xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2,
               mask, h01, c01, h02, c02, ys1, cs1, ys2, cs2, dy1, dy2, dhT1,
               dcT1, dhT2, dcT2):
    """``lstm2_train_bwd`` on CUDA tensors in ``design`` ("persistent" or
    "per_step"), or in the one ``_design`` picks where it is None;
    chip_smoke.py times the per-step design on the persistent design's
    calls through it. A design that does not take the shapes raises."""
    fn = "lstm2_train_bwd"
    T, B, G = xg1.shape
    H = G // 4
    bh = [(n, s, (B, H)) for n, s in (
        ("h01", h01), ("c01", c01), ("h02", h02), ("c02", c02),
        ("dhT1", dhT1), ("dcT1", dcT1), ("dhT2", dhT2), ("dcT2", dcT2))]
    tbh = [(n, s, (T, B, H)) for n, s in (
        ("ys1", ys1), ("cs1", cs1), ("ys2", ys2), ("cs2", cs2), ("dy1", dy1),
        ("dy2", dy2))]
    T, B, H, mask = _checked(
        fn, xg1, dm, (("w_hh1", w_hh1), ("w_ih2", w_ih2), ("w_hh2", w_hh2)),
        (("b_hh1", b_hh1), ("b2", b2)), mask, bh + tbh)
    plan = _card_design(xg1.device, B, H, T)["design"]
    if design is None:
        design = plan
    if design == "persistent" and plan != "persistent":
        raise ValueError(f"{fn}: the persistent design does not take B={B} "
                         f"H={H}")
    h1p, h1d, h2p = lstm2_bwd_operands(dm, h01, h02, ys1, ys2)
    carries = [s.float().contiguous() for s in (dhT1, dcT1, dhT2, dcT2)]
    dev = xg1.device
    du1 = torch.empty((T, B, G), dtype=torch.bfloat16, device=dev)
    du2 = torch.empty_like(du1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if design == "persistent":
        g1 = torch.empty((T * B, G), dtype=torch.float32, device=dev)
        g2 = torch.empty_like(g1)
        bar = torch.zeros((1,), dtype=torch.int32, device=dev)
        _call(fn, _PERSIST_ARGTYPES, _ptr(xg1), _ptr(w_hh1), _ptr(b_hh1),
              _ptr(w_ih2), _ptr(w_hh2), _ptr(b2), _ptr(mask), _ptr(dm),
              *(_ptr(s) for s in (h1p, h1d, h2p, c01, c02, cs1, cs2, dy1,
                                  dy2)),
              *(_ptr(s) for s in carries), _ptr(du1), _ptr(du2), _ptr(g1),
              _ptr(g2), _ptr(bar), T, B, H, stream,
              entry="lstm2_train_bwd_persistent")
    else:
        inj = torch.empty((B, H), dtype=torch.float32, device=dev)
        _call(fn, _BWD_ARGTYPES, _ptr(xg1), _ptr(dm), _ptr(w_hh1),
              _ptr(b_hh1), _ptr(w_ih2), _ptr(w_hh2), _ptr(b2), _ptr(mask),
              *(_ptr(s) for s in (h01, c01, h02, c02, ys1, cs1, ys2, cs2, dy1,
                                  dy2, h1d)),
              *(_ptr(s) for s in carries), _ptr(du1), _ptr(du2), _ptr(inj),
              T, B, H, stream)
    design_launches[design] += 1
    return (du1, du2, *(s.to(torch.bfloat16) for s in carries))


class _LSTM2ScanFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, h01, c01, h02,
                c02, mask):
        b1f, b2f = b_hh1.float(), b2.float()
        ins = (xg1, dm, w_hh1, b1f, w_ih2, w_hh2, b2f)
        outs = lstm2_train_fwd(*ins, mask, h01, c01, h02, c02)
        ctx.save_for_backward(*ins, h01, c01, h02, c02, *outs[:4])
        ctx.mask = mask
        ctx.b_dtypes = (b_hh1.dtype, b2.dtype)
        ctx.mark_non_differentiable(outs[1], outs[3])
        return outs

    @staticmethod
    def backward(ctx, dys1, _dcs1, dys2, _dcs2, dhT1, dcT1, dhT2, dcT2):
        saved = ctx.saved_tensors
        xg1, dm, w_hh1, b1f, w_ih2, w_hh2, b2f = saved[:7]
        h01, c01, h02, c02, ys1, cs1, ys2, cs2 = saved[7:]
        seq = lambda g: torch.zeros_like(ys1) if g is None \
            else g.contiguous()  # noqa: E731
        bh = lambda g: torch.zeros_like(h01) if g is None \
            else g.contiguous()  # noqa: E731
        du1, du2, dh01, dc01, dh02, dc02 = lstm2_train_bwd(
            xg1, dm, w_hh1, b1f, w_ih2, w_hh2, b2f, ctx.mask, h01, c01, h02,
            c02, ys1, cs1, ys2, cs2, seq(dys1), seq(dys2), bh(dhT1),
            bh(dcT1), bh(dhT2), bh(dcT2))
        # layer 1's gates take h1_{t-1} W_hh1^T, layer 2's (ys1 dm) W_ih2^T
        # and h2_{t-1} W_hh2^T: the weight gradients are float32 products
        # outside the kernel (the TPU package's XLA matmuls), rounded to
        # the weights' dtype; no gradient reaches dm or the mask
        T, B, G = du1.shape
        flat = lambda a: a.reshape(T * B, -1).float()  # noqa: E731
        du1f, du2f = flat(du1), flat(du2)
        h1p = torch.cat([h01[None], ys1[:-1]])
        h2p = torch.cat([h02[None], ys2[:-1]])
        dw_hh1 = (du1f.t() @ flat(h1p)).to(w_hh1.dtype)
        dw_ih2 = (du2f.t() @ flat(ys1 * dm.to(ys1.dtype))).to(w_ih2.dtype)
        dw_hh2 = (du2f.t() @ flat(h2p)).to(w_hh2.dtype)
        db1 = du1f.sum(0).to(ctx.b_dtypes[0])
        db2 = du2f.sum(0).to(ctx.b_dtypes[1])
        return (du1.to(xg1.dtype), None, dw_hh1, db1, dw_ih2, dw_hh2, db2,
                dh01.to(h01.dtype), dc01.to(c01.dtype), dh02.to(h02.dtype),
                dc02.to(c02.dtype), None)


def lstm2_scan_fused(xg1, dm, w_hh1, b_hh1, w_ih2, w_hh2, b2, h01, c01, h02,
                     c02, mask: Optional[torch.Tensor] = None):
    """Differentiable fused 2-layer LSTM recurrence (the JAX package's
    ``lstm2_scan_fused``, torch layout): xg1 (T, B, 4H), dm (T, B, H),
    w_hh1, w_ih2, w_hh2 (4H, H), b_hh1 and b2 = b_ih2 + b_hh2 (4H,), h0/c0
    (B, H) per layer, all in the compute dtype; mask (T, B) or None.
    Returns (ys1, cs1, ys2, cs2, hT1, cT1, hT2, cT2); gradients flow to xg1,
    the weights, the biases and the initial states (not through cs1, cs2,
    which no caller consumes, nor to dm)."""
    c = lambda t: t.contiguous()  # noqa: E731
    return _LSTM2ScanFused.apply(c(xg1), c(dm), c(w_hh1), b_hh1, c(w_ih2),
                                 c(w_hh2), b2, c(h01), c(c01), c(h02), c(c02),
                                 mask)


def lstm2_layer_train(x, h01, c01, h02, c02, p1, p2,
                      step_mask: Optional[torch.Tensor] = None,
                      dropout_mask: Optional[torch.Tensor] = None):
    """Differentiable fused 2-layer LSTM (the JAX package's
    ``lstm2_layer_pallas_train``): (T, B, in) -> ys2 (T, B, H),
    (hT1, hT2), (cT1, cT2) in x's dtype. Layer 1's input projection
    xg1 = x W_ih1^T + b_ih1 is one matrix product in x's dtype, outside the
    Function; layer 2's runs inside, a step at a time. ``p1``, ``p2``:
    ``ops.lstm.LSTMParams``, p2.w_ih (4H, H). ``dropout_mask`` (T, B, H) is
    the inter-layer inverted-dropout mask (ones when None)."""
    dtype = x.dtype
    T, B, _ = x.shape
    H = p1.w_hh.shape[1]
    xg1 = (x.reshape(T * B, -1) @ p1.w_ih.to(dtype).t()
           + p1.b_ih.to(dtype)).reshape(T, B, 4 * H)
    dm = (torch.ones((T, B, H), dtype=dtype, device=x.device)
          if dropout_mask is None else dropout_mask.to(dtype))
    ys1, cs1, ys2, cs2, hT1, cT1, hT2, cT2 = lstm2_scan_fused(
        xg1, dm, p1.w_hh.to(dtype), p1.b_hh.to(dtype), p2.w_ih.to(dtype),
        p2.w_hh.to(dtype), (p2.b_ih + p2.b_hh).to(dtype), h01.to(dtype),
        c01.to(dtype), h02.to(dtype), c02.to(dtype), step_mask)
    return ys2, (hT1, hT2), (cT1, cT2)
