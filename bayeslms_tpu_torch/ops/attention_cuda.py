"""Causal multi-head self-attention forward: the CUDA kernel's wrapper and
its plain twin.

Replaces ``bayeslms_tpu/ops/attention_pallas.py`` ``causal_attention_pallas``
(its ``_kernel`` Pallas body) and ``pallas_attention_ok``. The kernel is
``csrc/attention_fwd.cu``; its header says what bounds it on the H100 and
how its design answers that. ``causal_attention`` launches it for CUDA
tensors and raises on what it does not take; for CPU tensors it runs
``causal_attention_plain``.

Per batch column, head and query row r: s_c = (q_r d^-1/2) . k_c for
c <= r and -1e30 above the diagonal, an fp32 softmax, and o_r = P V with
P in fp32 (the TPU kernel's arithmetic: nothing is rounded to bf16 before
the output), the output in q's dtype. q, k and v are the time-major
(T, B, E) projections, E = nhead d, unscaled.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches, one per call that reaches the kernel; reset by callers
# that read it, such as chip_smoke.py
launches = 0

MAX_T = 8192   # the JAX gate's sequence limit
MAX_D = 256    # the widest head the kernel's tiles take
_NEG = -1e30

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 4 + [ctypes.c_int] * 4 + [_P, ctypes.c_float,
                                             ctypes.c_int, _P]


def attention_ok(q: torch.Tensor, nhead: int) -> bool:
    """Whether ``multihead_attention`` routes a causal, deterministic,
    mask-free call here: the JAX gate (``pallas_attention_ok``: head dim a
    multiple of 8, T <= 8,192) on a CUDA tensor. A head wider than the
    kernel's 256 columns passes the gate and is refused by
    ``causal_attention``, as no other route computes row 14's call."""
    T, _, E = q.shape
    d = E // nhead
    return q.is_cuda and d % 8 == 0 and T <= MAX_T


def _heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    """(T, B, E) -> (B nhead, T, d) float32."""
    T, B, E = x.shape
    d = E // nhead
    return x.float().reshape(T, B * nhead, d).transpose(0, 1)


def causal_attention_plain(q, k, v, nhead: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments as
    ``causal_attention``."""
    T, B, E = q.shape
    d = E // nhead
    s = torch.matmul(_heads(q, nhead) * float(d) ** -0.5,
                     _heads(k, nhead).transpose(1, 2))
    keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    o = torch.matmul(p, _heads(v, nhead)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(0, 1).reshape(T, B, E).to(q.dtype)


def _check(q, k, v, nhead):
    T, B, E = q.shape
    if E % nhead or E // nhead <= 0:
        raise ValueError(f"causal_attention: head dim {E}/{nhead} must be "
                         "a whole number")
    if E // nhead > MAX_D:
        raise NotImplementedError(
            f"causal_attention: head dim {E // nhead} > {MAX_D}, wider than "
            "the kernel's tiles")
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (T, B, E) or x.dtype != q.dtype \
                or x.device != q.device:
            raise ValueError(f"causal_attention: {name} must match q "
                             f"{(T, B, E)} {q.dtype} on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"causal_attention: bf16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"causal_attention: {name} needs unit stride "
                             "along its features")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     nhead: int) -> torch.Tensor:
    """Time-major causal attention: q, k, v (T, B, E) projections (views
    with unit feature stride, such as the column slices of the fused qkv
    projection, are read in place) -> (T, B, E) in q's dtype. CUDA tensors
    launch ``csrc/attention_fwd.cu`` (bf16 or float32, head dim <= 256,
    any T); CPU tensors run ``causal_attention_plain``. Each kernel launch
    adds one to the module's ``launches``."""
    if not q.is_cuda:
        return causal_attention_plain(q, k, v, nhead)
    _check(q, k, v, nhead)
    T, B, E = q.shape
    d = E // nhead
    out = torch.empty((T, B, E), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1))
    fn = _build.load("attention_fwd").attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), T, B,
             nhead, d, ctypes.cast(strides, _P), float(d) ** -0.5,
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
