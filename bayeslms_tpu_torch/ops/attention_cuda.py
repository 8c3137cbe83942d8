"""Causal multi-head self-attention forward: the CUDA kernels' wrapper and
their plain twin.

Replaces ``bayeslms_tpu/ops/attention_pallas.py`` ``causal_attention_pallas``
(its ``_kernel`` Pallas body, kernel row 14) and ``pallas_attention_ok``.
The kernels are in ``csrc/attention_fwd.cu``; its header says what bounds
them on the H100 and how their designs answer that. ``causal_attention``
launches them for CUDA tensors and raises on what they do not take; for CPU
tensors it runs ``causal_attention_plain``.

Two designs, chosen by ``_design`` and counted apart in
``design_launches``: the tensor cores ("wgmma", TMA loads; 64 query rows a
CTA, keys in tiles of 64) for bf16 heads of d <= 128 (d % 8 == 0, 16-byte
aligned views), and the fp32 CUDA cores ("simt") for float32, d = 256 and
views TMA cannot describe. ``_plan`` gives the launch plan as plain Python:
the grid and tile count the library launches with, the tile geometry it
checks against its kernel's, and the tile walk, which the CPU tests check.

Per batch column, head and query row r: s_c = (q_r d^-1/2) . k_c for
c <= r and -1e30 above the diagonal, an fp32 softmax, and o_r = P V with
P at fp32 precision (the TPU kernel's arithmetic; the wgmma design feeds the
tensor cores P as bf16(p) plus bf16(p - bf16(p)), two products into one
fp32 sum, P within 2^-16 of p), the output in q's dtype. q,
k and v are the time-major (T, B, E) projections, E = nhead d, unscaled.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches, one per call that reaches a kernel; reset by callers
# that read them, such as chip_smoke.py
launches = 0
# the same launches by design (``_design``)
design_launches = {"wgmma": 0, "simt": 0}

MAX_T = 8192   # the JAX gate's sequence limit
MAX_D = 256    # the widest head the kernels' tiles take
WGMMA_MAX_D = 128  # the widest head of the tensor-core design
_NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_P, ctypes.c_float, _I, _P, _P]


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


def _design(views, nhead: int) -> str:
    """The kernel design for these (T, B, E) views of q, k, v (and dO, in
    rows 16-17, which take the same rule): "wgmma"
    (bf16, head dim d <= 128 a multiple of 8, every view's data and (time,
    batch) strides 16-byte aligned, which TMA needs) or "simt" (the
    CUDA-core kernel: float32, wider heads, views TMA cannot describe). An
    explicit rule, not a fallback: the chosen kernel runs or raises."""
    q = views[0]
    d = q.shape[2] // nhead
    ok = (q.dtype == torch.bfloat16 and d <= WGMMA_MAX_D and d % 8 == 0
          and all(x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
                  and x.stride(1) % 8 == 0 for x in views))
    return "wgmma" if ok else "simt"


def _plan(T: int, B: int, nhead: int, design: str) -> dict:
    """The launch plan: the grid and tile count the kernel is launched
    with, the query rows and keys of a tile and the threads of a CTA (which
    the library holds against its kernel's), and ``block(x)`` -> (query
    tile, batch-head, key tiles walked) of CTA x, as the kernel computes
    them from the grid and tile count. Both designs take tiles of 64 rows
    and 64 keys. wgmma: x runs over ntiles x B h, the longest rows first
    (qt = ntiles - 1 - x // BH), 160 threads (a consumer warpgroup and a
    producer warp); simt: grid (B h, ntiles), 256 threads."""
    BH, rows = B * nhead, 64
    nt = -(-T // rows)
    if design == "wgmma":
        def blk(x):
            qt = nt - 1 - x // BH
            return qt, x % BH, range(qt + 1)
        return dict(design=design, grid=(nt * BH,), threads=160, rows=rows,
                    keys=rows, ntiles=nt, block=blk)

    def blk(x):
        qt = x // BH
        return qt, x % BH, range(qt + 1)
    return dict(design=design, grid=(BH, nt), threads=256, rows=rows,
                keys=rows, ntiles=nt, block=blk)


def _plan_words(plan: dict):
    """A plan as the library takes it: int32 {design (1 wgmma), grid x,
    grid y, tiles, rows, keys, threads}."""
    gx, gy = (*plan["grid"], 1)[:2]
    return (_I * 7)(int(plan["design"] == "wgmma"), gx, gy, plan["ntiles"],
                    plan["rows"], plan["keys"], plan["threads"])


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
    launch ``csrc/attention_fwd.cu`` in the design ``_design`` picks, on the
    plan ``_plan`` gives (bf16 or float32, head dim <= 256, any T); CPU
    tensors run ``causal_attention_plain``. Each kernel launch adds one to
    the module's ``launches`` and to its design's ``design_launches``."""
    if not q.is_cuda:
        return causal_attention_plain(q, k, v, nhead)
    _check(q, k, v, nhead)
    T, B, E = q.shape
    d = E // nhead
    design = _design((q, k, v), nhead)
    words = _plan_words(_plan(T, B, nhead, design))
    out = torch.empty((T, B, E), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1))
    fn = _build.load("attention_fwd").attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), T, B,
             nhead, d, ctypes.cast(strides, _P), float(d) ** -0.5,
             int(q.dtype == torch.bfloat16), ctypes.cast(words, _P),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed ({design}): "
                           f"CUDA error {err}")
    global launches
    launches += 1
    design_launches[design] += 1
    return out
