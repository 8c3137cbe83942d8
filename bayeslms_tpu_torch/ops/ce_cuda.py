"""Fused tied-decoder cross-entropy: the CUDA kernels' wrapper and their
plain twin.

Replaces ``bayeslms_tpu/ops/ce_pallas.py`` ``fused_decode_ce`` (its
``_kernel`` Pallas body, kernel row 2). That kernel computes the per-token
sums of ``_fwd_stats_kernel`` (row 9) without its statistics, so for CUDA
tensors ``fused_decode_ce`` launches row 9's kernels, ``ce_stats_split``
and ``ce_stats_merge`` of ``csrc/ce_train.cu`` (``ce_train_cuda.score_fwd``:
wgmma fed by TMA, 64-deep chunks added to nearest, the vocabulary walk
split where the token tiles alone do not fill the card), wherever D is a
multiple of 64; ``csrc/ce_fwd.cu`` (wmma, one sum over D) scores the other
multiples of 32. ``route`` is that rule; the headers of both sources say
what bounds them on the H100 and how their designs answer that. The
wrapper raises on what neither takes; for CPU tensors it runs
``ce_plain``.

Per token m: ce[m] = logsumexp_v(h_m . E_v + b_v) - (h_m . E_{t_m} + b_{t_m}),
with the products of h and E in h's dtype accumulated in float32, a float32
bias and a float32 result.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, ce_train_cuda

# kernel launches (one per call that reaches a kernel) and the same calls by
# route; reset by callers that read them, such as chip_smoke.py
launches = 0
design_launches = {"split": 0, "wmma": 0}

# the widths each route takes: row 9's forward walks D in 64-deep chunks,
# csrc/ce_fwd.cu in 32-deep ones
SPLIT_WIDTH = ce_train_cuda.FWD_CHUNK
WMMA_WIDTH = 32

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 3 + [_P]

# Tokens per step of the plain version: its (rows, V) float32 logits are
# the only large buffer (~0.8 GB at V = 49,152), where the whole (M, V)
# block at M ~ 98k would take ~19 GB.
PLAIN_ROWS = 4096


def ce_plain(h, emb, bias, targets):
    """Plain PyTorch version of the kernel, same arguments as
    ``fused_decode_ce``; float32 logits, a chunk of tokens at a time."""
    e = emb.to(h.dtype).to(torch.float32)
    b = bias.to(torch.float32)
    t = targets.long()
    out = []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        logits = torch.addmm(b, h[s:s + PLAIN_ROWS].to(torch.float32), e.t())
        tl = logits.gather(1, t[s:s + PLAIN_ROWS, None])[:, 0]
        out.append(torch.logsumexp(logits, dim=1) - tl)
    if not out:
        return torch.zeros((0,), dtype=torch.float32, device=h.device)
    return torch.cat(out)


def route(D: int) -> str:
    """The kernel that scores width D: "split" (``ce_stats_split`` and
    ``ce_stats_merge`` of csrc/ce_train.cu) for D a multiple of 64, "wmma"
    (csrc/ce_fwd.cu) for the other multiples of 32. Raises ValueError on
    any other width. An explicit rule: the chosen kernel runs or raises."""
    if D > 0 and D % SPLIT_WIDTH == 0:
        return "split"
    if D > 0 and D % WMMA_WIDTH == 0:
        return "wmma"
    raise ValueError(f"fused_decode_ce: width {D} is not a multiple of "
                     f"{WMMA_WIDTH}")


def fused_decode_ce(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE of a tied decoder, from hidden states.

    h (M, D) in the compute dtype; emb (V, D), cast to h's dtype; bias (V,)
    float32; targets (M,) int. Returns ce (M,) float32. CUDA tensors (bf16,
    any M and V) launch the kernels ``route(D)`` names; CPU tensors run
    ``ce_plain``. Each call that reaches a kernel adds one to the module's
    ``launches`` and to its route's ``design_launches``.
    """
    global launches
    if not h.is_cuda:
        return ce_plain(h, emb, bias, targets)
    M, D = h.shape
    which = route(D)
    if which == "split":
        out = ce_train_cuda.score_fwd(h, emb, bias, targets)
        launches += 1
        design_launches[which] += 1
        return out
    V = emb.shape[0]
    dev = h.device
    if h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise ValueError(f"fused_decode_ce: h must be contiguous bf16, got "
                         f"{h.dtype}")
    if tuple(emb.shape) != (V, D) or emb.device != dev:
        raise ValueError(f"fused_decode_ce: emb must be (V, {D}) on {dev}; "
                         f"got {tuple(emb.shape)}")
    if tuple(bias.shape) != (V,) or tuple(targets.shape) != (M,) \
            or bias.device != dev or targets.device != dev:
        raise ValueError("fused_decode_ce: bias must be (V,) and targets "
                         f"({M},) on {dev}")
    emb = emb.to(torch.bfloat16).contiguous()
    bias = bias.to(torch.float32).contiguous()
    tgt = targets.to(torch.int32).contiguous()
    out = torch.empty((M,), dtype=torch.float32, device=dev)

    lib = _build.load("ce_fwd")
    fn = lib.ce_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(h.data_ptr(), emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(),
             out.data_ptr(), M, V, D,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_decode_ce kernel launch failed: CUDA error {err}")
    launches += 1
    design_launches[which] += 1
    return out

