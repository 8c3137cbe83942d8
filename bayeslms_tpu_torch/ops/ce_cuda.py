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
multiples of 32. ``route`` is that rule for bf16 operands; float32
operands take ``csrc/ce_f32.cu`` (float32 products on the CUDA cores, the
vocabulary walk split by ``f32_plan``) at any width. The headers of the
sources say what bounds them on the H100 and how their designs answer
that. The wrapper raises on what none takes; for CPU tensors it runs
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
design_launches = {"split": 0, "wmma": 0, "f32": 0}

# the widths each route takes: row 9's forward walks D in 64-deep chunks,
# csrc/ce_fwd.cu in 32-deep ones
SPLIT_WIDTH = ce_train_cuda.FWD_CHUNK
WMMA_WIDTH = 32

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 3 + [_P]
# csrc/ce_f32.cu's ce_f32: six pointers, M, V, D, S, tiles a part, the
# stream
_F32_ARGTYPES = [_P] * 6 + [ctypes.c_int] * 5 + [_P]
# the float32 kernel's tiles (tokens, vocabulary rows) and the most parts
# its vocabulary walk is split into
F32_ROWS = 128
F32_COLS = 128
F32_MAX_SPLITS = 32

# Tokens per step of the plain version: its (rows, V) float32 logits are
# the only large buffer (~0.8 GB at V = 49,152), where the whole (M, V)
# block at M ~ 98k would take ~19 GB.
PLAIN_ROWS = 4096


def ce_plain(h, emb, bias, targets, acc=torch.float32):
    """Plain PyTorch version of the kernel, same arguments as
    ``fused_decode_ce``; float32 logits, a chunk of tokens at a time.
    ``acc`` is the logits' dtype: float64 with float64 operands is
    chip_smoke.py's float64 reference."""
    e = emb.to(h.dtype).to(acc)
    b = bias.to(acc)
    t = targets.long()
    out = []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        logits = torch.addmm(b, h[s:s + PLAIN_ROWS].to(acc), e.t())
        tl = logits.gather(1, t[s:s + PLAIN_ROWS, None])[:, 0]
        out.append(torch.logsumexp(logits, dim=1) - tl)
    if not out:
        return torch.zeros((0,), dtype=acc, device=h.device)
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


def f32_plan(M: int, V: int, n_sm: int) -> dict:
    """The float32 kernel's launch for M tokens over V words on a card of
    ``n_sm`` SMs: ceil(M / 128) token tiles; where they number fewer than
    two waves (2 ``n_sm``), the vocabulary walk of ceil(V / 128) tiles is
    split into S parts (at most ``F32_MAX_SPLITS``, none empty) so that the
    grid reaches them. Returns the tiles, S, the vocabulary tiles a part and
    the grid."""
    tiles = -(-M // F32_ROWS)
    vt = max(1, -(-V // F32_COLS))
    want = -(-2 * n_sm // max(tiles, 1))
    S = max(1, min(F32_MAX_SPLITS, vt, want))
    tpp = -(-vt // S)
    S = -(-vt // tpp)
    return dict(tiles=tiles, S=S, tiles_per_part=tpp, grid=(tiles, S))


def _fused_f32(h, emb, bias, targets):
    """``fused_decode_ce`` on float32 CUDA tensors: ``ce_f32`` of
    ``csrc/ce_f32.cu`` (the split walk and the merge, two launches)."""
    M, D = h.shape
    V = emb.shape[0]
    dev = h.device
    if not h.is_contiguous():
        raise ValueError("fused_decode_ce: h must be contiguous")
    if tuple(emb.shape) != (V, D) or emb.device != dev:
        raise ValueError(f"fused_decode_ce: emb must be (V, {D}) on {dev}; "
                         f"got {tuple(emb.shape)}")
    if tuple(bias.shape) != (V,) or tuple(targets.shape) != (M,) \
            or bias.device != dev or targets.device != dev or V == 0:
        raise ValueError("fused_decode_ce: bias must be (V,) and targets "
                         f"({M},) on {dev}, V > 0")
    emb = emb.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    tgt = targets.to(torch.int32).contiguous()
    plan = f32_plan(M, V, _build.sm_count(dev.index))
    ws = torch.empty((3, plan["S"], M), dtype=torch.float32, device=dev)
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    fn = _build.load("ce_f32").ce_f32
    fn.argtypes, fn.restype = _F32_ARGTYPES, ctypes.c_int
    err = fn(h.data_ptr(), emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(),
             ws.data_ptr(), out.data_ptr(), M, V, D, plan["S"],
             plan["tiles_per_part"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_ce float32 kernel launch failed: "
                           f"CUDA error {err}")
    return out


def fused_decode_ce(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE of a tied decoder, from hidden states.

    h (M, D) in the compute dtype; emb (V, D), cast to h's dtype; bias (V,)
    float32; targets (M,) int. Returns ce (M,) float32. CUDA tensors launch
    by h's dtype (any M and V): bf16 the kernels ``route(D)`` names,
    float32 ``csrc/ce_f32.cu`` (any D; route "f32"); another dtype raises.
    CPU tensors run ``ce_plain``. Each call that reaches a kernel adds one
    to the module's ``launches`` and to its route's ``design_launches``.
    """
    global launches
    if not h.is_cuda:
        return ce_plain(h, emb, bias, targets)
    if h.dtype == torch.float32:
        out = _fused_f32(h, emb, bias, targets)
        launches += 1
        design_launches["f32"] += 1
        return out
    if h.dtype != torch.bfloat16:
        raise ValueError(f"fused_decode_ce: {h.dtype} h; the kernels take "
                         "bf16 or float32")
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

