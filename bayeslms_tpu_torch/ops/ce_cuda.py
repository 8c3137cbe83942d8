"""Fused tied-decoder cross-entropy: the CUDA kernel's wrapper and its
plain twin.

Replaces ``bayeslms_tpu/ops/ce_pallas.py`` ``fused_decode_ce`` (its
``_kernel`` Pallas body). The kernel is ``csrc/ce_fwd.cu``; its header says
what bounds it on the H100 and how its design answers that.
``fused_decode_ce`` launches it for CUDA tensors and raises on what it does
not take; for CPU tensors it runs ``ce_plain``.

Per token m: ce[m] = logsumexp_v(h_m . E_v + b_v) - (h_m . E_{t_m} + b_{t_m}),
with the products of h and E in h's dtype accumulated in float32, a float32
bias and a float32 result.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches (one per call that reaches the kernel); reset by callers
# that read it, such as chip_smoke.py
launches = 0

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


def fused_decode_ce(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE of a tied decoder, from hidden states.

    h (M, D) in the compute dtype; emb (V, D), cast to h's dtype; bias (V,)
    float32; targets (M,) int. Returns ce (M,) float32. CUDA tensors launch
    ``csrc/ce_fwd.cu`` (bf16, D a multiple of 32, any M and V); CPU tensors
    run ``ce_plain``. Each kernel launch adds one to the module's ``launches``.
    """
    if not h.is_cuda:
        return ce_plain(h, emb, bias, targets)
    M, D = h.shape
    V = emb.shape[0]
    dev = h.device
    if h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise ValueError(f"fused_decode_ce: h must be contiguous bf16, got "
                         f"{h.dtype}")
    if D % 32 != 0 or tuple(emb.shape) != (V, D) or emb.device != dev:
        raise ValueError(f"fused_decode_ce: emb must be (V, {D}) on {dev} "
                         f"with {D} a multiple of 32; got {tuple(emb.shape)}")
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
    global launches
    launches += 1
    return out

