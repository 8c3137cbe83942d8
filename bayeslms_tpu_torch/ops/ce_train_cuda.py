"""Fused tied-decoder cross-entropy with gradients: the CUDA kernels'
wrappers, their plain twins and the autograd Function
``fused_decode_ce_train``.

Replaces ``bayeslms_tpu/ops/ce_pallas.py`` ``fused_decode_ce_train`` (its
``_fwd_stats_kernel``, ``_bwd_dh_kernel`` and ``_bwd_de_kernel`` Pallas
bodies). The kernels are in ``csrc/ce_train.cu``, whose header says what
bounds them on the H100 and how their design answers that. ``ce_train_fwd``,
``ce_train_dh`` and ``ce_train_de`` launch them for CUDA tensors and raise on
what they do not take; for CPU tensors they run the plain twins beside them.

With s_mv = h_m . E_v + b_v (products of h and E in h's dtype accumulated in
float32, a float32 bias): the forward gives ce_m, max_m and sumexp_m; the
backward forms d_mv = a_m p_mv + b_m [v = t_m] with p_mv = exp(s_mv - max_m)
/ sumexp_m, and gives dh = d E and dE = d^T h with d rounded to h's dtype,
and db = sum_m d_mv in float32. The scoring path's ``ce_cuda`` stays as it
is.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches, one per call that reaches a kernel; reset by callers that
# read them, such as chip_smoke.py
launches = {"ce_train_fwd": 0, "ce_train_dh": 0, "ce_train_de": 0}

_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 7 + [ctypes.c_int] * 3 + [_P]
_BWD_ARGTYPES = [ctypes.c_int] + [_P] * 10 + [ctypes.c_int] * 3 + [_P]

# D columns a backward block owns (csrc/ce_train.cu DS)
D_SLICE = 256
# Tokens per step of the plain versions, whose (rows, V) float32 blocks are
# their only large buffers
PLAIN_ROWS = 4096


def _scores(h, e, bias, s):
    return torch.addmm(bias, h[s:s + PLAIN_ROWS].float(), e.t())


def ce_train_fwd_plain(h, emb, bias, targets):
    """Plain PyTorch version of the forward kernel, same arguments as
    ``ce_train_fwd``."""
    e = emb.to(h.dtype).float()
    b = bias.float()
    t = targets.long()
    ce, mx, se = [], [], []
    for s in range(0, h.shape[0], PLAIN_ROWS):
        logits = _scores(h, e, b, s)
        m = logits.max(dim=1).values
        sumexp = torch.exp(logits - m[:, None]).sum(dim=1)
        tl = logits.gather(1, t[s:s + PLAIN_ROWS, None])[:, 0]
        ce.append(torch.log(sumexp) + m - tl)
        mx.append(m)
        se.append(sumexp)
    if not ce:
        z = torch.zeros((0,), dtype=torch.float32, device=h.device)
        return z, z.clone(), z.clone()
    return torch.cat(ce), torch.cat(mx), torch.cat(se)


def _d_rows(h, e, bias, t, mx, se, a, b, s):
    """float32 d for tokens [s, s + PLAIN_ROWS)."""
    p = torch.exp(_scores(h, e, bias, s) - mx[s:s + PLAIN_ROWS, None]) \
        / se[s:s + PLAIN_ROWS, None]
    d = a[s:s + PLAIN_ROWS, None] * p
    rows = torch.arange(d.shape[0], device=d.device)
    d[rows, t[s:s + PLAIN_ROWS]] += b[s:s + PLAIN_ROWS]
    return d


def ce_train_dh_plain(h, emb, bias, targets, mx, se, a, b):
    """Plain PyTorch version of the dh kernel, same arguments as
    ``ce_train_dh``."""
    e = emb.to(h.dtype).float()
    bias, t = bias.float(), targets.long()
    out = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    for s in range(0, h.shape[0], PLAIN_ROWS):
        d = _d_rows(h, e, bias, t, mx, se, a, b, s)
        out[s:s + PLAIN_ROWS] = (d.to(h.dtype).float() @ e).to(h.dtype)
    return out


def ce_train_de_plain(h, emb, bias, targets, mx, se, a, b):
    """Plain PyTorch version of the dE/db kernel, same arguments as
    ``ce_train_de``."""
    e = emb.to(h.dtype).float()
    bias, t = bias.float(), targets.long()
    de = torch.zeros(emb.shape, dtype=torch.float32, device=h.device)
    db = torch.zeros(emb.shape[:1], dtype=torch.float32, device=h.device)
    for s in range(0, h.shape[0], PLAIN_ROWS):
        d = _d_rows(h, e, bias, t, mx, se, a, b, s)
        de += d.to(h.dtype).float().t() @ h[s:s + PLAIN_ROWS].float()
        db += d.sum(dim=0)
    return de, db


def _check(fn, h, emb, bias, targets, vectors=()):
    """Validate and convert the arguments the kernels take; returns (M, V,
    D, emb in bf16, bias in fp32, targets in int32)."""
    M, D = h.shape
    V = emb.shape[0]
    dev = h.device
    if h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise ValueError(f"{fn}: h must be contiguous bf16, got {h.dtype}")
    if D % D_SLICE != 0 or tuple(emb.shape) != (V, D) or emb.device != dev:
        raise ValueError(f"{fn}: emb must be (V, {D}) on {dev} with {D} a "
                         f"multiple of {D_SLICE}; got {tuple(emb.shape)}")
    if tuple(bias.shape) != (V,) or tuple(targets.shape) != (M,) \
            or bias.device != dev or targets.device != dev:
        raise ValueError(f"{fn}: bias must be ({V},) and targets ({M},) on "
                         f"{dev}")
    for name, v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (M,) \
                or v.device != dev or not v.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32 "
                             f"({M},) on {dev}")
    return (M, V, D, emb.to(torch.bfloat16).contiguous(),
            bias.to(torch.float32).contiguous(),
            targets.to(torch.int32).contiguous())


def _call(name, fn, argtypes, *args):
    lib = _build.load("ce_train")
    f = getattr(lib, fn)
    f.argtypes, f.restype = argtypes, ctypes.c_int
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def ce_train_fwd(h: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                 targets: torch.Tensor):
    """Per-token CE of a tied decoder with its softmax statistics.

    h (M, D) in the compute dtype; emb (V, D), cast to h's dtype; bias (V,)
    float32; targets (M,) int. Returns ce, max, sumexp (M,) float32. CUDA
    tensors launch ``ce_train_fwd`` of ``csrc/ce_train.cu`` (bf16, D a
    multiple of 256, any M and V); CPU tensors run ``ce_train_fwd_plain``.
    """
    if not h.is_cuda:
        return ce_train_fwd_plain(h, emb, bias, targets)
    M, V, D, emb, bias, tgt = _check("ce_train_fwd", h, emb, bias, targets)
    ce, mx, se = (torch.empty((M,), dtype=torch.float32, device=h.device)
                  for _ in range(3))
    _call("ce_train_fwd", "ce_train_fwd", _FWD_ARGTYPES, h.data_ptr(),
          emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(), ce.data_ptr(),
          mx.data_ptr(), se.data_ptr(), M, V, D,
          torch.cuda.current_stream(h.device).cuda_stream)
    return ce, mx, se


def _bwd(name, which, h, emb, bias, targets, mx, se, a, b, out, db):
    M, V, D, emb, bias, tgt = _check(name, h, emb, bias, targets,
                                     (("max", mx), ("sumexp", se), ("a", a),
                                      ("b", b)))
    _call(name, "ce_train_bwd", _BWD_ARGTYPES, which, h.data_ptr(),
          emb.data_ptr(), bias.data_ptr(), tgt.data_ptr(), mx.data_ptr(),
          se.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
          None if db is None else db.data_ptr(), M, V, D,
          torch.cuda.current_stream(h.device).cuda_stream)


def ce_train_dh(h, emb, bias, targets, mx, se, a, b):
    """dh_m = sum_v (a_m p_mv + b_m [v = t_m]) E_v, (M, D) in h's dtype.

    The forward's arguments, its statistics mx, se and the per-token
    coefficients a, b (M,) float32 (the CE's gradient: a = g, b = -g). CUDA
    tensors launch the dh kernel of ``csrc/ce_train.cu``; CPU tensors run
    ``ce_train_dh_plain``.
    """
    if not h.is_cuda:
        return ce_train_dh_plain(h, emb, bias, targets, mx, se, a, b)
    out = torch.empty(h.shape, dtype=torch.bfloat16, device=h.device)
    _bwd("ce_train_dh", 0, h, emb, bias, targets, mx, se, a, b, out, None)
    return out


def ce_train_de(h, emb, bias, targets, mx, se, a, b):
    """dE_v = sum_m (a_m p_mv + b_m [v = t_m]) h_m, (V, D) float32, and db_v
    = sum_m (...), (V,) float32. Arguments as ``ce_train_dh``. CUDA tensors
    launch the dE kernel of ``csrc/ce_train.cu``; CPU tensors run
    ``ce_train_de_plain``.
    """
    if not h.is_cuda:
        return ce_train_de_plain(h, emb, bias, targets, mx, se, a, b)
    de = torch.empty(emb.shape, dtype=torch.float32, device=h.device)
    db = torch.empty(emb.shape[:1], dtype=torch.float32, device=h.device)
    _bwd("ce_train_de", 1, h, emb, bias, targets, mx, se, a, b, de, db)
    return de, db


class _FusedDecodeCETrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, emb, bias, targets):
        # the table in h's dtype, cast once for the three kernels
        emb_c = emb.to(h.dtype).contiguous()
        ce, mx, se = ce_train_fwd(h, emb_c, bias, targets)
        ctx.save_for_backward(h, emb_c, bias, targets, mx, se)
        ctx.emb_dtype = emb.dtype
        return ce

    @staticmethod
    def backward(ctx, g):
        h, emb_c, bias, targets, mx, se = ctx.saved_tensors
        a = g.float().contiguous()
        b = -a
        dh = ce_train_dh(h, emb_c, bias, targets, mx, se, a, b)
        de, db = ce_train_de(h, emb_c, bias, targets, mx, se, a, b)
        return dh.to(h.dtype), de.to(ctx.emb_dtype), db.to(bias.dtype), None


def fused_decode_ce_train(h: torch.Tensor, emb: torch.Tensor,
                          bias: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Differentiable per-token CE of a tied decoder (the JAX package's
    ``fused_decode_ce_train``): h (M, D) in the compute dtype, emb (V, D),
    bias (V,), targets (M,) int. Returns ce (M,) float32; gradients flow to
    h, emb and bias. The backward recomputes the score tiles from the
    forward's (max, sumexp) instead of keeping (M, V) logits."""
    return _FusedDecodeCETrain.apply(h, emb, bias, targets)
