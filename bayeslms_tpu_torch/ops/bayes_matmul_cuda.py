"""Fused Gaussian sample-and-matmul: the CUDA kernel's wrapper, its plain
twin and the autograd Function ``bayes_matmul``.

Replaces ``bayeslms_tpu/ops/bayes_matmul.py`` ``bayes_matmul`` (the
``_matmul_kernel`` Pallas body and its custom VJP) and ``bayes_matmul_ok``.
The forward kernel is ``csrc/bayes_matmul.cu``; its header says what bounds
it on the H100 and how its design answers that. ``bayes_matmul_fwd``
launches it for CUDA tensors and raises on what it does not take; for CPU
tensors it runs ``bayes_matmul_plain``.

y = x . W^T with W = mean + exp(lgstd) eps in float32, eps drawn per
128-row weight tile from the seed by the generator of ``csrc/bayes_sample.cu``
(``bayes_sample_cuda``; the two kernels share ``csrc/bayes_philox.cuh``), so
the forward's W equals ``bayes_sample_cuda.sample_weights(mean, lgstd,
seed)`` bit for bit and is never stored. The backward draws it again with
that sampler (kernel row 13 on the card) and forms, with ``torch.matmul``
outside any kernel as the JAX package leaves them to XLA
(``_bayes_matmul_bwd``): dx = g W, dmean = g^T x, dlgstd = g^T x * (W -
mean).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, bayes_sample_cuda

# kernel launches, one per call that reaches the kernel; reset by callers
# that read it, such as chip_smoke.py
launches = 0

TILE_ROWS = bayes_sample_cuda.TILE_ROWS

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 4 + [_P]


def bayes_matmul_ok(x2d: torch.Tensor, N: int, K: int) -> bool:
    """The JAX gate (``bayes_matmul_ok``: N % 128, K % 128, M % 8) on a CUDA
    tensor: where ``BayesDense(use_fused=True)`` takes the kernel."""
    M = x2d.shape[0]
    return x2d.is_cuda and N % TILE_ROWS == 0 and K % 128 == 0 and M % 8 == 0


def bayes_matmul_plain(x, mean, lgstd, seed) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments as
    ``bayes_matmul_fwd``: the sampler's twin, then a float32 matmul."""
    w = bayes_sample_cuda.sample_weights_plain(mean, lgstd, seed)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def bayes_matmul_fwd(x: torch.Tensor, mean: torch.Tensor, lgstd: torch.Tensor,
                     seed: torch.Tensor) -> torch.Tensor:
    """y = x . (mean + exp(lgstd) eps)^T, x (M, K) bf16 or float32, mean and
    lgstd (N, K) float32, seed int32 (1,), all on one device; y (M, N) in
    x's dtype. CUDA tensors launch ``csrc/bayes_matmul.cu`` (N a multiple of
    128, K of 16); CPU tensors run ``bayes_matmul_plain``. Each kernel
    launch adds one to the module's ``launches``."""
    if not x.is_cuda:
        return bayes_matmul_plain(x, mean, lgstd, seed)
    M, K = x.shape
    N = mean.shape[0]
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bayes_matmul: x must be bf16 or float32, got "
                         f"{x.dtype}")
    if N % TILE_ROWS or K % 16:
        raise ValueError(f"bayes_matmul: N = {N} must be a multiple of "
                         f"{TILE_ROWS} and K = {K} of 16")
    for name, t in (("mean", mean), ("lgstd", lgstd)):
        if tuple(t.shape) != (N, K) or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"bayes_matmul: {name} must be float32 ({N}, "
                             f"{K}) on {dev}")
    if tuple(seed.shape) != (1,) or seed.dtype != torch.int32 \
            or seed.device != dev:
        raise ValueError(f"bayes_matmul: seed must be int32 (1,) on {dev}")
    x, mean, lgstd = x.contiguous(), mean.contiguous(), lgstd.contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    fn = _build.load("bayes_matmul").bayes_matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(seed.data_ptr(), x.data_ptr(), mean.data_ptr(), lgstd.data_ptr(),
             y.data_ptr(), M, N, K, int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bayes_matmul kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return y


class _BayesMatmul(torch.autograd.Function):
    """The JAX custom VJP: the forward kernel, then a backward that draws
    W again from the seed (nothing is kept but the inputs)."""

    @staticmethod
    def forward(ctx, x, mean, lgstd, seed):
        ctx.save_for_backward(x, mean, lgstd, seed)
        return bayes_matmul_fwd(x, mean, lgstd, seed)

    @staticmethod
    def backward(ctx, g):
        x, mean, lgstd, seed = ctx.saved_tensors
        w = bayes_sample_cuda.sample_weights(mean, lgstd, seed)
        gf = g.float()
        dw = gf.t() @ x.float()
        return ((gf @ w).to(x.dtype), dw.to(mean.dtype),
                (dw * (w - mean.float())).to(lgstd.dtype), None)


def bayes_matmul(x: torch.Tensor, mean: torch.Tensor, lgstd: torch.Tensor,
                 seed: torch.Tensor) -> torch.Tensor:
    """``bayes_matmul_fwd``, differentiable in x, mean and lgstd."""
    return _BayesMatmul.apply(x, mean, lgstd, seed)
