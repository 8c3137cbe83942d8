"""Fused Gaussian sample-and-matmul: the CUDA kernel's wrapper, its plain
twin and the autograd Function ``bayes_matmul``.

Replaces ``bayeslms_tpu/ops/bayes_matmul.py`` ``bayes_matmul`` (the
``_matmul_kernel`` Pallas body and its custom VJP) and ``bayes_matmul_ok``.
The forward kernels are in ``csrc/bayes_matmul.cu``; its header says what
bounds them on the H100 and how their two designs, picked by ``_design``,
answer that. ``bayes_matmul_fwd`` launches them for CUDA tensors and raises
on what they do not take; for CPU tensors it runs ``bayes_matmul_plain``.

y = x . W^T with W = mean + exp(lgstd) eps in float32, eps drawn per
128-row weight tile from the seed by the generator of ``csrc/bayes_sample.cu``
(``bayes_sample_cuda``; the two kernels share ``csrc/bayes_philox.cuh``), so
the forward's W equals ``bayes_sample_cuda.sample_weights(mean, lgstd,
seed)`` bit for bit ("simt" never stores it; "split" stores it once a call
as three bf16 pieces, ``split_weights``). The backward draws it again with
that sampler (kernel row 13 on the card) and forms, with ``torch.matmul``
outside any kernel as the JAX package leaves them to XLA
(``_bayes_matmul_bwd``): dx = g W, dmean = g^T x, dlgstd = g^T x * (W -
mean).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, bayes_sample_cuda

# kernel launches, one per call that reaches the kernels, and the calls by
# design; reset by callers that read them, such as chip_smoke.py
launches = 0
design_launches = {"split": 0, "simt": 0}

TILE_ROWS = bayes_sample_cuda.TILE_ROWS
# the split design's tile of y: rows (two warpgroups of 64) x columns
SPLIT_TILE = (128, 104)

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_int] * 4 + [_P]
_SPLIT_ARGTYPES = [_P] * 6 + [ctypes.c_int] * 3 + [_P]


def _design(dtype: torch.dtype, M: int, N: int, K: int,
            n_sm: int = 132) -> dict:
    """The forward's design (row 12) for x (M, K) of ``dtype`` and W (N, K):
    "split" for bf16 x (W drawn once as three bf16 pieces, then y on the
    tensor cores in 128 x 104 tiles), "simt" for float32 x (the CUDA-core
    kernel, W drawn in every block, 128 x 64 tiles). An explicit rule: the
    chosen design runs or raises. Returns a dict with the design, the grid
    (column tiles, row tiles for "split"; row tiles, column tiles for
    "simt"), its CTAs, the waves they make on ``n_sm`` SMs (one CTA a SM in
    "split", whose shared memory takes most of one) and the launches a
    call."""
    if dtype == torch.bfloat16:
        rows, cols = SPLIT_TILE
        grid = (-(-N // cols), -(-M // rows))
        ctas = grid[0] * grid[1]
        return dict(design="split", grid=grid, ctas=ctas,
                    waves=ctas / n_sm, launches=2)
    grid = (-(-M // 128), N // 64)
    return dict(design="simt", grid=grid, ctas=grid[0] * grid[1],
                waves=None, launches=1)


def split_weights(w: torch.Tensor):
    """The split design's three bf16 pieces of a float32 W: W1 = bf16(W),
    W2 = bf16(W - W1), W3 = bf16(W - W1 - W2), so that (W1 + W2) + W3 = W
    exactly in float32 (what ``bmm_draw_split`` writes)."""
    w1 = w.to(torch.bfloat16)
    r = w - w1.float()
    w2 = r.to(torch.bfloat16)
    w3 = (r - w2.float()).to(torch.bfloat16)
    return w1, w2, w3


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
    x's dtype. CUDA tensors launch ``csrc/bayes_matmul.cu`` in the design
    ``_design`` picks (N a multiple of 128, K of 16); CPU tensors run
    ``bayes_matmul_plain``. Each call that reaches the kernels adds one to
    the module's ``launches``."""
    if not x.is_cuda:
        return bayes_matmul_plain(x, mean, lgstd, seed)
    return _fwd(None, x, mean, lgstd, seed)


def _fwd(design, x, mean, lgstd, seed):
    """``bayes_matmul_fwd`` on CUDA tensors in ``design`` ("split" or
    "simt"), or in the one ``_design`` picks where it is None;
    chip_smoke.py times the CUDA-core kernel on the split design's bf16
    calls through it. "split" raises for float32 x."""
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
    plan = _design(x.dtype, M, N, K)["design"]
    if design is None:
        design = plan
    if design == "split" and plan != "split":
        raise ValueError(f"bayes_matmul: the split design takes bf16 x, not "
                         f"{x.dtype}")
    lib = _build.load("bayes_matmul")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if design == "split":
        pieces = torch.empty((3, N, K), dtype=torch.bfloat16, device=dev)
        fn = lib.bayes_matmul_split
        fn.argtypes, fn.restype = _SPLIT_ARGTYPES, ctypes.c_int
        err = fn(seed.data_ptr(), x.data_ptr(), mean.data_ptr(),
                 lgstd.data_ptr(), pieces.data_ptr(), y.data_ptr(), M, N, K,
                 stream)
    else:
        fn = lib.bayes_matmul
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        err = fn(seed.data_ptr(), x.data_ptr(), mean.data_ptr(),
                 lgstd.data_ptr(), y.data_ptr(), M, N, K,
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"bayes_matmul ({design}) kernel launch failed: "
                           f"error {err}")
    global launches
    launches += 1
    design_launches[design] += 1
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
