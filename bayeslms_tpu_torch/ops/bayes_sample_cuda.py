"""Gaussian weight sampler: the CUDA kernel's wrapper, its plain twin and
the autograd Function ``sample_noise``.

Replaces ``bayeslms_tpu/ops/bayes_matmul.py`` ``sample_weights`` (its
``_sample_kernel`` Pallas body), ``sample_noise`` and ``sample_noise_ok``.
The kernel is ``csrc/bayes_sample.cu``, whose header says what bounds it on
the H100 and how its design answers that. ``sample_weights`` launches it
for CUDA tensors and raises on what it does not take; for CPU tensors it
runs ``sample_weights_plain``.

out = mean + exp(lgstd) * eps in float32, eps by Box-Muller from two
24-bit uniforms (the TPU kernel's arithmetic), the uniforms from a
Philox4x32-10 generator keyed by (seed + tile, 0), tile = row // 128, and
counted by the element's offset in its tile (two elements a call). So eps
depends on (seed, tile, offset) only and a step can draw it again. The
bits are not the TPU's (its on-core generator has no counterpart here):
the twin computes the kernel's integers exactly with torch int64 ops, and
its uniforms equal the kernel's bit for bit; eps and out agree within a
few float32 ulps (the library's log, cos and exp).

The seed is a device int32 tensor of shape (1,) that the kernel reads
itself, so a training step draws it without a host round trip.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# kernel launches, one per call that reaches the kernel; reset by callers
# that read it, such as chip_smoke.py
launches = 0

TILE_ROWS = 128  # the TPU kernel's weight tile, rows sharing one key
_TWO_PI = 6.283185307179586
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, _P]


def tile_shape_ok(shape) -> bool:
    """The JAX gate's shape rule: 2-D, both dimensions multiples of 128."""
    return (len(shape) == 2 and shape[0] % TILE_ROWS == 0
            and shape[1] % 128 == 0)


def sample_noise_ok(lgstd: torch.Tensor) -> bool:
    """Whether the kernel takes this gate slice, as the JAX package's gate
    (``bayes_matmul.py`` ``sample_noise_ok``): a CUDA tensor of an
    admitted shape. Other slices take ``gaussian.sample_diff``."""
    return lgstd.is_cuda and tile_shape_ok(tuple(lgstd.shape))


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product m * x, for a uint32
    constant m and uint32 values x held in int64: the product is split at
    16 bits of m so that no partial product overflows int64."""
    a = x * (m & 0xFFFF)           # < 2^48
    b = x * (m >> 16)              # < 2^48
    low = a + ((b & 0xFFFF) << 16)  # < 2^49: the product is b 2^16 + a
    return (b >> 16) + (low >> 32), low & _U32


def philox4x32_10(ctr: torch.Tensor, k0: torch.Tensor, k1=0):
    """Philox4x32-10 of counters (ctr, 0, 0, 0) under keys (k0, k1), uint32
    values held in int64 tensors (k1 an int or a tensor that broadcasts to
    ctr); returns the four output words."""
    c0, c1 = ctr, torch.zeros_like(ctr)
    c2, c3 = torch.zeros_like(ctr), torch.zeros_like(ctr)
    k0 = k0 + torch.zeros_like(ctr)
    k1 = k1 + torch.zeros_like(ctr)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms_plain(seed: torch.Tensor, shape, device=None):
    """The kernel's two uniforms (u1, u2) of every element of an (N, K)
    draw, float32, each (N, K)."""
    N, K = shape
    device = seed.device if device is None else device
    n = N * K
    pairs = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    tile_pairs = TILE_ROWS * K // 2
    tile = pairs // tile_pairs
    key = (seed.to(device=device, dtype=torch.int64).reshape(())
           + tile) & _U32
    x0, x1, x2, x3 = philox4x32_10(pairs - tile * tile_pairs, key)
    w1 = torch.stack((x0, x2), dim=1).reshape(-1)[:n]
    w2 = torch.stack((x1, x3), dim=1).reshape(-1)[:n]
    scale = torch.tensor(2.0 ** -24, dtype=torch.float32, device=device)
    u1 = (w1 >> 8).to(torch.float32) * scale + torch.tensor(
        1e-12, dtype=torch.float32, device=device)
    u2 = (w2 >> 8).to(torch.float32) * scale
    return u1.reshape(N, K), u2.reshape(N, K)


def normal_plain(seed: torch.Tensor, shape, device=None) -> torch.Tensor:
    """eps of every element of an (N, K) draw, float32: Box-Muller on
    ``uniforms_plain``."""
    u1, u2 = uniforms_plain(seed, shape, device)
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=u1.device)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def sample_weights_plain(mean: Optional[torch.Tensor], lgstd: torch.Tensor,
                         seed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments as
    ``sample_weights``."""
    eps = normal_plain(seed, tuple(lgstd.shape), lgstd.device)
    d = torch.exp(lgstd.float()) * eps
    return d if mean is None else (mean.float() + d).to(mean.dtype)


def _launch(mean, lgstd, seed, uni=None) -> torch.Tensor:
    if lgstd.dim() != 2 or lgstd.dtype != torch.float32 \
            or lgstd.numel() % 2:
        raise ValueError(f"bayes_sample: lgstd must be 2-D float32 with an "
                         f"even count; got {tuple(lgstd.shape)} {lgstd.dtype}")
    dev = lgstd.device
    if mean is not None and (tuple(mean.shape) != tuple(lgstd.shape)
                             or mean.dtype != torch.float32
                             or mean.device != dev):
        raise ValueError("bayes_sample: mean must be float32 and shaped and "
                         "placed as lgstd")
    if tuple(seed.shape) != (1,) or seed.dtype != torch.int32 \
            or seed.device != dev:
        raise ValueError(f"bayes_sample: seed must be int32 (1,) on {dev}")
    # the kernel's float2 loads want 8-byte alignment
    lgstd = lgstd.contiguous() if lgstd.data_ptr() % 8 == 0 else lgstd.clone()
    if mean is not None:
        mean = mean.contiguous() if mean.data_ptr() % 8 == 0 else mean.clone()
    out = torch.empty_like(lgstd)
    N, K = lgstd.shape
    lib = _build.load("bayes_sample")
    fn = lib.bayes_sample
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(seed.data_ptr(), 0 if mean is None else mean.data_ptr(),
             lgstd.data_ptr(), out.data_ptr(),
             0 if uni is None else uni.data_ptr(), N * K, K,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bayes_sample kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


def sample_weights(mean: Optional[torch.Tensor], lgstd: torch.Tensor,
                   seed: torch.Tensor) -> torch.Tensor:
    """mean + exp(lgstd) * eps, or exp(lgstd) * eps when ``mean`` is None.

    lgstd (N, K) float32, mean None or float32 like it, seed int32 (1,) on
    the same device. CUDA tensors launch ``csrc/bayes_sample.cu`` (any N,
    N K even); CPU tensors run ``sample_weights_plain``. Each kernel launch
    adds one to the module's ``launches``."""
    if not lgstd.is_cuda:
        return sample_weights_plain(mean, lgstd, seed)
    return _launch(mean, lgstd, seed)


def sample_uniforms(lgstd: torch.Tensor, seed: torch.Tensor):
    """One kernel launch that also returns its uniforms: (noise, u1, u2),
    each (N, K) float32, for checks of the generator against
    ``uniforms_plain`` (CUDA tensors only)."""
    if not lgstd.is_cuda:
        raise ValueError("sample_uniforms: the kernel's uniforms need a CUDA "
                         "tensor")
    uni = torch.empty((*lgstd.shape, 2), dtype=torch.float32,
                      device=lgstd.device)
    noise = _launch(None, lgstd, seed, uni)
    return noise, uni[..., 0], uni[..., 1]


class _SampleNoise(torch.autograd.Function):
    """exp(lgstd) * eps; d/dlgstd is the noise itself (JAX
    ``_sample_noise_bwd``), nothing for the seed."""

    @staticmethod
    def forward(ctx, lgstd, seed):
        noise = sample_weights(None, lgstd, seed)
        ctx.save_for_backward(noise)
        return noise

    @staticmethod
    def backward(ctx, g):
        (noise,) = ctx.saved_tensors
        return g * noise, None


def sample_noise(lgstd: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """exp(lgstd) * eps drawn by ``sample_weights`` (the kernel for CUDA
    tensors), differentiable in lgstd."""
    return _SampleNoise.apply(lgstd, seed)
