"""Gaussian weight sampler: the CUDA kernel's wrapper, its plain twin and
the autograd Function ``sample_noises`` (a step's slices in one launch;
``sample_noise`` its one-slice case).

Replaces ``bayeslms_tpu/ops/bayes_matmul.py`` ``sample_weights`` (its
``_sample_kernel`` Pallas body), ``sample_noise`` and ``sample_noise_ok``.
The kernel is ``csrc/bayes_sample.cu``, whose header says what bounds it on
the H100 and how its design answers that. ``sample_slices`` launches it
once for a table of up to ``MAX_SLICES`` slices, each under its own seed
(``sample_weights`` is its one-slice case), for CUDA tensors, and raises
on what it does not take; for CPU tensors it runs ``sample_slices_plain``.

out = mean + exp(lgstd) * eps in float32, eps by Box-Muller from two
24-bit uniforms (the TPU kernel's arithmetic), the uniforms from a
Philox4x32-10 generator keyed by (seed + tile, 0), tile = row // 128, and
counted by the element's offset in its tile (two elements a call). So eps
depends on (seed, tile, offset) only: a step can draw it again, and a
slice drawn among others equals its draw alone, bit for bit. The bits are
not the TPU's (its on-core generator has no counterpart here): the twin
computes the kernel's integers exactly with torch int64 ops, and its
uniforms equal the kernel's bit for bit; eps and out agree within a few
float32 ulps (the library's log, cos and exp).

The seeds are a device int32 tensor that the kernel reads itself, so a
training step draws them without a host round trip.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

# kernel launches, one per launch of the kernel (a table of slices); reset
# by callers that read it, such as chip_smoke.py
launches = 0

TILE_ROWS = 128  # the TPU kernel's weight tile, rows sharing one key
MAX_SLICES = 8   # the slices of one launch (csrc/bayes_sample.cu)
_TWO_PI = 6.283185307179586
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF

_P = ctypes.c_void_p
# bayes_sample_slices: the seeds, the count, five arrays (lgstd, mean,
# out, uni pointers; the counts), K, the seed indices, the stream
_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P]


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


def sample_slices_plain(lgstds: Sequence[torch.Tensor], seeds: torch.Tensor,
                        means: Optional[Sequence[Optional[torch.Tensor]]]
                        = None) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel, same arguments as
    ``sample_slices``: slice i is ``sample_weights_plain`` under
    ``seeds[i]``."""
    means = [None] * len(lgstds) if means is None else means
    return [sample_weights_plain(m, lg, seeds[i:i + 1])
            for i, (lg, m) in enumerate(zip(lgstds, means))]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel's float4 loads and stores want 16-byte alignment
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(lgstds, seeds, means=None, unis=None) -> List[torch.Tensor]:
    n = len(lgstds)
    means = [None] * n if means is None else list(means)
    unis = [None] * n if unis is None else list(unis)
    if not 0 < n <= MAX_SLICES or len(means) != n or len(unis) != n:
        raise ValueError(f"bayes_sample: 1 to {MAX_SLICES} slices, each "
                         f"with its mean (or None); got {n}")
    dev = lgstds[0].device
    if seeds.dim() != 1 or seeds.numel() < n or seeds.dtype != torch.int32 \
            or seeds.device != dev:
        raise ValueError(f"bayes_sample: seeds must be int32 ({n},) or "
                         f"longer on {dev}")
    lgs, mns, outs = [], [], []
    for lg, mean in zip(lgstds, means):
        if lg.dim() != 2 or lg.dtype != torch.float32 or lg.numel() % 2 \
                or lg.device != dev:
            raise ValueError(f"bayes_sample: lgstd must be 2-D float32 with "
                             f"an even count on {dev}; got "
                             f"{tuple(lg.shape)} {lg.dtype} on {lg.device}")
        if mean is not None and (tuple(mean.shape) != tuple(lg.shape)
                                 or mean.dtype != torch.float32
                                 or mean.device != dev):
            raise ValueError("bayes_sample: mean must be float32 and shaped "
                             "and placed as lgstd")
        lgs.append(_aligned(lg))
        mns.append(None if mean is None else _aligned(mean))
        outs.append(torch.empty_like(lgs[-1]))
    ptrs = lambda ts: (_P * n)(*(0 if t is None  # noqa: E731
                                 else t.data_ptr() for t in ts))
    counts = (ctypes.c_longlong * n)(*(lg.numel() for lg in lgs))
    cols = (ctypes.c_int * n)(*(lg.shape[1] for lg in lgs))
    index = (ctypes.c_int * n)(*range(n))
    fn = _build.load("bayes_sample").bayes_sample_slices
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(seeds.data_ptr(), n, ptrs(lgs), ptrs(mns), ptrs(outs),
             ptrs(unis), counts, cols, index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bayes_sample kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return outs


def sample_slices(lgstds: Sequence[torch.Tensor], seeds: torch.Tensor,
                  means: Optional[Sequence[Optional[torch.Tensor]]] = None
                  ) -> List[torch.Tensor]:
    """mean_i + exp(lgstd_i) * eps_i for every slice i, eps_i drawn under
    ``seeds[i]`` (exp(lgstd_i) * eps_i where ``means`` or its entry is
    None).

    lgstds: float32 2-D tensors with even element counts; seeds int32 (S,),
    S >= len(lgstds), on the same device. CUDA tensors launch
    ``csrc/bayes_sample.cu`` once for every ``MAX_SLICES`` slices; CPU
    tensors run ``sample_slices_plain``. Each kernel launch adds one to the
    module's ``launches``."""
    if not lgstds[0].is_cuda:
        return sample_slices_plain(lgstds, seeds, means)
    means = [None] * len(lgstds) if means is None else list(means)
    out = []
    for i in range(0, len(lgstds), MAX_SLICES):
        j = i + MAX_SLICES
        out += _launch(lgstds[i:j], seeds[i:j], means[i:j])
    return out


def sample_weights(mean: Optional[torch.Tensor], lgstd: torch.Tensor,
                   seed: torch.Tensor) -> torch.Tensor:
    """mean + exp(lgstd) * eps, or exp(lgstd) * eps when ``mean`` is None:
    ``sample_slices``'s one-slice case.

    lgstd (N, K) float32, mean None or float32 like it, seed int32 (1,) on
    the same device. CUDA tensors launch ``csrc/bayes_sample.cu`` (any N,
    N K even); CPU tensors run ``sample_weights_plain``. Each kernel launch
    adds one to the module's ``launches``."""
    if not lgstd.is_cuda:
        return sample_weights_plain(mean, lgstd, seed)
    if tuple(seed.shape) != (1,):
        raise ValueError(f"bayes_sample: seed must be int32 (1,); got "
                         f"{tuple(seed.shape)}")
    return _launch([lgstd], seed, [mean])[0]


def sample_uniforms(lgstd: torch.Tensor, seed: torch.Tensor):
    """One kernel launch that also returns its uniforms: (noise, u1, u2),
    each (N, K) float32, for checks of the generator against
    ``uniforms_plain`` (CUDA tensors only)."""
    if not lgstd.is_cuda:
        raise ValueError("sample_uniforms: the kernel's uniforms need a CUDA "
                         "tensor")
    uni = torch.empty((*lgstd.shape, 2), dtype=torch.float32,
                      device=lgstd.device)
    noise = _launch([lgstd], seed, [None], [uni])[0]
    return noise, uni[..., 0], uni[..., 1]


class _SampleNoises(torch.autograd.Function):
    """exp(lgstd_i) * eps_i for every slice, one output each; d/dlgstd_i is
    g_i * noise_i (JAX ``_sample_noise_bwd`` slice by slice), nothing for
    the seeds."""

    @staticmethod
    def forward(ctx, seeds, *lgstds):
        noises = sample_slices(lgstds, seeds)
        ctx.save_for_backward(*noises)
        return tuple(noises)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *(None if g is None else g * n
                        for g, n in zip(gs, ctx.saved_tensors)))


def sample_noises(lgstds: Sequence[torch.Tensor],
                  seeds: torch.Tensor) -> List[torch.Tensor]:
    """exp(lgstd_i) * eps_i under ``seeds[i]`` for every slice, drawn by
    ``sample_slices`` (one kernel launch for CUDA tensors), differentiable
    in each lgstd."""
    return list(_SampleNoises.apply(seeds, *lgstds))


def sample_noise(lgstd: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """exp(lgstd) * eps under ``seed`` (int32 (1,)): ``sample_noises``'s
    one-slice case, differentiable in lgstd."""
    return sample_noises([lgstd], seed)[0]
