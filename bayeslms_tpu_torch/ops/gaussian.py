"""Gaussian reparameterisation and closed-form KL terms, counterpart of
``bayeslms_tpu/ops/gaussian.py``.

The closed forms keep the reference's reduction quirks, so that losses
compare with the JAX package's and the reference's:

- ``kl_std_normal`` (mean-reduced, no ``-1`` term): BayesLSTM/Bayes2LSTM,
  BayesLinear, the EMB projection;
- ``kl_std_normal_m1`` (mean-reduced, with ``-1``): GPNN, VNN;
- ``kl_vs_prior_sum`` (sum-reduced, against a prior mean): the BayesLSTM
  prior branch;
- ``kl_vs_prior_full`` (GPNN2): the log-variance-ratio term divided by the
  trailing dimension of ``mean``.

Every parameter is a log-std ("lgstd"), std = exp(lgstd). The samplers
take the standard-normal draw ``eps`` injected, or draw it with
``torch.randn`` from ``generator`` (other bits than ``jax.random``: a test
injects the JAX package's draw).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.rng import sample_stream


def _eps(like: torch.Tensor, eps: Optional[torch.Tensor],
         generator: Optional[torch.Generator]) -> torch.Tensor:
    if eps is not None:
        if tuple(eps.shape) != tuple(like.shape):
            raise ValueError(f"injected eps {tuple(eps.shape)} != "
                             f"{tuple(like.shape)}")
        return eps.to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=sample_stream(generator),
                       device=like.device, dtype=like.dtype)


def sample_gaussian(mean, lgstd, scale: float = 1.0, eps=None,
                    generator=None):
    """mean + scale * eps * exp(lgstd), eps ~ N(0, 1)."""
    return mean + scale * _eps(mean, eps, generator) * torch.exp(lgstd)


def sample_diff(lgstd, scale: float = 1.0, eps=None, generator=None):
    """scale * eps * exp(lgstd): the additive perturbation alone."""
    return scale * _eps(lgstd, eps, generator) * torch.exp(lgstd)


def kl_std_normal(mean, lgstd):
    """mean(mean^2 - 2 lgstd + exp(2 lgstd)) / 2: the reference's form,
    without the -1."""
    return torch.mean(mean ** 2.0 - lgstd * 2.0 + torch.exp(lgstd * 2.0)) / 2.0


def kl_std_normal_m1(mean, lgstd):
    """mean(mean^2 - 2 lgstd + exp(2 lgstd) - 1) / 2: the KL against N(0, 1)."""
    return torch.mean(mean ** 2.0 - lgstd * 2.0 + torch.exp(lgstd * 2.0)
                      - 1.0) / 2.0


def kl_vs_prior_sum(mean, lgstd, prior_mean):
    """sum((mean - prior)^2 - 2 lgstd + exp(2 lgstd)) / 2."""
    return torch.sum((mean - prior_mean) ** 2.0 - lgstd * 2.0
                     + torch.exp(lgstd * 2.0)) / 2.0


def kl_vs_prior_full(mean, lgstd, prior_mean, prior_lgstd):
    """Gaussian-against-Gaussian KL, sum-reduced, with the reference's
    quirk: the log-variance-ratio term is divided by ``mean.shape[-1]``."""
    var = torch.exp(2.0 * lgstd)
    pvar = torch.exp(2.0 * prior_lgstd)
    mean_sq = (mean - prior_mean) ** 2.0 / pvar
    std_sq = var / pvar
    log_std_sq = 2.0 * (prior_lgstd - lgstd) / mean.shape[-1]
    return torch.sum(mean_sq + std_sq - log_std_sq - 1.0) / 2.0


def lgstd_init_(t: torch.Tensor, stdv: float,
                generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from U(2 log stdv, log stdv), the law of every
    lgstd parameter."""
    lo, hi = 2.0 * math.log(stdv), math.log(stdv)
    with torch.no_grad():
        return t.uniform_(lo, hi, generator=generator)
