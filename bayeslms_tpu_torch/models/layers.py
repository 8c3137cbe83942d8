"""The Bayesian dense layer, counterpart of ``bayeslms_tpu/models/layers.py``
``BayesDense`` (the reference's ``BayesLinear``, model.py:1049-1134). The GP
and variational units of that module are ROADMAP.md queue A item 10.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops import bayes_matmul_cuda, gaussian
from . import initializers as tinit


class BayesDense(nn.Module):
    """y = x W^T with a Gaussian posterior N(weight_mean, exp(weight_lgstd)^2)
    on the (out, in) weight and no bias, as at both of the reference's call
    sites (FFN linear2, MHA o_net). Evaluation uses the mean; training
    draws one W per call.

    ``use_fused``, as in the JAX package: None or False takes the plain
    path (W = mean + exp(lgstd) eps, then a matmul in x's dtype); True
    takes kernel row 12 (``bayes_matmul_cuda.bayes_matmul``, W drawn inside
    the matmul from a seed drawn on the device from ``generator``, float32
    dot) where ``bayes_matmul_ok`` admits the shape on a CUDA tensor. No
    configuration sets it; it is an attribute, as the JAX field is."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight_mean = nn.Parameter(torch.empty((out_features,
                                                     in_features)))
        self.weight_lgstd = nn.Parameter(torch.empty((out_features,
                                                      in_features)))
        self.use_fused: Optional[bool] = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(self.out_features + 1)
        tinit.uniform_(self.weight_mean, stdv, gen)
        gaussian.lgstd_init_(self.weight_lgstd, stdv, gen)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``eps`` injects the training draw (out, in) of the plain path."""
        if not deterministic and self.use_fused and eps is None:
            x2 = x.reshape(-1, self.in_features)
            if bayes_matmul_cuda.bayes_matmul_ok(x2, self.out_features,
                                                 self.in_features):
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=x.device, dtype=torch.int32)
                y = bayes_matmul_cuda.bayes_matmul(
                    x2, self.weight_mean, self.weight_lgstd, seed)
                return y.reshape(*x.shape[:-1], self.out_features)
        w = self.weight_mean
        if not deterministic:
            w = w + gaussian.sample_diff(self.weight_lgstd, eps=eps,
                                         generator=generator)
        return x @ w.t().to(x.dtype)

    def kl(self, prior_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The closed form of model.py:1110-1123, mean-reduced without the
        -1 term; with ``prior_mean`` the prior branch (weights against the
        prior's means, mean-reduced)."""
        if prior_mean is None:
            return gaussian.kl_std_normal(self.weight_mean, self.weight_lgstd)
        return torch.mean((self.weight_mean - prior_mean) ** 2.0
                          - self.weight_lgstd * 2.0
                          + torch.exp(self.weight_lgstd * 2.0)) / 2.0
