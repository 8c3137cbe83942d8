"""Layers of ``bayeslms_tpu/models/layers.py``: the Bayesian dense layer
``BayesDense`` (the reference's ``BayesLinear``, model.py:1049-1134), the
activation table ``ACTS``, the GP activation unit ``GPNN`` (types 0-3,
model.py:1780-1906), the random-feature GP unit ``GPNN2`` (type 4,
model.py:2036-2102) and the variational hidden-state noise unit ``VNN``
(model.py:2534-2579). ``GPNNNode``, which no container builds, is ROADMAP.md
queue A item 10.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import bayes_matmul_cuda, gaussian
from ..utils.rng import sample_stream
from . import initializers as tinit

# the activations of the GP units' act sets; gelu is the exact (erf) GELU
# (the JAX table's sin and cos serve only GPNNNode, ROADMAP.md queue A
# item 10)
ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "gelu": torch.nn.functional.gelu}


class GPNN(nn.Module):
    """GP activation unit: y = sum_i coef_i act_i(x W^T + b) (the reference's
    ``GPNN``). ``gpnn_type`` selects which of {weights, coefs} are
    Bayesian: 0 neither, 1 the coefs, 2 the weights and bias, 3 both; their
    log-stds are ``coef_lgstd``, ``weights_lgstd`` and ``bias_lgstd``. One
    sample a call site (``draw``), taken only when training with
    ``sample_enabled`` (the reference ships ``self.sample = False``: its
    training is deterministic with the KL)."""

    def __init__(self, input_size: int, output_size: int,
                 act_set: Sequence[str] = ("sigmoid", "tanh", "relu"),
                 gpnn_type: int = 0, sample_enabled: bool = False):
        super().__init__()
        if gpnn_type not in (0, 1, 2, 3):
            raise ValueError(f"GPNN type {gpnn_type} is not a GPNN (0-3); "
                             "type 4 is the random-feature GPNN2")
        self.input_size, self.output_size = input_size, output_size
        self.act_set = tuple(act_set)
        self.gpnn_type, self.sample_enabled = gpnn_type, sample_enabled
        k = len(self.act_set)
        self.weights_mean = nn.Parameter(torch.empty((output_size,
                                                      input_size)))
        self.bias_mean = nn.Parameter(torch.empty((output_size,)))
        self.coef_mean = nn.Parameter(torch.empty((k, output_size)))
        if gpnn_type in (1, 3):
            self.coef_lgstd = nn.Parameter(torch.empty((k, output_size)))
        if gpnn_type in (2, 3):
            self.weights_lgstd = nn.Parameter(torch.empty((output_size,
                                                           input_size)))
            self.bias_lgstd = nn.Parameter(torch.empty((output_size,)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(self.output_size)
        tinit.uniform_(self.weights_mean, stdv, gen)
        with torch.no_grad():
            self.bias_mean.zero_()
            self.coef_mean.uniform_(0.0, 1.0, generator=gen)
        for name, p in self.named_parameters():
            if name.endswith("_lgstd"):
                gaussian.lgstd_init_(p, stdv, gen)

    def draw(self, deterministic: bool = True,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Iterator[torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The effective (weights, bias, coef) of one call: the means, or,
        training with ``sample_enabled``, the means plus exp(lgstd) eps, eps
        in the JAX call order (coef, then weights and bias) from ``noise``
        or drawn from ``generator``."""
        w, b, coef = self.weights_mean, self.bias_mean, self.coef_mean
        if deterministic or not self.sample_enabled:
            return w, b, coef

        def diff(lgstd):
            return gaussian.sample_diff(lgstd, eps=_next_eps(noise, "GPNN"),
                                        generator=generator)

        if self.gpnn_type in (1, 3):
            coef = coef + diff(self.coef_lgstd)
        if self.gpnn_type in (2, 3):
            w = w + diff(self.weights_lgstd)
            b = b + diff(self.bias_lgstd)
        return w, b, coef

    @staticmethod
    def apply_drawn(x, w, b, coef, act_set: Sequence[str]) -> torch.Tensor:
        out = x @ w.t().to(x.dtype) + b.to(x.dtype)
        acc = None
        for i, act in enumerate(act_set):
            term = ACTS[act](out) * coef[i].to(x.dtype)
            acc = term if acc is None else acc + term
        return acc

    def forward(self, x, hx=None, deterministic: bool = True, drawn=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Iterator[torch.Tensor]] = None):
        if hx is not None:
            x = torch.cat([x, hx], dim=-1)
        w, b, coef = (drawn if drawn is not None
                      else self.draw(deterministic, generator, noise))
        return self.apply_drawn(x, w, b, coef, self.act_set)

    def kl(self) -> torch.Tensor:
        """model.py:1816-1826: mean-reduced, with the -1 term."""
        kl = torch.zeros((), device=self.coef_mean.device)
        if self.gpnn_type in (1, 3):
            kl = kl + gaussian.kl_std_normal_m1(self.coef_mean,
                                                self.coef_lgstd)
        if self.gpnn_type in (2, 3):
            kl = kl + gaussian.kl_std_normal_m1(self.weights_mean,
                                                self.weights_lgstd)
            kl = kl + gaussian.kl_std_normal_m1(self.bias_mean,
                                                self.bias_lgstd)
        return kl


# GPNN2's Monte Carlo terms (random features), n_MC_terms of model.py:2042
N_MC_TERMS = 150


def _next_eps(noise: Optional[Iterator[torch.Tensor]], who: str):
    """The next injected eps of ``noise``, or None without injection;
    raises when ``noise`` runs out."""
    if noise is None:
        return None
    eps = next(noise, None)
    if eps is None:
        raise ValueError(f"{who}: fewer injected noise tensors than sampled "
                         "tensors")
    return eps


class GPNN2(nn.Module):
    """Random-feature GP unit (the reference's ``GPNN2``, "first version"):
    out = x F, acc = out + sum_a act_a(out) (the skip connection),
    y = acc / sqrt(N_MC_TERMS) C + c, with the frequency matrix F
    (input_dim, N_MC_TERMS) drawn from N(``frequency_mean``,
    exp(``frequency_lgstd``)^2) whenever training (no sample flag), and the
    read-out ``coef_kernel`` (N_MC_TERMS, output_dim), ``coef_bias``
    (output_dim,) in the JAX layout."""

    def __init__(self, input_dim: int, output_dim: int,
                 act_set: Sequence[str] = ("sigmoid", "tanh", "relu", "gelu")):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.act_set = tuple(act_set)
        self.frequency_mean = nn.Parameter(torch.empty((input_dim,
                                                        N_MC_TERMS)))
        self.frequency_lgstd = nn.Parameter(torch.empty((input_dim,
                                                         N_MC_TERMS)))
        self.coef_kernel = nn.Parameter(torch.empty((N_MC_TERMS, output_dim)))
        self.coef_bias = nn.Parameter(torch.empty((output_dim,)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        stdv = 1.0 / math.sqrt(N_MC_TERMS)
        tinit.uniform_(self.frequency_mean, stdv, gen)
        gaussian.lgstd_init_(self.frequency_lgstd, stdv, gen)
        bound = tinit.torch_linear_weight(N_MC_TERMS)
        tinit.uniform_(self.coef_kernel, bound, gen)
        tinit.uniform_(self.coef_bias, bound, gen)

    def draw(self, deterministic: bool = True,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Iterator[torch.Tensor]] = None) -> torch.Tensor:
        """The frequency matrix of one call: the mean, or, training, the
        mean plus exp(lgstd) eps, eps the next of ``noise`` or drawn from
        ``generator``."""
        freq = self.frequency_mean
        if not deterministic:
            freq = freq + gaussian.sample_diff(
                self.frequency_lgstd, eps=_next_eps(noise, "GPNN2"),
                generator=generator)
        return freq

    def apply_drawn(self, x: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
        out = x @ freq.to(x.dtype)
        acc = out
        for act in self.act_set:
            acc = acc + ACTS[act](out)
        acc = acc / math.sqrt(N_MC_TERMS)
        return acc @ self.coef_kernel.to(x.dtype) + self.coef_bias.to(x.dtype)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Iterator[torch.Tensor]] = None):
        return self.apply_drawn(x, self.draw(deterministic, generator, noise))

    def kl(self, prior_mean: Optional[torch.Tensor] = None,
           prior_lgstd: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The prior-updating KL of model.py:2078-2096 against a zero
        prior by default (no container sows it)."""
        pm = (torch.zeros_like(self.frequency_mean) if prior_mean is None
              else prior_mean)
        pl = (torch.zeros_like(self.frequency_lgstd) if prior_lgstd is None
              else prior_lgstd)
        return gaussian.kl_vs_prior_full(self.frequency_mean,
                                         self.frequency_lgstd, pm, pl)


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
                seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=sample_stream(generator),
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


class VNN(nn.Module):
    """Variational hidden-state noise unit (the reference's ``VNN``,
    model.py:2534-2579): while training, the hidden vector takes additive
    noise 0.1 eps exp(``hidden_lgstd``), eps ~ N(0, 1), a fresh (1, H) draw
    at every time step. Its KL (model.py:2544-2549) reads the forward
    activations as the mean and, a reference quirk kept for loss parity,
    exponentiates the activations rather than the lgstd."""

    def __init__(self, input_size: int):
        super().__init__()
        self.input_size = input_size
        self.hidden_lgstd = nn.Parameter(torch.empty((1, input_size)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        gaussian.lgstd_init_(self.hidden_lgstd,
                             1.0 / math.sqrt(self.input_size), gen)

    def noise(self, n_steps: int, generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n_steps, 1, H): 0.1 eps exp(lgstd), eps the injected
        (n_steps, 1, H) standard-normal draw or one from ``generator``."""
        lg = self.hidden_lgstd
        shape = (n_steps, 1, self.input_size)
        if eps is None:
            eps = torch.randn(shape, generator=sample_stream(generator),
                              device=lg.device, dtype=lg.dtype)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"VNN: injected eps {tuple(eps.shape)} != "
                             f"{shape}")
        return 0.1 * eps.to(device=lg.device, dtype=lg.dtype) \
            * torch.exp(lg)[None]

    def kl(self, hidden_mean: torch.Tensor) -> torch.Tensor:
        """mean(h^2 - 2 lgstd + exp(2 h) - 1) / 2, h the last step's
        pre-noise hidden."""
        return torch.mean(hidden_mean ** 2.0 - self.hidden_lgstd * 2.0
                          + torch.exp(hidden_mean * 2.0) - 1.0) / 2.0
