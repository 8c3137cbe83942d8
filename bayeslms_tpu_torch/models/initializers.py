"""Initialisation laws of ``bayeslms_tpu/models/initializers.py``, drawn from
an explicit ``torch.Generator``.

Recurrent weights and biases are U(-1/sqrt(H), 1/sqrt(H)) (torch's LSTM
default), the embedding (tied decoder) is U(-0.1, 0.1), the decoder bias is
zero, and the Bayesian core's log-stds are U(2 log s, log s) with
s = 1/sqrt(H). The Transformer's dense layers (flax (in, out) kernels)
follow ``transformer_lm.py:49-52,86-89,121-127``: torch's Linear default
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, and the fused qkv
projection xavier-uniform. Torch and JAX draw different streams from one
seed: the same law, not the same numbers.
"""

from __future__ import annotations

import math

import torch

from ..ops import gaussian


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from U(-bound, bound)."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def rnn_bound(nhid: int) -> float:
    return 1.0 / math.sqrt(nhid)


EMBEDDING_BOUND = 0.1


def lgstd_(t: torch.Tensor, nhid: int, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with the Bayesian core's log-std law,
    U(2 log s, log s), s = 1/sqrt(nhid)."""
    return gaussian.lgstd_init_(t, rnn_bound(nhid), gen)


def torch_linear_weight(fan_in: int) -> float:
    """The bound of torch's Linear default, for weight and bias alike."""
    return 1.0 / math.sqrt(fan_in)


torch_linear_bias = torch_linear_weight


def xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill a 2-D kernel in place from flax's ``glorot_uniform``:
    U(-b, b), b = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    return uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)
