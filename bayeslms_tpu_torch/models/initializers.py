"""Initialisation laws of ``bayeslms_tpu/models/initializers.py``, drawn from
an explicit ``torch.Generator``.

Recurrent weights and biases are U(-1/sqrt(H), 1/sqrt(H)) (torch's LSTM
default), the embedding (tied decoder) is U(-0.1, 0.1), the decoder bias is
zero, and the Bayesian core's log-stds are U(2 log s, log s) with
s = 1/sqrt(H). Torch and JAX draw different streams from one seed: the same
law, not the same numbers.
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
