"""Initialisation laws of ``bayeslms_tpu/models/initializers.py``, drawn from
an explicit ``torch.Generator``.

Recurrent weights and biases are U(-1/sqrt(H), 1/sqrt(H)) (torch's LSTM
default), the embedding (tied decoder) is U(-0.1, 0.1), the decoder bias is
zero. Torch and JAX draw different streams from one seed: the same law,
not the same numbers.
"""

from __future__ import annotations

import math

import torch


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from U(-bound, bound)."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def rnn_bound(nhid: int) -> float:
    return 1.0 / math.sqrt(nhid)


EMBEDDING_BOUND = 0.1
