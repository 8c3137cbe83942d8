"""The random streams of a training forward.

A model's ``generator`` argument is one ``torch.Generator``, from which
every draw of the forward comes, or a ``Streams`` pair: dropout (the
masks, the attention kernels' dropout seed) from ``dropout``, and the
weight, GP and variational draws (the Bayesian sampler's seeds, every eps)
from ``sample``. Data-parallel training hands each rank its own dropout
stream and one sample stream that is the same on every rank, so that the
ranks drop different units of their columns and share one posterior draw
a step, as the JAX package folds the shard index into its dropout key
only (``bayeslms_tpu/train/loop.py`` ``_step_impl``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class Streams(NamedTuple):
    dropout: torch.Generator
    sample: torch.Generator


Generator = Union[torch.Generator, Streams, None]


def dropout_stream(g: Generator) -> Optional[torch.Generator]:
    """The generator that dropout draws from."""
    return g.dropout if isinstance(g, Streams) else g


def sample_stream(g: Generator) -> Optional[torch.Generator]:
    """The generator that the weight, GP and variational draws come from."""
    return g.sample if isinstance(g, Streams) else g
