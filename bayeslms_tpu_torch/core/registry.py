"""Model construction, counterpart of ``bayeslms_tpu/core/registry.py``.

The port builds the 2-layer LSTM with a tied decoder, with
``uncertainty="none"`` or ``"Bayesian"`` (the gate-slice Bayes2LSTM core);
every other configuration raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from __future__ import annotations

import torch

from ..models.lstm_lm import RecurrentLM
from .checkpoint import params_to_jax
from .config import ModelConfig


def build_model(cfg: ModelConfig) -> RecurrentLM:
    """An uninitialised model on the CPU; ``init_params`` fills it."""
    cfg.validate()
    if cfg.is_transformer:
        raise NotImplementedError(
            "the Transformer family is not ported yet (ROADMAP.md queue A item 9)")
    return RecurrentLM(cfg)


def init_params(model: RecurrentLM, cfg: ModelConfig, seed: int = 0) -> dict:
    """Draw ``model``'s parameters from a ``torch.Generator`` seeded with
    ``seed`` and return them as the JAX package's parameter tree (nested
    dicts of float32 numpy arrays)."""
    model.reset_parameters(torch.Generator(device="cpu").manual_seed(seed))
    return params_to_jax(model)
