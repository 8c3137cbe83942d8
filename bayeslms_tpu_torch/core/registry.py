"""Model construction, counterpart of ``bayeslms_tpu/core/registry.py``.

The port builds the 2-layer LSTM with a tied decoder, with
``uncertainty="none"``, ``"Bayesian"`` (the gate-slice Bayes2LSTM core) or
``"Gaussian"`` (the GP-LSTM core of an ``l_gauss_pos`` string: GP gates
1-7, GPNN types 0-3 and GPNN2), and the Transformer with a tied decoder,
standard, Bayesian at the FFN, the MHA or the embedding, or with the GP-FFN
layer (``t_gauss_pos`` 0-4); every other configuration raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import torch

from torch import nn

from ..models.lstm_lm import RecurrentLM
from ..models.transformer_lm import TransformerLM
from .checkpoint import params_to_jax
from .config import ModelConfig


def build_model(cfg: ModelConfig) -> nn.Module:
    """An uninitialised model on the CPU (``RecurrentLM`` or
    ``TransformerLM``); ``init_params`` fills it."""
    cfg.validate()
    if cfg.is_transformer:
        return TransformerLM(cfg)
    return RecurrentLM(cfg)


def init_params(model: nn.Module, cfg: ModelConfig, seed: int = 0) -> dict:
    """Draw ``model``'s parameters from a ``torch.Generator`` seeded with
    ``seed`` and return them as the JAX package's parameter tree (nested
    dicts of float32 numpy arrays)."""
    model.reset_parameters(torch.Generator(device="cpu").manual_seed(seed))
    return params_to_jax(model)
