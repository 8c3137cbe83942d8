"""Model construction, counterpart of ``bayeslms_tpu/core/registry.py``.

The port builds the recurrent LM (``RecurrentLM``: the standard LSTM of any
depth, the GRU and the vanilla RNN; the 2-layer LSTM's uncertainty cores,
``"Bayesian"`` (the gate-slice Bayes2LSTM core), ``"Gaussian"`` (the
GP-LSTM core of an ``l_gauss_pos`` string: GP gates 1-7, GPNN types 0-3
and GPNN2; or the legacy GaussLSTM of ``l_gauss_legacy_pos``) and
``"Variational"`` (the variational LSTM of ``l_v_pos``, or the legacy
VLSTM with ``l_v_legacy``)) and the Transformer (standard, Bayesian at the
FFN, the MHA or the embedding, with the GP-FFN layer (``t_gauss_pos``
0-4) or with variational layers (``t_v_pos`` 1-3)), each with a tied or an
untied decoder. An uncertainty core at another depth or model raises
``NotImplementedError`` (the JAX package quietly builds two LSTM layers
there).
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
