"""Configuration dataclasses, field for field those of
``bayeslms_tpu/core/config.py`` (the JAX package), so that one configuration
describes a model in both packages. The port runs them on one device
or, for training with ``dp_shards`` > 1 or a mesh, on the ranks of a
``torch.distributed`` group (``parallel/``) (the standard LSTM of any depth, the GRU and the vanilla RNN; the 2-layer
LSTM's Bayesian gate-slice core, the GP-LSTM of every ``l_gauss_pos``
string, the legacy GaussLSTM (``l_gauss_legacy_pos`` 0-8), the variational
LSTM (``l_v_pos``) and the legacy VLSTM (``l_v_legacy``); the Transformer,
standard, Bayesian at the FFN, MHA or EMB, with the GP-FFN layer, and
variational (``t_v_pos`` 0-3); tied or untied decoders). The
uncertainty cores raise ``NotImplementedError`` for a depth or model other
than the 2-layer LSTM, which the JAX package quietly builds as two LSTM
layers.

Flag map to the reference recipes (BayesLMs ``steps/pytorchnn/train.py``):
``uncertainty`` -> --uncertainty, ``t_bayes_pos`` -> --T_bayes_pos,
``l_bayes_pos`` -> --L_bayes_pos, ``t_gauss_pos`` -> --T_gauss_pos,
``l_gauss_pos`` -> --L_gauss_pos, ``t_v_pos`` -> --T_v_pos,
``l_v_pos`` -> --L_v_pos.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture and uncertainty positions. Defaults follow the AMI
    recipes: LSTM 1024/1024 x2 or Transformer 512/4096 x6."""

    model: str = "LSTM"  # LSTM | GRU | RNN_TANH | RNN_RELU | Transformer
    vocab_size: int = 0
    emsize: int = 1024
    nhid: int = 1024
    nlayers: int = 2
    nhead: int = 8
    dropout: float = 0.2
    tied: bool = True

    uncertainty: str = "none"  # none | Bayesian | Gaussian | Variational
    t_bayes_pos: str = "none"  # none | FFN | MHA | EMB
    l_bayes_pos: int = 0  # 0 none, 1-4 gate slice (i,f,g,o), 5 whole layer
    t_gauss_pos: int = 3  # 0-3 GPNN type, 4 GPNN2, >4 none
    l_gauss_pos: str = "00"  # gate digit, gpnn-type digit, ...
    t_v_pos: int = 0  # 0 none, 1 layer0, 2 layer1, 3 layers 0+1
    l_v_pos: str = "00"  # per-layer variational flag
    l_gauss_legacy_pos: int = -1  # legacy GaussLSTM position, -1 = off
    l_v_legacy: bool = False  # legacy whole-output-noise VLSTM
    gp_sample: bool = False  # GP layers draw samples while training

    # parameters are stored in param_dtype; activations and the kernels'
    # operands are in compute_dtype (bfloat16 on the scoring path)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    v_seq_len: int = 100  # sequence length the variational layers gate on

    @property
    def is_transformer(self) -> bool:
        return self.model == "Transformer"

    def validate(self) -> "ModelConfig":
        if self.model not in ("LSTM", "GRU", "RNN_TANH", "RNN_RELU", "Transformer"):
            raise ValueError(f"unknown model type {self.model!r}")
        if self.uncertainty not in ("none", "Bayesian", "Gaussian", "Variational"):
            raise ValueError(f"unknown uncertainty {self.uncertainty!r}")
        if self.t_bayes_pos not in ("none", "FFN", "MHA", "EMB"):
            raise ValueError(f"unknown t_bayes_pos {self.t_bayes_pos!r}")
        if not 0 <= self.l_bayes_pos <= 5:
            raise ValueError("l_bayes_pos must be in [0, 5]")
        if self.vocab_size <= 0:
            raise ValueError("vocab_size must be set (> 0)")
        return self


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (reference train.py:64-105, :464-512)."""

    lr: float = 0.1
    momentum: float = 0.9
    batch_size: int = 32
    eval_batch_size: int = 20
    epochs: int = 32
    seq_len: int = 100
    clip: float = 1.0
    seed: int = 1111
    log_interval: int = 200
    # plateau scheduler: halve the LR and reload the best checkpoint on an
    # epoch that does not improve; stop after `max_plateaus` plateaus
    lr_decay: float = 0.5
    max_plateaus: int = 8
    data_fraction: float = 1.0  # 1.0 = the whole training set
    prior: bool = False
    prior_path: Optional[str] = None
    prior_kl: bool = False
    save: str = "model.ckpt"
    resume: bool = False
    dp_shards: int = 1
    # the JAX package's PRNG choice; kept for one configuration in both
    # packages and ignored here, where dropout draws from a torch.Generator
    rng_impl: str = "rbg"
    profile_dir: Optional[str] = None

    def validate(self) -> "TrainConfig":
        return self


@dataclasses.dataclass(frozen=True)
class RescoreConfig:
    """N-best rescoring (reference lmrescore_nbest_pytorchnn_cuda.sh)."""

    nbest: int = 20
    acwt: float = 0.1
    nn_weight: float = 1.0
    inter_flag: int = 0  # 0 none, 1 logit-level interp, 2 score-level interp
    inter_alpha: float = 0.8
    # cross-utterance hidden-state carry-over: every hypothesis of an
    # utterance starts from the state the previous utterance's first
    # hypothesis ended in
    carry_over: bool = True
    max_hyp_len: int = 128  # longer hypotheses score their first tokens
    batch_size: int = 64
    carry_chunk_utts: int = 10  # utterances per chain in one packed chunk
    min_lmwt: int = 7
    max_lmwt: int = 15
    mc_samples: int = 0  # Monte-Carlo-average scoring; 0 = posterior mean
    backward: bool = False  # score reversed hypotheses (backward LM)
    splice_len: int = 0  # context tokens spliced before each hypothesis
    xl_mems: bool = False  # Transformer-XL cross-utterance memories
