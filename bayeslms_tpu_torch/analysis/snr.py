"""Posterior signal-to-noise analysis, counterpart of
``bayeslms_tpu/analysis/snr.py``.

The reference's variance.py: for a trained Bayesian checkpoint, SNR =
|posterior mean| / softplus(lgstd) over the sampled gate slice
(variance.py:37-57), reported as the median. As in the JAX package, every
(mean, lgstd) pair of a checkpoint is reported, with the gate-slice rows
of the mean taken for the Bayesian LSTM.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.checkpoint import _flatten, load_params
from ..core.config import ModelConfig


def softplus(x):
    return np.log1p(np.exp(x))


def snr_report(params, cfg: Optional[ModelConfig] = None) -> Dict[str, dict]:
    """Median and mean SNR and the mean sigma of every mean/lgstd pair of
    the parameter tree ``params``, keyed by the lgstd's "/"-joined path."""
    flat = {"/".join(map(str, k)): np.asarray(v)
            for k, v in _flatten(params).items()}
    report = {}
    for name, lgstd in flat.items():
        if "lgstd" not in name:
            continue
        mean = flat.get(name.replace("lgstd", "mean"))
        if mean is None:
            continue
        # the Bayesian LSTM's gate slice: the lgstd covers rows
        # [(pos - 1) H, pos H) of the gate-blocked mean (variance.py:47-49)
        if cfg is not None and mean.shape != lgstd.shape:
            H, pos = cfg.nhid, cfg.l_bayes_pos
            if 1 <= pos <= 4 and mean.shape[0] == 4 * H \
                    and lgstd.shape[0] == H:
                mean = mean[(pos - 1) * H: pos * H]
        if mean.shape != lgstd.shape:
            continue
        snr = np.abs(mean) / softplus(lgstd)
        report[name] = {
            "median_snr": float(np.median(snr)),
            "mean_snr": float(np.mean(snr)),
            "mean_sigma": float(np.mean(softplus(lgstd))),
            "shape": list(lgstd.shape),
        }
    return report


def snr_from_checkpoint(path: str, cfg: Optional[ModelConfig] = None):
    """``snr_report`` of any checkpoint ``core/checkpoint.py``
    ``load_params`` reads: the port's own, the JAX package's ``.ckpt`` or
    the reference's ``model.pt``."""
    tree = load_params(path, cfg or ModelConfig(vocab_size=1))
    return snr_report(tree, cfg)
