"""Batched N-best scorer, counterpart of ``bayeslms_tpu/rescore/scorer.py``.

A hypothesis scores the SUM of its token cross-entropies (the reference's
``len * mean_CE``). For the LSTM with ``carry_over``, every hypothesis of an
utterance starts from the state in which the previous utterance's first
hypothesis ended, per carry-over chain; the packed-carry layout scores a
chunk of utterances of all chains as one time-packed sequence. The
Transformer scores every hypothesis on its own through the packed-nocarry
layout, whatever ``carry_over`` says, as the JAX package does; the fused
CE kernel then runs at width emsize. With ``xl_mems`` the Transformer
scores each utterance against Transformer-XL memories of the previous
utterance in its chain instead (``layouts/xl.py``). Every model scores
deterministically, as in the JAX package: the Bayesian and GP ones at
their posterior means, the variational ones without their noise.

With ``carry_over=False`` the LSTM scores every hypothesis on its own
through the recurrent branch of packed-nocarry (zero-state resets at the
hypotheses' starts).

A pass encodes the whole N-best set in one call of the native encoder
(``data/native.py``, ``nbest.encode_all_native``); ``nbest.encode_hyp``
is its plain version. Where a word of the mapping holds whitespace the
native encoder cannot take it, and the pass encodes in Python, as the JAX
package does.

This slice runs on one device, with ``inter_flag=0``, ``mc_samples=0``, no
backward scoring and no context splicing; the rest raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..core.checkpoint import params_from_jax
from ..core.config import ModelConfig, RescoreConfig
from ..core.registry import build_model
from ..data.native import NativeEncoder
from ..utils.gcquiet import quiet_gc
from . import layouts
from .nbest import encode_all_native, encode_hyp


class BatchScorer:
    def __init__(self, cfg: ModelConfig, params, rcfg: RescoreConfig,
                 device=None):
        """``params``: the JAX package's parameter tree (nested dicts of
        arrays, see core/checkpoint.py). ``device``: where the model runs;
        None means ``cuda``, which must be present (no CPU fallback)."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchScorer: no CUDA device; pass device='cpu' to score on "
                "the CPU with the kernels' plain versions")
        if rcfg.xl_mems:
            # the JAX scorer's refusals, in its words
            u = cfg.uncertainty
            std_layers = (
                u == "none"
                or (u == "Bayesian" and cfg.t_bayes_pos in ("none", "EMB"))
                or (u == "Gaussian" and cfg.t_gauss_pos > 4)
                or (u == "Variational" and cfg.t_v_pos == 0))
            if not (cfg.is_transformer and std_layers):
                raise ValueError(
                    "xl_mems requires a Transformer whose encoder layers are "
                    "all standard (stochastic layers have no memory hook)")
            if rcfg.inter_flag or rcfg.mc_samples:
                raise ValueError(
                    "xl_mems is incompatible with interpolation/MC")
            if rcfg.splice_len:
                raise ValueError(
                    "xl_mems provides its own cross-utterance context; it is "
                    "incompatible with splice_len/context files")
        if rcfg.inter_flag:
            raise NotImplementedError(
                "interpolation is not ported yet (ROADMAP.md queue A item 11)")
        if rcfg.mc_samples or rcfg.backward or rcfg.splice_len:
            raise NotImplementedError(
                "MC-average, backward and context-spliced scoring are not "
                "ported yet (ROADMAP.md queue A item 11)")
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = device
        self.model = params_from_jax(build_model(cfg), params).to(device)
        self.model.requires_grad_(False)
        # Every pass reads the weight matrices (embedding = tied decoder,
        # W_ih, W_hh) in the compute dtype: cast them once, here. Biases
        # stay float32, as the kernels take them (b_ih2 + b_hh2 is summed
        # before its rounding).
        cdtype = getattr(torch, cfg.compute_dtype)
        for p in self.model.parameters():
            if p.dim() == 2:
                p.data = p.data.to(cdtype)
        self.oov_stats = {"total": 0, "per_utt": {}}  # set by score_nbest
        self._enc_key = self._enc = None

    def encoder(self, word2idx: Dict[str, int]) -> Optional[NativeEncoder]:
        """The native encoder of ``word2idx``, built once for that dict (the
        dict itself is the key, held by the scorer), or None where a word
        holds whitespace."""
        if self._enc_key is not word2idx:
            self._enc = NativeEncoder.build(word2idx)
            self._enc_key = word2idx
        return self._enc

    def encode(self, nbest, word2idx: Dict[str, int]):
        """{utt: [(inp, tgt, n_ctx, n_oov), ...]} of every hypothesis: one
        native call for the whole set, or ``encode_hyp`` a hypothesis where
        the native encoder cannot take the mapping."""
        enc = self.encoder(word2idx)
        if enc is not None:
            return encode_all_native(nbest, enc)
        return {k: [encode_hyp(h, word2idx) for h in hyps]
                for k, hyps in nbest.items()}

    def score_nbest(
        self,
        nbest: "OrderedDict[str, List[str]]",
        word2idx: Dict[str, int],
        stream_fn=None,
        context_map: Optional[Dict[str, str]] = None,
    ):
        """Score every hypothesis. ``stream_fn(utt_key) -> chain label``
        splits utterances into independent carry-over chains (one per
        recording), which run side by side; utterances within a chain stay
        serial. Default: one chain. ``context_map`` (utterance -> previous
        decode's text) is the JAX scorer's argument; without context
        splicing (``splice_len`` 0, the only setting ported) it changes
        nothing, as there. Returns {utt: [(hyp, score), ...]}."""
        if self.rcfg.xl_mems and context_map:
            raise ValueError(
                "xl_mems provides its own cross-utterance context; "
                "context_map would be silently ignored")
        # cyclic GC deferred to the gap between passes (utils/gcquiet.py)
        with quiet_gc(), torch.inference_mode():
            enc_all = self.encode(nbest, word2idx)
            result = layouts.select(self).fn(self, nbest, word2idx,
                                             stream_fn, enc_all)
        per_utt = {k: sum(e[3] for e in enc_all[k]) for k in nbest}
        self.oov_stats = {"total": sum(per_utt.values()), "per_utt": per_utt}
        return result
