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
utterance in its chain instead (``layouts/xl.py``). Without MC every
model scores deterministically, as in the JAX package: the Bayesian and
GP ones at their posterior means, the variational ones without their
noise.

With ``carry_over=False`` the LSTM scores every hypothesis on its own
through the recurrent branch of packed-nocarry (zero-state resets at the
hypotheses' starts).

A pass encodes the whole N-best set in one call of the native encoder
(``data/native.py``, ``nbest.encode_all_native``); ``nbest.encode_hyp``
is its plain version. Where a word of the mapping holds whitespace the
native encoder cannot take it, and the pass encodes in Python, as the JAX
package does.

Interpolation with a second model of the same family (``inter_flag`` 1,
logit-level; 2, score-level; weight ``inter_alpha`` on the first model)
rides every layout that takes its family, through the fused CE
(``layouts/common.py``). ``mc_samples`` > 0 scores the MC average over
that many posterior draws of a dropout-free twin of the model
(``layouts/slotted.py``). ``backward`` reverses each hypothesis's words;
``splice_len`` puts up to that many words of context (``context_map``,
or by default the previous utterance's first hypothesis in its chain)
before each hypothesis, scored as conditioning only.

The scorer runs on one device, or with ``mesh`` (``parallel/mesh.py``)
on the dp ranks of a ``torch.distributed`` group: every rank calls
``score_nbest`` with the same N-best, runs the layout's one-device pass
on its block (the chains of packed-carry and slotted-carry, the columns of
packed-nocarry and slotted-bucketed; MC and XL stay whole on every rank,
as in the JAX package) and returns all the scores, gathered in the order
of the one-device pass. It refuses at construction, before any
device work, with ``ValueError``: a second model of the other family, of
another vocabulary, or missing under interpolation; MC with interpolation
(the JAX package scores the first model alone there) or with carry-over
on a recurrent model; XL with interpolation, MC or splicing. The JAX
package fails mid-pass on a cross-family pair.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..core.checkpoint import params_from_jax
from ..core.config import ModelConfig, RescoreConfig
from ..core.registry import build_model
from ..data.native import NativeEncoder
from ..utils.gcquiet import quiet_gc
from . import layouts
from .layouts import common
from .nbest import encode_all_native, encode_hyp


class BatchScorer:
    def __init__(self, cfg: ModelConfig, params, rcfg: RescoreConfig,
                 cfg2: Optional[ModelConfig] = None, params2=None,
                 device=None, mesh=None):
        """``params``: the JAX package's parameter tree (nested dicts of
        arrays, see core/checkpoint.py). ``cfg2``/``params2``: the second
        model of ``inter_flag`` 1 or 2 (``cfg2`` None: ``cfg``'s
        geometry). ``device``: where the models run; None means ``cuda``,
        which must be present (no CPU fallback). ``mc_noise``, None after
        construction, may be set to a callable (T, row, draw) -> eps list
        that MC scoring hands the model in place of its own draws
        (``layouts/slotted.py``). ``mesh``: score on its dp ranks, on its
        device (the JAX scorer's ``mesh``; its dp axis is read)."""
        if mesh is not None:
            device = mesh.device
        device = torch.device("cuda" if device is None else device)
        self.interp = rcfg.inter_flag
        self.cfg2 = cfg2 or cfg
        self.is_tm = cfg.is_transformer
        _refuse(cfg, self.cfg2 if self.interp else None, params2, rcfg)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchScorer: no CUDA device; pass device='cpu' to score on "
                "the CPU with the kernels' plain versions")
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = device
        self.mesh = mesh
        # MC draws posterior samples but applies no dropout: its model is
        # the dropout-free twin (the deterministic paths read no dropout)
        mcfg = dataclasses.replace(cfg, dropout=0.0) if rcfg.mc_samples \
            else cfg
        self.model = _load(mcfg, params, device,
                           cast=not rcfg.mc_samples)
        self.model2 = _load(self.cfg2, params2, device) if self.interp \
            else None
        self.m2 = common.interp_m2(self, params, params2)
        self.mc_noise = None
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

    def encode(self, nbest, word2idx: Dict[str, int], context_map=None):
        """{utt: [(inp, tgt, n_ctx, n_oov), ...]} of every hypothesis: one
        native call for the whole set, or ``encode_hyp`` a hypothesis where
        the native encoder cannot take the mapping or context is spliced
        (the native encoder takes no context)."""
        rc = self.rcfg
        enc = self.encoder(word2idx) if rc.splice_len == 0 else None
        if enc is not None:
            return encode_all_native(nbest, enc, backward=rc.backward)
        ctx = context_map or {}
        return {k: [encode_hyp(h, word2idx, backward=rc.backward,
                               context=ctx.get(k, ""),
                               splice_len=rc.splice_len) for h in hyps]
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
        decode's text) gives the context spliced before each hypothesis
        under ``splice_len``; without one, an utterance's context is the
        first hypotheses of the utterances before it in its chain, as in
        the JAX package. Without splicing it changes nothing. Returns
        {utt: [(hyp, score), ...]}."""
        if self.rcfg.xl_mems and context_map:
            raise ValueError(
                "xl_mems provides its own cross-utterance context; "
                "context_map would be silently ignored")
        if context_map is None and self.rcfg.splice_len > 0:
            context_map, last = {}, {}
            for k, hyps in nbest.items():
                label = stream_fn(k) if stream_fn else "_all"
                context_map[k] = last.get(label, "")
                if hyps:
                    last[label] = (last.get(label, "") + " " + hyps[0]).strip()
        # cyclic GC deferred to the gap between passes (utils/gcquiet.py)
        with quiet_gc(), torch.inference_mode():
            enc_all = self.encode(nbest, word2idx, context_map)
            result = layouts.select(self).fn(self, nbest, word2idx,
                                             stream_fn, enc_all)
        per_utt = {k: sum(e[3] for e in enc_all[k]) for k in nbest}
        self.oov_stats = {"total": sum(per_utt.values()), "per_utt": per_utt}
        return result


def _refuse(cfg: ModelConfig, cfg2: Optional[ModelConfig], params2,
            rcfg: RescoreConfig) -> None:
    """The configurations the port does not score, before any device work
    (ValueError). ``cfg2`` is the second model's configuration under
    interpolation, else None."""
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
    if rcfg.inter_flag not in (0, 1, 2):
        raise ValueError(f"inter_flag {rcfg.inter_flag}: 0 (none), 1 "
                         "(logit-level) or 2 (score-level)")
    if cfg2 is not None:
        if params2 is None:
            raise ValueError("interpolation needs a second model (params2)")
        if cfg2.is_transformer != cfg.is_transformer:
            raise ValueError(
                f"interpolation of a {cfg.model} with a {cfg2.model}: the "
                "two models must be of one family (both recurrent or both "
                "Transformers), whose fused CE takes their hidden states "
                "side by side")
        if cfg2.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"interpolation: the second model's vocabulary "
                f"({cfg2.vocab_size}) is not the first's ({cfg.vocab_size})")
    if rcfg.mc_samples:
        if rcfg.inter_flag:
            raise ValueError(
                "mc_samples with interpolation: MC-average scoring draws the "
                "first model alone; score with one or the other")
        if rcfg.carry_over and not cfg.is_transformer:
            raise ValueError("mc_samples requires carry_over=False")


def _load(cfg: ModelConfig, params, device,
          cast: bool = True) -> torch.nn.Module:
    """The model of ``params`` on ``device``. With ``cast`` its weight
    matrices (the embedding, an untied ``decoder_w``, W_ih, W_hh) are
    cast once to the compute dtype, as every deterministic pass reads
    them; biases stay
    float32, as the kernels take them (b_ih2 + b_hh2 is summed before its
    rounding). MC keeps every parameter float32, as training does: a draw
    adds its float32 noise to the float32 means (and the sampler takes
    float32 log-std tables), and the ops round the sum once."""
    model = params_from_jax(build_model(cfg), params).to(device)
    model.requires_grad_(False)
    cdtype = getattr(torch, cfg.compute_dtype)
    for p in model.parameters():
        if cast and p.dim() == 2:
            p.data = p.data.to(cdtype)
    return model
