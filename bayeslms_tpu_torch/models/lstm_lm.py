"""Recurrent language models, counterpart of
``bayeslms_tpu/models/lstm_lm.py``.

The port has the standard 2-layer LSTM core, the Bayesian gate-slice
LSTM core (``uncertainty="Bayesian"``) and the container with a tied
decoder: the scoring pass (``deterministic=True``, dropout off, the Bayes
core at its posterior mean) and the training forward, with dropout on the
embedding, between the standard core's layers and on the core's output, as
``RecurrentLM.__call__``, ``StandardRNNCore`` and ``BayesLSTMCore`` apply
it in the JAX package. GRU/RNN cores and the GP and variational cores are
ROADMAP.md queue A items 3 and 10; the cores raise for them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops import bayes_sample_cuda, gaussian
from ..ops.lstm import LSTMParams, lstm_stack2
from . import initializers as tinit

Hidden = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (nlayers, B, H)


def init_hidden(nlayers: int, batch: int, nhid: int,
                dtype=torch.float32, device=None) -> Hidden:
    z = torch.zeros((nlayers, batch, nhid), dtype=dtype, device=device)
    return (z, z.clone())


class DropoutMasks(NamedTuple):
    """Keep masks (nonzero = kept) of one training forward: on the
    embedding (T, B, emsize), between the layers (None for the Bayesian
    core, which has no inter-layer dropout) and on the core's output
    (T, B, nhid). Drawn by ``draw_dropout_masks`` or injected, so that a
    test can feed both packages the same masks."""

    emb: torch.Tensor
    layer: Optional[torch.Tensor]
    out: torch.Tensor


def draw_dropout_masks(cfg: ModelConfig, T: int, B: int,
                       gen: torch.Generator, device=None) -> DropoutMasks:
    """Bernoulli(1 - cfg.dropout) keep masks from ``gen`` (on ``device``)."""
    keep = 1.0 - cfg.dropout
    draw = lambda width: torch.rand(  # noqa: E731
        (T, B, width), generator=gen, device=device) < keep
    layer = None if cfg.uncertainty == "Bayesian" else draw(cfg.nhid)
    return DropoutMasks(draw(cfg.emsize), layer, draw(cfg.nhid))


def _dropout(x, mask, keep):
    """Inverted dropout as flax's ``nn.Dropout``: x / keep where kept."""
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class StandardRNNCore(nn.Module):
    """Multi-layer LSTM; this slice has the 2-layer LSTM branch. Parameter
    names follow the JAX tree: ``l{k}_w_ih``, ``l{k}_w_hh``, ``l{k}_b_ih``,
    ``l{k}_b_hh``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.model != "LSTM" or cfg.nlayers != 2:
            raise NotImplementedError(
                f"{cfg.model} with {cfg.nlayers} layers is not ported yet: the "
                "GRU/RNN cores and other depths are ROADMAP.md queue A item 3")
        for k, in_size in ((0, cfg.emsize), (1, cfg.nhid)):
            for name, shape in (("w_ih", (4 * cfg.nhid, in_size)),
                                ("w_hh", (4 * cfg.nhid, cfg.nhid)),
                                ("b_ih", (4 * cfg.nhid,)),
                                ("b_hh", (4 * cfg.nhid,))):
                self.register_parameter(
                    f"l{k}_{name}", nn.Parameter(torch.empty(shape)))
        self.nhid = cfg.nhid

    def layer(self, k: int) -> LSTMParams:
        return LSTMParams(*(getattr(self, f"l{k}_{n}")
                            for n in ("w_ih", "w_hh", "b_ih", "b_hh")))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            tinit.uniform_(p, tinit.rnn_bound(self.nhid), gen)

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None):
        """``train`` takes the grad route of ``lstm_stack2``;
        ``dropout_mask`` (T, B, H) scales layer 1's output there."""
        h0, c0 = hidden
        out, hs, cs = lstm_stack2(x, h0, c0, self.layer(0), self.layer(1),
                                  step_mask, reset_mask, reset_src,
                                  train=train, dropout_mask=dropout_mask)
        return out, (torch.stack(hs), torch.stack(cs))


_GATE_PARAMS = ("w_hh", "w_ih", "b_hh", "b_ih")  # the JAX sampling order
_TORCH_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
                "b_hh": "bias_hh"}


class BayesLSTMCore(nn.Module):
    """Two-layer LSTM with Gaussian gate-slice posteriors, the JAX
    package's ``BayesLSTMCore``; parameters ``weight_{ih,hh}_mean_{1,2}``,
    ``bias_{ih,hh}_mean_{1,2}`` and their ``_lgstd_`` twins.

    ``both_layers=True`` (Bayes2LSTM, what ``RecurrentLM`` builds):
    positions 1-4 sample the gate row slice [(pos-1) H, pos H) of both
    layers, the KL covers layer 1 only; position 5 samples nothing and keeps
    the summed-means KL quirk. ``both_layers=False`` (BayesLSTM): positions
    1-4 sample layer 1 only; position 5 samples the whole of layer 2 with
    the layer-1 lgstds. No inter-layer dropout in either (the reference
    runs its fused kernel with dropout 0).

    One eps per call and sampled tensor, drawn before the recurrence. The
    2-D slices that ``bayes_sample_cuda.sample_noise_ok`` admits go
    through the sampler kernel (seed drawn on the device from
    ``generator``); the biases and other slices through
    ``gaussian.sample_diff``. ``noise`` injects every eps instead, one per
    sampled tensor in the JAX call order: layer 1 then 2, and w_hh, w_ih,
    b_hh, b_ih within a layer.
    """

    def __init__(self, cfg: ModelConfig, both_layers: bool = True):
        super().__init__()
        if cfg.model != "LSTM" or cfg.nlayers != 2:
            raise NotImplementedError(
                f"the Bayesian core with {cfg.model} x {cfg.nlayers} is not "
                "ported: the reference's Bayes(2)LSTM is a 2-layer LSTM "
                "(ROADMAP.md queue A item 3 brings other depths)")
        H, pos = cfg.nhid, cfg.l_bayes_pos
        self.nhid, self.pos, self.both_layers = H, pos, both_layers
        self.lgstd_layers: Tuple[int, ...] = ()
        for l, in_size in ((1, cfg.emsize), (2, cfg.nhid)):
            for n, shape in (("w_ih", (4 * H, in_size)), ("w_hh", (4 * H, H)),
                             ("b_ih", (4 * H,)), ("b_hh", (4 * H,))):
                self.register_parameter(self._name(n, "mean", l),
                                        nn.Parameter(torch.empty(shape)))
        if 1 <= pos <= 5:
            rows = H if pos <= 4 else 4 * H
            self.lgstd_layers = (1, 2) if both_layers else (1,)
            for l in self.lgstd_layers:
                in_size = cfg.emsize if l == 1 else cfg.nhid
                for n, shape in (("w_hh", (rows, H)),
                                 ("w_ih", (rows, in_size)),
                                 ("b_hh", (rows,)), ("b_ih", (rows,))):
                    self.register_parameter(self._name(n, "lgstd", l),
                                            nn.Parameter(torch.empty(shape)))

    @staticmethod
    def _name(param: str, kind: str, layer: int) -> str:
        return f"{_TORCH_NAMES[param]}_{kind}_{layer}"

    def means(self, layer: int) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, self._name(n, "mean", layer))
                for n in _GATE_PARAMS}

    def lgstds(self, layer: int) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, self._name(n, "lgstd", layer))
                for n in _GATE_PARAMS}

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if "_lgstd_" in name:
                tinit.lgstd_(p, self.nhid, gen)
            else:
                tinit.uniform_(p, tinit.rnn_bound(self.nhid), gen)

    def _perturbed(self, generator, noise) -> list:
        """The two layers' effective weights of one training forward."""
        eff = [self.means(1), self.means(2)]
        pos, H = self.pos, self.nhid
        draws = None if noise is None else iter(noise)

        def diff(lg):
            eps = None
            if draws is not None:
                eps = next(draws, None)
                if eps is None:
                    raise ValueError("BayesLSTMCore: fewer injected noise "
                                     "tensors than sampled tensors")
            if eps is None and bayes_sample_cuda.sample_noise_ok(lg):
                seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=lg.device, dtype=torch.int32)
                return bayes_sample_cuda.sample_noise(lg, seed)
            return gaussian.sample_diff(lg, eps=eps, generator=generator)

        if 1 <= pos <= 4:
            r0, r1 = (pos - 1) * H, pos * H
            for li in ((0, 1) if self.both_layers else (0,)):
                lp = self.lgstds(li + 1)
                for n in _GATE_PARAMS:
                    w = eff[li][n]
                    # out of place, so the gradient reaches the mean rows
                    # and, through the sample, the lgstd
                    eff[li][n] = torch.cat([w[:r0], w[r0:r1] + diff(lp[n]),
                                            w[r1:]])
        elif pos == 5 and not self.both_layers:
            # BayesLSTM position 5: the whole of layer 2, with the layer-1
            # lgstds
            lp = self.lgstds(1)
            for n in _GATE_PARAMS:
                eff[1][n] = eff[1][n] + diff(lp[n])
        if draws is not None and next(draws, None) is not None:
            raise ValueError("BayesLSTMCore: more injected noise tensors "
                             "than sampled tensors")
        return eff

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """``train`` samples the weights and takes the grad route of
        ``lstm_stack2``; otherwise the posterior means take the scoring
        route. This core has no inter-layer dropout: ``dropout_mask`` must
        be None."""
        if dropout_mask is not None:
            raise ValueError("BayesLSTMCore has no inter-layer dropout")
        eff = (self._perturbed(generator, noise) if train
               else [self.means(1), self.means(2)])
        p = [LSTMParams(e["w_ih"], e["w_hh"], e["b_ih"], e["b_hh"])
             for e in eff]
        h0, c0 = hidden
        out, hs, cs = lstm_stack2(x, h0, c0, p[0], p[1], step_mask,
                                  reset_mask, reset_src, train=train)
        return out, (torch.stack(hs), torch.stack(cs))

    def kl_value(self, prior_w: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None) -> torch.Tensor:
        """The KL of Bayes(2)LSTM.kl_divergence: mean-reduced closed form
        against N(0, 1) over the layer-1 slice (weights plus biases). With
        ``prior_w = (prior weight_hh_mean_1, prior weight_ih_mean_1)`` the
        prior branch instead: sum-reduced, weights only, against the prior
        means. Position 5 with both layers keeps the reference's quirk of
        adding layer 2's hh and layer 1's ih terms."""
        H, pos = self.nhid, self.pos
        if not 1 <= pos <= 5:
            return torch.zeros((), device=self.weight_hh_mean_1.device)
        m1, lp = self.means(1), self.lgstds(1)
        quirk = pos == 5 and self.both_layers
        cat = lambda a, b: torch.cat([a, b], -1)  # noqa: E731
        rows = slice((pos - 1) * H, pos * H) if pos <= 4 else slice(None)
        w_mean = cat(m1["w_hh"][rows], m1["w_ih"][rows])
        w_lgstd = cat(lp["w_hh"], lp["w_ih"])
        if quirk:
            m2, lp2 = self.means(2), self.lgstds(2)
            w_mean = w_mean + cat(m2["w_hh"], m1["w_ih"])
            w_lgstd = w_lgstd + cat(lp2["w_hh"], lp["w_ih"])
        if prior_w is not None:
            p_hh, p_ih = prior_w
            return gaussian.kl_vs_prior_sum(
                w_mean, w_lgstd, cat(p_hh[rows], p_ih[rows]))
        b_mean = cat(m1["b_hh"][rows], m1["b_ih"][rows])
        b_lgstd = cat(lp["b_hh"], lp["b_ih"])
        if quirk:
            b_mean = b_mean + cat(m2["b_hh"], m1["b_ih"])
            b_lgstd = b_lgstd + cat(lp2["b_hh"], lp["b_ih"])
        return (gaussian.kl_std_normal(w_mean, w_lgstd)
                + gaussian.kl_std_normal(b_mean, b_lgstd))


class RecurrentLM(nn.Module):
    """Embedding -> recurrent core -> tied decoder (reference RNNModel).

    ``forward`` with ``deterministic=True`` (the default) is the scoring
    pass, dropout off; ``deterministic=False`` is the training forward.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.uncertainty not in ("none", "Bayesian"):
            raise NotImplementedError(
                f"uncertainty={cfg.uncertainty!r} is not ported yet: the GP "
                "and variational cores are ROADMAP.md queue A item 10")
        if not cfg.tied:
            raise NotImplementedError(
                "an untied decoder is not ported yet (ROADMAP.md queue A item 3)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, cfg.emsize)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        self.core = (BayesLSTMCore(cfg) if cfg.uncertainty == "Bayesian"
                     else StandardRNNCore(cfg))

    def reset_parameters(self, gen: torch.Generator) -> None:
        tinit.uniform_(self.embedding, tinit.EMBEDDING_BOUND, gen)
        with torch.no_grad():
            self.decoder_b.zero_()
        self.core.reset_parameters(gen)

    def forward(self, tokens, hidden: Hidden, step_mask=None,
                return_hidden: bool = False, reset_mask=None,
                reset_src: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[DropoutMasks] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """tokens (T, B) -> logits (T, B, V) float32 and the new hidden.

        ``step_mask`` (T, B) freezes the state on padded steps.
        ``reset_mask`` (T, B) with ``reset_src`` (B,) are the packed
        carry-over resets (see ops/lstm.py). ``return_hidden`` returns the
        core's output states (T, B, H) in place of logits, for the fused
        decoder CE. ``deterministic=False`` runs the training forward: the
        LSTM's grad route and, when ``cfg.dropout`` > 0, dropout with
        ``dropout_masks`` or masks drawn from ``generator``. The Bayesian
        core then samples its weights from ``generator``, or takes the
        injected ``noise`` (see ``BayesLSTMCore``).
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        emb = self.embedding[tokens].to(dtype)
        kw = {}
        if not deterministic and isinstance(self.core, BayesLSTMCore):
            kw = dict(generator=generator, noise=noise)
        if deterministic or cfg.dropout == 0:
            out, hidden = self.core(emb, hidden, step_mask, reset_mask,
                                    reset_src, train=not deterministic, **kw)
        else:
            keep = 1.0 - cfg.dropout
            m = dropout_masks
            if m is None:
                m = draw_dropout_masks(cfg, tokens.shape[0], tokens.shape[1],
                                       generator, emb.device)
            layer = None if m.layer is None else m.layer.to(dtype) / keep
            out, hidden = self.core(
                _dropout(emb, m.emb, keep), hidden, step_mask, reset_mask,
                reset_src, train=True, dropout_mask=layer, **kw)
            out = _dropout(out, m.out, keep)
        if return_hidden:
            return out, hidden
        logits = out @ self.embedding.to(dtype).t() + self.decoder_b.to(dtype)
        return logits.float(), hidden
