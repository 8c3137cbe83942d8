"""DARTS supernets, counterpart of ``bayeslms_tpu/nas/supernet.py``:
deterministic-against-stochastic branch search (the reference's
model_search_bayes.py).

- ``gumbel_softmax``: softmax((logits + G) / T), G ~ Gumbel(0, 1) from
  injected or drawn uniforms, temperature 5.
- ``TransformerSupernet``: per layer, the FFN blends a standard branch and
  a Bayesian (``BayesDense`` beside linear2; mode ``bayes``) or GP (a
  ``GPNN`` in place of linear1 and its GELU, blended at the middle before
  the shared linear2; mode ``gauss``) branch; arch weights (nlayers, 1, 2).
- ``LSTMSupernet``: per layer and gate, a blend of the activated standard
  gate and a Bayesian (the branch at its posterior mean over cat(x, h))
  or GP (a ``GPNN`` over cat(x, h)) branch; arch weights (nlayers, 4, 2).

The JAX package's quirks are kept: the Bayesian LSTM branch runs at its
posterior mean during search (the reference flips ``.sample`` only after
the forward), ``b_ih`` enters the standard gates twice and ``b_hh`` never,
the branch KL is added unweighted by the arch weights, and the ``gauss``
Transformer blends at the FFN's middle. The supernets read no compute
dtype: they run in float32, as the JAX ones do.

No kernel runs here, as none runs in the JAX package: the explicit causal
mask sends the attention to its plain path, and ``BayesDense`` samples on
its plain path (JAX's ``use_fused=False``), so every operation stays twice
differentiable for the architect's second-order step. Only plain products
run on the card.

Architecture weights are not parameters of the modules: they are an
explicit argument, owned by the ``Architect``. Every draw of a forward
(dropout masks, the Bayesian branch's eps, the GP units' eps) comes from a
``Draws``, which a search step shares among its forwards, as the JAX step
hands one set of keys to all of them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..models import initializers as tinit
from ..models.layers import ACTS, GPNN, BayesDense
from ..models.lstm_lm import Hidden
from ..models.transformer_lm import (PE_LEN, Dense, LayerNorm,
                                     MultiheadSelfAttention, _torch_linear_)
from ..ops import gaussian
from ..ops.attention import causal_mask, sinusoidal_positional_encoding

TM_GP_ACTS = ("tanh", "sigmoid", "relu", "gelu")
LSTM_GP_ACTS = ("sigmoid", "tanh", "relu")
_GATE_ACTS = (torch.sigmoid, torch.sigmoid, torch.tanh, torch.sigmoid)


def gumbel_softmax(logits: torch.Tensor, u: Optional[torch.Tensor] = None,
                   temperature: float = 5.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """softmax((logits + G) / T) over the last axis, G = -log(-log(u +
    1e-20) + 1e-20) with ``u`` uniform in [0, 1) of logits' shape, injected
    or drawn from ``generator``."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
    g = -torch.log(-torch.log(u.to(logits) + 1e-20) + 1e-20)
    return torch.softmax((logits + g) / temperature, dim=-1)


def init_arch_weights(nlayers: int, slots: int = 1, branches: int = 2,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Small random logits, 1e-3 N(0, 1) (the reference's)."""
    return 1e-3 * torch.randn((nlayers, slots, branches), generator=generator,
                              device=device)


class Draws:
    """The random draws of one search step. Every forward of the step
    (the architect's and the weight step's) calls ``begin`` and then asks
    for its draws in its own order; the k-th draw of a kind and shape is
    drawn once and handed to every forward that asks for it, as the JAX
    step's forwards all take the same keys (a batch of another length
    gets masks of its own). ``inject(kind, shape)`` ("keep" or "normal")
    may return a draw (a keep mask, nonzero = kept, or standard-normal
    eps) in place of one from ``generator``; None draws."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 inject: Optional[Callable] = None):
        self.generator, self.inject = generator, inject
        self._cache: dict = {}
        self._i = 0

    def begin(self) -> "Draws":
        self._i = 0
        return self

    def _get(self, kind: str, shape, device, make):
        key = (self._i, kind, tuple(shape))
        self._i += 1
        if key not in self._cache:
            x = None if self.inject is None else self.inject(kind,
                                                             tuple(shape))
            self._cache[key] = make() if x is None else \
                torch.as_tensor(x).to(device)
        return self._cache[key]

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        return self._get("keep", shape, device, lambda: torch.rand(
            shape, generator=self.generator, device=device) < 1.0 - rate)

    def normal(self, shape, device) -> torch.Tensor:
        return self._get("normal", shape, device, lambda: torch.randn(
            shape, generator=self.generator, device=device))


def _drop(x, rate: float, training: bool, draws: Optional[Draws]):
    """flax's ``nn.Dropout``: x / keep where kept."""
    if not training or rate == 0.0:
        return x
    keep = draws.keep(x.shape, rate, x.device)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


def _gpnn_noise(unit: GPNN, training: bool, draws: Optional[Draws]):
    """The eps of one ``GPNN.draw`` in the JAX order (coef, then weights
    and bias), or None where it does not sample."""
    if not training or not unit.sample_enabled:
        return None
    dev = unit.coef_mean.device
    shapes = []
    if unit.gpnn_type in (1, 3):
        shapes.append(unit.coef_mean.shape)
    if unit.gpnn_type in (2, 3):
        shapes += [unit.weights_mean.shape, unit.bias_mean.shape]
    return iter([draws.normal(s, dev) for s in shapes])


def _weights(arch: torch.Tensor, gumbel_u, temperature: float):
    if gumbel_u is None:
        return torch.softmax(arch, dim=-1)
    return gumbel_softmax(arch, gumbel_u, temperature)


class SearchEncoderLayer(nn.Module):
    """Post-LN encoder layer whose FFN blends a standard and a stochastic
    branch by ``weights`` (2,): mode ``bayes`` (the reference's
    BayesTransSearchEncoderLayer) adds a ``BayesDense`` (ff -> d) beside
    linear2 on the same middle; ``gauss`` (GaussTransSearchEncoderLayer)
    blends a GPNN (d -> ff, type 3, sampling) with GELU(linear1) at the
    middle, then one dropout and linear2."""

    def __init__(self, d: int, nhead: int, ff: int, dropout: float,
                 mode: str):
        super().__init__()
        f32 = torch.float32
        self.d, self.nhead, self.ff, self.dropout = d, nhead, ff, dropout
        self.mode = mode
        self.self_attn = MultiheadSelfAttention(d, nhead, dropout, f32)
        self.linear1 = Dense(d, ff, f32)
        self.linear2 = Dense(ff, d, f32)
        self.branch = BayesDense(ff, d) if mode == "bayes" else GPNN(
            d, ff, TM_GP_ACTS, gpnn_type=3, sample_enabled=True)
        self.norm1 = LayerNorm(d, f32)
        self.norm2 = LayerNorm(d, f32)

    def reset_parameters(self, gen) -> None:
        self.self_attn.reset_parameters(gen)
        _torch_linear_(self.linear1, self.d, gen)
        _torch_linear_(self.linear2, self.ff, gen)
        self.branch.reset_parameters(gen)
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()

    def forward(self, src, weights, attn_mask, training: bool,
                draws: Optional[Draws]):
        T, B, _ = src.shape
        rate = self.dropout
        amask = None
        if training and rate > 0.0:
            amask = draws.keep((B, self.nhead, T, T), rate, src.device)
        src2 = self.self_attn(src, attn_mask, not training, amask)
        src = self.norm1(src + _drop(src2, rate, training, draws))
        if self.mode == "bayes":
            mid = _drop(F.gelu(self.linear1(src)), rate, training, draws)
            eps = draws.normal(self.branch.weight_mean.shape, src.device) \
                if training else None
            sto = self.branch(mid, not training, eps=eps)
            src2 = weights[0] * self.linear2(mid) + weights[1] * sto
        else:
            gp = self.branch(src, deterministic=not training,
                             noise=_gpnn_noise(self.branch, training, draws))
            mid = weights[0] * F.gelu(self.linear1(src)) + weights[1] * gp
            src2 = self.linear2(_drop(mid, rate, training, draws))
        return self.norm2(src + _drop(src2, rate, training, draws))

    def branch_kl(self) -> torch.Tensor:
        return self.branch.kl()


class TransformerSupernet(nn.Module):
    """Searchable Transformer LM (BayesTransModelSearch /
    GaussTransModelSearch): embedding x sqrt(E) + positions -> dropout ->
    ``SearchEncoderLayer`` x nlayers -> tied decoder."""

    def __init__(self, cfg: ModelConfig, mode: str = "bayes"):
        super().__init__()
        if mode not in ("bayes", "gauss"):
            raise ValueError(f"search mode {mode!r}: bayes or gauss")
        self.cfg, self.mode = cfg, mode
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size,
                                                   cfg.emsize)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        self.register_buffer("pe", sinusoidal_positional_encoding(
            PE_LEN, cfg.emsize), persistent=False)
        self.layers = [SearchEncoderLayer(cfg.emsize, cfg.nhead, cfg.nhid,
                                          cfg.dropout, mode)
                       for _ in range(cfg.nlayers)]
        for i, layer in enumerate(self.layers):
            self.add_module(f"layers_{i}", layer)

    def reset_parameters(self, gen: torch.Generator) -> None:
        tinit.uniform_(self.embedding, tinit.EMBEDDING_BOUND, gen)
        with torch.no_grad():
            self.decoder_b.zero_()
        for layer in self.layers:
            layer.reset_parameters(gen)

    def forward(self, tokens, arch, deterministic: bool = True,
                draws: Optional[Draws] = None, gumbel_u=None,
                temperature: float = 5.0):
        """tokens (T, B), arch (nlayers, 1, 2) logits -> (logits (T, B, V)
        float32, the layers' branch KL, unweighted). ``gumbel_u``: uniforms
        of arch's shape for ``gumbel_softmax``; None takes softmax(arch),
        as the search does."""
        cfg = self.cfg
        training = not deterministic
        if training:
            draws = (draws or Draws()).begin()
        T = tokens.shape[0]
        # an explicit mask pins the attention to its plain, twice
        # differentiable path
        mask = causal_mask(T, device=tokens.device)
        w = _weights(arch, gumbel_u, temperature)
        x = self.embedding[tokens] * math.sqrt(cfg.emsize)
        x = _drop(x + self.pe[:T, None, :], cfg.dropout, training, draws)
        kl = torch.zeros((), device=x.device)
        for l, layer in enumerate(self.layers):
            x = layer(x, w[l, 0], mask, training, draws)
            kl = kl + layer.branch_kl()
        return x @ self.embedding.t() + self.decoder_b, kl


class LSTMSearchCell(nn.Module):
    """One LSTM layer whose gates each blend the activated standard gate
    and a stochastic branch over cat(x, h) by ``gate_w`` (4, 2): mode
    ``bayes`` (BayesLSTMSearchCell) a per-gate Bayesian linear map at its
    posterior mean (``branch_mean`` (4H, in + H), ``branch_bias_mean``),
    ``gauss`` (GPLSTMSearchCell) per-gate GPNNs ``gpnn0``-``gpnn3`` (type
    3, sampling, drawn once a forward). Standard gates: x W_ih^T + b_ih +
    h W_hh^T + b_ih (the reference's bias quirk)."""

    def __init__(self, input_size: int, hidden_size: int, mode: str):
        super().__init__()
        H, IN = hidden_size, input_size
        self.input_size, self.hidden_size, self.mode = IN, H, mode
        self.w_ih = nn.Parameter(torch.empty((4 * H, IN)))
        self.w_hh = nn.Parameter(torch.empty((4 * H, H)))
        self.b_ih = nn.Parameter(torch.empty((4 * H,)))
        self.b_hh = nn.Parameter(torch.empty((4 * H,)))
        if mode == "bayes":
            self.branch_mean = nn.Parameter(torch.empty((4 * H, IN + H)))
            self.branch_lgstd = nn.Parameter(torch.empty((4 * H, IN + H)))
            self.branch_bias_mean = nn.Parameter(torch.empty((4 * H,)))
            self.branch_bias_lgstd = nn.Parameter(torch.empty((4 * H,)))
        else:
            self.branches = [GPNN(IN + H, H, LSTM_GP_ACTS, gpnn_type=3,
                                  sample_enabled=True) for _ in range(4)]
            for g, unit in enumerate(self.branches):
                self.add_module(f"gpnn{g}", unit)

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = tinit.rnn_bound(self.hidden_size)
        tinit.uniform_(self.w_ih, bound, gen)
        tinit.uniform_(self.w_hh, bound, gen)
        with torch.no_grad():
            self.b_ih.zero_()
            self.b_hh.zero_()
        if self.mode == "bayes":
            tinit.uniform_(self.branch_mean, bound, gen)
            gaussian.lgstd_init_(self.branch_lgstd, bound, gen)
            with torch.no_grad():
                self.branch_bias_mean.zero_()
            gaussian.lgstd_init_(self.branch_bias_lgstd, bound, gen)
        else:
            for unit in self.branches:
                unit.reset_parameters(gen)

    def forward(self, x, hc: Hidden, gate_w, training: bool,
                draws: Optional[Draws]):
        T, B, _ = x.shape
        H, IN = self.hidden_size, self.input_size
        x2 = x.reshape(T * B, -1)
        xg = (x2 @ self.w_ih.t() + self.b_ih).reshape(T, B, 4 * H)
        w_hh_t = self.w_hh.t()
        if self.mode == "bayes":
            wh_t = self.branch_mean[:, IN:].t()
            br_xg = (x2 @ self.branch_mean[:, :IN].t()
                     + self.branch_bias_mean).reshape(T, B, 4 * H)
        else:
            gp = []
            for unit in self.branches:
                w_, b_, coef = unit.draw(not training, noise=_gpnn_noise(
                    unit, training, draws))
                pre_x = (x2 @ w_[:, :IN].t() + b_).reshape(T, B, H)
                gp.append((pre_x, w_[:, IN:].t(), coef, unit.act_set))
            br_xg = torch.cat([g[0] for g in gp], dim=-1)
        h, c = hc
        ys = []
        for t in range(T):
            std_g = (xg[t] + h @ w_hh_t + self.b_ih).chunk(4, dim=-1)
            brx_g = br_xg[t].chunk(4, dim=-1)
            if self.mode == "bayes":
                br_g = (br_xg[t] + h @ wh_t).chunk(4, dim=-1)
            outs = []
            for g in range(4):
                std = gate_w[g, 0] * _GATE_ACTS[g](std_g[g])
                if self.mode == "bayes":
                    outs.append(std + gate_w[g, 1] * _GATE_ACTS[g](br_g[g]))
                    continue
                _, w_h_t, coef, act_set = gp[g]
                pre = brx_g[g] + h @ w_h_t
                gp_out = None
                for ai, act in enumerate(act_set):
                    term = ACTS[act](pre) * coef[ai]
                    gp_out = term if gp_out is None else gp_out + term
                outs.append(std + gate_w[g, 1] * gp_out)
            i, f, gg, o = outs
            c = f * c + i * gg
            h = o * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys), (h, c)

    def branch_kl(self) -> torch.Tensor:
        """Bayes: the four per-gate KLs (mean-reduced, with the -1 term,
        over each gate's (H, in + H) block and (H,) bias); equal blocks make
        their sum 4 x the whole array's mean. Gauss: the GPNNs' KLs."""
        if self.mode == "bayes":
            return 4.0 * (
                gaussian.kl_std_normal_m1(self.branch_mean, self.branch_lgstd)
                + gaussian.kl_std_normal_m1(self.branch_bias_mean,
                                            self.branch_bias_lgstd))
        kl = self.branches[0].kl()
        for unit in self.branches[1:]:
            kl = kl + unit.kl()
        return kl


class LSTMSupernet(nn.Module):
    """Searchable LSTM LM (BayesLSTMModelSearch): embedding -> dropout ->
    ``LSTMSearchCell`` x nlayers (``cell0``, ...) -> dropout -> tied
    decoder."""

    def __init__(self, cfg: ModelConfig, mode: str = "bayes"):
        super().__init__()
        if mode not in ("bayes", "gauss"):
            raise ValueError(f"search mode {mode!r}: bayes or gauss")
        self.cfg, self.mode = cfg, mode
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size,
                                                   cfg.emsize)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        self.cells = [LSTMSearchCell(cfg.emsize if l == 0 else cfg.nhid,
                                     cfg.nhid, mode)
                      for l in range(cfg.nlayers)]
        for l, cell in enumerate(self.cells):
            self.add_module(f"cell{l}", cell)

    def reset_parameters(self, gen: torch.Generator) -> None:
        tinit.uniform_(self.embedding, tinit.EMBEDDING_BOUND, gen)
        with torch.no_grad():
            self.decoder_b.zero_()
        for cell in self.cells:
            cell.reset_parameters(gen)

    def forward(self, tokens, hidden: Hidden, arch,
                deterministic: bool = True, draws: Optional[Draws] = None,
                gumbel_u=None, temperature: float = 5.0
                ) -> Tuple[torch.Tensor, Hidden, torch.Tensor]:
        """tokens (T, B), hidden (h, c) each (nlayers, B, H), arch
        (nlayers, 4, 2) logits -> (logits (T, B, V), the new hidden, the
        cells' branch KL, unweighted)."""
        cfg = self.cfg
        training = not deterministic
        if training:
            draws = (draws or Draws()).begin()
        w = _weights(arch, gumbel_u, temperature)
        h0, c0 = hidden
        out = _drop(self.embedding[tokens], cfg.dropout, training, draws)
        hs, cs = [], []
        kl = torch.zeros((), device=out.device)
        for l, cell in enumerate(self.cells):
            out, (hT, cT) = cell(out, (h0[l], c0[l]), w[l], training, draws)
            hs.append(hT)
            cs.append(cT)
            kl = kl + cell.branch_kl()
        out = _drop(out, cfg.dropout, training, draws)
        logits = out @ self.embedding.t() + self.decoder_b
        return logits, (torch.stack(hs), torch.stack(cs)), kl


def build_supernet(cfg: ModelConfig, mode: str) -> nn.Module:
    if cfg.is_transformer:
        return TransformerSupernet(cfg, mode)
    return LSTMSupernet(cfg, mode)
