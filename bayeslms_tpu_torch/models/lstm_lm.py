"""Recurrent language models, counterpart of
``bayeslms_tpu/models/lstm_lm.py``.

The port has the standard 2-layer LSTM core, the Bayesian gate-slice
LSTM core (``uncertainty="Bayesian"``), the GP-LSTM core
(``uncertainty="Gaussian"``: ``GPLSTMCore`` with GP gates 1-7 and GPNN
types 0-4, ``GPLSTMCell``, ``StdLSTMLayer``; with ``l_gauss_legacy_pos``
0-8 the legacy ``GaussLSTMLegacyCore``), the variational cores
(``uncertainty="Variational"``: ``VLSTMCore``, with ``l_v_legacy`` the
legacy ``VLSTMLegacyCore``) and the container with a tied decoder: the
scoring pass (``deterministic=True``, dropout off, the Bayes core at its
posterior mean, the GP units at their means, no variational noise) and the
training forward, with dropout on the embedding, between the standard
core's layers and on the core's output, as ``RecurrentLM.__call__``,
``StandardRNNCore``, ``BayesLSTMCore``, ``GPLSTMCore`` and the variational
cores apply it in the JAX package. The standard core takes the LSTM at
any depth, the GRU and the vanilla RNN (tanh, relu); the decoder is tied
or the model's own ``decoder_w``. The uncertainty cores are 2-layer LSTMs
and raise for other depths and models, where the JAX package quietly
builds two LSTM layers.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops import (bayes_sample_cuda, gaussian, gp_lstm_cuda, lstm_cuda,
                   lstm_train_cuda)
from ..ops.lstm import (LSTMParams, gru_layer, lstm_layer,
                       lstm_stack2, rnn_layer)
from ..utils.rng import dropout_stream, sample_stream
from . import initializers as tinit
from .layers import ACTS, GPNN, GPNN2, VNN, _next_eps

Hidden = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (nlayers, B, H)


def init_hidden(nlayers: int, batch: int, nhid: int,
                dtype=torch.float32, device=None) -> Hidden:
    z = torch.zeros((nlayers, batch, nhid), dtype=dtype, device=device)
    return (z, z.clone())


class DropoutMasks(NamedTuple):
    """Keep masks (nonzero = kept) of one training forward: on the
    embedding (T, B, emsize), between the layers (None for the cores that
    have no inter-layer dropout; for the standard core one (T, B, nhid)
    mask at two layers, a sequence of nlayers - 1 of them at other depths)
    and on the core's output (T, B, nhid). Drawn by ``draw_dropout_masks``
    or injected, so that a test can feed both packages the same masks."""

    emb: torch.Tensor
    layer: Optional[torch.Tensor]
    out: torch.Tensor


def draw_dropout_masks(cfg: ModelConfig, T: int, B: int,
                       gen: torch.Generator, device=None) -> DropoutMasks:
    """Bernoulli(1 - cfg.dropout) keep masks from ``gen`` (on ``device``);
    no inter-layer mask for the cores that have no inter-layer dropout
    (all but the standard core, alone or as the GP-LSTM's gate-0 core)."""
    keep = 1.0 - cfg.dropout
    draw = lambda width: torch.rand(  # noqa: E731
        (T, B, width), generator=dropout_stream(gen), device=device) < keep
    layered = cfg.uncertainty == "none" or (
        cfg.uncertainty == "Gaussian" and cfg.l_gauss_legacy_pos < 0
        and cfg.l_gauss_pos[:1] == "0")
    layer = None
    if layered:
        layer = draw(cfg.nhid) if cfg.nlayers == 2 else tuple(
            draw(cfg.nhid) for _ in range(cfg.nlayers - 1))
    return DropoutMasks(draw(cfg.emsize), layer, draw(cfg.nhid))


def _dropout(x, mask, keep):
    """Inverted dropout as flax's ``nn.Dropout``: x / keep where kept."""
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class StandardRNNCore(nn.Module):
    """Multi-layer LSTM, GRU or vanilla RNN (tanh or relu) with torch
    nn.LSTM's dropout between layers (on every layer's output but the
    last), the JAX package's ``StandardRNNCore``. Parameter names follow the
    JAX tree: ``l{k}_w_ih`` (G H, in), ``l{k}_w_hh`` (G H, H), ``l{k}_b_ih``,
    ``l{k}_b_hh`` (G H,), G = 4 (LSTM), 3 (GRU, rows r, z, n) or 1 (RNN).

    The 2-layer LSTM takes ``lstm_stack2`` (the scoring route of kernel row
    1; in training two calls of rows 5-6, or rows 7-8 under the fused
    switch). Every other depth runs layer by layer: an LSTM layer through
    ``ops.lstm.lstm_layer`` (rows 3-4 when deterministic, rows 5-6 in
    training, on a CUDA tensor its gate admits), a GRU or RNN layer through
    ``gru_layer`` / ``rnn_layer``, which reach no kernel in the JAX package
    either. The GRU and RNN carry no cell state: their ``c`` is zeros, as
    the JAX core stacks it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        gates = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[cfg.model]
        if cfg.nlayers < 1:
            raise ValueError(f"nlayers {cfg.nlayers}: at least one layer")
        for k in range(cfg.nlayers):
            in_size = cfg.emsize if k == 0 else cfg.nhid
            for name, shape in (("w_ih", (gates * cfg.nhid, in_size)),
                                ("w_hh", (gates * cfg.nhid, cfg.nhid)),
                                ("b_ih", (gates * cfg.nhid,)),
                                ("b_hh", (gates * cfg.nhid,))):
                self.register_parameter(
                    f"l{k}_{name}", nn.Parameter(torch.empty(shape)))
        self.nhid, self.kind, self.nlayers = cfg.nhid, cfg.model, cfg.nlayers

    def layer(self, k: int) -> LSTMParams:
        return LSTMParams(*(getattr(self, f"l{k}_{n}")
                            for n in ("w_ih", "w_hh", "b_ih", "b_hh")))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            tinit.uniform_(p, tinit.rnn_bound(self.nhid), gen)

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None):
        """``train`` takes the grad routes. ``dropout_mask``: the
        nlayers - 1 inter-layer (T, B, H) masks, scaled by 1 / keep
        (``RecurrentLM`` scales them), or None."""
        h0, c0 = hidden
        masks = dropout_mask
        if masks is not None and len(masks) != self.nlayers - 1:
            raise ValueError(f"StandardRNNCore: {len(masks)} inter-layer "
                             f"dropout masks for {self.nlayers} layers")
        if self.kind == "LSTM" and self.nlayers == 2:
            out, hs, cs = lstm_stack2(x, h0, c0, self.layer(0),
                                      self.layer(1), step_mask, reset_mask,
                                      reset_src, train=train,
                                      dropout_mask=None if masks is None
                                      else masks[0])
            return out, (torch.stack(hs), torch.stack(cs))
        rkw = dict(step_mask=step_mask, reset_mask=reset_mask,
                   reset_src=reset_src)
        out, hs, cs = x, [], []
        for k in range(self.nlayers):
            p = self.layer(k)
            if self.kind == "LSTM":
                out, hT, cT = lstm_layer(out, h0[k], c0[k], p,
                                         allow_kernel=not train, **rkw)
            elif self.kind == "GRU":
                out, hT = gru_layer(out, h0[k], p, **rkw)
                cT = torch.zeros_like(hT)
            else:
                out, hT = rnn_layer(out, h0[k], p, "tanh"
                                    if self.kind == "RNN_TANH" else "relu",
                                    **rkw)
                cT = torch.zeros_like(hT)
            hs.append(hT)
            cs.append(cT)
            if masks is not None and k < self.nlayers - 1:
                out = out * masks[k].to(out.dtype)
        return out, (torch.stack(hs), torch.stack(cs))


_GATE_PARAMS = ("w_hh", "w_ih", "b_hh", "b_ih")  # the JAX sampling order
_TORCH_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
                "b_hh": "bias_hh"}


def _draw_diffs(lgstds, generator, noise) -> list:
    """exp(lgstd) * eps for every tensor of ``lgstds``, in order. ``noise``
    injects every eps instead, one per tensor. Otherwise the 2-D slices
    that ``bayes_sample_cuda.sample_noise_ok`` admits are drawn together by
    ``sample_noises``, one kernel launch under seeds drawn by one
    ``torch.randint`` from ``generator``; the rest (the biases, the slices
    the gate refuses, every CPU tensor) by ``gaussian.sample_diff``."""
    if noise is not None:
        noise = list(noise)
        if len(noise) < len(lgstds) or any(e is None for e in noise):
            raise ValueError("BayesLSTMCore: fewer injected noise tensors "
                             "than sampled tensors")
        if len(noise) > len(lgstds):
            raise ValueError("BayesLSTMCore: more injected noise tensors "
                             "than sampled tensors")
        return [gaussian.sample_diff(lg, eps=e, generator=generator)
                for lg, e in zip(lgstds, noise)]
    diffs = [None] * len(lgstds)
    admitted = [i for i, lg in enumerate(lgstds)
                if bayes_sample_cuda.sample_noise_ok(lg)]
    if admitted:
        seeds = torch.randint(0, 2 ** 31 - 1, (len(admitted),),
                              generator=sample_stream(generator),
                              device=lgstds[admitted[0]].device,
                              dtype=torch.int32)
        drawn = bayes_sample_cuda.sample_noises(
            [lgstds[i] for i in admitted], seeds)
        for i, d in zip(admitted, drawn):
            diffs[i] = d
    return [gaussian.sample_diff(lg, generator=generator) if d is None else d
            for lg, d in zip(lgstds, diffs)]


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
    through the sampler kernel together, one launch a forward (their seeds
    drawn on the device from ``generator`` by one ``torch.randint``); the
    biases and other slices through ``gaussian.sample_diff``
    (``_draw_diffs``). ``noise`` injects every eps instead, one per sampled
    tensor in the JAX call order: layer 1 then 2, and w_hh, w_ih, b_hh,
    b_ih within a layer.
    """

    def __init__(self, cfg: ModelConfig, both_layers: bool = True):
        super().__init__()
        _two_layers(cfg, "the Bayesian core")
        H, pos = cfg.nhid, cfg.l_bayes_pos
        self.nhid, self.pos, self.both_layers = H, pos, both_layers
        self.lgstd_layers: Tuple[int, ...] = ()
        _mean_params(self, H, cfg.emsize, cfg.nhid)
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
        # the sampled tensors in order: (layer index, name, lgstd); layer 1
        # then 2, and w_hh, w_ih, b_hh, b_ih within a layer
        if 1 <= pos <= 4:
            slots = [(li, n, self.lgstds(li + 1)[n])
                     for li in ((0, 1) if self.both_layers else (0,))
                     for n in _GATE_PARAMS]
        elif pos == 5 and not self.both_layers:
            # BayesLSTM position 5: the whole of layer 2, with the layer-1
            # lgstds
            slots = [(1, n, self.lgstds(1)[n]) for n in _GATE_PARAMS]
        else:
            slots = []
        diffs = _draw_diffs([lg for _, _, lg in slots], generator, noise)
        r0, r1 = (pos - 1) * H, pos * H
        for (li, n, _), d in zip(slots, diffs):
            w = eff[li][n]
            # out of place, so the gradient reaches the mean rows and,
            # through the sample, the lgstd
            eff[li][n] = (torch.cat([w[:r0], w[r0:r1] + d, w[r1:]])
                          if pos <= 4 else w + d)
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


# the standard activations of the gates [i, f, g, o]
_GATE_ACTS = (torch.sigmoid, torch.sigmoid, torch.tanh, torch.sigmoid)


class GPLSTMCell(nn.Module):
    """One GP-activation LSTM layer, the JAX package's ``GPLSTMCell`` (the
    reference's ``GPLSTMCell``, model.py:1683-1777).

    ``gpnn_type`` 0-3 builds a ``GPNN`` (``gpnn``, drawn once a call, see
    ``GPNN.draw``): gates 1-4 replace that gate of [i, f, g, o] by the unit
    over cat(x_t, h_{t-1}), act set (sigmoid,) for gate 2 and (sigmoid,
    tanh, relu) otherwise; gate 5 transforms the cell state, c <- gpnn(c),
    before the update; gate 6 replaces the hidden projection, gates = xg_t +
    gpnn(h_{t-1}) with no second bias (so it needs input_size =
    hidden_size); gate 7 the input projection, xg = gpnn(x) over the whole
    sequence. Type 4 builds a ``GPNN2`` (act set (sigmoid, relu, tanh))
    applied to the replaced gate's pre-activation (gates 1-4) or to c
    (gate 5), its frequencies drawn afresh every step while training
    (``noise`` hands it T eps, one a step); for gates 6-7 it is built and
    unused, as in JAX. Other digits build no GP unit and run the standard
    cell. Parameters ``weights_ih``, ``bias_ih``, ``weights_hh``,
    ``bias_hh`` and ``gpnn.*``; the reference adds ``bias_ih`` to both
    projections and never uses ``bias_hh`` (model.py:1749-1753), and so
    does this cell.

    Routes as JAX, on a CUDA tensor without resets: gates 1-4 (types 0-3)
    to ``gp_lstm_cuda.gpg_layer_fused`` (kernel rows 20-21) where
    ``gpg_kernel_ok`` admits, gate 6 to ``gp6_layer_fused`` (rows 18-19)
    where ``gp6_kernel_ok`` admits, gate 7 to
    ``lstm_train_cuda.lstm_scan_fused`` (rows 5-6, deterministic too) where
    ``lstm_kernel_ok`` admits the training route; all with a float32
    carry. Otherwise (packed resets, a refused shape, a CPU tensor, gate 5,
    type 4) the JAX package's scan runs step by step, its carry in the
    promoted dtype of h0 and x, with ``lstm_cuda.apply_reset`` at the
    resets.
    """

    def __init__(self, input_size: int, hidden_size: int, gate_type: int,
                 gpnn_type: int, sample_enabled: bool = False):
        super().__init__()
        H, g, t = hidden_size, gate_type, gpnn_type
        self.input_size, self.hidden_size = input_size, H
        self.gate_type, self.gpnn_type = g, t
        self.weights_ih = nn.Parameter(torch.empty((4 * H, input_size)))
        self.bias_ih = nn.Parameter(torch.empty((4 * H,)))
        self.weights_hh = nn.Parameter(torch.empty((4 * H, H)))
        self.bias_hh = nn.Parameter(torch.empty((4 * H,)))
        if t <= 3 and 1 <= g <= 7:
            if g == 6 and input_size != H:
                raise ValueError(
                    f"GP gate 6 applies its (in {input_size} -> {4 * H}) unit "
                    f"to h (width {H}): it needs input_size == hidden_size "
                    "(a layer-0 gate-6 cell needs emsize == nhid)")
            n_in, n_out = {5: (H, H), 6: (input_size, 4 * H),
                           7: (input_size, 4 * H)}.get(g, (H + input_size, H))
            acts = ("sigmoid",) if g == 2 else ("sigmoid", "tanh", "relu")
            self.gpnn = GPNN(n_in, n_out, acts, t, sample_enabled)
        elif t == 4:
            self.gpnn = GPNN2(H, H if g <= 5 else 4 * H,
                              act_set=("sigmoid", "relu", "tanh"))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = tinit.rnn_bound(self.hidden_size)
        tinit.uniform_(self.weights_ih, bound, gen)
        tinit.uniform_(self.weights_hh, bound, gen)
        with torch.no_grad():
            self.bias_ih.zero_()
            self.bias_hh.zero_()
        if hasattr(self, "gpnn"):
            self.gpnn.reset_parameters(gen)

    def forward(self, x, hc: Hidden, deterministic: bool = True,
                step_mask=None, reset_mask=None, reset_src=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Iterator[torch.Tensor]] = None):
        """x (T, B, in) -> ys (T, B, H), (hT, cT). ``noise`` hands the GP
        unit its eps when it samples (see ``GPNN.draw``; type 4: one
        (H, n_mc) eps a step)."""
        H, g, t = self.hidden_size, self.gate_type, self.gpnn_type
        dtype = x.dtype
        T, B, _ = x.shape
        h0, c0 = hc
        gp = getattr(self, "gpnn", None)
        drawn = gpx = None
        if g == 7 and t <= 3:
            # the GP unit over x, hoisted: the recurrence is the standard
            # LSTM step with b_ih as its bias (the quirk)
            xg = GPNN.apply_drawn(x, *gp.draw(deterministic, generator,
                                              noise), gp.act_set)
            if reset_mask is None and lstm_cuda.lstm_kernel_ok(x, H,
                                                               train=True):
                ys, _cs, hT, cT = lstm_train_cuda.lstm_scan_fused(
                    xg, self.weights_hh.to(dtype), self.bias_ih.to(dtype),
                    h0.to(dtype).contiguous(), c0.to(dtype).contiguous(),
                    step_mask)
                return ys, (hT, cT)
        else:
            # the x-only projections over the whole sequence
            xg = (x.reshape(T * B, -1) @ self.weights_ih.to(dtype).t()
                  + self.bias_ih.to(dtype)).reshape(T, B, 4 * H)
        if t <= 3 and 1 <= g <= 6:
            drawn = gp.draw(deterministic, generator, noise)
            w, b, coef = drawn
            if g == 6 and reset_mask is None and \
                    gp_lstm_cuda.gp6_kernel_ok(x, H):
                return gp_lstm_cuda.gp6_layer_fused(xg, w, b, coef, h0, c0,
                                                    step_mask)
            if g <= 4:
                n_in = self.input_size
                gpx = x @ w[:, :n_in].t().to(dtype) + b.to(dtype)
                drawn = (w[:, n_in:], coef)
                if reset_mask is None and gp_lstm_cuda.gpg_kernel_ok(x, H):
                    return gp_lstm_cuda.gpg_layer_fused(
                        xg, gpx, self.weights_hh, self.bias_ih, drawn[0],
                        coef, h0, c0, g, gp.act_set, step_mask)
        if t == 4 and 1 <= g <= 5:
            # GPNN2 redraws its frequencies every step while training; step
            # s takes drawn[s % len(drawn)], the mean when deterministic
            drawn = [gp.draw(deterministic, generator, noise)
                     for _ in range(1 if deterministic else T)]
        return self._scan(xg, gpx, drawn, h0, c0, step_mask, reset_mask,
                          reset_src)

    def _scan(self, xg, gpx, drawn, h0, c0, step_mask, reset_mask,
              reset_src):
        """The JAX package's scan: operands in the carry's promoted dtype,
        as JAX promotes."""
        g, t = self.gate_type, self.gpnn_type
        dtype = xg.dtype
        gp = getattr(self, "gpnn", None)
        pd = torch.promote_types(h0.dtype, dtype)
        w_hh_t = self.weights_hh.to(dtype).t().to(pd)
        b_ih = self.bias_ih.to(dtype).to(pd)
        mixes = t <= 3 and 1 <= g <= 4
        if mixes:
            w_h_t = drawn[0].to(dtype).t().to(pd)
            coefs = [drawn[1][a].to(dtype).to(pd)
                     for a in range(len(gp.act_set))]
        h, c = h0, c0
        ys = []
        for s in range(xg.shape[0]):
            if reset_mask is not None:
                h = lstm_cuda.apply_reset(h, reset_mask[s], reset_src)
                c = lstm_cuda.apply_reset(c, reset_mask[s], reset_src)
            if g == 6 and t <= 3:
                gates = xg[s] + GPNN.apply_drawn(h, *drawn, gp.act_set)
            else:
                gates = xg[s] + h @ w_hh_t + b_ih
            pre4 = gates.chunk(4, dim=-1)
            rep = None
            if mixes:
                pre = gpx[s] + h @ w_h_t
                for a, name in enumerate(gp.act_set):
                    term = ACTS[name](pre) * coefs[a]
                    rep = term if rep is None else rep + term
            elif t == 4 and 1 <= g <= 4:
                rep = gp.apply_drawn(pre4[g - 1], drawn[s % len(drawn)])
            i, f, gg, o = [rep if q + 1 == g and rep is not None else act(v)
                           for q, (act, v) in enumerate(zip(_GATE_ACTS,
                                                            pre4))]
            c_in = c
            if g == 5 and t <= 3:
                c_in = GPNN.apply_drawn(c, *drawn, gp.act_set)
            elif g == 5 and t == 4:
                c_in = gp.apply_drawn(c, drawn[s % len(drawn)])
            cn = f * c_in + i * gg
            hn = o * torch.tanh(cn)
            if step_mask is not None:
                keep = step_mask[s].bool()[:, None]
                hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
            h, c = hn, cn
            ys.append(h)
        return torch.stack(ys), (h, c)

    def kl(self) -> torch.Tensor:
        """The GPNN's KL (types 0-3); zero for GPNN2 and for a cell with no
        GP unit, as in JAX."""
        if self.gpnn_type <= 3 and hasattr(self, "gpnn"):
            return self.gpnn.kl()
        return torch.zeros((), device=self.weights_hh.device)


class StdLSTMLayer(nn.Module):
    """One standard LSTM layer with its own parameters ``l_w_ih``,
    ``l_w_hh``, ``l_b_ih``, ``l_b_hh`` (the JAX package's
    ``_StdLSTMLayer``): ``ops.lstm.lstm_layer`` with the forward-only
    kernel route allowed when deterministic (rows 3-4), the grad route
    (rows 5-6) otherwise."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        G = 4 * hidden_size
        self.hidden_size = hidden_size
        for name, shape in (("w_ih", (G, input_size)),
                            ("w_hh", (G, hidden_size)), ("b_ih", (G,)),
                            ("b_hh", (G,))):
            self.register_parameter(f"l_{name}",
                                    nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            tinit.uniform_(p, tinit.rnn_bound(self.hidden_size), gen)

    def forward(self, x, h0, c0, step_mask=None, deterministic: bool = True,
                reset_mask=None, reset_src=None):
        p = LSTMParams(self.l_w_ih, self.l_w_hh, self.l_b_ih, self.l_b_hh)
        return lstm_layer(x, h0, c0, p, step_mask, reset_mask, reset_src,
                          allow_kernel=deterministic)


class GPLSTMCore(nn.Module):
    """The GP-LSTM stack of the ``l_gauss_pos`` digit string (the JAX
    package's ``GPLSTMCore``; the reference's ``GPLSTM``, model.py:1609-1681):
    digit 0 the gate (0: the standard core, ``std_core``), digit 1 the GPNN
    type (0-3 GPNN, 4 GPNN2); length 2: a GP cell (``cell0``) then a
    standard layer (``std1``); length 3: a standard layer (``std0``) then a
    GP cell (``cell1``); length 4: GP cells in both layers, the second's
    gate digit 2 (digit 3 unread), e.g. ``6360``. No inter-layer dropout.
    ``kl_value`` is the KL that the JAX core sows: the cells' GPNN KLs when
    the gate digit is > 0 and the type 1-3."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        s = cfg.l_gauss_pos
        if not (2 <= len(s) <= 4 and s.isdigit()):
            raise ValueError(f"l_gauss_pos {s!r}: a string of 2 to 4 digits")
        H, E, sample = cfg.nhid, cfg.emsize, cfg.gp_sample
        gate, gtype = int(s[0]), int(s[1])
        self.kind = "std" if gate == 0 else f"len{len(s)}"
        self.sows_kl = gate > 0 and 0 < gtype <= 3
        if self.kind == "std":
            self.std_core = StandardRNNCore(cfg)
            return
        _two_layers(cfg, "the GP-LSTM with GP cells")
        if self.kind == "len2":
            self.cell0 = GPLSTMCell(E, H, gate, gtype, sample)
            self.std1 = StdLSTMLayer(H, H)
        elif self.kind == "len3":
            self.std0 = StdLSTMLayer(E, H)
            self.cell1 = GPLSTMCell(H, H, gate, gtype, sample)
        else:
            self.cell0 = GPLSTMCell(E, H, gate, gtype, sample)
            self.cell1 = GPLSTMCell(H, H, int(s[2]), gtype, sample)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.reset_parameters(gen)

    def _cells(self):
        return [m for m in self.children() if isinstance(m, GPLSTMCell)]

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """``train`` runs the training forward: the GPNN units sample when
        ``cfg.gp_sample``, the GPNN2 units of gates 1-5 every step whatever
        it says (eps from ``noise``, in the JAX call order: a cell at a
        time, one a step for GPNN2; or drawn from ``generator``), the
        standard layer takes its grad route.
        ``dropout_mask`` is the standard core's inter-layer mask (the GP
        kinds have none)."""
        if self.kind == "std":
            return self.std_core(x, hidden, step_mask, reset_mask, reset_src,
                                 train=train, dropout_mask=dropout_mask)
        if dropout_mask is not None:
            raise ValueError("the GP-LSTM core has no inter-layer dropout")
        det = not train
        draws = None if noise is None else iter(noise)
        h0, c0 = hidden
        rkw = dict(reset_mask=reset_mask, reset_src=reset_src)
        ckw = dict(generator=generator, noise=draws)
        if self.kind == "len2":
            out0, (h_a, c_a) = self.cell0(x, (h0[0], c0[0]), det, step_mask,
                                          **rkw, **ckw)
            out1, h_b, c_b = self.std1(out0, h0[1], c0[1], step_mask, det,
                                       **rkw)
        elif self.kind == "len3":
            out0, h_a, c_a = self.std0(x, h0[0], c0[0], step_mask, det, **rkw)
            out1, (h_b, c_b) = self.cell1(out0, (h0[1], c0[1]), det,
                                          step_mask, **rkw, **ckw)
        else:
            out0, (h_a, c_a) = self.cell0(x, (h0[0], c0[0]), det, step_mask,
                                          **rkw, **ckw)
            out1, (h_b, c_b) = self.cell1(out0, (h0[1], c0[1]), det,
                                          step_mask, **rkw, **ckw)
        if draws is not None and next(draws, None) is not None:
            raise ValueError("GPLSTMCore: more injected noise tensors than "
                             "sampled tensors")
        dt = torch.promote_types(h_a.dtype, h_b.dtype)
        return out1, (torch.stack([h_a.to(dt), h_b.to(dt)]),
                      torch.stack([c_a.to(dt), c_b.to(dt)]))

    def kl_value(self, prior_w=None) -> torch.Tensor:
        """The sum of the cells' GPNN KLs (mean-reduced, with the -1 term)
        where the JAX core sows them, else zero. The GP units have no
        prior branch: ``prior_w`` is not read."""
        kl = torch.zeros((), device=next(self.parameters()).device)
        if self.sows_kl:
            for cell in self._cells():
                kl = kl + cell.kl()
        return kl


def _two_layers(cfg: ModelConfig, what: str) -> None:
    """The uncertainty cores are 2-layer LSTMs. At another depth or model
    the JAX package builds and runs two LSTM layers all the same (at depth
    1 it reads the second layer's state from the first's, clamping the
    index); the port refuses instead (ROADMAP.md C, deliberate
    differences)."""
    if cfg.model != "LSTM" or cfg.nlayers != 2:
        raise NotImplementedError(
            f"{what} with {cfg.model} x {cfg.nlayers}: the reference's is a "
            "2-layer LSTM, and the JAX package quietly builds two LSTM "
            "layers for any other depth or model; the port refuses it "
            "(ROADMAP.md C, deliberate differences: only the standard core "
            "takes other depths and the GRU/RNN)")


def _mean_params(module: nn.Module, H: int, E: int, in2: int) -> None:
    """``weight_{ih,hh}_mean_{1,2}``, ``bias_{ih,hh}_mean_{1,2}`` of the
    Bayesian and legacy cores (layer 2's input width ``in2``)."""
    for l, in_size in ((1, E), (2, in2)):
        for n, shape in (("w_ih", (4 * H, in_size)), ("w_hh", (4 * H, H)),
                         ("b_ih", (4 * H,)), ("b_hh", (4 * H,))):
            module.register_parameter(f"{_TORCH_NAMES[n]}_mean_{l}",
                                      nn.Parameter(torch.empty(shape)))


def _mean_layer(module: nn.Module, layer: int) -> LSTMParams:
    return LSTMParams(*(getattr(module, f"{_TORCH_NAMES[n]}_mean_{layer}")
                        for n in ("w_ih", "w_hh", "b_ih", "b_hh")))


def _lstm_scan(xg, w_hh_t, bias, h0, c0, step_mask, reset_mask, reset_src,
               gates_of=None, cell_of=None, noise=None):
    """The JAX package's hand-rolled LSTM scans (the legacy and variational
    cores): operands in the promoted dtype of the carry and ``xg``, as JAX
    promotes. gates = (xg_t + h W_hh^T) + bias, or ``gates_of(t, h)``;
    ``cell_of(t, pre4, c)`` -> (i, f, g, o, c_in) with the activations
    applied, by default the standard cell; ``noise`` (T, 1, H) is added to
    each step's output before the step mask. Returns (ys, ys before the
    noise, hT, cT)."""
    pd = torch.promote_types(h0.dtype, xg.dtype)
    w = None if w_hh_t is None else w_hh_t.to(pd)
    b = None if bias is None else bias.to(pd)
    h, c = h0, c0
    ys, pre = [], []
    for s in range(xg.shape[0]):
        if reset_mask is not None:
            h = lstm_cuda.apply_reset(h, reset_mask[s], reset_src)
            c = lstm_cuda.apply_reset(c, reset_mask[s], reset_src)
        gates = xg[s].to(pd) + h @ w + b if gates_of is None \
            else gates_of(s, h)
        pre4 = gates.chunk(4, dim=-1)
        if cell_of is None:
            i, f, g, o = (act(v) for act, v in zip(_GATE_ACTS, pre4))
            c_in = c
        else:
            i, f, g, o, c_in = cell_of(s, pre4, c)
        cn = f * c_in + i * g
        hp = o * torch.tanh(cn)
        hn = hp if noise is None else hp + noise[s].to(hp.dtype)
        if step_mask is not None:
            keep = step_mask[s].bool()[:, None]
            hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
        h, c = hn, cn
        ys.append(h)
        pre.append(hp)
    return torch.stack(ys), torch.stack(pre), h, c


class _KLRecorder(nn.Module):
    """A core whose KL reads the forward's activations: ``kl_value``
    returns the KL of its last forward (``_kl``, zero before the first), as
    the JAX core sows it during that forward. The prior branch does not
    exist for these cores: ``prior_w`` is not read."""

    _kl: Optional[torch.Tensor] = None

    def kl_value(self, prior_w=None) -> torch.Tensor:
        if self._kl is None:
            return torch.zeros((), device=next(self.parameters()).device)
        return self._kl


class GaussLSTMLegacyCore(nn.Module):
    """The reference's orphaned ``GaussLSTM`` (model.py:1369-1606), the JAX
    package's ``GaussLSTMLegacyCore``, positions 0-8: a hand-rolled 2-layer
    LSTM at the posterior means (``weight_{ih,hh}_mean_{1,2}``,
    ``bias_{ih,hh}_mean_{1,2}``) with a deterministic type-0 ``gpnn`` in
    layer 1 only: 1, 2, 4 replace the i, f, o gate's pre-activation by
    gpnn(x_t) (act set sigmoid, tanh, relu), 3 and 8 the cell gate's
    activation; 5 transforms the previous cell state, c <- gpnn(c); 6 takes
    gates = x W_ih^T + b_ih + gpnn(h) (b_hh dropped), 7 gates = gpnn(x) +
    h W_hh^T + b_hh (b_ih dropped), a (H -> 4H) unit. The x-only work is
    hoisted; layer 1 runs the JAX package's scan, layer 2 ``ops.lstm
    .lstm_layer`` (rows 3-4 when deterministic, rows 5-6 in training on a
    CUDA tensor that ``lstm_kernel_ok`` admits: in training the float32
    carry promotes layer 1's output, as in JAX, and at H = 1,024 the gate
    refuses float32, so the scan runs). emsize must equal nhid (the unit
    reads the layer input with its H-wide weights). No sampling and no KL,
    as the reference class."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _two_layers(cfg, "the legacy GaussLSTM")
        H, E, pos = cfg.nhid, cfg.emsize, cfg.l_gauss_legacy_pos
        if not 0 <= pos <= 8:
            raise ValueError(f"l_gauss_legacy_pos {pos}: 0-8 (or -1, off)")
        if E != H:
            raise ValueError(f"the legacy GaussLSTM needs emsize == nhid "
                             f"(its GP unit reads the {E}-wide input with "
                             f"{H}-wide weights)")
        self.nhid, self.pos = H, pos
        _mean_params(self, H, E, H)
        if 1 <= pos <= 5 or pos == 8:
            self.gpnn = GPNN(H, H, ("sigmoid", "tanh", "relu"))
        elif pos in (6, 7):
            self.gpnn = GPNN(H, 4 * H)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if "_mean_" in name:
                tinit.uniform_(p, tinit.rnn_bound(self.nhid), gen)
        if hasattr(self, "gpnn"):
            self.gpnn.reset_parameters(gen)

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """``train`` takes layer 2's grad route; nothing samples, so
        ``generator`` and ``noise`` (which must be empty) are not read."""
        if dropout_mask is not None:
            raise ValueError("the legacy GaussLSTM has no inter-layer dropout")
        if noise:
            raise ValueError("the legacy GaussLSTM draws no noise")
        pos, dtype = self.pos, x.dtype
        h0, c0 = hidden
        p1 = _mean_layer(self, 1)
        w_hh1_t = p1.w_hh.to(dtype).t()
        b_ih1, b_hh1 = p1.b_ih.to(dtype), p1.b_hh.to(dtype)
        gp = getattr(self, "gpnn", None)
        drawn = None if gp is None else gp.draw()
        if pos == 7:
            xg = GPNN.apply_drawn(x, *drawn, gp.act_set)
        else:
            xg = x @ p1.w_ih.to(dtype).t() + b_ih1
        gpx = None
        if 1 <= pos <= 4 or pos == 8:
            gpx = GPNN.apply_drawn(x, *drawn, gp.act_set)

        def gates6(s, h):
            return xg[s].to(h.dtype) + GPNN.apply_drawn(h, *drawn,
                                                        gp.act_set)

        def cell(s, pre4, c):
            i, f, g, o = pre4
            rep = gpx[s] if gpx is not None else None
            i = rep if pos == 1 else i
            f = rep if pos == 2 else f
            o = rep if pos == 4 else o
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = rep if pos in (3, 8) else torch.tanh(g)
            c_in = GPNN.apply_drawn(c, *drawn, gp.act_set) if pos == 5 else c
            return i, f, g, o, c_in

        ys1, _, h1T, c1T = _lstm_scan(
            xg, None if pos == 6 else w_hh1_t,
            None if pos == 6 else b_hh1, h0[0], c0[0], step_mask, reset_mask,
            reset_src, gates_of=gates6 if pos == 6 else None, cell_of=cell)
        ys2, h2T, c2T = lstm_layer(ys1, h0[1], c0[1], _mean_layer(self, 2),
                                   step_mask, reset_mask, reset_src,
                                   allow_kernel=not train)
        dt = torch.promote_types(h1T.dtype, h2T.dtype)
        return ys2, (torch.stack([h1T.to(dt), h2T.to(dt)]),
                     torch.stack([c1T.to(dt), c2T.to(dt)]))


class VLSTMLegacyCore(_KLRecorder):
    """The reference's orphaned ``VLSTM`` (model.py:2582-2733), the JAX
    package's ``VLSTMLegacyCore``: a 2-layer LSTM at the posterior means
    (``ops.lstm.lstm_stack2``) whose whole output sequence takes additive
    noise eps exp(``hiddens_lgstd``) while training, with trainable
    (32, H) posterior and prior tables (32, the recipes' batch, which the
    reference's broadcast requires: training at another batch raises).
    Quirks kept: layer 2's w_ih is (4H, emsize); the KL (sown when either
    ``l_v_pos`` digit is 1) reads the pre-noise output and is taken only at
    batch 32 (zero otherwise). One eps (32, H) a training forward, from
    ``generator`` or the injected ``noise``. With emsize = nhid, the
    training forward takes the fused 2-layer route under its switch (kernel
    rows 7-8, ``ops/lstm.py``)."""

    NOISE_ROWS = 32

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _two_layers(cfg, "the legacy VLSTM")
        H, E = cfg.nhid, cfg.emsize
        self.nhid = H
        _mean_params(self, H, E, E)
        self.active = "1" in cfg.l_v_pos[:2]
        if self.active:
            for n in ("hiddens_lgstd", "hiddens_mean", "hiddens_lgstd_p",
                      "hiddens_mean_p"):
                self.register_parameter(n, nn.Parameter(
                    torch.empty((self.NOISE_ROWS, H))))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if "lgstd" in name:
                tinit.lgstd_(p, self.nhid, gen)
            else:
                tinit.uniform_(p, tinit.rnn_bound(self.nhid), gen)

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        if dropout_mask is not None:
            raise ValueError("the legacy VLSTM has no inter-layer dropout")
        draws = None if noise is None else iter(noise)
        h0, c0 = hidden
        out, hs, cs = lstm_stack2(x, h0, c0, _mean_layer(self, 1),
                                  _mean_layer(self, 2), step_mask, reset_mask,
                                  reset_src, train=train)
        kl = torch.zeros((), device=x.device)
        if self.active:
            pre = out
            if train:
                if out.shape[1] != self.NOISE_ROWS:
                    raise ValueError(
                        f"legacy VLSTM noise table is ({self.NOISE_ROWS}, H); "
                        f"the reference's output += noise broadcast requires "
                        f"batch == {self.NOISE_ROWS}, got {out.shape[1]}")
                lg = self.hiddens_lgstd
                eps = _next_eps(draws, "VLSTMLegacyCore")
                diff = gaussian.sample_diff(lg, eps=eps, generator=generator)
                out = out + diff.to(out.dtype)[None]
            if pre.shape[1] == self.NOISE_ROWS:
                kl = self.kl(pre)
        if draws is not None and next(draws, None) is not None:
            raise ValueError("VLSTMLegacyCore: more injected noise tensors "
                             "than sampled tensors")
        self._kl = kl
        return out, (torch.stack(hs), torch.stack(cs))

    def kl(self, hidden: torch.Tensor) -> torch.Tensor:
        """model.py:2664-2672 with the hidden sequence passed in (the
        reference's ``self.hidden`` is never assigned)."""
        prior_mean = hidden * self.hiddens_mean_p
        return torch.mean((hidden - prior_mean) ** 2.0
                          - self.hiddens_lgstd * 2.0
                          + torch.exp(self.hiddens_lgstd * 2.0)) / 2.0


class VLSTMCore(_KLRecorder):
    """The variational LSTM (the reference's ``VariationalLSTM``,
    ``VLSTMCell``, ``VNN``, model.py:2426-2579), the JAX package's
    ``VLSTMCore``: two hand-rolled layers on the JAX scan, parameters
    ``l{k}_weights_ih``, ``l{k}_bias_ih``, ``l{k}_weights_hh``,
    ``l{k}_bias_hh`` (kept, unused: the reference adds ``bias_ih`` twice,
    model.py:2519) and ``l{k}_vnn.hidden_lgstd``. When layer k's ``l_v_pos``
    digit is 1 and the model trains, its hidden state takes the VNN's noise
    at every step, and the noised hidden feeds the recurrence; its KL
    (summed over such layers) reads the last step's pre-noise hidden, in
    training and evaluation alike, as JAX sows it. ``noise`` injects one
    (T, 1, H) standard-normal eps a noised layer, layer 1 first. No kernel:
    a Python loop over T, as the GP cells' scan."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _two_layers(cfg, "the variational LSTM")
        s = cfg.l_v_pos
        if len(s) < 2 or not s[:2].isdigit():
            raise ValueError(f"l_v_pos {s!r}: a string of two digits")
        H = self.nhid = cfg.nhid
        self.vtypes = (int(s[0]), int(s[1]))
        for k, in_size in ((0, cfg.emsize), (1, H)):
            for n, shape in (("weights_ih", (4 * H, in_size)),
                             ("bias_ih", (4 * H,)),
                             ("weights_hh", (4 * H, H)),
                             ("bias_hh", (4 * H,))):
                self.register_parameter(f"l{k}_{n}",
                                        nn.Parameter(torch.empty(shape)))
            self.add_module(f"l{k}_vnn", VNN(H))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for k in (0, 1):
            for n in ("weights_ih", "weights_hh"):
                tinit.uniform_(getattr(self, f"l{k}_{n}"),
                               tinit.rnn_bound(self.nhid), gen)
            with torch.no_grad():
                getattr(self, f"l{k}_bias_ih").zero_()
                getattr(self, f"l{k}_bias_hh").zero_()
            getattr(self, f"l{k}_vnn").reset_parameters(gen)

    def forward(self, x, hidden: Hidden, step_mask=None, reset_mask=None,
                reset_src=None, train: bool = False, dropout_mask=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        if dropout_mask is not None:
            raise ValueError("the variational LSTM has no inter-layer "
                             "dropout")
        draws = None if noise is None else iter(noise)
        h0, c0 = hidden
        out, hs, cs = x, [], []
        kl = torch.zeros((), device=x.device)
        T, B, _ = x.shape
        for k in (0, 1):
            dtype = out.dtype
            b_ih = getattr(self, f"l{k}_bias_ih").to(dtype)
            xg = (out.reshape(T * B, -1)
                  @ getattr(self, f"l{k}_weights_ih").to(dtype).t()
                  + b_ih).reshape(T, B, -1)
            vnn = getattr(self, f"l{k}_vnn")
            eps = None
            if self.vtypes[k] == 1 and train:
                eps = vnn.noise(T, generator, _next_eps(
                    draws, "VLSTMCore")).to(dtype)
            out, pre, hT, cT = _lstm_scan(
                xg, getattr(self, f"l{k}_weights_hh").to(dtype).t(), b_ih,
                h0[k], c0[k], step_mask, reset_mask, reset_src, noise=eps)
            hs.append(hT)
            cs.append(cT)
            if self.vtypes[k] == 1:
                kl = kl + vnn.kl(pre[-1])
        if draws is not None and next(draws, None) is not None:
            raise ValueError("VLSTMCore: more injected noise tensors than "
                             "sampled tensors")
        self._kl = kl
        return out, (torch.stack(hs), torch.stack(cs))


class RecurrentLM(nn.Module):
    """Embedding -> recurrent core -> decoder (reference RNNModel): tied to
    the embedding, or with ``cfg.tied`` False its own ``decoder_w`` (V,
    nhid), as the JAX package names it.

    ``forward`` with ``deterministic=True`` (the default) is the scoring
    pass, dropout off; ``deterministic=False`` is the training forward.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, cfg.emsize)))
        if not cfg.tied:
            self.decoder_w = nn.Parameter(torch.empty((cfg.vocab_size,
                                                       cfg.nhid)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        if cfg.uncertainty == "Bayesian":
            self.core = BayesLSTMCore(cfg)
        elif cfg.uncertainty == "Gaussian":
            self.core = (GaussLSTMLegacyCore(cfg)
                         if cfg.l_gauss_legacy_pos >= 0 else GPLSTMCore(cfg))
        elif cfg.uncertainty == "Variational":
            self.core = (VLSTMLegacyCore(cfg) if cfg.l_v_legacy
                         else VLSTMCore(cfg))
        else:
            self.core = StandardRNNCore(cfg)

    @property
    def decoder_weight(self) -> torch.Tensor:
        """The decoder's (V, nhid) weight: the embedding when tied, else
        ``decoder_w``."""
        return self.embedding if self.cfg.tied else self.decoder_w

    def reset_parameters(self, gen: torch.Generator) -> None:
        tinit.uniform_(self.embedding, tinit.EMBEDDING_BOUND, gen)
        if not self.cfg.tied:
            tinit.uniform_(self.decoder_w, tinit.EMBEDDING_BOUND, gen)
        with torch.no_grad():
            self.decoder_b.zero_()
        self.core.reset_parameters(gen)

    def forward(self, tokens, hidden: Hidden, step_mask=None,
                return_hidden: bool = False, reset_mask=None,
                reset_src: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[DropoutMasks] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                emb_in: Optional[torch.Tensor] = None):
        """tokens (T, B) -> logits (T, B, V) float32 and the new hidden.

        ``step_mask`` (T, B) freezes the state on padded steps.
        ``reset_mask`` (T, B) with ``reset_src`` (B,) are the packed
        carry-over resets (see ops/lstm.py). ``return_hidden`` returns the
        core's output states (T, B, H) in place of logits, for the fused
        decoder CE. ``deterministic=False`` runs the training forward: the
        LSTM's grad route and, when ``cfg.dropout`` > 0, dropout with
        ``dropout_masks`` or masks drawn from ``generator``. The Bayesian
        core then samples its weights from ``generator``, or takes the
        injected ``noise`` (see ``BayesLSTMCore``); so do the GP units of
        the GP-LSTM core (see ``GPLSTMCore``) and the variational cores'
        noise (see ``VLSTMCore``, ``VLSTMLegacyCore``). ``emb_in`` (T, B,
        emsize) replaces the table lookup: the tensor-parallel step embeds
        from its vocabulary shard (``parallel/train_parallel.py``).
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        emb = (self.embedding[tokens] if emb_in is None else emb_in).to(dtype)
        kw = {}
        if not deterministic and not isinstance(self.core, StandardRNNCore):
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
            layer = m.layer
            if layer is not None:
                # one mask at two layers, a sequence of them at others
                layer = [x.to(dtype) / keep for x in (
                    layer if isinstance(layer, (list, tuple)) else [layer])]
            out, hidden = self.core(
                _dropout(emb, m.emb, keep), hidden, step_mask, reset_mask,
                reset_src, train=True, dropout_mask=layer, **kw)
            out = _dropout(out, m.out, keep)
        if return_hidden:
            return out, hidden
        logits = (out @ self.decoder_weight.to(dtype).t()
                  + self.decoder_b.to(dtype))
        return logits.float(), hidden
