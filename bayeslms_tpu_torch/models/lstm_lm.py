"""Recurrent language models, counterpart of
``bayeslms_tpu/models/lstm_lm.py``.

The port has the standard 2-layer LSTM core, the Bayesian gate-slice
LSTM core (``uncertainty="Bayesian"``), the GP-LSTM core
(``uncertainty="Gaussian"``: ``GPLSTMCore`` with GP gates 1-4 and GPNN
types 0-3, ``GPLSTMCell``, ``StdLSTMLayer``) and the container with a tied
decoder: the scoring pass (``deterministic=True``, dropout off, the Bayes
core at its posterior mean, the GP units at their means) and the training
forward, with dropout on the embedding, between the standard core's layers
and on the core's output, as ``RecurrentLM.__call__``, ``StandardRNNCore``,
``BayesLSTMCore`` and ``GPLSTMCore`` apply it in the JAX package. GRU/RNN
cores, GP gates 5-7, GPNN2, the legacy GaussLSTM and the variational cores
are ROADMAP.md queue A items 3 and 10; the cores raise for them.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops import bayes_sample_cuda, gaussian, gp_lstm_cuda, lstm_cuda
from ..ops.lstm import LSTMParams, lstm_layer, lstm_stack2
from . import initializers as tinit
from .layers import ACTS, GPNN

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
    """Bernoulli(1 - cfg.dropout) keep masks from ``gen`` (on ``device``);
    no inter-layer mask for the cores that have no inter-layer dropout
    (the Bayesian and the GP-LSTM ones)."""
    keep = 1.0 - cfg.dropout
    draw = lambda width: torch.rand(  # noqa: E731
        (T, B, width), generator=gen, device=device) < keep
    layered = cfg.uncertainty == "none" or (
        cfg.uncertainty == "Gaussian" and cfg.l_gauss_pos[:1] == "0")
    layer = draw(cfg.nhid) if layered else None
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


def _gp_refusal(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: GP gates 5-7, GPNN2 (type 4), the legacy "
        "GaussLSTM and the variational cores are ROADMAP.md queue A item 10")


class GPLSTMCell(nn.Module):
    """One GP-activation LSTM layer, the JAX package's ``GPLSTMCell`` for
    gates 1-4 (the reference's ``GPLSTMCell``, model.py:1683-1777): gate
    ``gate_type`` of [i, f, g, o] is replaced by a GP unit (``gpnn``, type
    ``gpnn_type`` 0-3) over cat(x_t, h_{t-1}), with the act set (sigmoid,)
    for gate 2 and (sigmoid, tanh, relu) otherwise, its weights drawn once
    a call. Parameters ``weights_ih``, ``bias_ih``, ``weights_hh``,
    ``bias_hh`` and ``gpnn.*``; the reference adds ``bias_ih`` to both
    projections and never uses ``bias_hh`` (model.py:1749-1753), and so
    does this cell.

    Routes as JAX: without resets, on a CUDA tensor that
    ``gp_lstm_cuda.gpg_kernel_ok`` admits, the recurrence goes to
    ``gp_lstm_cuda.gpg_layer_fused`` (kernel rows 20-21, float32 carry);
    otherwise (packed resets, a refused shape, a CPU tensor) the JAX
    package's scan runs step by step, its carry in the promoted dtype of
    h0 and x, with ``lstm_cuda.apply_reset`` at the resets.
    """

    def __init__(self, input_size: int, hidden_size: int, gate_type: int,
                 gpnn_type: int, sample_enabled: bool = False):
        super().__init__()
        if gate_type not in (1, 2, 3, 4):
            raise _gp_refusal(f"GP gate {gate_type}")
        if gpnn_type not in (0, 1, 2, 3):
            raise _gp_refusal(f"GPNN type {gpnn_type}")
        H = hidden_size
        self.input_size, self.hidden_size = input_size, H
        self.gate_type, self.gpnn_type = gate_type, gpnn_type
        self.weights_ih = nn.Parameter(torch.empty((4 * H, input_size)))
        self.bias_ih = nn.Parameter(torch.empty((4 * H,)))
        self.weights_hh = nn.Parameter(torch.empty((4 * H, H)))
        self.bias_hh = nn.Parameter(torch.empty((4 * H,)))
        acts = ("sigmoid",) if gate_type == 2 else ("sigmoid", "tanh", "relu")
        self.gpnn = GPNN(H + input_size, H, acts, gpnn_type, sample_enabled)

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = tinit.rnn_bound(self.hidden_size)
        tinit.uniform_(self.weights_ih, bound, gen)
        tinit.uniform_(self.weights_hh, bound, gen)
        with torch.no_grad():
            self.bias_ih.zero_()
            self.bias_hh.zero_()
        self.gpnn.reset_parameters(gen)

    def forward(self, x, hc: Hidden, deterministic: bool = True,
                step_mask=None, reset_mask=None, reset_src=None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Iterator[torch.Tensor]] = None):
        """x (T, B, in) -> ys (T, B, H), (hT, cT). ``noise`` hands the GP
        unit its eps when it samples (see ``GPNN.draw``)."""
        H, g, n_in = self.hidden_size, self.gate_type, self.input_size
        dtype = x.dtype
        T, B, _ = x.shape
        h0, c0 = hc
        # the x-only projections over the whole sequence
        xg = (x.reshape(T * B, -1) @ self.weights_ih.to(dtype).t()
              + self.bias_ih.to(dtype)).reshape(T, B, 4 * H)
        w, b, coef = self.gpnn.draw(deterministic, generator, noise)
        w_h = w[:, n_in:]
        gpx = x @ w[:, :n_in].t().to(dtype) + b.to(dtype)
        acts = self.gpnn.act_set
        if reset_mask is None and gp_lstm_cuda.gpg_kernel_ok(x, H):
            return gp_lstm_cuda.gpg_layer_fused(
                xg, gpx, self.weights_hh, self.bias_ih, w_h, coef, h0, c0, g,
                acts, step_mask)
        # the scan: operands in the carry's promoted dtype, as JAX promotes
        pd = torch.promote_types(h0.dtype, dtype)
        w_hh_t = self.weights_hh.to(dtype).t().to(pd)
        w_h_t = w_h.to(dtype).t().to(pd)
        b_ih = self.bias_ih.to(dtype).to(pd)
        coefs = [coef[a].to(dtype).to(pd) for a in range(len(acts))]
        h, c = h0, c0
        ys = []
        for t in range(T):
            if reset_mask is not None:
                h = lstm_cuda.apply_reset(h, reset_mask[t], reset_src)
                c = lstm_cuda.apply_reset(c, reset_mask[t], reset_src)
            gi, gf, gg, go = (xg[t] + h @ w_hh_t + b_ih).chunk(4, dim=-1)
            pre = gpx[t] + h @ w_h_t
            gp = None
            for a, name in enumerate(acts):
                term = ACTS[name](pre) * coefs[a]
                gp = term if gp is None else gp + term
            i = gp if g == 1 else torch.sigmoid(gi)
            f = gp if g == 2 else torch.sigmoid(gf)
            gg = gp if g == 3 else torch.tanh(gg)
            o = gp if g == 4 else torch.sigmoid(go)
            cn = f * c + i * gg
            hn = o * torch.tanh(cn)
            if step_mask is not None:
                keep = step_mask[t].bool()[:, None]
                hn, cn = torch.where(keep, hn, h), torch.where(keep, cn, c)
            h, c = hn, cn
            ys.append(h)
        return torch.stack(ys), (h, c)

    def kl(self) -> torch.Tensor:
        return self.gpnn.kl()


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
    type; length 2: a GP cell (``cell0``) then a standard layer (``std1``);
    length 3: a standard layer (``std0``) then a GP cell (``cell1``);
    length 4: GP cells in both layers, the second's gate digit 2. No
    inter-layer dropout. ``kl_value`` is the KL that the JAX core sows: the
    cells' GPNN KLs when the gate digit is > 0 and the type 1-3."""

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
        elif self.kind == "len2":
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
        """``train`` runs the training forward: the GP units sample when
        ``cfg.gp_sample`` (eps from ``noise``, in the JAX call order, or
        drawn from ``generator``), the standard layer takes its grad route.
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


class RecurrentLM(nn.Module):
    """Embedding -> recurrent core -> tied decoder (reference RNNModel).

    ``forward`` with ``deterministic=True`` (the default) is the scoring
    pass, dropout off; ``deterministic=False`` is the training forward.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.uncertainty == "Variational":
            raise _gp_refusal("uncertainty='Variational'")
        if cfg.uncertainty == "Gaussian" and cfg.l_gauss_legacy_pos >= 0:
            raise _gp_refusal(
                f"the legacy GaussLSTM (l_gauss_legacy_pos="
                f"{cfg.l_gauss_legacy_pos})")
        if not cfg.tied:
            raise NotImplementedError(
                "an untied decoder is not ported yet (ROADMAP.md queue A item 3)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, cfg.emsize)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        if cfg.uncertainty == "Bayesian":
            self.core = BayesLSTMCore(cfg)
        elif cfg.uncertainty == "Gaussian":
            self.core = GPLSTMCore(cfg)
        else:
            self.core = StandardRNNCore(cfg)

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
        injected ``noise`` (see ``BayesLSTMCore``); so do the GP units of
        the GP-LSTM core when ``cfg.gp_sample`` (see ``GPLSTMCore``).
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        emb = self.embedding[tokens].to(dtype)
        kw = {}
        if not deterministic and isinstance(self.core, (BayesLSTMCore,
                                                        GPLSTMCore)):
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
