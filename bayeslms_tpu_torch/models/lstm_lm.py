"""Recurrent language models, counterpart of
``bayeslms_tpu/models/lstm_lm.py``.

The port has the standard 2-layer LSTM core and the container with a
tied decoder: the scoring pass (``deterministic=True``, dropout off) and
the training forward, with dropout on the embedding, between the layers
and on the core's output, as ``RecurrentLM.__call__`` and
``StandardRNNCore`` apply it in the JAX package. GRU/RNN cores and the
Bayesian, GP and variational cores are ROADMAP.md queue A items 3, 7 and
10; ``StandardRNNCore`` raises for them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..ops.lstm import LSTMParams, lstm_stack2
from . import initializers as tinit

Hidden = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (nlayers, B, H)


def init_hidden(nlayers: int, batch: int, nhid: int,
                dtype=torch.float32, device=None) -> Hidden:
    z = torch.zeros((nlayers, batch, nhid), dtype=dtype, device=device)
    return (z, z.clone())


class DropoutMasks(NamedTuple):
    """Keep masks (nonzero = kept) of one training forward: on the
    embedding (T, B, emsize), between the layers and on the core's output
    (T, B, nhid). Drawn by ``draw_dropout_masks`` or injected, so that a
    test can feed both packages the same masks."""

    emb: torch.Tensor
    layer: torch.Tensor
    out: torch.Tensor


def draw_dropout_masks(cfg: ModelConfig, T: int, B: int,
                       gen: torch.Generator, device=None) -> DropoutMasks:
    """Bernoulli(1 - cfg.dropout) keep masks from ``gen`` (on ``device``)."""
    keep = 1.0 - cfg.dropout
    draw = lambda width: torch.rand(  # noqa: E731
        (T, B, width), generator=gen, device=device) < keep
    return DropoutMasks(draw(cfg.emsize), draw(cfg.nhid), draw(cfg.nhid))


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


class RecurrentLM(nn.Module):
    """Embedding -> recurrent core -> tied decoder (reference RNNModel).

    ``forward`` with ``deterministic=True`` (the default) is the scoring
    pass, dropout off; ``deterministic=False`` is the training forward.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.uncertainty != "none":
            raise NotImplementedError(
                f"uncertainty={cfg.uncertainty!r} is not ported yet: the "
                "Bayesian, GP and variational cores are ROADMAP.md queue A "
                "items 7 and 10")
        if not cfg.tied:
            raise NotImplementedError(
                "an untied decoder is not ported yet (ROADMAP.md queue A item 3)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, cfg.emsize)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
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
                dropout_masks: Optional[DropoutMasks] = None):
        """tokens (T, B) -> logits (T, B, V) float32 and the new hidden.

        ``step_mask`` (T, B) freezes the state on padded steps.
        ``reset_mask`` (T, B) with ``reset_src`` (B,) are the packed
        carry-over resets (see ops/lstm.py). ``return_hidden`` returns the
        core's output states (T, B, H) in place of logits, for the fused
        decoder CE. ``deterministic=False`` runs the training forward: the
        LSTM's grad route and, when ``cfg.dropout`` > 0, dropout with
        ``dropout_masks`` or masks drawn from ``generator``.
        """
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        emb = self.embedding[tokens].to(dtype)
        if deterministic or cfg.dropout == 0:
            out, hidden = self.core(emb, hidden, step_mask, reset_mask,
                                    reset_src, train=not deterministic)
        else:
            keep = 1.0 - cfg.dropout
            m = dropout_masks
            if m is None:
                m = draw_dropout_masks(cfg, tokens.shape[0], tokens.shape[1],
                                       generator, emb.device)
            out, hidden = self.core(
                _dropout(emb, m.emb, keep), hidden, step_mask, reset_mask,
                reset_src, train=True,
                dropout_mask=m.layer.to(dtype) / keep)
            out = _dropout(out, m.out, keep)
        if return_hidden:
            return out, hidden
        logits = out @ self.embedding.to(dtype).t() + self.decoder_b.to(dtype)
        return logits.float(), hidden
