"""Transformer language models, counterpart of
``bayeslms_tpu/models/transformer_lm.py``: the standard model and the
Bayesian ones with the posterior at the FFN, the MHA output projection or
the embedding (``t_bayes_pos`` FFN / MHA / EMB).

The reference's containers (model.py:121-171, :836-1046, :1137-1309):
embedding x sqrt(E) -> [EMB: a Bayesian (E, E) projection] -> sinusoidal
positions -> dropout -> post-LN encoder layers with an exact-GELU FFN ->
[EMB: the projection's mean, transposed back] -> tied decoder. Layouts are
time-major (T, B, E); layer norms compute in float32 and cast back to the
compute dtype. The stochastic layer is layer 0 only and uses dropout 0.2
whatever the model's dropout (model.py:1202,1207). Parameter names follow
the JAX tree (``layers_0.self_attn.qkv_net.kernel``, flax (in, out)
kernels), so the weight exchange only walks it.

Training draws dropout masks (embedding, attention probabilities, the two
residual branches and the FFN's middle) and the Bayesian eps from a
``torch.Generator``, or takes them injected (``TransformerDropoutMasks``
and ``noise``), so that a test can feed both packages the same draws. The
GP and variational layers are ROADMAP.md queue A item 10, Transformer-XL
memories item 9b.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..ops import gaussian
from ..ops.attention import (draw_keep, multihead_attention,
                             sinusoidal_positional_encoding)
from . import initializers as tinit
from .layers import BayesDense

PE_LEN = 5000  # rows of the positional table (model.py:93)
BAYES_LAYER_DROPOUT = 0.2  # the stochastic layer's hardcoded rate


class EncoderDropoutMasks(NamedTuple):
    """Keep masks (nonzero = kept) of one encoder layer's training forward:
    the attention probabilities (B, nhead, T, T), the attention branch
    (T, B, E), the FFN's middle (T, B, nhid) and the FFN branch (T, B, E),
    in the JAX call order."""

    attn: torch.Tensor
    attn_out: torch.Tensor
    ff: torch.Tensor
    ff_out: torch.Tensor


class TransformerDropoutMasks(NamedTuple):
    """Keep masks of one training forward: the embedding (T, B, E) and one
    ``EncoderDropoutMasks`` a layer."""

    emb: torch.Tensor
    layers: Sequence[EncoderDropoutMasks]


def _dropout(x, rate: float, deterministic: bool, mask, generator):
    """Inverted dropout as flax's ``nn.Dropout``: x / keep where kept, with
    ``mask`` or a mask drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    if mask is None:
        mask = draw_keep(x.shape, rate, generator, x.device)
    return torch.where(mask.bool(), x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out) and ``bias`` (out,), float32
    parameters, the product in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((in_features, out_features)))
        self.bias = nn.Parameter(torch.empty((out_features,)))
        self.dtype = dtype

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


def _torch_linear_(dense: Dense, fan_in: int, gen, zero_bias=False) -> None:
    tinit.uniform_(dense.kernel, tinit.torch_linear_weight(fan_in), gen)
    if zero_bias:
        with torch.no_grad():
            dense.bias.zero_()
    else:
        tinit.uniform_(dense.bias, tinit.torch_linear_bias(fan_in), gen)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-5, ``scale`` and ``bias``): float32
    statistics, the output cast back to the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((dim,)))
        self.bias = nn.Parameter(torch.empty((dim,)))
        self.dtype = dtype

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias,
                            1e-5).to(self.dtype)


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv causal self-attention (model.py:836-928): xavier qkv
    kernel, zero biases on qkv and o."""

    def __init__(self, E: int, nhead: int, dropout: float, dtype):
        super().__init__()
        self.E, self.nhead, self.dropout = E, nhead, dropout
        self.qkv_net = Dense(E, 3 * E, dtype)
        self.o_net = Dense(E, E, dtype)

    def reset_parameters(self, gen) -> None:
        tinit.xavier_uniform_(self.qkv_net.kernel, gen)
        with torch.no_grad():
            self.qkv_net.bias.zero_()
        _torch_linear_(self.o_net, self.E, gen, zero_bias=True)

    def forward(self, x, attn_mask=None, deterministic=True, dropout_mask=None,
                generator=None):
        q, k, v = self.qkv_net(x).split(self.E, dim=-1)
        out = multihead_attention(q, k, v, self.nhead, attn_mask, self.dropout,
                                  deterministic, causal=True,
                                  dropout_mask=dropout_mask,
                                  generator=generator)
        return self.o_net(out)


class BayesMultiheadSelfAttention(nn.Module):
    """Separate q/k/v projections (torch's Linear default init: the
    reference never resets them) and a bias-free Bayesian output projection
    (model.py:931-1019)."""

    def __init__(self, E: int, nhead: int, dropout: float, dtype):
        super().__init__()
        self.E, self.nhead, self.dropout = E, nhead, dropout
        self.q_net = Dense(E, E, dtype)
        self.k_net = Dense(E, E, dtype)
        self.v_net = Dense(E, E, dtype)
        self.o_net = BayesDense(E, E)

    def reset_parameters(self, gen) -> None:
        for dense in (self.q_net, self.k_net, self.v_net):
            _torch_linear_(dense, self.E, gen)
        self.o_net.reset_parameters(gen)

    def forward(self, x, attn_mask=None, deterministic=True, dropout_mask=None,
                generator=None, eps=None):
        out = multihead_attention(self.q_net(x), self.k_net(x), self.v_net(x),
                                  self.nhead, attn_mask, self.dropout,
                                  deterministic, causal=True,
                                  dropout_mask=dropout_mask,
                                  generator=generator)
        return self.o_net(out, deterministic, eps=eps, generator=generator)


class StandardEncoderLayer(nn.Module):
    """Post-LN encoder layer with an exact-GELU FFN (model.py:1022-1046).
    ``bayes_pos`` "FFN" or "MHA" makes it the Bayesian layer
    (``BayesEncoderLayer``)."""

    def __init__(self, d: int, nhead: int, ff: int, dropout: float, dtype,
                 bayes_pos: str = "none"):
        super().__init__()
        self.d, self.ff, self.dropout = d, ff, dropout
        self.bayes_pos = bayes_pos
        attention = BayesMultiheadSelfAttention if bayes_pos == "MHA" \
            else MultiheadSelfAttention
        self.self_attn = attention(d, nhead, dropout, dtype)
        self.linear1 = Dense(d, ff, dtype)
        self.linear2 = BayesDense(ff, d) if bayes_pos == "FFN" \
            else Dense(ff, d, dtype)
        self.norm1 = LayerNorm(d, dtype)
        self.norm2 = LayerNorm(d, dtype)

    def reset_parameters(self, gen) -> None:
        self.self_attn.reset_parameters(gen)
        _torch_linear_(self.linear1, self.d, gen)
        if self.bayes_pos == "FFN":
            self.linear2.reset_parameters(gen)
        else:
            _torch_linear_(self.linear2, self.ff, gen)
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()

    def forward(self, src, attn_mask=None, deterministic: bool = True,
                masks: Optional[EncoderDropoutMasks] = None,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None):
        """``eps`` injects the Bayesian sub-module's draw."""
        m = masks or EncoderDropoutMasks(None, None, None, None)
        drop = lambda x, mask: _dropout(  # noqa: E731
            x, self.dropout, deterministic, mask, generator)
        if self.bayes_pos == "MHA":
            src2 = self.self_attn(src, attn_mask, deterministic, m.attn,
                                  generator, eps=eps)
        else:
            src2 = self.self_attn(src, attn_mask, deterministic, m.attn,
                                  generator)
        src = self.norm1(src + drop(src2, m.attn_out))
        mid = drop(F.gelu(self.linear1(src)), m.ff)
        if self.bayes_pos == "FFN":
            src2 = self.linear2(mid, deterministic, eps=eps,
                                generator=generator)
        else:
            src2 = self.linear2(mid)
        return self.norm2(src + drop(src2, m.ff_out))


class BayesEncoderLayer(StandardEncoderLayer):
    """The stochastic layer: ``linear2`` a bias-free BayesDense (FFN,
    model.py:1149-1153) or the attention a BayesMultiheadSelfAttention
    (MHA, model.py:1141-1146)."""

    def __init__(self, d: int, nhead: int, ff: int, dropout: float, dtype,
                 bayes_pos: str):
        if bayes_pos not in ("FFN", "MHA"):
            raise ValueError(f"BayesEncoderLayer: bayes_pos {bayes_pos!r}")
        super().__init__(d, nhead, ff, dropout, dtype, bayes_pos)

    def kl(self, prior_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Bayesian sub-module's KL (train.py:341-352)."""
        dense = self.linear2 if self.bayes_pos == "FFN" else self.self_attn.o_net
        return dense.kl(prior_mean)


class TransformerLM(nn.Module):
    """Embedding x sqrt(E) -> [EMB projection] -> positions -> layers ->
    [EMB transpose-reuse] -> tied decoder (the JAX ``TransformerLM``
    without ``mems``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.uncertainty in ("Gaussian", "Variational"):
            raise NotImplementedError(
                f"the {cfg.uncertainty} Transformer is not ported yet: its GP "
                "and variational layers are ROADMAP.md queue A item 10")
        if not cfg.tied:
            raise NotImplementedError(
                "an untied decoder is not ported yet (ROADMAP.md queue A "
                "item 3)")
        if cfg.emsize % cfg.nhead:
            raise ValueError(f"emsize {cfg.emsize} is not a multiple of "
                             f"nhead {cfg.nhead}")
        self.cfg = cfg
        E, ff, n = cfg.emsize, cfg.nhid, cfg.nlayers
        dtype = getattr(torch, cfg.compute_dtype)
        self.embedding = nn.Parameter(torch.empty((cfg.vocab_size, E)))
        self.decoder_b = nn.Parameter(torch.empty((cfg.vocab_size,)))
        self.register_buffer("pe", sinusoidal_positional_encoding(PE_LEN, E),
                             persistent=False)
        bayes = cfg.uncertainty == "Bayesian"
        self.bayes_pos = cfg.t_bayes_pos if bayes else "none"
        layers = []
        if self.bayes_pos in ("FFN", "MHA"):
            layers.append(BayesEncoderLayer(E, cfg.nhead, ff,
                                            BAYES_LAYER_DROPOUT, dtype,
                                            self.bayes_pos))
        while len(layers) < n:
            layers.append(StandardEncoderLayer(E, cfg.nhead, ff, cfg.dropout,
                                               dtype))
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)
        self.layers = layers
        if self.bayes_pos == "EMB":
            self.embed_mean = nn.Parameter(torch.empty((E, E)))
            self.embed_lgstd = nn.Parameter(torch.empty((E, E)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        tinit.uniform_(self.embedding, tinit.EMBEDDING_BOUND, gen)
        with torch.no_grad():
            self.decoder_b.zero_()
        for layer in self.layers:
            layer.reset_parameters(gen)
        if self.bayes_pos == "EMB":
            stde = 1.0 / math.sqrt(self.cfg.emsize + 1)
            tinit.uniform_(self.embed_mean, stde, gen)
            gaussian.lgstd_init_(self.embed_lgstd, stde, gen)

    def bayes_site(self) -> Optional[Tuple[str, ...]]:
        """The parameter path of the BayesDense whose KL has a prior branch
        (FFN: ``layers_0/linear2``, MHA: ``layers_0/self_attn/o_net``), or
        None."""
        return {"FFN": ("layers_0", "linear2"),
                "MHA": ("layers_0", "self_attn", "o_net")}.get(self.bayes_pos)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                return_hidden: bool = False,
                positions: Optional[torch.Tensor] = None,
                pack_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[TransformerDropoutMasks] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
        """tokens (T, B) -> logits (T, B, V) float32, or with
        ``return_hidden`` the pre-decoder states (T, B, E) for the fused CE.

        ``positions`` (T, B) with ``pack_mask`` (B, 1, T, T) additive: packed
        scoring, several hypotheses along one column, positions restarting
        at each, attention causal within each (the packed scorer's). Without
        them attention is causal over the window and owns its mask, so the
        attention kernel route is eligible. ``deterministic=False`` is the
        training forward: dropout with ``dropout_masks`` or masks drawn from
        ``generator``, and the Bayesian layer's weights sampled with the
        injected ``noise`` (one eps, (out, in) or (E, E) for EMB) or from
        ``generator``."""
        cfg = self.cfg
        T = tokens.shape[0]
        dtype = getattr(torch, cfg.compute_dtype)
        m = dropout_masks
        draws = None if noise is None else list(noise)
        eps = None
        if draws is not None and not deterministic:
            if len(draws) != (self.bayes_pos != "none"):
                raise ValueError(f"TransformerLM: {len(draws)} injected noise "
                                 f"tensors for t_bayes_pos {self.bayes_pos!r}")
            eps = draws[0] if draws else None

        x = self.embedding[tokens].to(dtype) * math.sqrt(cfg.emsize)
        if self.bayes_pos == "EMB":
            w = self.embed_mean
            if not deterministic:
                w = w + gaussian.sample_diff(self.embed_lgstd, eps=eps,
                                             generator=generator)
            x = x @ w.t().to(dtype)
        if positions is not None:
            x = x + self.pe[positions].to(dtype)
        else:
            x = x + self.pe[:T, None, :].to(dtype)
        x = _dropout(x, cfg.dropout, deterministic,
                     None if m is None else m.emb, generator)
        for i, layer in enumerate(self.layers):
            x = layer(x, pack_mask, deterministic,
                      None if m is None else m.layers[i], generator,
                      eps if i == 0 and self.bayes_pos in ("FFN", "MHA")
                      else None)
        if self.bayes_pos == "EMB":
            # transpose-reuse with the MEAN projection (model.py:1302-1307)
            x = x @ self.embed_mean.to(dtype)
        if return_hidden:
            return x
        logits = x @ self.embedding.to(dtype).t() + self.decoder_b.to(dtype)
        return logits.float()

    def kl_value(self, prior_mean: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """The KL dispatch of train.py:335-356: the stochastic layer's for
        FFN and MHA (with ``prior_mean``, the prior's weight mean at
        ``bayes_site``, the prior branch), the embedding projection's
        against N(0, 1) for EMB, zero otherwise."""
        if self.bayes_pos in ("FFN", "MHA"):
            return self.layers[0].kl(prior_mean)
        if self.bayes_pos == "EMB":
            return gaussian.kl_std_normal(self.embed_mean, self.embed_lgstd)
        return torch.zeros((), device=self.embedding.device)
