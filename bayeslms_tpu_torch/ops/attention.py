"""Multi-head self-attention over time-major projections, counterpart of
``bayeslms_tpu/ops/attention.py``.

The reference's self-built MultiheadAttention (model.py:836-928): q scaled
by head_dim^-0.5, an additive mask, softmax, dropout on the attention
probabilities, P V. Routing follows the JAX package's:

- causal, deterministic, no explicit mask, and a shape that
  ``attention_cuda.attention_ok`` admits on a CUDA tensor: kernel row 14
  (``csrc/attention_fwd.cu``), the scoring and eval route;
- causal training (``deterministic=False``) without an explicit mask or an
  injected ``dropout_mask`` at T >= ``FLASH_TRAIN_MIN_T`` on a CUDA tensor:
  kernel rows 15-17 (``csrc/attention_train.cu``), forward and backward with
  the dropout drawn inside the kernels from a seed drawn here, as the JAX
  package routes it; a shape that ``attention_train_cuda.flash_attn_train_ok``
  refuses raises there rather than take another route. A
  non-deterministic forward that records no gradient (MC-average scoring
  under ``torch.inference_mode``) takes row 15 at every T: the JAX
  package's short-T reason for the plain path, XLA fusing the einsums
  into their neighbours in a training step, has no counterpart there;
- everything else: the plain matmul/softmax path, which the JAX package
  computes outside any Pallas kernel. An explicit mask (the packed scorer's,
  Transformer-XL's) pins it, as in JAX; so does an injected
  ``dropout_mask``, which only the plain path can apply (the kernels draw
  their own bits); and so does a CPU tensor, whatever T.

Layout: time-major (T, B, E), E = nhead d.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.rng import dropout_stream
from . import attention_cuda, attention_train_cuda

FLASH_TRAIN_MIN_T = 1024  # where the JAX package routes training to rows 15-17


def causal_mask(T: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive (T, T) mask: 0 on and below the diagonal, -inf above
    (model.py:148-152)."""
    keep = torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return torch.zeros((T, T), dtype=dtype, device=device).masked_fill(
        ~keep, float("-inf"))


def sinusoidal_positional_encoding(max_len: int, d_model: int,
                                   device=None) -> torch.Tensor:
    """(max_len, d_model) float32 sin/cos table (model.py:93-104)."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


def draw_keep(shape, rate: float, generator: Optional[torch.Generator],
              device=None) -> torch.Tensor:
    """A Bernoulli(1 - rate) keep mask drawn from ``generator``."""
    return torch.rand(shape, generator=dropout_stream(generator),
                      device=device) < 1.0 - rate


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        nhead: int, attn_mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0, deterministic: bool = True,
                        causal: bool = False,
                        dropout_mask: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Scaled dot-product attention over time-major projections q (T, B, E),
    k and v (S, B, E) -> (T, B, E).

    ``attn_mask``: additive, (T, S) or broadcastable to (B, nhead, T, S)
    (the packed scorer's (B, 1, T, T)); with ``causal=True`` and no mask this
    function owns the causal mask and the kernel routes are eligible.
    Training (``deterministic=False``) with ``dropout_rate`` > 0 drops
    attention probabilities with ``dropout_mask`` (B, nhead, T, S), nonzero
    = kept, or a mask drawn from ``generator``; on the kernel route the
    kernels draw it from a seed that ``generator`` gives."""
    T, B, E = q.shape
    if causal and attn_mask is None:
        if deterministic and attention_cuda.attention_ok(q, nhead):
            return attention_cuda.causal_attention(q, k, v, nhead)
        if not deterministic and dropout_mask is None and q.is_cuda \
                and (T >= FLASH_TRAIN_MIN_T or not torch.is_grad_enabled()):
            if not attention_train_cuda.flash_attn_train_ok(q, nhead):
                raise ValueError(
                    f"causal attention training at T = {T}, E = {E}, "
                    f"{nhead} heads: the flash-attention training kernels "
                    f"take a head dim that is a multiple of 8 and T <= "
                    f"{attention_train_cuda.MAX_T}")
            if dropout_rate > 0.0:
                seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=dropout_stream(generator),
                                     dtype=torch.int32, device=q.device)
            else:
                seed = torch.zeros((1,), dtype=torch.int32, device=q.device)
            return attention_train_cuda.flash_attention_train(
                q, k, v, nhead, dropout_rate, seed)
        attn_mask = causal_mask(T, device=q.device)
    S = k.shape[0]
    d = E // nhead
    scaling = float(d) ** -0.5

    def split_heads(x, L):  # (L, B, E) -> (B, h, L, d)
        return x.reshape(L, B, nhead, d).permute(1, 2, 0, 3)

    qh = split_heads(q * scaling, T)
    kh = split_heads(k, S)
    vh = split_heads(v, S)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if attn_mask is not None:
        scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and not deterministic:
        keep = dropout_mask
        if keep is None:
            keep = draw_keep(probs.shape, dropout_rate, generator, q.device)
        probs = torch.where(keep.bool(), probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    out = torch.matmul(probs, vh)
    return out.permute(2, 0, 1, 3).reshape(T, B, E)
