"""LSTM recurrences, counterpart of ``bayeslms_tpu/ops/lstm.py``.

Weights keep the torch layout, W (4H, in) applied as x W^T, gate order
[i, f, g, o]. ``lstm_layer`` is the JAX package's single-layer scan.
``lstm_stack2`` is the 2-layer recurrence. Its scoring route computes
layer 1's input projection for the whole sequence as one matrix product
and hands the recurrence to ``lstm_cuda.lstm2_fwd``; its training route
(``train=True``) runs two ``lstm_layer_train`` calls with the inter-layer
dropout mask between them, as the JAX package does when a mask is given.
``lstm_layer_train`` hands its recurrence to the autograd Function
``lstm_train_cuda.lstm_scan_fused``. The wrappers launch the CUDA kernels
for CUDA tensors and run their plain twins for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import lstm_cuda, lstm_train_cuda


class LSTMParams(NamedTuple):
    """One layer of LSTM weights (torch layout)."""

    w_ih: torch.Tensor  # (4H, in)
    w_hh: torch.Tensor  # (4H, H)
    b_ih: torch.Tensor  # (4H,)
    b_hh: torch.Tensor  # (4H,)


def lstm_layer(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    p: LSTMParams,
    step_mask: Optional[torch.Tensor] = None,
    reset_mask: Optional[torch.Tensor] = None,
    reset_src: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-layer LSTM over (T, B, in) -> ys (T, B, H), hT, cT, with the
    state carried in x's dtype.

    ``step_mask`` (T, B) keeps the previous (h, c) on padded steps, so the
    final state is each column's state at its true length. ``reset_mask``
    (T, B) with ``reset_src`` (B,): before step t, columns with a reset
    take column ``reset_src[b]``'s state (-1: zeros).
    """
    dtype = x.dtype
    w_hh_t = p.w_hh.to(dtype).t()
    b_hh = p.b_hh.to(dtype)
    T, B, _ = x.shape
    xg = (x.reshape(T * B, -1) @ p.w_ih.to(dtype).t()
          + p.b_ih.to(dtype)).reshape(T, B, -1)
    h, c = h0.to(dtype), c0.to(dtype)
    ys = []
    for t in range(T):
        if reset_mask is not None:
            h = lstm_cuda.apply_reset(h, reset_mask[t], reset_src)
            c = lstm_cuda.apply_reset(c, reset_mask[t], reset_src)
        keep = None if step_mask is None else step_mask[t]
        h, c = lstm_cuda.cell_update(xg[t] + h @ w_hh_t + b_hh, h, c, keep)
        ys.append(h)
    return torch.stack(ys), h, c


def lstm_layer_train(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    p: LSTMParams,
    step_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable single-layer LSTM (the JAX package's
    ``lstm_layer_pallas_train``): (T, B, in) -> ys (T, B, H), hT, cT in x's
    dtype. xg = x W_ih^T + b_ih is one matrix product in x's dtype; the
    recurrence and its backward are ``lstm_scan_fused``'s."""
    dtype = x.dtype
    T, B, _ = x.shape
    H = p.w_hh.shape[1]
    xg = (x.reshape(T * B, -1) @ p.w_ih.to(dtype).t()
          + p.b_ih.to(dtype)).reshape(T, B, 4 * H)
    ys, _, hT, cT = lstm_train_cuda.lstm_scan_fused(
        xg, p.w_hh.to(dtype), p.b_hh.to(dtype), h0.to(dtype), c0.to(dtype),
        step_mask)
    return ys, hT, cT


def lstm_stack2(
    x: torch.Tensor,
    h0: torch.Tensor,  # (2, B, H)
    c0: torch.Tensor,  # (2, B, H)
    p1: LSTMParams,
    p2: LSTMParams,
    step_mask: Optional[torch.Tensor] = None,
    reset_mask: Optional[torch.Tensor] = None,
    reset_src: Optional[torch.Tensor] = None,
    train: bool = False,
    dropout_mask: Optional[torch.Tensor] = None,
):
    """Two stacked LSTM layers.

    Returns ys2 (T, B, H), (hT1, hT2), (cT1, cT2) in x's dtype.
    ``train=False`` is the forward-only scoring route (no dropout): the
    biases are rounded to x's dtype and handed over in float32, as the TPU
    kernel takes them (b_hh1, and b_ih2 + b_hh2 summed before the
    rounding). ``train=True`` is the grad route: two ``lstm_layer_train``
    calls, layer 1's output multiplied by ``dropout_mask`` (T, B, H), the
    inter-layer inverted-dropout mask, when one is given; resets are not
    taken there.
    """
    if train:
        if reset_mask is not None:
            raise NotImplementedError(
                "packed resets on the training route: resets belong to the "
                "packed scoring layouts, which do not train")
        ys1, h1T, c1T = lstm_layer_train(x, h0[0], c0[0], p1, step_mask)
        if dropout_mask is not None:
            ys1 = ys1 * dropout_mask.to(ys1.dtype)
        ys2, h2T, c2T = lstm_layer_train(ys1, h0[1], c0[1], p2, step_mask)
        return ys2, (h1T, h2T), (c1T, c2T)
    if dropout_mask is not None:
        raise ValueError("lstm_stack2: a dropout mask needs train=True")
    dtype = x.dtype
    T, B, _ = x.shape
    H = p1.w_hh.shape[1]
    xg1 = (x.reshape(T * B, -1) @ p1.w_ih.to(dtype).t()
           + p1.b_ih.to(dtype)).reshape(T, B, 4 * H)
    f32 = torch.float32
    return lstm_cuda.lstm2_fwd(
        xg1.contiguous(), p1.w_hh.to(dtype).contiguous(),
        p1.b_hh.to(dtype).to(f32), p2.w_ih.to(dtype).contiguous(),
        p2.w_hh.to(dtype).contiguous(),
        (p2.b_ih + p2.b_hh).to(dtype).to(f32),
        h0[0], c0[0], h0[1], c0[1], step_mask, reset_mask, reset_src)
