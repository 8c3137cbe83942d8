"""LSTM recurrences, counterpart of ``bayeslms_tpu/ops/lstm.py``.

Weights keep the torch layout, W (4H, in) applied as x W^T, gate order
[i, f, g, o]. ``lstm_layer`` is the JAX package's single-layer layer and
routes as it does: on a CUDA tensor that ``lstm_cuda.lstm_kernel_ok`` admits,
a forward-only call (``allow_kernel``, JAX's ``allow_pallas``) hands its
recurrence to ``lstm_cuda.lstm_fwd`` (kernel rows 3-4) and a call without
resets otherwise to ``lstm_layer_train`` (rows 5-6); where the gate refuses,
as on a CPU tensor, it runs the JAX package's scan, with the state carried in
x's dtype. ``lstm_stack2`` is the 2-layer recurrence. Its scoring route
asks ``lstm_cuda.lstm2_fwd_ok`` (JAX's ``pallas_lstm2_ok`` at the batch):
where it admits, layer 1's input projection for the whole sequence is one
matrix product and the recurrence goes to ``lstm_cuda.lstm2_fwd``; where it
refuses (float32 at H 1,024), two ``lstm_layer`` calls, as JAX; its training
route (``train=True``) runs two ``lstm_layer_train`` calls with the
inter-layer dropout mask between them, as the JAX package does by default.
``lstm_layer_train`` hands its recurrence to the autograd Function
``lstm_train_cuda.lstm_scan_fused``. The wrappers launch the CUDA kernels for
CUDA tensors and run their plain twins for CPU tensors. ``gru_layer`` and
``rnn_layer`` are the JAX package's GRU and vanilla-RNN layers: JAX scans
them with ``lax.scan`` and no Pallas kernel, so they are a loop over the
steps here, one matrix product a step, on every device.

The JAX package's fused training route is opt-in there and here, under the
same switch: with ``BAYESLM_PALLAS_LSTM2_TRAIN=1`` (and neither
``BAYESLM_PALLAS_LSTM2`` nor ``BAYESLM_PALLAS_LSTM_TRAIN`` set to ``0``), a
training call without resets whose layer-2 ``w_ih`` is (4H, H) and that
``lstm2_train_cuda.lstm2_kernel_ok`` admits (a CUDA tensor) runs both layers
through ``lstm2_train_cuda.lstm2_layer_train`` (kernel rows 7-8). JAX keeps
it off by default because it measured it 2-5% slower than two layers at
B = 32 on its TPU.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch

from . import lstm2_train_cuda, lstm_cuda, lstm_train_cuda


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
    allow_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-layer LSTM over (T, B, in) -> ys (T, B, H), hT, cT in x's
    dtype.

    ``step_mask`` (T, B) keeps the previous (h, c) on padded steps, so the
    final state is each column's state at its true length. ``reset_mask``
    (T, B) with ``reset_src`` (B,): before step t, columns with a reset
    take column ``reset_src[b]``'s state (-1: zeros). ``allow_kernel``
    marks a forward-only call (eval, scoring), which may take kernel rows
    3-4; otherwise a call without resets may take the grad route of rows
    5-6. Both routes need ``lstm_cuda.lstm_kernel_ok``; the scan, run
    where it refuses, carries the state in x's dtype.
    """
    H = p.w_hh.shape[1]
    if allow_kernel:
        if lstm_cuda.lstm_kernel_ok(x, H):
            return lstm_layer_fwd(x, h0, c0, p, step_mask, reset_mask,
                                  reset_src)
    elif reset_mask is None and lstm_cuda.lstm_kernel_ok(x, H, train=True):
        return lstm_layer_train(x, h0, c0, p, step_mask)
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


def lstm_layer_fwd(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    p: LSTMParams,
    step_mask: Optional[torch.Tensor] = None,
    reset_mask: Optional[torch.Tensor] = None,
    reset_src: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-only single-layer LSTM (the JAX package's
    ``lstm_layer_pallas``): xg = x W_ih^T + b_ih is one matrix product in
    x's dtype; the recurrence is ``lstm_cuda.lstm_fwd``'s, with b_hh
    rounded to x's dtype and handed over in float32, as the TPU kernel
    takes it."""
    dtype = x.dtype
    T, B, _ = x.shape
    H = p.w_hh.shape[1]
    xg = (x.reshape(T * B, -1) @ p.w_ih.to(dtype).t()
          + p.b_ih.to(dtype)).reshape(T, B, 4 * H)
    return lstm_cuda.lstm_fwd(
        xg.contiguous(), p.w_hh.to(dtype).contiguous(),
        p.b_hh.to(dtype).float(), h0.to(dtype), c0.to(dtype), step_mask,
        reset_mask, reset_src)


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


def fused_train_enabled() -> bool:
    """The JAX package's switch of the fused 2-layer training route:
    ``BAYESLM_PALLAS_LSTM2_TRAIN=1``, and neither ``BAYESLM_PALLAS_LSTM2``
    nor ``BAYESLM_PALLAS_LSTM_TRAIN`` set to ``0``. Off by default."""
    env = os.environ
    return (env.get("BAYESLM_PALLAS_LSTM2_TRAIN", "0") == "1"
            and env.get("BAYESLM_PALLAS_LSTM2", "1") != "0"
            and env.get("BAYESLM_PALLAS_LSTM_TRAIN", "1") != "0")


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
    ``train=False`` is the forward-only scoring route (no dropout), routed
    as JAX routes it, on every device: where ``lstm_cuda.lstm2_fwd_ok``
    admits the width, x's item size and the batch (and layer 2's w_ih is
    (4H, H)), ``lstm_cuda.lstm2_fwd`` (kernel row 1 on a CUDA tensor, its
    plain version on the CPU), with the biases rounded to x's dtype and
    handed over in float32, as the TPU kernel takes them (b_hh1, and
    b_ih2 + b_hh2 summed before the rounding); where it refuses, two
    ``lstm_layer(..., allow_kernel=True)`` calls, each under its own gate
    (``lstm_kernel_ok``: rows 3-4, or the scan). At float32 and H 1,024 both
    gates refuse, so the card runs the scan there, in cuBLAS's float32
    products (``torch.backends.cuda.matmul.allow_tf32`` left as PyTorch
    sets it, False): the counterpart of JAX's XLA scan, chosen by the same
    formulas before any launch, not a twin standing in for a kernel.
    ``train=True`` is the grad route: two ``lstm_layer_train``
    calls, layer 1's output multiplied by ``dropout_mask`` (T, B, H), the
    inter-layer inverted-dropout mask, when one is given; or, under the
    switch (``fused_train_enabled``), ``lstm2_train_cuda.lstm2_layer_train``
    where JAX's conditions hold. Resets are not taken there.
    """
    if train:
        if reset_mask is not None:
            raise NotImplementedError(
                "packed resets on the training route: resets belong to the "
                "packed scoring layouts, which do not train")
        H = p1.w_hh.shape[1]
        if fused_train_enabled() and tuple(p2.w_ih.shape) == (4 * H, H) \
                and lstm2_train_cuda.lstm2_kernel_ok(x, H):
            return lstm2_train_cuda.lstm2_layer_train(
                x, h0[0], c0[0], h0[1], c0[1], p1, p2, step_mask,
                dropout_mask)
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
    if tuple(p2.w_ih.shape) != (4 * H, H) \
            or not lstm_cuda.lstm2_fwd_ok(H, x.element_size(), B):
        ys1, h1T, c1T = lstm_layer(x, h0[0], c0[0], p1, step_mask,
                                   reset_mask, reset_src, allow_kernel=True)
        ys2, h2T, c2T = lstm_layer(ys1, h0[1], c0[1], p2, step_mask,
                                   reset_mask, reset_src, allow_kernel=True)
        return ys2, (h1T, h2T), (c1T, c2T)
    xg1 = (x.reshape(T * B, -1) @ p1.w_ih.to(dtype).t()
           + p1.b_ih.to(dtype)).reshape(T, B, 4 * H)
    f32 = torch.float32
    return lstm_cuda.lstm2_fwd(
        xg1.contiguous(), p1.w_hh.to(dtype).contiguous(),
        p1.b_hh.to(dtype).to(f32), p2.w_ih.to(dtype).contiguous(),
        p2.w_hh.to(dtype).contiguous(),
        (p2.b_ih + p2.b_hh).to(dtype).to(f32),
        h0[0], c0[0], h0[1], c0[1], step_mask, reset_mask, reset_src)


def _masked(h_old, h_new, keep):
    """The JAX ``_masked``: columns whose step mask is 0 keep ``h_old``."""
    return torch.where(keep.bool()[:, None], h_new, h_old)


def gru_layer(x, h0, p: LSTMParams, step_mask=None, reset_mask=None,
              reset_src=None):
    """Single-layer GRU, torch gate order [r, z, n] along the 3H rows:
    (T, B, in) -> ys (T, B, H), hT in x's dtype. n = tanh(x_n + r (h W_hn^T
    + b_hn)), h' = (1 - z) n + z h. ``step_mask`` and the packed resets
    (``reset_mask``, ``reset_src``) as in ``lstm_layer``."""
    dtype = x.dtype
    T, B, _ = x.shape
    w_hh_t = p.w_hh.to(dtype).t()
    b_hh = p.b_hh.to(dtype)
    xg = (x.reshape(T * B, -1) @ p.w_ih.to(dtype).t()
          + p.b_ih.to(dtype)).reshape(T, B, -1)
    h = h0.to(dtype)
    ys = []
    for t in range(T):
        if reset_mask is not None:
            h = lstm_cuda.apply_reset(h, reset_mask[t], reset_src)
        xr, xz, xn = xg[t].chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh_t + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        hn_ = (1.0 - z) * n + z * h
        h = hn_ if step_mask is None else _masked(h, hn_, step_mask[t])
        ys.append(h)
    return torch.stack(ys), h


def rnn_layer(x, h0, p: LSTMParams, nonlinearity: str = "tanh",
              step_mask=None, reset_mask=None, reset_src=None):
    """Single-layer vanilla RNN, h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)
    with act tanh or relu: (T, B, in) -> ys (T, B, H), hT in x's dtype;
    masks and resets as in ``gru_layer``."""
    if nonlinearity not in ("tanh", "relu"):
        raise ValueError(f"rnn_layer: nonlinearity {nonlinearity!r}, tanh "
                         "or relu")
    act = torch.tanh if nonlinearity == "tanh" else torch.relu
    dtype = x.dtype
    T, B, _ = x.shape
    w_hh_t = p.w_hh.to(dtype).t()
    b_hh = p.b_hh.to(dtype)
    xg = (x.reshape(T * B, -1) @ p.w_ih.to(dtype).t()
          + p.b_ih.to(dtype)).reshape(T, B, -1)
    h = h0.to(dtype)
    ys = []
    for t in range(T):
        if reset_mask is not None:
            h = lstm_cuda.apply_reset(h, reset_mask[t], reset_src)
        hn_ = act(xg[t] + h @ w_hh_t + b_hh)
        h = hn_ if step_mask is None else _masked(h, hn_, step_mask[t])
        ys.append(h)
    return torch.stack(ys), h
