"""Shared building blocks of the scoring layouts, counterpart of
``bayeslms_tpu/rescore/layouts/common.py``: the host-side row builder with
its CE gather plan, the fused decoder CE over the gathered positions with
a segment sum per hypothesis, the Transformer's scores of one padded
(T, B) batch, and the assembly of scores per utterance.

The JAX package pads the gather plan to a multiple of 4096 entries to bound
its compile cache; PyTorch compiles nothing, so the plan here holds exactly
the real positions and no entry carries a zero weight.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ...ops import ce_cuda


def build_rows(rows, T: int, C: int, t_offs, seg_ids):
    """rows: list of (c, in_ids, tgt_ids) hypotheses, hypothesis i placed in
    column c from time step ``t_offs[i]`` on, cut at T.

    Returns (data, tgt, step_mask) as (T, C) numpy arrays and the CE gather
    plan (idx, seg): flat (t*C + c) positions of the targets and the score
    segment ``seg_ids[i]`` each belongs to. Every target is scored: the
    JAX package's exclusion of spliced-context targets comes with context
    splicing (ROADMAP.md queue A item 11)."""
    data = np.zeros((T * C,), np.int64)
    tgt = np.zeros((T * C,), np.int64)
    mask = np.zeros((T * C,), np.uint8)
    if not rows:
        empty = np.zeros((0,), np.int64)
        return (data.reshape(T, C), tgt.reshape(T, C), mask.reshape(T, C),
                (empty, empty))
    n_h = len(rows)
    lens = np.fromiter((min(len(r[1]), T) for r in rows), np.int64, count=n_h)
    tot = int(lens.sum())
    flat_in = np.fromiter((v for r, L in zip(rows, lens) for v in r[1][:L]),
                          np.int64, count=tot)
    flat_tg = np.fromiter((v for r, L in zip(rows, lens) for v in r[2][:L]),
                          np.int64, count=tot)
    off = np.cumsum(lens) - lens
    t_vec = (np.arange(tot, dtype=np.int64) - np.repeat(off, lens)
             + np.repeat(np.asarray(t_offs, np.int64), lens))
    c_vec = np.repeat(np.fromiter((r[0] for r in rows), np.int64, n_h), lens)
    dest = t_vec * C + c_vec
    data[dest] = flat_in
    tgt[dest] = flat_tg
    mask[dest] = 1
    seg_vec = np.repeat(np.asarray(seg_ids, np.int64), lens)
    return (data.reshape(T, C), tgt.reshape(T, C), mask.reshape(T, C),
            (dest, seg_vec))


def fused_scores_packed(model, flat_h, flat_tgt, idx, seg, n_seg: int):
    """Per-segment sums of the token CE at the gathered positions.

    flat_h (T*C, H) core outputs, flat_tgt (T*C,) targets, idx/seg the
    gather plan on the same device. Returns (n_seg,) float32."""
    ce = ce_cuda.fused_decode_ce(
        flat_h.index_select(0, idx).contiguous(), model.embedding,
        model.decoder_b, flat_tgt.index_select(0, idx))
    out = torch.zeros((n_seg,), dtype=torch.float32, device=ce.device)
    return out.index_add_(0, seg, ce)


def fused_scores(model, h, tgt, mask):
    """Per-column sums of the token CE of a padded batch: h (T, B, E)
    hidden states, tgt (T, B), mask (T, B) float32 over the real tokens.
    Returns (B,) float32."""
    T, B, E = h.shape
    ce = ce_cuda.fused_decode_ce(h.reshape(T * B, E).contiguous(),
                                 model.embedding, model.decoder_b,
                                 tgt.reshape(-1)).reshape(T, B)
    return (ce * mask).sum(dim=0)


def tm_scores(s, data, tgt, mask):
    """One (T, B) Transformer batch -> (B,) scores: hidden states, the
    fused CE (kernel row 2), the masked sums (the JAX ``tm_scores``' fused
    branch; the port always takes it)."""
    h = s.model(data, deterministic=True, return_hidden=True)
    return fused_scores(s.model, h, tgt, mask)


def assemble(nbest, scores):
    out = OrderedDict()
    for key, hyps in nbest.items():
        out[key] = [(hyp, scores[(key, i)]) for i, hyp in enumerate(hyps)]
    return out
