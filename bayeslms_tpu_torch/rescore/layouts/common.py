"""Shared building blocks of the scoring layouts, counterpart of
``bayeslms_tpu/rescore/layouts/common.py``: the host-side row builder with
its CE gather plan, the fused decoder CE over the gathered positions with
a sum per hypothesis, the Transformer's scores of one padded (T, B) batch,
and the assembly of scores per utterance.

The JAX package pads the gather plan to a multiple of 4096 entries to bound
its compile cache; PyTorch compiles nothing, so the plan here holds exactly
the real positions and no entry carries a zero weight. A hypothesis's sum
is a row of a gathered (hypotheses, longest) matrix summed in a fixed
order, where the JAX ``segment_sum`` scatters: ``index_add_``'s atomic
adds on the card would give other bits from one pass to the next, and a
scores file printed at 4 decimals would change with them.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict

import numpy as np
import torch

from ...ops import ce_cuda


def build_rows(rows, T: int, C: int, t_offs, seg_ids):
    """rows: list of (c, in_ids, tgt_ids) hypotheses, hypothesis i placed in
    column c from time step ``t_offs[i]`` on, cut at T.

    Returns (data, tgt, step_mask) as (T, C) numpy arrays and the CE gather
    plan (idx, cols, segs): idx the flat (t*C + c) positions of the
    targets, hypothesis by hypothesis; cols (hypotheses, longest) the
    indices into idx of each hypothesis's targets, padded with len(idx);
    segs the score segment ``seg_ids[i]`` of each hypothesis. Every target
    is scored: the JAX package's exclusion of spliced-context targets comes
    with context splicing (ROADMAP.md queue A item 11)."""
    data = np.zeros((T * C,), np.int64)
    tgt = np.zeros((T * C,), np.int64)
    mask = np.zeros((T * C,), np.uint8)
    if not rows:
        empty = np.zeros((0,), np.int64)
        return (data.reshape(T, C), tgt.reshape(T, C), mask.reshape(T, C),
                (empty, np.zeros((0, 1), np.int64), empty))
    n_h = len(rows)
    lens = np.fromiter((min(len(r[1]), T) for r in rows), np.int64, count=n_h)
    tot = int(lens.sum())
    flat_in = _flat([r[1] for r in rows], lens, tot)
    flat_tg = _flat([r[2] for r in rows], lens, tot)
    off = np.cumsum(lens) - lens
    pos = np.arange(tot, dtype=np.int64) - np.repeat(off, lens)
    t_vec = pos + np.repeat(np.asarray(t_offs, np.int64), lens)
    c_vec = np.repeat(np.fromiter((r[0] for r in rows), np.int64, n_h), lens)
    dest = t_vec * C + c_vec
    data[dest] = flat_in
    tgt[dest] = flat_tg
    mask[dest] = 1
    cols = np.full((n_h, max(int(lens.max()), 1)), tot, np.int64)
    cols[np.repeat(np.arange(n_h), lens), pos] = np.arange(tot)
    return (data.reshape(T, C), tgt.reshape(T, C), mask.reshape(T, C),
            (dest, cols, np.asarray(seg_ids, np.int64)))


def _flat(seqs, lens, tot: int) -> np.ndarray:
    """The first ``lens[i]`` ids of every sequence, end to end, as int64:
    one concatenate of the native encoder's int32 views, one pass over
    ``encode_hyp``'s lists."""
    if isinstance(seqs[0], np.ndarray):
        return np.concatenate([s[:L] for s, L in zip(seqs, lens)]).astype(
            np.int64)
    return np.fromiter(itertools.chain.from_iterable(
        s[:L] for s, L in zip(seqs, lens)), np.int64, count=tot)


def fused_scores_packed(model, flat_h, flat_tgt, plan, n_seg: int):
    """Per-hypothesis sums of the token CE at the gathered positions.

    flat_h (T*C, H) core outputs, flat_tgt (T*C,) targets, plan the
    ``build_rows`` gather plan on the same device. Returns (n_seg,)
    float32, the same bits from every call on the same inputs."""
    idx, cols, segs = plan
    ce = ce_cuda.fused_decode_ce(
        flat_h.index_select(0, idx).contiguous(), model.embedding,
        model.decoder_b, flat_tgt.index_select(0, idx))
    ce = torch.cat([ce, ce.new_zeros((1,))])  # cols' padding reads this 0
    out = torch.zeros((n_seg,), dtype=torch.float32, device=ce.device)
    return out.index_copy_(0, segs, ce[cols].sum(dim=1))


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
