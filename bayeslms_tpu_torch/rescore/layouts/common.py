"""Shared building blocks of the scoring layouts, counterpart of
``bayeslms_tpu/rescore/layouts/common.py``: the host-side row builder with
its CE gather plan, the interpolated decoder's constants (``interp_m2``),
the fused decoder CE over the gathered positions (``fused_ce_tokens``,
interpolation-aware) with a sum per hypothesis, the Transformer's scores
of one padded (T, B) batch, the assembly of scores per utterance, and,
under a dp mesh, each rank's block of the work and the gather of the
ranks' scores (``dp_block``, ``local_chains``, ``gather_scores``).

Interpolation with a second model of the same family takes the fused CE
as in the JAX package: logit interpolation (``inter_flag`` 1) is one call
on the concatenated hidden states [h1, h2] against the pre-scaled
decoder concat(a W1, (1 - a) W2), since a h1 W1' + (1 - a) h2 W2' =
[h1, h2] concat(a W1, (1 - a) W2)'; score interpolation (2) is two calls
combined as a ce1 + (1 - a) ce2.

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
    """rows: list of (c, in_ids, tgt_ids[, n_ctx]) hypotheses, hypothesis i
    placed in column c from time step ``t_offs[i]`` on, cut at T. A
    slotted (R, T_r, C) batch is the (R * T_r, C) one with ``t_offs[i]`` =
    r * T_r and its rows cut at T_r beforehand.

    Returns (data, tgt, step_mask) as (T, C) numpy arrays and the CE gather
    plan (idx, cols, segs): idx the flat (t*C + c) positions of the scored
    targets, hypothesis by hypothesis; cols (hypotheses, longest) the
    indices into idx of each hypothesis's targets, padded with len(idx);
    segs the score segment ``seg_ids[i]`` of each hypothesis. A target at a
    position below ``n_ctx`` WITHIN its hypothesis (spliced context) sits
    in the batch and conditions the model but is not scored; the test reads
    the local position, never the packed time."""
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
    n_ctx = np.minimum(np.fromiter(
        (r[3] if len(r) > 3 else 0 for r in rows), np.int64, n_h), lens)
    keep = pos >= np.repeat(n_ctx, lens)  # context is not scored
    k_lens = lens - n_ctx
    n_keep = int(k_lens.sum())
    k_pos = (np.arange(n_keep, dtype=np.int64)
             - np.repeat(np.cumsum(k_lens) - k_lens, k_lens))
    cols = np.full((n_h, max(int(k_lens.max()), 1)), n_keep, np.int64)
    cols[np.repeat(np.arange(n_h), k_lens), k_pos] = np.arange(n_keep)
    return (data.reshape(T, C), tgt.reshape(T, C), mask.reshape(T, C),
            (dest[keep], cols, np.asarray(seg_ids, np.int64)))


def _flat(seqs, lens, tot: int) -> np.ndarray:
    """The first ``lens[i]`` ids of every sequence, end to end, as int64:
    one concatenate of the native encoder's int32 views, one pass over
    ``encode_hyp``'s lists."""
    if isinstance(seqs[0], np.ndarray):
        return np.concatenate([s[:L] for s, L in zip(seqs, lens)]).astype(
            np.int64)
    return np.fromiter(itertools.chain.from_iterable(
        s[:L] for s, L in zip(seqs, lens)), np.int64, count=tot)


def interp_m2(s, params, params2):
    """The decoder constants of the fused interpolated CE, built once per
    scorer from the two parameter trees (float32): for ``inter_flag`` 1 the
    pre-scaled concatenated decoder concat(a W1, (1 - a) W2) (V, D1 + D2),
    scaled in float32 and stored in the compute dtype, and the mixed bias
    a b1 + (1 - a) b2 in float32; for flag 2 the second model's decoder.
    Each model's decoder weight W is its tied embedding or its untied
    ``decoder_w``. None without interpolation."""
    if not s.interp:
        return None
    m2 = s.model2
    if s.interp == 2:
        return m2.decoder_weight, m2.decoder_b
    a = float(s.rcfg.inter_alpha)
    dev = s.model.embedding.device

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    def dec(tree, cfg):
        return tree["embedding"] if cfg.tied else tree["decoder_w"]

    W = torch.cat([a * f32(dec(params, s.cfg)),
                   (1.0 - a) * f32(dec(params2, s.cfg2))], dim=1)
    b = a * f32(params["decoder_b"]) + (1.0 - a) * f32(params2["decoder_b"])
    return W.to(s.model.decoder_weight.dtype).contiguous(), b


def fused_ce_tokens(s, hsel, h2sel, tsel):
    """Per-token CE (kernel row 2) at the gathered positions: hsel (M, D1)
    the first model's hidden states, h2sel (M, D2) the second's (None
    without interpolation), tsel (M,) the targets. Returns (M,) float32."""
    m = s.model
    if s.interp == 1:
        W, b = s.m2
        hcat = torch.cat([hsel, h2sel.to(hsel.dtype)], dim=1).contiguous()
        return ce_cuda.fused_decode_ce(hcat, W, b, tsel)
    ce = ce_cuda.fused_decode_ce(hsel.contiguous(), m.decoder_weight,
                                 m.decoder_b, tsel)
    if s.interp == 2:
        a = float(s.rcfg.inter_alpha)
        W, b = s.m2
        ce2 = ce_cuda.fused_decode_ce(h2sel.to(hsel.dtype).contiguous(), W,
                                      b, tsel)
        return a * ce + (1.0 - a) * ce2
    return ce


def segment_sums(ce, plan, n_seg: int):
    """(n_seg,) float32: each hypothesis's sum of its token values ``ce``
    (in the order of the plan's idx), a row of the gathered (hypotheses,
    longest) matrix summed in a fixed order; segments without a
    hypothesis read 0."""
    _, cols, segs = plan
    ce = torch.cat([ce, ce.new_zeros((1,))])  # cols' padding reads this 0
    out = torch.zeros((n_seg,), dtype=torch.float32, device=ce.device)
    return out.index_copy_(0, segs, ce[cols].sum(dim=1))


def fused_scores_packed(s, flat_h, flat_tgt, plan, n_seg: int,
                        flat_h2=None):
    """Per-hypothesis sums of the token CE at the gathered positions.

    flat_h (T*C, H) core outputs, flat_h2 the second model's (T*C, H2)
    under interpolation, flat_tgt (T*C,) targets, plan the ``build_rows``
    gather plan on the same device. Returns (n_seg,) float32, the same
    bits from every call on the same inputs."""
    idx = plan[0]
    h2sel = None if flat_h2 is None else flat_h2.index_select(0, idx)
    ce = fused_ce_tokens(s, flat_h.index_select(0, idx), h2sel,
                         flat_tgt.index_select(0, idx))
    return segment_sums(ce, plan, n_seg)


def fused_scores(model, h, tgt, mask):
    """Per-column sums of the token CE of a padded batch: h (T, B, E)
    hidden states, tgt (T, B), mask (T, B) float32 over the real tokens.
    Returns (B,) float32."""
    T, B, E = h.shape
    ce = ce_cuda.fused_decode_ce(h.reshape(T * B, E).contiguous(),
                                 model.decoder_weight, model.decoder_b,
                                 tgt.reshape(-1)).reshape(T, B)
    return (ce * mask).sum(dim=0)


def tm_scores(s, data, tgt, mask):
    """One (T, B) Transformer batch -> (B,) scores: hidden states, the
    fused CE (kernel row 2), the masked sums (the JAX ``tm_scores``' fused
    branch; the port always takes it)."""
    h = s.model(data, deterministic=True, return_hidden=True)
    return fused_scores(s.model, h, tgt, mask)


def dp_block(s):
    """(dp ranks, this rank's index among them): (1, 0) without a mesh.
    The tp ranks of a mesh score their dp rank's block alike."""
    m = s.mesh
    return (1, 0) if m is None else (m.dp, m.dp_index)


def local_chains(s, stream_keys):
    """This rank's contiguous block of the carry-over chains: the chain
    list padded with empty chains to a multiple of dp (so that a chain
    never crosses ranks, as the JAX layouts pad), cut into dp blocks."""
    dp, i = dp_block(s)
    keys = list(stream_keys) + [[]] * (-len(stream_keys) % dp)
    g = len(keys) // dp
    return keys[i * g:(i + 1) * g]


def gather_scores(s, scores: dict) -> dict:
    """Every dp rank's {(utt, hyp): score}, merged on every rank."""
    if dp_block(s)[0] == 1:
        return scores
    from ...parallel.mesh import gather_object

    out = {}
    for part in gather_object(s.mesh, scores, "dp"):
        out.update(part)
    return out


def assemble(nbest, scores):
    out = OrderedDict()
    for key, hyps in nbest.items():
        out[key] = [(hyp, scores[(key, i)]) for i, hyp in enumerate(hyps)]
    return out
