"""Packed layouts, counterpart of ``bayeslms_tpu/rescore/layouts/packed.py``
(single device):

- packed-carry (``carry_allowed``, ``packed_carry_impl``,
  ``score_carry_packed``), the LSTM with carry-over. Per chunk of
  ``carry_chunk_utts`` utterances: ONE (T, G*N) sequence, where chain g's
  utterances lie one after another along the time axis of its N columns,
  each at its exact (``max_hyp_len``-capped) length. A reset event at each
  utterance start gives every column of the chain the state of the chain's
  column 0, which is the previous utterance's FIRST hypothesis held at its
  true length by the step mask: the reference scorer's carry-over
  (compute_sentence_scores_bayes_jianwei.py:261-274). The GP-LSTM runs
  here too: its GP cell takes the JAX scan under the resets, its standard
  layer ``lstm_cuda.lstm_fwd`` with them (kernel row 3).
- packed-nocarry (``nocarry_allowed``, ``tm_packed_impl``,
  ``rnn_packed_impl``, ``score_packed_nocarry``), the Transformer and the
  LSTM without carry-over: independent hypotheses bin-packed
  best-fit-decreasing into columns of T steps. The Transformer's
  positions restart at each hypothesis and its attention is causal within
  it through an additive (B, 1, T, T) mask; the recurrent branch starts
  each hypothesis from a zero state, a reset event at its first step with
  source -1 (``lstm_cuda.apply_reset``; in kernel row 1, and row 3 for the
  GP-LSTM's standard layer, a -1 source reads zeros).
"""

from __future__ import annotations

import bisect
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ...models.lstm_lm import init_hidden
from . import common


def carry_allowed(s) -> bool:
    # the scorer refuses the other JAX gates' cases (interpolation, MC, XL)
    # at construction
    return s.rcfg.carry_over and not s.cfg.is_transformer


def nocarry_allowed(s) -> bool:
    # the JAX registry sends every Transformer here, whatever carry_over
    # says, and the LSTM without carry-over (the scorer refuses the other
    # JAX gates' cases, interpolation and MC, at construction)
    return s.cfg.is_transformer or not s.rcfg.carry_over


def packed_carry_impl(s, data, tgt, mask, reset, carry, G: int, N: int,
                      n_seg: int, plan):
    """One chunk on the device. data/tgt/mask/reset (T, G*N); carry
    (h, c) each (L, G, H); plan the CE gather plan. Returns the (n_seg,)
    scores and the next chunk's carry."""
    B = data.shape[1]

    def bcast(a):  # (L, G, H) -> (L, G*N, H), chain state on every column
        L_, G_, H_ = a.shape
        return a[:, :, None, :].expand(L_, G_, N, H_).reshape(L_, G_ * N, H_)

    def first_hyp(a):  # (L, G*N, H) -> (L, G, H), column 0 of each chain
        L_, B_, H_ = a.shape
        return a.reshape(L_, B_ // N, N, H_)[:, :, 0, :].contiguous()

    reset_src = (torch.arange(B, dtype=torch.int32, device=data.device)
                 // N) * N
    hseq, (h, c) = s.model(data, (bcast(carry[0]), bcast(carry[1])),
                           step_mask=mask, reset_mask=reset,
                           reset_src=reset_src, return_hidden=True)
    scores = common.fused_scores_packed(
        s.model, hseq.reshape(-1, hseq.shape[-1]), tgt.reshape(-1), plan,
        n_seg)
    return scores, (first_hyp(h), first_hyp(c))


def score_carry_packed(s, nbest, word2idx, stream_fn=None, enc_all=None):
    rc = s.rcfg
    dev = s.device
    N = max((len(h) for h in nbest.values()), default=1)
    streams: "OrderedDict[str, list]" = OrderedDict()
    for k in nbest:
        label = stream_fn(k) if stream_fn else "_all"
        streams.setdefault(label, []).append(k)
    stream_keys = list(streams.values())
    G = len(stream_keys)
    U_total = max((len(sk) for sk in stream_keys), default=0)
    cap = rc.max_hyp_len
    cdtype = getattr(torch, s.cfg.compute_dtype)
    carry = init_hidden(s.cfg.nlayers, G, s.cfg.nhid, dtype=cdtype, device=dev)
    scores: Dict[tuple, float] = {}
    pending = []
    U_CHUNK = max(1, min(rc.carry_chunk_utts, U_total))
    for st in range(0, U_total, U_CHUNK):
        U = min(U_CHUNK, U_total - st)
        # pass 1: per-chain segment offsets (exact capped lengths)
        segs = {}  # (g, u) -> (key, t_off, segT)
        t_pack = 1
        for g, skeys in enumerate(stream_keys):
            off = 0
            for u in range(U):
                if st + u >= len(skeys):
                    continue
                k = skeys[st + u]
                segT = min(max((len(x) for x, *_ in enc_all[k]), default=1),
                           cap)
                segs[(g, u)] = (k, off, segT)
                off += segT
            t_pack = max(t_pack, off)
        T = -(-t_pack // 64) * 64
        # pass 2: rows and reset events
        rows, t_offs, seg_ids = [], [], []
        reset_np = np.zeros((T, G * N), np.uint8)
        slot_key = {}
        for (g, u), (k, off, segT) in segs.items():
            if off > 0:
                reset_np[off, g * N:(g + 1) * N] = 1
            for c, (x, y, _, _) in enumerate(enc_all[k]):
                rows.append((g * N + c, x[:segT], y[:segT]))
                t_offs.append(off)
                seg_ids.append((u * G + g) * N + c)
            slot_key[(u, g)] = k
        data, tgt, mask, plan = common.build_rows(
            rows, T, G * N, t_offs, seg_ids)
        to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out, carry = packed_carry_impl(
            s, to(data), to(tgt), to(mask), to(reset_np), carry, G, N,
            U * G * N, [to(a) for a in plan])
        pending.append((out, slot_key, U))

    for out, slot_key, U in pending:
        o = out.cpu().numpy().reshape(U, G, N)
        for (u, g), k in slot_key.items():
            for i in range(len(nbest[k])):
                scores[(k, i)] = float(o[u, g, i])
    return common.assemble(nbest, scores)


def tm_packed_impl(s, data, tgt, segs, positions, Bc: int, n_seg: int,
                   plan):
    """The Transformer's packed pass on the device. data, tgt, segs
    (segment ids, 0 on padding) and positions are (T, C), C a multiple of
    ``Bc``; one forward a block of ``Bc`` columns, as the JAX scorer scans
    them; plan the CE gather plan. Returns the (n_seg,) scores."""
    T, C = data.shape
    dev = data.device
    tril = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    eye = torch.eye(T, dtype=torch.bool, device=dev)
    hs = []
    for c0 in range(0, C, Bc):
        sq = segs[:, c0:c0 + Bc].t()  # (b, T)
        same = sq[:, :, None] == sq[:, None, :]
        # causal within one's own segment; padding (segment 0) rows attend
        # to themselves too, so that their discarded softmax stays finite
        valid = (same & tril) | eye
        mask = torch.zeros(valid.shape, dtype=torch.float32, device=dev)
        mask = mask.masked_fill(~valid, float("-inf"))[:, None]
        hs.append(s.model(data[:, c0:c0 + Bc], return_hidden=True,
                          positions=positions[:, c0:c0 + Bc],
                          pack_mask=mask))
    h = torch.cat(hs, dim=1)
    return common.fused_scores_packed(s.model, h.reshape(T * C, -1),
                                      tgt.reshape(-1), plan, n_seg)


def rnn_packed_impl(s, data, tgt, mask, reset, Bc: int, n_seg: int, plan):
    """The LSTM's packed pass on the device. data, tgt, mask (the real
    steps) and reset (a hypothesis's first step past a column's first) are
    (T, C), C a multiple of ``Bc``; one forward a block of ``Bc`` columns
    from a zero state, every reset taking source -1 (a zero state), as the
    JAX scorer scans them; plan the CE gather plan. Returns the (n_seg,)
    scores."""
    T, C = data.shape
    cfg = s.cfg
    h0, c0 = init_hidden(cfg.nlayers, Bc, cfg.nhid,
                         dtype=getattr(torch, cfg.compute_dtype),
                         device=data.device)
    src = torch.full((Bc,), -1, dtype=torch.int32, device=data.device)
    hs = []
    for b0 in range(0, C, Bc):
        cols = slice(b0, b0 + Bc)
        h, _ = s.model(data[:, cols], (h0, c0), step_mask=mask[:, cols],
                       reset_mask=reset[:, cols], reset_src=src,
                       return_hidden=True)
        hs.append(h)
    h = torch.cat(hs, dim=1)
    return common.fused_scores_packed(s.model, h.reshape(T * C, -1),
                                      tgt.reshape(-1), plan, n_seg)


def score_packed_nocarry(s, nbest, word2idx, stream_fn=None, enc_all=None):
    """Every hypothesis on its own (no carry-over; ``stream_fn`` is not
    read), ``max_hyp_len``-capped, bin-packed best-fit-decreasing into
    columns of T = max(128, max_hyp_len + 2 rounded up to 64) steps, Bc
    columns a block as the JAX layout (about 24 x ``batch_size`` tokens a
    block): the Transformer with its segments and positions, the LSTM with
    a zero-state reset at each hypothesis's start."""
    rc = s.rcfg
    items = [(key, i, x, y) for key in nbest
             for i, (x, y, _, _) in enumerate(enc_all[key])]
    if not items:
        return common.assemble(nbest, {})
    cap = rc.max_hyp_len
    items = [(k, i, x[:cap], y[:cap]) for (k, i, x, y) in items]
    T = max(128, -(-(cap + 2) // 64) * 64)
    # best-fit decreasing: each hypothesis into the open column with the
    # smallest sufficient remaining room
    order = sorted(range(len(items)), key=lambda i: -len(items[i][2]))
    rems: list = []  # sorted (room left, column)
    fills = []  # per column [steps used, hypotheses]
    place = {}  # item -> (column, time offset, slot)
    for i in order:
        L = min(len(items[i][2]), T)
        j = bisect.bisect_left(rems, (L, -1))
        if j < len(rems):
            r, col = rems.pop(j)
        else:
            r, col = T, len(fills)
            fills.append([0, 0])
        used, slot = fills[col]
        place[i] = (col, used, slot)
        fills[col] = [used + L, slot + 1]
        if r - L > 0:
            bisect.insort(rems, (r - L, col))
    Bc = max(8, -(-rc.batch_size * 24 // T // 8) * 8)
    C = -(-len(fills) // Bc) * Bc
    tm = s.cfg.is_transformer
    rows, t_offs = [], []
    if tm:
        segs = np.zeros((T, C), np.int64)
        pos = np.zeros((T, C), np.int64)
    else:
        reset = np.zeros((T, C), np.uint8)
    for i, (_, _, x, y) in enumerate(items):
        col, off, slot = place[i]
        rows.append((col, x, y))
        t_offs.append(off)
        if tm:
            L = min(len(x), T)
            segs[off:off + L, col] = slot + 1
            pos[off:off + L, col] = np.arange(L)
        elif off > 0:
            reset[off, col] = 1  # zero-state reset at the hypothesis's start
    data, tgt, mask, plan = common.build_rows(rows, T, C, t_offs,
                                              range(len(items)))
    to = lambda a: torch.from_numpy(a).to(s.device)  # noqa: E731
    if tm:
        out = tm_packed_impl(s, to(data), to(tgt), to(segs), to(pos), Bc,
                             len(items), [to(a) for a in plan])
    else:
        out = rnn_packed_impl(s, to(data), to(tgt), to(mask), to(reset), Bc,
                              len(items), [to(a) for a in plan])
    out = out.cpu().numpy()
    scores = {(k, i): float(out[n]) for n, (k, i, _, _) in enumerate(items)}
    return common.assemble(nbest, scores)
