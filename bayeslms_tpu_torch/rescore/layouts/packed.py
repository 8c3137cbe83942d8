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

Under a dp mesh each rank runs the same pass on its block: packed-carry
on a contiguous block of the chains, packed-nocarry on a contiguous block
of each device call's columns, each with a gather plan of its own; the
ranks' scores are then gathered (the JAX ``install_steps`` shard_map
bodies, ``layouts/steps.py``).

Under interpolation both run the second model beside the first, on the
same batch, from its own state of its own geometry (``nlayers``,
``nhid``, dtype), and score both models' states through one fused CE
(``common.fused_scores_packed``). The gates are the JAX package's without
its fused-CE switch, opt-outs included.
"""

from __future__ import annotations

import bisect
import os
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ...models.lstm_lm import init_hidden
from . import common


def carry_allowed(s) -> bool:
    """Packed-time carry-over, the JAX gate without its fused-CE switch
    (the port always fuses): the recurrent model with carry-over, a second
    model of the same family under interpolation, no MC, no XL, and
    ``BAYESLM_PACKED_CARRY`` not set to ``0``. An untied model takes it
    too, its ``decoder_w`` in the fused CE, where the JAX package's
    untied model leaves the fused CE and so this layout for
    slotted-carry; the scores are the same (ROADMAP.md C)."""
    rc = s.rcfg
    return (rc.carry_over and not s.is_tm
            and (s.interp == 0 or not s.cfg2.is_transformer)
            and rc.mc_samples == 0 and not rc.xl_mems
            and os.environ.get("BAYESLM_PACKED_CARRY", "1") != "0")


def nocarry_allowed(s) -> bool:
    """Bin-packed independent hypotheses, the JAX gate without its fused-CE
    switch: no MC, no XL, a same-family pair under interpolation, and
    ``BAYESLM_PACKED_TM`` (the Transformer) or ``BAYESLM_PACKED_NOCARRY``
    (the recurrent model) not set to ``0``. The registry sends every
    Transformer here first, whatever ``carry_over`` says, and the
    recurrent model without carry-over."""
    rc = s.rcfg
    env = "BAYESLM_PACKED_TM" if s.is_tm else "BAYESLM_PACKED_NOCARRY"
    return (rc.mc_samples == 0 and not rc.xl_mems
            and (s.interp == 0
                 or s.cfg2.is_transformer == s.cfg.is_transformer)
            and os.environ.get(env, "1") != "0")


def chain_state(cfg, G: int, device):
    """A zero (h, c), each (nlayers, G, nhid) in ``cfg``'s compute
    dtype."""
    return init_hidden(cfg.nlayers, G, cfg.nhid,
                       dtype=getattr(torch, cfg.compute_dtype), device=device)


def bcast(a, N: int):
    """(L, G, H) -> (L, G*N, H): each chain's state on its N columns."""
    L_, G_, H_ = a.shape
    return a[:, :, None, :].expand(L_, G_, N, H_).reshape(L_, G_ * N, H_)


def first_hyp(a, N: int):
    """(L, G*N, H) -> (L, G, H): column 0 of each chain (its first
    hypothesis), the state the chain carries on."""
    L_, B_, H_ = a.shape
    return a.reshape(L_, B_ // N, N, H_)[:, :, 0, :].contiguous()


def packed_carry_impl(s, data, tgt, mask, reset, carry, carry2, G: int,
                      N: int, n_seg: int, plan):
    """One chunk on the device. data/tgt/mask/reset (T, G*N); carry
    (h, c) each (L, G, H), carry2 the second model's under interpolation
    (its own geometry), else None; plan the CE gather plan. Returns the
    (n_seg,) scores and the next chunk's two carries."""
    B = data.shape[1]
    reset_src = (torch.arange(B, dtype=torch.int32, device=data.device)
                 // N) * N

    def run(model, c):
        hseq, (h, cc) = model(data, (bcast(c[0], N), bcast(c[1], N)),
                              step_mask=mask, reset_mask=reset,
                              reset_src=reset_src, return_hidden=True)
        return hseq.reshape(-1, hseq.shape[-1]), (first_hyp(h, N),
                                                  first_hyp(cc, N))

    hseq, carry = run(s.model, carry)
    hseq2 = None
    if s.interp:
        hseq2, carry2 = run(s.model2, carry2)
    scores = common.fused_scores_packed(s, hseq, tgt.reshape(-1), plan,
                                        n_seg, hseq2)
    return scores, carry, carry2


def score_carry_packed(s, nbest, word2idx, stream_fn=None, enc_all=None):
    rc = s.rcfg
    dev = s.device
    N = max((len(h) for h in nbest.values()), default=1)
    streams: "OrderedDict[str, list]" = OrderedDict()
    for k in nbest:
        label = stream_fn(k) if stream_fn else "_all"
        streams.setdefault(label, []).append(k)
    stream_keys = common.local_chains(s, list(streams.values()))
    G = len(stream_keys)
    U_total = max((len(sk) for sk in stream_keys), default=0)
    cap = rc.max_hyp_len
    carry = chain_state(s.cfg, G, dev)
    carry2 = chain_state(s.cfg2, G, dev) if s.interp else None
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
            for c, (x, y, nc, _) in enumerate(enc_all[k]):
                rows.append((g * N + c, x[:segT], y[:segT], nc))
                t_offs.append(off)
                seg_ids.append((u * G + g) * N + c)
            slot_key[(u, g)] = k
        data, tgt, mask, plan = common.build_rows(
            rows, T, G * N, t_offs, seg_ids)
        to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out, carry, carry2 = packed_carry_impl(
            s, to(data), to(tgt), to(mask), to(reset_np), carry, carry2, G,
            N, U * G * N, [to(a) for a in plan])
        pending.append((out, slot_key, U))

    for out, slot_key, U in pending:
        o = out.cpu().numpy().reshape(U, G, N)
        for (u, g), k in slot_key.items():
            for i in range(len(nbest[k])):
                scores[(k, i)] = float(o[u, g, i])
    return common.assemble(nbest, common.gather_scores(s, scores))


def tm_packed_impl(s, data, tgt, segs, positions, Bc: int, n_seg: int,
                   plan):
    """The Transformer's packed pass on the device. data, tgt, segs
    (segment ids, 0 on padding) and positions are (T, C), C a multiple of
    ``Bc``; one forward a block of ``Bc`` columns of each model, as the JAX
    scorer scans them; plan the CE gather plan. Returns the (n_seg,)
    scores."""
    T, C = data.shape
    dev = data.device
    tril = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    eye = torch.eye(T, dtype=torch.bool, device=dev)
    models = (s.model, s.model2) if s.interp else (s.model,)
    hs = ([], [])
    for c0 in range(0, C, Bc):
        sq = segs[:, c0:c0 + Bc].t()  # (b, T)
        same = sq[:, :, None] == sq[:, None, :]
        # causal within one's own segment; padding (segment 0) rows attend
        # to themselves too, so that their discarded softmax stays finite
        valid = (same & tril) | eye
        mask = torch.zeros(valid.shape, dtype=torch.float32, device=dev)
        mask = mask.masked_fill(~valid, float("-inf"))[:, None]
        for model, out in zip(models, hs):
            out.append(model(data[:, c0:c0 + Bc], return_hidden=True,
                             positions=positions[:, c0:c0 + Bc],
                             pack_mask=mask))
    h, h2 = (None if not o else torch.cat(o, dim=1).reshape(T * C, -1)
             for o in hs)
    return common.fused_scores_packed(s, h, tgt.reshape(-1), plan, n_seg,
                                      h2)


def rnn_packed_impl(s, data, tgt, mask, reset, Bc: int, n_seg: int, plan):
    """The LSTM's packed pass on the device. data, tgt, mask (the real
    steps) and reset (a hypothesis's first step past a column's first) are
    (T, C), C a multiple of ``Bc``; one forward a block of ``Bc`` columns
    of each model from a zero state, every reset taking source -1 (a zero
    state), as the JAX scorer scans them; plan the CE gather plan. Returns
    the (n_seg,) scores."""
    T, C = data.shape
    src = torch.full((Bc,), -1, dtype=torch.int32, device=data.device)
    models = [(s.model, s.cfg)] + ([(s.model2, s.cfg2)] if s.interp else [])
    hs = []
    for model, cfg in models:
        h0 = chain_state(cfg, Bc, data.device)
        out = []
        for b0 in range(0, C, Bc):
            cols = slice(b0, b0 + Bc)
            h, _ = model(data[:, cols], h0, step_mask=mask[:, cols],
                         reset_mask=reset[:, cols], reset_src=src,
                         return_hidden=True)
            out.append(h)
        hs.append(torch.cat(out, dim=1).reshape(T * C, -1))
    return common.fused_scores_packed(s, hs[0], tgt.reshape(-1), plan, n_seg,
                                      hs[1] if s.interp else None)


def score_packed_nocarry(s, nbest, word2idx, stream_fn=None, enc_all=None):
    """Every hypothesis on its own (no carry-over; ``stream_fn`` is not
    read), ``max_hyp_len``-capped, bin-packed best-fit-decreasing into
    columns of T = max(128, max_hyp_len + 2 rounded up to 64) steps, Bc
    columns a block as the JAX layout (about 24 x ``batch_size`` tokens a
    block): the Transformer with its segments and positions, the LSTM with
    a zero-state reset at each hypothesis's start."""
    rc = s.rcfg
    items = [(key, i, x, y, nc) for key in nbest
             for i, (x, y, nc, _) in enumerate(enc_all[key])]
    if not items:
        return common.assemble(nbest, {})
    cap = rc.max_hyp_len
    items = [(k, i, x[:cap], y[:cap], nc) for (k, i, x, y, nc) in items]
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
    # a device call's columns, a multiple of dp; this rank's block of each
    # call's columns is Bl wide
    dp, r = common.dp_block(s)
    Bc = max(8, -(-rc.batch_size * 24 // T // 8) * 8)
    Bc = -(-Bc // dp) * dp
    Bl = Bc // dp
    C = -(-len(fills) // Bc) * Bl
    mine = [i for i in range(len(items)) if place[i][0] % Bc // Bl == r]
    if not mine:
        return common.assemble(nbest, common.gather_scores(s, {}))
    tm = s.cfg.is_transformer
    rows, t_offs = [], []
    if tm:
        segs = np.zeros((T, C), np.int64)
        pos = np.zeros((T, C), np.int64)
    else:
        reset = np.zeros((T, C), np.uint8)
    for i in mine:
        _, _, x, y, nc = items[i]
        col, off, slot = place[i]
        col = col // Bc * Bl + col % Bl
        rows.append((col, x, y, nc))
        t_offs.append(off)
        if tm:
            L = min(len(x), T)
            segs[off:off + L, col] = slot + 1
            pos[off:off + L, col] = np.arange(L)
        elif off > 0:
            reset[off, col] = 1  # zero-state reset at the hypothesis's start
    data, tgt, mask, plan = common.build_rows(rows, T, C, t_offs,
                                              range(len(mine)))
    to = lambda a: torch.from_numpy(a).to(s.device)  # noqa: E731
    if tm:
        out = tm_packed_impl(s, to(data), to(tgt), to(segs), to(pos), Bl,
                             len(mine), [to(a) for a in plan])
    else:
        out = rnn_packed_impl(s, to(data), to(tgt), to(mask), to(reset), Bl,
                              len(mine), [to(a) for a in plan])
    out = out.cpu().numpy()
    scores = {items[i][:2]: float(out[n]) for n, i in enumerate(mine)}
    return common.assemble(nbest, common.gather_scores(s, scores))
