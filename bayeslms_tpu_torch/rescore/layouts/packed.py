"""Packed-time carry-over layout, counterpart of
``bayeslms_tpu/rescore/layouts/packed.py`` (``carry_allowed``,
``packed_carry_impl``, ``score_carry_packed``; single device).

Per chunk of ``carry_chunk_utts`` utterances: ONE (T, G*N) sequence, where
chain g's utterances lie one after another along the time axis of its N
columns, each at its exact (``max_hyp_len``-capped) length. A reset event
at each utterance start gives every column of the chain the state of the
chain's column 0, which is the previous utterance's FIRST hypothesis held
at its true length by the step mask: the reference scorer's carry-over
(compute_sentence_scores_bayes_jianwei.py:261-274).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from ...models.lstm_lm import init_hidden
from . import common


def carry_allowed(s) -> bool:
    # the scorer refuses the other JAX gates' cases (Transformer,
    # interpolation, MC, XL) at construction
    return s.rcfg.carry_over


def packed_carry_impl(s, data, tgt, mask, reset, carry, G: int, N: int,
                      n_seg: int, idx, seg):
    """One chunk on the device. data/tgt/mask/reset (T, G*N); carry
    (h, c) each (L, G, H); idx/seg the CE gather plan. Returns the (n_seg,)
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
        s.model, hseq.reshape(-1, hseq.shape[-1]), tgt.reshape(-1), idx, seg,
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
        data, tgt, mask, (idx, seg) = common.build_rows(
            rows, T, G * N, t_offs, seg_ids)
        to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out, carry = packed_carry_impl(
            s, to(data), to(tgt), to(mask), to(reset_np), carry, G, N,
            U * G * N, to(idx), to(seg))
        pending.append((out, slot_key, U))

    for out, slot_key, U in pending:
        o = out.cpu().numpy().reshape(U, G, N)
        for (u, g), k in slot_key.items():
            for i in range(len(nbest[k])):
                scores[(k, i)] = float(o[u, g, i])
    return common.assemble(nbest, scores)
