"""Transformer-XL cross-utterance memory layout (``RescoreConfig.xl_mems``),
counterpart of ``bayeslms_tpu/rescore/layouts/xl.py``.

Utterances stay serial per chain, as the LSTM's carry-over does: every
hypothesis of an utterance attends over memories built from the previous
utterance's FIRST hypothesis in its chain, with positions continuing from
the real memory length: the full-context scores of [prev; hyp]. Memory
lengths are bucketed by ``length_buckets`` (right-padded, ``mem_len``
masking). A chain's first utterance, and every memory build, is a plain
causal forward (kernel row 14 on the card); every score goes through the
fused CE (row 2). The inputs of every call are known on the host, so
nothing waits for the device until the one copy of all scores at the end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nbest import bucket_for, length_buckets, pad_batch
from . import common


def xl_mem_impl(s, data):
    """data (Mb, 1) right-padded previous-first-hypothesis ids -> one
    (Mb, 1, E) memory a layer (the layer inputs; causal attention keeps the
    real prefix exact whatever the padding)."""
    _, mems = s.model(data, deterministic=True, return_hidden=True,
                      return_mems=True)
    return mems


def xl_score_impl(s, data, tgt, ce_mask, mems, mem_len: int):
    """One utterance's (T, N) batch against its chain's memories, each
    broadcast over the N columns -> (N,) scores."""
    B = data.shape[1]
    mems_b = [m.expand(m.shape[0], B, m.shape[2]) for m in mems]
    h = s.model(data, deterministic=True, mems=mems_b, mem_len=mem_len,
                return_hidden=True)
    return common.fused_scores(s.model, h, tgt, ce_mask)


def _to(dev):
    """numpy -> device: through pinned memory without waiting on the card.
    A plain ``.to(dev)`` from pageable memory synchronises the stream, so
    the host would wait on every upload for the previous utterance's CE
    kernel and the card would then idle while the host issues the next
    forward."""
    if dev.type == "cuda":
        return lambda a: torch.from_numpy(a).pin_memory().to(
            dev, non_blocking=True)
    return lambda a: torch.from_numpy(a).to(dev)


def score_xl(s, nbest, word2idx, stream_fn=None, enc_all=None):
    rc = s.rcfg
    to = _to(s.device)
    buckets = length_buckets(rc.max_hyp_len)
    N = max((len(h) for h in nbest.values()), default=1)
    last: Dict[str, list] = {}  # chain label -> previous first-hyp ids
    pending = []  # (device scores, key, n_hyps)
    for k, hyps in nbest.items():
        label = stream_fn(k) if stream_fn else "_all"
        enc = enc_all[k]
        T = bucket_for(max(len(x) for x, _, _, _ in enc), buckets)
        data, tgt, mask, _ = pad_batch([x for x, *_ in enc],
                                       [y for _, y, *_ in enc], T, N)
        data, tgt, mask = to(data.astype(np.int64)), \
            to(tgt.astype(np.int64)), to(mask)
        prev = last.get(label)
        if prev is None:
            out = common.tm_scores(s, data, tgt, mask)
        else:
            Mb = bucket_for(len(prev), buckets)
            pdata = np.zeros((Mb, 1), np.int64)
            pdata[:len(prev), 0] = prev
            mems = xl_mem_impl(s, to(pdata))
            out = xl_score_impl(s, data, tgt, mask, mems, min(len(prev), Mb))
        pending.append((out, k, len(hyps)))
        if enc:
            # an over-long previous utterance keeps BOS and its TRAILING
            # tokens (the words next to the next utterance)
            ids = list(enc[0][0])
            if len(ids) > rc.max_hyp_len:
                ids = [ids[0]] + ids[-(rc.max_hyp_len - 1):]
            last[label] = ids
    scores: Dict[tuple, float] = {}
    if pending:
        got = torch.stack([o for o, _, _ in pending]).cpu().numpy()
        for row, (_, k, n) in zip(got, pending):
            for i in range(n):
                scores[(k, i)] = float(row[i])
    return common.assemble(nbest, scores)
