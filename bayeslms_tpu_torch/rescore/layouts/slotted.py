"""Slotted layouts, counterpart of ``bayeslms_tpu/rescore/layouts/slotted.py``:
one hypothesis a (bucketed T, column) slot.

- ``score_bucketed``: every hypothesis on its own, globally
  length-bucketed (``nbest.length_buckets``) into rows of ``batch_size``
  columns, one model call a row from a zero state and one fused-CE call
  (kernel row 2) a bucket. It also hosts MC-average scoring
  (``mc_samples`` > 0), in the form of the JAX ``mc_fused_impl``: for each
  draw k the hidden states of every row of a bucket, one row-2 call on
  the gathered real positions giving -log p_k(target), then
  score = -sum_t [logsumexp_k(-ce_k,t) - log K] in float32.
- ``score_carry``: the recurrent model with carry-over, chains side by
  side, utterances serial, one (T, G*N) call an utterance slot from the
  chain state broadcast over its N hypotheses; the chain carries its first
  hypothesis's state; one row-2 call a chunk of utterances.

Under a dp mesh each rank scores its block, as the packed layouts do:
``score_carry`` a contiguous block of the chains, ``score_bucketed`` a
contiguous block of each row's columns; MC stays whole on every rank, as
the JAX package keeps it unsharded.

The registry takes them where the packed layouts' gates refuse: MC, and
the opt-outs ``BAYESLM_PACKED_CARRY``, ``BAYESLM_PACKED_NOCARRY`` and
``BAYESLM_PACKED_TM`` set to ``0``, which let a check hold the packed
layouts against these. Every score goes through the fused CE, as
everywhere in the port; row 2's plain version is the CPU path.

MC draws: row j of the bucket of length T takes, for draw k, the noise of
``scorer.mc_noise(T, j, k)`` where the scorer has one (a callable giving
the eps the model's ``noise`` argument takes, in its call order; how a test
feeds the JAX package's draws), else the model draws from a
``torch.Generator`` seeded by (T, j, k) alone: the draws of a row do not
depend on the order in which rows and draws run.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict

import torch

from ..nbest import bucket_for, length_buckets
from . import common
from .packed import bcast, chain_state, first_hyp


def _hidden(model, is_tm: bool, data, hidden=None, step_mask=None, **kw):
    """One model's pre-decoder states of a (T, B) row (and, for the
    recurrent model, its new (h, c))."""
    if is_tm:
        return model(data, return_hidden=True, **kw), None
    return model(data, hidden, step_mask=step_mask, return_hidden=True,
                 **kw)


def _rows_hidden(model, cfg, data, mask, R: int, T: int):
    """The pre-decoder states of R rows of a slotted (R*T, B) batch, each
    row from a zero state: (R*T*B, H)."""
    is_tm = cfg.is_transformer
    h0 = None if is_tm else chain_state(cfg, data.shape[1], data.device)
    hs = [_hidden(model, is_tm, data[r * T:(r + 1) * T], h0,
                              None if is_tm else mask[r * T:(r + 1) * T])[0]
          for r in range(R)]
    return torch.cat(hs, dim=0).reshape(-1, hs[0].shape[-1])


def bucket_chunk_impl(s, data, tgt, mask, R: int, T: int, n_seg: int,
                      plan):
    """The rows of one bucket on the device: data/tgt/mask (R*T, Bc), row r
    at [r*T, (r+1)*T); plan the CE gather plan. One model call a row and
    model, one fused CE call. Returns the (n_seg,) scores."""
    h = _rows_hidden(s.model, s.cfg, data, mask, R, T)
    h2 = (_rows_hidden(s.model2, s.cfg2, data, mask, R, T)
          if s.interp else None)
    return common.fused_scores_packed(s, h, tgt.reshape(-1), plan, n_seg,
                                      h2)


def mc_seed(T: int, row: int, draw: int) -> int:
    """The generator seed of draw ``draw`` of row ``row`` of the bucket of
    length T."""
    return (T * 1_000_003 + row) * 1_009 + draw


def mc_fused_impl(s, data, tgt, mask, R: int, T: int, n_seg: int, plan):
    """MC-average scores of one bucket: for each of the K = ``mc_samples``
    draws, every row's hidden states under its own draw (``mc_noise`` or
    the generator of ``mc_seed``), non-deterministic, on the dropout-free
    model; one fused CE call a draw on the gathered positions. Returns
    the (n_seg,) scores -sum [logsumexp_k(-ce_k) - log K] per
    hypothesis."""
    K = s.rcfg.mc_samples
    dev = data.device
    is_tm = s.is_tm
    h0 = None if is_tm else chain_state(s.cfg, data.shape[1], dev)
    idx = plan[0]
    tsel = tgt.reshape(-1).index_select(0, idx)
    ces = []
    for k in range(K):
        hs = []
        for r in range(R):
            noise = None
            if s.mc_noise is not None:
                noise = [torch.as_tensor(e, device=dev)
                         for e in s.mc_noise(T, r, k)]
            gen = torch.Generator(device=dev).manual_seed(mc_seed(T, r, k))
            rows = slice(r * T, (r + 1) * T)
            hs.append(_hidden(
                s.model, is_tm, data[rows], h0,
                None if is_tm else mask[rows], deterministic=False,
                generator=gen, noise=noise)[0])
        h = torch.cat(hs, dim=0).reshape(-1, hs[0].shape[-1])
        ces.append(common.fused_ce_tokens(s, h.index_select(0, idx), None,
                                          tsel))
    lp = torch.logsumexp(-torch.stack(ces), dim=0) - math.log(K)
    return -common.segment_sums(lp, plan, n_seg)


def score_bucketed(s, nbest, word2idx, stream_fn=None, enc_all=None):
    """Global length buckets, ``batch_size`` columns a row; ``stream_fn``
    is not read. A hypothesis longer than ``max_hyp_len`` scores its first
    ``max_hyp_len`` tokens."""
    rc = s.rcfg
    items = [(key, i, x, y, nc) for key in nbest
             for i, (x, y, nc, _) in enumerate(enc_all[key])]
    buckets = length_buckets(rc.max_hyp_len)
    by_bucket: Dict[int, list] = {}
    for it in items:
        by_bucket.setdefault(bucket_for(len(it[2]), buckets), []).append(it)
    to = lambda a: torch.from_numpy(a).to(s.device)  # noqa: E731
    mc = rc.mc_samples > 0
    impl = mc_fused_impl if mc else bucket_chunk_impl
    # a row's columns, a multiple of dp; this rank's block of each row is
    # Bl wide (MC: the whole row on every rank)
    dp, r = (1, 0) if mc else common.dp_block(s)
    Bc = -(-rc.batch_size // dp) * dp
    Bl = Bc // dp
    pending = []
    for T, group in sorted(by_bucket.items()):
        R = -(-len(group) // Bc)
        mine = [i for i in range(len(group)) if i % Bc // Bl == r]
        if not mine:
            continue
        rows = [(i % Bl, group[i][2][:T], group[i][3][:T], group[i][4])
                for i in mine]
        data, tgt, mask, plan = common.build_rows(
            rows, R * T, Bl, [(i // Bc) * T for i in mine],
            range(len(mine)))
        pending.append((impl(s, to(data), to(tgt), to(mask), R, T,
                             len(mine), [to(a) for a in plan]),
                        [group[i] for i in mine]))
    scores = {}
    for out, group in pending:
        for v, (key, hid, *_) in zip(out.cpu().tolist(), group):
            scores[(key, hid)] = v
    if not mc:
        scores = common.gather_scores(s, scores)
    return common.assemble(nbest, scores)


def carry_chunk_impl(s, data, tgt, mask, carry, carry2, U: int, T: int,
                     N: int, n_seg: int, plan):
    """U serial utterance slots of G chains on the device: data/tgt/mask
    (U*T, G*N), slot u at [u*T, (u+1)*T); carry (h, c) each (L, G, H),
    carry2 the second model's (its own geometry) or None. One model call a
    slot and model, each hypothesis starting from its chain's state, the
    chain carrying its first hypothesis's; one fused CE call. Returns the
    (n_seg,) scores and the two carries."""

    def run(model, c):
        hs = []
        for u in range(U):
            rows = slice(u * T, (u + 1) * T)
            h, (hh, cc) = model(data[rows], (bcast(c[0], N), bcast(c[1], N)),
                                step_mask=mask[rows], return_hidden=True)
            hs.append(h)
            c = (first_hyp(hh, N), first_hyp(cc, N))
        return torch.cat(hs, dim=0).reshape(-1, hs[0].shape[-1]), c

    h, carry = run(s.model, carry)
    h2 = None
    if s.interp:
        h2, carry2 = run(s.model2, carry2)
    scores = common.fused_scores_packed(s, h, tgt.reshape(-1), plan, n_seg,
                                        h2)
    return scores, carry, carry2


def score_carry(s, nbest, word2idx, stream_fn=None, enc_all=None):
    """Chains (``stream_fn``'s labels, one chain by default) side by side,
    ``carry_chunk_utts`` utterances a chunk, each chunk at the length
    bucket of its longest hypothesis."""
    rc = s.rcfg
    buckets = length_buckets(rc.max_hyp_len)
    N = max((len(h) for h in nbest.values()), default=1)
    streams: "OrderedDict[str, list]" = OrderedDict()
    for k in nbest:
        label = stream_fn(k) if stream_fn else "_all"
        streams.setdefault(label, []).append(k)
    stream_keys = common.local_chains(s, list(streams.values()))
    G = len(stream_keys)
    U_total = max((len(sk) for sk in stream_keys), default=0)
    dev = s.device
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    carry = chain_state(s.cfg, G, dev)
    carry2 = chain_state(s.cfg2, G, dev) if s.interp else None
    pending = []
    U_CHUNK = max(1, min(rc.carry_chunk_utts, U_total))
    for st in range(0, U_total, U_CHUNK):
        U = min(U_CHUNK, U_total - st)
        chunk_max = max((len(x) for skeys in stream_keys
                         for k in skeys[st:st + U] for x, *_ in enc_all[k]),
                        default=1)
        T = bucket_for(chunk_max, buckets)
        rows, t_offs, seg_ids = [], [], []
        slot_key = {}
        for g, skeys in enumerate(stream_keys):
            for u in range(U):
                if st + u >= len(skeys):
                    continue
                k = skeys[st + u]
                for c, (x, y, nc, _) in enumerate(enc_all[k]):
                    rows.append((g * N + c, x[:T], y[:T], nc))
                    t_offs.append(u * T)
                    seg_ids.append((u * G + g) * N + c)
                slot_key[(u, g)] = k
        data, tgt, mask, plan = common.build_rows(rows, U * T, G * N, t_offs,
                                                  seg_ids)
        # a ragged tail's empty slots have all-zero masks: the chain's
        # state stays frozen through them
        out, carry, carry2 = carry_chunk_impl(
            s, to(data), to(tgt), to(mask), carry, carry2, U, T, N,
            U * G * N, [to(a) for a in plan])
        pending.append((out, slot_key, U))
    scores: Dict[tuple, float] = {}
    for out, slot_key, U in pending:
        o = out.cpu().numpy().reshape(U, G, N)
        for (u, g), k in slot_key.items():
            for i in range(len(nbest[k])):
                scores[(k, i)] = float(o[u, g, i])
    return common.assemble(nbest, common.gather_scores(s, scores))
