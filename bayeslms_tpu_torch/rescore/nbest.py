"""N-best list I/O and hypothesis encoding, counterpart of
``bayeslms_tpu/rescore/nbest.py``.

File formats are those of the reference scorer
(compute_sentence_scores_bayes_jianwei.py): input lines ``utt-N word ...``,
output lines ``utt-N score`` with 4 decimals. Keys group by everything
before the last ``-``. ``encode_all_native`` encodes a whole N-best set
in one call of the native encoder (``data/native.py``); ``encode_hyp``,
one hypothesis in Python, is its plain version and gives the same ids.
``text_nbest`` builds an N-best set in the bench's shape from real text.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np


def load_nbest(path: str) -> "OrderedDict[str, List[str]]":
    nbest: "OrderedDict[str, List[str]]" = OrderedDict()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            try:
                key, hyp = line.split(" ", 1)
            except ValueError:
                key, hyp = line, " "
            key = key.rsplit("-", 1)[0]
            nbest.setdefault(key, []).append(hyp)
    return nbest


SPECIAL_WORDS = ("<s>", "</s>", "<unk>")


def text_nbest(lines: List[str], words: List[str], n_recordings: int = 30,
               utts: int = 10, n_hyps: int = 20, max_words: int = 40,
               seed: int = 0) -> "OrderedDict[str, List[str]]":
    """An N-best set in the JAX bench's shape (``bench.py``
    ``make_synthetic_nbest``: recordings of serial utterances, ``n_hyps``
    hypotheses each) from real text: utterance u of recording m
    (``meet{m}_utt{u}``) is ``lines[utts m + u]`` clipped to ``max_words``
    words; its hypothesis 0 is that line, and each other hypothesis
    replaces 1 to 3 of its words (fewer in a shorter line) with words
    drawn from ``words`` less ``SPECIAL_WORDS``, by
    ``np.random.default_rng(seed)``, utterance by utterance."""
    pool = [w for w in words if w not in SPECIAL_WORDS]
    rng = np.random.default_rng(seed)
    nbest: "OrderedDict[str, List[str]]" = OrderedDict()
    for m in range(n_recordings):
        for u in range(utts):
            ref = lines[utts * m + u].split()[:max_words]
            hyps = [" ".join(ref)]
            for _ in range(n_hyps - 1):
                hyp = list(ref)
                k = min(int(rng.integers(1, 4)), len(hyp))
                for i in rng.choice(len(hyp), size=k, replace=False):
                    hyp[i] = pool[int(rng.integers(len(pool)))]
                hyps.append(" ".join(hyp))
            nbest[f"meet{m}_utt{u}"] = hyps
    return nbest


def write_scores(nbest_and_scores, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for key, pairs in nbest_and_scores.items():
            for idx, (_, score) in enumerate(pairs, 1):
                f.write("%s-%d %.4f\n" % (key, idx, score))


def encode_hyp(
    hyp: str,
    word2idx: Dict[str, int],
    bos: str = "<s>",
    unk: str = "<unk>",
    backward: bool = False,
    context: str = "",
    splice_len: int = 0,
):
    """'<s> w1 ... wn' input ids and 'w1 ... wn <s>' target ids.

    ``backward`` reverses the word order; ``context``/``splice_len`` put up
    to splice_len trailing context words between <s> and the hypothesis,
    and ``n_ctx`` counts the target positions to leave out of the score.
    ``n_oov`` counts words (context and hypothesis) mapped to ``<unk>``.
    Returns (inp, tgt, n_ctx, n_oov).
    """
    words = hyp.split()
    if backward:
        words = words[::-1]
    ctx_words = context.split()[-splice_len:] if (context and splice_len) else []
    unk_id = word2idx.get(unk, 0)
    # -1 marks OOV (vocab ids are non-negative): one dict scan per word
    ids = [word2idx.get(w, -1) for w in words]
    ctx_ids = [word2idx.get(w, -1) for w in ctx_words]
    n_oov = ids.count(-1) + ctx_ids.count(-1)
    if n_oov:
        ids = [unk_id if i < 0 else i for i in ids]
        ctx_ids = [unk_id if i < 0 else i for i in ctx_ids]
    bos_id = word2idx.get(bos, 0)
    inp = [bos_id] + ctx_ids + ids
    tgt = ctx_ids + ids + [bos_id]
    return inp, tgt, len(ctx_ids), n_oov


def encode_all_native(nbest, enc, backward: bool = False):
    """``encode_hyp`` of every hypothesis of ``nbest`` without context, in
    ONE call of the native encoder ``enc`` (``NativeEncoder``) over the
    whole set; the <s> framing is numpy scatters. The same (inp, tgt, 0,
    n_oov) tuples as ``encode_hyp``, with inp and tgt int32 views into two
    shared flat buffers. Returns {utt_key: [(inp, tgt, 0, n_oov), ...]}."""
    keys = list(nbest)
    all_hyps = [h for k in keys for h in nbest[k]]
    if not all_hyps:
        return {k: [] for k in keys}
    ids, offs, oov = enc.encode_lines("\n".join(all_hyps))
    n = len(all_hyps)
    N = ids.shape[0]
    offs = offs.astype(np.int64)
    hyp_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(offs))
    pos = np.arange(N, dtype=np.int64)
    if backward:
        # the word order reversed within each hypothesis
        ids = ids[offs[hyp_of] + (offs[hyp_of + 1] - 1 - pos)]
    # hypothesis i spans [offs[i] + i, offs[i + 1] + i + 1) of both buffers:
    # <s> then its ids (inp), its ids then <s> (tgt)
    arange_n = np.arange(n, dtype=np.int64)
    starts = offs[:-1] + arange_n
    ends = offs[1:] + arange_n + 1
    inp_flat = np.empty(N + n, np.int32)
    tgt_flat = np.empty(N + n, np.int32)
    inp_flat[pos + hyp_of + 1] = ids
    inp_flat[starts] = enc.bos
    tgt_flat[pos + hyp_of] = ids
    tgt_flat[ends - 1] = enc.bos
    out, i = {}, 0
    for k in keys:
        c = len(nbest[k])
        out[k] = [(inp_flat[starts[j]:ends[j]], tgt_flat[starts[j]:ends[j]],
                   0, int(oov[j])) for j in range(i, i + c)]
        i += c
    return out


def length_buckets(max_len: int, n_buckets: int = 5) -> List[int]:
    """Up to ``n_buckets`` geometrically spaced bucket boundaries from 16 to
    ``max_len``, rounded up to multiples of 8."""
    if max_len <= 16:
        return [max_len]
    out = []
    for i in range(n_buckets):
        b = 16.0 * (max_len / 16.0) ** (i / (n_buckets - 1))
        b = min(int(-(-b // 8) * 8), max_len)
        if not out or b > out[-1]:
            out.append(b)
    if out[-1] != max_len:
        out.append(max_len)
    return out


def bucket_for(length: int, buckets) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_batch(seqs_in: List[List[int]], seqs_tgt: List[List[int]], T: int,
              B: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Pad to a (T, B) time-major batch: (data, tgt, float32 mask of the
    real tokens, lengths), each sequence cut at T."""
    n = len(seqs_in)
    assert n <= B
    data = np.zeros((T, B), np.int32)
    tgt = np.zeros((T, B), np.int32)
    mask = np.zeros((T, B), np.float32)
    lens = np.zeros((B,), np.int32)
    for j, (x, y) in enumerate(zip(seqs_in, seqs_tgt)):
        L = min(len(x), T)
        data[:L, j] = x[:L]
        tgt[:L, j] = y[:L]
        mask[:L, j] = 1.0
        lens[j] = L
    return data, tgt, mask, lens


def rewrite_nbest(words_path: str, out_dir: str, max_n: int = 20) -> int:
    """Split an N-best words archive into one file a rank: lines "utt-N w1
    w2 ..." go to ``out_dir/words.<N>`` as "utt w1 w2 ..." for N <=
    ``max_n`` (the reference's word2vec.ipynb ``rewrite_nbest``). Returns
    the number of ranks written."""
    os.makedirs(out_dir, exist_ok=True)
    handles = {}
    try:
        with open(words_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(" ", 1)
                if not parts[0]:
                    continue
                utt, n = parts[0].rsplit("-", 1)
                n = int(n)
                if n > max_n:
                    continue
                if n not in handles:
                    handles[n] = open(os.path.join(out_dir, f"words.{n}"),
                                      "w", encoding="utf-8")
                rest = parts[1] if len(parts) > 1 else ""
                handles[n].write(f"{utt} {rest}\n")
    finally:
        for h in handles.values():
            h.close()
    return len(handles)
