"""N-best list I/O and hypothesis encoding, counterpart of
``bayeslms_tpu/rescore/nbest.py``.

File formats are those of the reference scorer
(compute_sentence_scores_bayes_jianwei.py): input lines ``utt-N word ...``,
output lines ``utt-N score`` with 4 decimals. Keys group by everything
before the last ``-``. The native batch encoder of the JAX package
(``data/native.py``) is ROADMAP.md queue A item 2.
"""

from __future__ import annotations

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
