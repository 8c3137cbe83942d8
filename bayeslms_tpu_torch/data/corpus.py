"""Corpus loading and batch layout, counterpart of
``bayeslms_tpu/data/corpus.py`` (numpy only).

- ``Corpus``: per line, append ``<s>``, map OOV words to ``<unk>`` and
  concatenate all lines into one id stream (reference ``data.py:36-52``),
  through the native C++ tokenizer (``data/native.py``) unless the caller
  asks for the Python path with ``use_native=False``; both give the same
  ids. A failed build of the tokenizer raises (the JAX package falls back
  to Python without a word).
- ``batchify``: trim the stream to ``(len // bsz) * bsz`` tokens and lay it
  out as ``(rows, bsz)``, one contiguous stream per column
  (``train.py:167-179``).
- ``get_batch``: input window ``[i, i + seq_len)`` and target window
  ``[i + 1, i + 1 + seq_len)`` (``train.py:299-303``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .vocab import Vocab


class Corpus:
    """Train/valid/test id streams built from text files and words.txt."""

    def __init__(self, path: str, use_native: bool = True) -> None:
        words_txt = os.path.join(path, "words.txt")
        self.vocab = Vocab.from_file(words_txt)
        self._native = None
        if use_native:
            from .native import NativeTokenizer

            self._native = NativeTokenizer(words_txt)
        self.train = self.tokenize(os.path.join(path, "train.txt"))
        self.valid = self.tokenize(os.path.join(path, "valid.txt"))
        self.test = self.tokenize(os.path.join(path, "test.txt"))

    def tokenize(self, path: str) -> np.ndarray:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if self._native is not None:
            return self._native.tokenize(path)
        ids = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                ids.extend(self.vocab.encode(line.split() + ["<s>"]))
        return np.asarray(ids, dtype=np.int32)


def batchify(stream: np.ndarray, bsz: int) -> np.ndarray:
    """(tokens,) -> (tokens // bsz, bsz), column-per-stream layout."""
    nbatch = stream.shape[0] // bsz
    return stream[: nbatch * bsz].reshape(bsz, nbatch).T.copy()


def get_batch(source: np.ndarray, i: int,
              seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window [i, i + seq_len) of a batchified (rows, bsz) array and its
    targets, each (L, bsz) time-major; L < seq_len at the ragged end."""
    L = min(seq_len, source.shape[0] - 1 - i)
    return source[i: i + L], source[i + 1: i + 1 + L]


def windows(source: np.ndarray, seq_len: int, drop_ragged: bool = True):
    """All full-length windows stacked, (N, seq_len, bsz) inputs and
    targets. With ``drop_ragged=False`` the ragged final window (the
    reference iterates ``range(0, rows - 1, seq_len)``) comes back as a
    third value, ``(data, target)`` or None."""
    rows, bsz = source.shape
    starts = [i for i in range(0, rows - 1, seq_len) if i + seq_len + 1 <= rows]
    empty = np.zeros((0, seq_len, bsz), dtype=source.dtype)
    data = np.stack([source[i: i + seq_len] for i in starts]) if starts else empty
    tgt = (np.stack([source[i + 1: i + 1 + seq_len] for i in starts])
           if starts else empty.copy())
    if drop_ragged:
        return data, tgt
    tail_start = starts[-1] + seq_len if starts else 0
    tail = get_batch(source, tail_start, seq_len) if tail_start < rows - 1 else None
    return data, tgt, tail


def apply_data_fraction(stream: np.ndarray, fraction: float) -> np.ndarray:
    """The first ``fraction`` of the stream (reference --mark base-0.Xset,
    train.py:151-165)."""
    if fraction >= 1.0:
        return stream
    return stream[: int(len(stream) * fraction)]
