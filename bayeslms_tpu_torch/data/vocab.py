"""Vocabulary, counterpart of ``bayeslms_tpu/data/vocab.py``.

A Kaldi-style words.txt holds one "word index" pair per line; the first
occurrence of a word wins and ids follow file order (the index column is
ignored), as the reference's ``data.py:9-26``.
"""

from __future__ import annotations

from typing import Dict, List


class Vocab:
    """Word <-> id mapping."""

    def __init__(self) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: List[str] = []

    def _add(self, word: str) -> None:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1

    @classmethod
    def from_file(cls, path: str) -> "Vocab":
        v = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) != 2:
                    raise ValueError(f"bad vocab line: {line!r}")
                v._add(parts[0])
        return v

    @classmethod
    def from_words(cls, words) -> "Vocab":
        v = cls()
        for w in words:
            v._add(w)
        return v

    def encode(self, words, unk: str = "<unk>") -> List[int]:
        """Ids of ``words``; out-of-vocabulary words map to ``unk``."""
        unk_id = self.word2idx.get(unk)
        out = []
        for w in words:
            i = self.word2idx.get(w, unk_id)
            if i is None:
                raise KeyError(f"OOV {w!r} and no {unk!r} in vocab")
            out.append(i)
        return out

    def __len__(self) -> int:
        return len(self.idx2word)

    def __contains__(self, w: str) -> bool:
        return w in self.word2idx
