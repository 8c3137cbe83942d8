"""ctypes binding to the native tokenizer (``tools/src/tokenizer.cc``),
counterpart of ``bayeslms_tpu/data/native.py``.

- ``NativeTokenizer``: a words.txt vocabulary in C++; ``tokenize`` maps a
  text file to one int32 id stream in a single pass (per line its words and
  ``<s>``, OOV words to ``<unk>``; the reference's ``data.py:36-52``).
- ``NativeEncoder``: an arbitrary word -> id mapping in C++;
  ``encode_lines`` maps a newline-joined block of hypotheses to flat ids,
  offsets and OOV counts in one call (the N-best scorer's encode).

The library is compiled with g++ at first use into
``bayeslms_tpu_torch/_build/`` (``utils/host_build.py``). Unlike the JAX
module, which swallows a failed build and falls back to Python, a missing
compiler or a failed build raises with the compiler's message here; the
Python paths run only where the caller asks for them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..utils import host_build

_lib = None


def _load() -> ctypes.CDLL:
    """The tokenizer library, built if needed, loaded once."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(host_build.path(host_build.TOKENIZER))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.blm_vocab_load.restype = ctypes.c_void_p
    lib.blm_vocab_load.argtypes = [ctypes.c_char_p]
    lib.blm_vocab_free.argtypes = [ctypes.c_void_p]
    lib.blm_vocab_size.restype = ctypes.c_int64
    lib.blm_vocab_size.argtypes = [ctypes.c_void_p]
    lib.blm_tokenize.restype = ctypes.c_int64
    lib.blm_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(i32p)]
    lib.blm_free_ids.argtypes = [i32p]
    lib.blm_free_i64.argtypes = [i64p]
    lib.blm_vocab_from_pairs.restype = ctypes.c_void_p
    lib.blm_vocab_from_pairs.argtypes = [ctypes.c_char_p]
    lib.blm_encode_lines.restype = ctypes.c_int64
    lib.blm_encode_lines.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(i32p),
        ctypes.POINTER(i64p), ctypes.POINTER(i32p)]
    _lib = lib
    return lib


class _Handle:
    """A C++ vocabulary, freed with its owner."""

    def __init__(self, lib, vocab):
        self._lib = lib
        self._vocab = vocab

    def __del__(self):
        if getattr(self, "_vocab", None):
            self._lib.blm_vocab_free(self._vocab)


class NativeTokenizer(_Handle):
    """A words.txt vocabulary; ``tokenize`` returns int32 numpy arrays."""

    def __init__(self, words_txt: str):
        lib = _load()
        vocab = lib.blm_vocab_load(words_txt.encode())
        if not vocab:
            raise RuntimeError(f"failed to load vocab from {words_txt}")
        super().__init__(lib, vocab)

    def __len__(self) -> int:
        return int(self._lib.blm_vocab_size(self._vocab))

    def tokenize(self, text_path: str) -> np.ndarray:
        out = ctypes.POINTER(ctypes.c_int32)()
        n = self._lib.blm_tokenize(self._vocab, text_path.encode(),
                                   ctypes.byref(out))
        if n < 0:
            raise RuntimeError(f"native tokenize failed for {text_path}")
        try:
            return np.ctypeslib.as_array(out, shape=(n,)).copy() if n \
                else np.zeros((0,), np.int32)
        finally:
            self._lib.blm_free_ids(out)


class NativeEncoder(_Handle):
    """Batch hypothesis encoder over a word -> id mapping. ``encode_lines``
    maps a newline-joined block of hypotheses to (flat int32 ids, int64
    offsets, int32 OOV counts a line) in one C call; OOV words map to
    ``<unk>`` (id 0 without one) and are counted."""

    def __init__(self, lib, vocab, bos: int):
        super().__init__(lib, vocab)
        self.bos = bos

    @staticmethod
    def build(word2idx) -> "Optional[NativeEncoder]":
        """The encoder of ``word2idx``, or None where a word holds
        whitespace (the mapping cannot go through the "word id" lines the
        library reads): a property of the vocabulary, as in the JAX
        package. A failed build of the library raises."""
        lib = _load()
        if any(not isinstance(w, str) or " " in w or "\t" in w or "\n" in w
               for w in word2idx):
            return None
        buf = "\n".join(f"{w} {i}" for w, i in word2idx.items())
        vocab = lib.blm_vocab_from_pairs(buf.encode("utf-8"))
        if not vocab:
            raise RuntimeError("the native encoder refused the vocabulary")
        return NativeEncoder(lib, vocab, word2idx.get("<s>", 0))

    def encode_lines(self, text: str):
        ids_p = ctypes.POINTER(ctypes.c_int32)()
        offs_p = ctypes.POINTER(ctypes.c_int64)()
        oov_p = ctypes.POINTER(ctypes.c_int32)()
        n = self._lib.blm_encode_lines(
            self._vocab, text.encode("utf-8"), ctypes.byref(ids_p),
            ctypes.byref(offs_p), ctypes.byref(oov_p))
        try:
            offs = np.ctypeslib.as_array(offs_p, shape=(n + 1,)).copy()
            total = int(offs[-1])
            ids = (np.ctypeslib.as_array(ids_p, shape=(total,)).copy()
                   if total else np.zeros((0,), np.int32))
            oov = np.ctypeslib.as_array(oov_p, shape=(n,)).copy()
        finally:
            self._lib.blm_free_ids(ids_p)
            self._lib.blm_free_i64(offs_p)
            self._lib.blm_free_ids(oov_p)
        return ids, offs, oov
