"""Build the repository's C++ host programs (``tools/src/``) with g++ at
first use.

The native tokenizer library (``tokenizer.cc``: the corpus tokenizer and
the N-best batch encoder, bound in ``data/native.py``) and the lattice
pipeline's tools (``lattice_to_nbest``, ``arpa_score``, ``int2sym``,
``nbest_to_lattice``, ``wer``, ``lattice_copy``; run by
``rescore/pipeline.py``) are compiled with the flags of ``tools/Makefile``
into ``bayeslms_tpu_torch/_build/``, beside the CUDA kernels
(``ops/_build.py``). A program is named after a hash of its source, the
headers under ``tools/src/`` and the flags, so an unchanged source is not
built again. Every missing program of one call builds at once, through
the kernels' ``compile_all``. A missing compiler or a failed build raises
with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, Iterable

from ..ops._build import BUILD_DIR, compile_all

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tools", "src")
CXXFLAGS = ["-O2", "-std=c++17", "-Wall", "-Wextra"]  # tools/Makefile:5
TOKENIZER = "tokenizer"
TOOLS = ("lattice_to_nbest", "arpa_score", "int2sym", "nbest_to_lattice",
         "wer", "lattice_copy")


def _source(name: str) -> str:
    return "tokenizer.cc" if name == TOKENIZER else f"{name}_main.cc"


def _flags(name: str):
    """The g++ arguments besides the output and the source:
    tools/Makefile:26 for the library, :21-22 for a tool (zlib for the
    gzipped binary lattice archives)."""
    return [*CXXFLAGS, "-shared", "-fPIC"] if name == TOKENIZER \
        else CXXFLAGS


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(SRC) if f.endswith(".hpp"))
    for src in [_source(name), *headers]:
        with open(os.path.join(SRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    suffix = ".so" if name == TOKENIZER else ""
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}{suffix}")


def build(names: Iterable[str] = (TOKENIZER, *TOOLS)) -> Dict[str, str]:
    """Compile every named program whose binary is missing, all g++
    processes at once. Returns {name: path}."""
    if not os.path.isdir(SRC):
        raise RuntimeError(f"the C++ sources are not at {SRC}: the port's "
                           "host programs build from the repository's "
                           "tools/src")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (PATH): the port's host programs "
                           "are built from tools/src at first use")
    targets = {n: _target(n) for n in names}
    compile_all(targets, lambda n, out: [
        cxx, *_flags(n), "-o", out, os.path.join(SRC, _source(n)),
        *([] if n == TOKENIZER else ["-lz"])], "g++")
    return targets


def path(name: str) -> str:
    """The built program ``name``, compiled now if it is missing."""
    return build([name])[name]
