"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``bayeslms_tpu_torch/csrc/`` is compiled on first use
into a shared library with a plain C interface, named after a hash of the
source, the headers under ``csrc/`` and the flags, in
``bayeslms_tpu_torch/_build/`` (listed in .gitignore). An unchanged source
is not built again; an edited header rebuilds every kernel. No PyTorch
header is included, so one build takes seconds. A missing ``nvcc`` or a failed build
raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("lstm2_fwd", "ce_fwd", "lstm_train", "ce_train")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once. Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp, cmd)
    errors = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, targets[n])  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, loaded once."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build([name])[name])
    return lib
