"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``bayeslms_tpu_torch/csrc/`` is compiled on first use
into a shared library with a plain C interface, named after a hash of the
source, the headers under ``csrc/``, the flags and any ``-D`` defines, in
``bayeslms_tpu_torch/_build/`` (listed in .gitignore). An unchanged source
is not built again; an edited header rebuilds every kernel. No PyTorch
header is included, so one build takes seconds. A missing ``nvcc`` or a failed build
raises with the compiler's output; there is no fallback. A kernel is named
by its source (``"bayes_sample"``) or, for a variant built with defines, by
``(source, ("-DNAME=VALUE", ...))``: chip_smoke.py builds planted-fault
variants that way.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Tuple, Union

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("lstm2_fwd", "ce_fwd", "lstm_train", "ce_train", "bayes_sample",
           "attention_fwd", "bayes_matmul", "attention_train", "lstm_fwd",
           "gp_lstm", "gp6_lstm", "lstm2_train")

Kernel = Union[str, Tuple[str, Tuple[str, ...]]]  # source, or (source, defines)

_loaded: Dict[Kernel, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


def _split(kernel: Kernel) -> Tuple[str, Tuple[str, ...]]:
    return (kernel, ()) if isinstance(kernel, str) else kernel


def _target(kernel: Kernel) -> str:
    name, defines = _split(kernel)
    digest = hashlib.sha256(" ".join([*FLAGS, *defines]).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(kernels: Iterable[Kernel] = KERNELS) -> Dict[Kernel, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once. Returns {kernel: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {k: _target(k) for k in kernels}
    procs = {}
    for n, so in targets.items():
        if os.path.exists(so):
            continue
        name, defines = _split(n)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, *defines, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
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


def load(kernel: Kernel) -> ctypes.CDLL:
    """The kernel library ``kernel``, built if needed, loaded once."""
    lib = _loaded.get(kernel)
    if lib is None:
        lib = _loaded[kernel] = ctypes.CDLL(build([kernel])[kernel])
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once; the kernels' rules size
    their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count
