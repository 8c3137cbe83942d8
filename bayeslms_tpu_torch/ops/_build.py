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
from typing import Callable, Dict, Hashable, Iterable, List, Tuple, Union

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("lstm2_fwd", "ce_fwd", "lstm_train", "ce_train", "bayes_sample",
           "attention_fwd", "bayes_matmul", "attention_train", "lstm_fwd",
           "gp_lstm", "gp6_lstm", "lstm2_train", "lstm_f32", "ce_f32")

Kernel = Union[str, Tuple[str, Tuple[str, ...]]]  # source, or (source, defines)

_loaded: Dict[Kernel, ctypes.CDLL] = {}

# The ROADMAP.md items (queue B, B.5's float32 training slices) that bring
# float32 operands to the kernels that take bf16 only, by kernel row; rows
# 1-4 and 12-17 take float32 already.
F32_ITEMS = {"rows 9-11": "B.5a", "rows 5-6": "B.5b", "rows 18-21": "B.5c",
             "rows 7-8": "B.5d"}


def refuse_float32(fn: str, t: torch.Tensor, rows: str) -> None:
    """The bf16-only wrappers' refusal of a float32 operand, naming the
    ROADMAP.md item that brings it (``F32_ITEMS[rows]``). A dtype other than
    float32 goes on to the wrapper's own checks."""
    if t.dtype == torch.float32:
        raise ValueError(
            f"{fn}: float32 operands on the card: kernel {rows} take bf16 "
            f"only until ROADMAP.md {F32_ITEMS[rows]} (B.5's float32 "
            "training slices); pass bf16 operands, or CPU tensors")


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


def compile_all(targets: Dict[Hashable, str],
                command: Callable[[Hashable, str], List[str]],
                compiler: str) -> None:
    """Build every target file that is missing, all compiler processes at
    once: ``command(key, out)`` is the command line that writes ``out``.
    Each writes a pid-suffixed file renamed onto its target, so concurrent
    builds agree. Raises with every failed build's output."""
    procs = {}
    for key, out in targets.items():
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = command(key, tmp)
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, cmd)
    errors = []
    for key, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, targets[key])
    if errors:
        raise RuntimeError(f"{compiler} failed:\n" + "\n".join(errors))


def _command(kernel: Kernel, out: str) -> List[str]:
    name, defines = _split(kernel)
    return [_nvcc(), *FLAGS, *defines, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build(kernels: Iterable[Kernel] = KERNELS) -> Dict[Kernel, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once. Returns {kernel: library path}."""
    targets = {k: _target(k) for k in kernels}
    compile_all(targets, _command, "nvcc")
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
