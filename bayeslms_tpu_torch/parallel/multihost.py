"""Joining and launching a group of ranks, counterpart of
``bayeslms_tpu/parallel/multihost.py``.

- ``initialize_multihost()`` joins this process into the group a launcher
  started (``torchrun`` or any launcher with its contract) and returns False
  where there is a single process. The environment maps onto the JAX
  names: ``MASTER_ADDR``:``MASTER_PORT`` is ``JAX_COORDINATOR_ADDRESS``,
  ``WORLD_SIZE`` is ``JAX_NUM_PROCESSES``, ``RANK`` is ``JAX_PROCESS_ID``;
  ``LOCAL_RANK`` (no JAX name: a JAX process holds all its host's chips)
  picks this rank's card under NCCL. One process is one rank and one card,
  so a host of four cards runs four processes.
- ``is_primary()``: True on rank 0 (and in a single process).
- ``spawn(target, world, payload)``: runs ``target`` (``"module:function"``)
  in ``world`` new processes on this host, joined through a ``FileStore``
  in a temporary directory, and returns each rank's return value. A rank
  that dies takes the others down after ``GRACE`` seconds, and the whole
  run after ``timeout``: a broken rank cannot hang a collective forever.
  The command line (``cli/main.py``) and the tests launch their ranks
  with it; ``python -m bayeslms_tpu_torch.parallel.multihost`` is the
  rank's entry point.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# seconds a collective may wait before it raises; seconds the other ranks
# may live on after one failed; torch's threads a spawned rank
COLLECTIVE_TIMEOUT = 600.0
GRACE = 5.0
RANK_THREADS = 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_multihost(backend: Optional[str] = None) -> bool:
    """Join the launcher's group (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); no-op returning False when ``WORLD_SIZE`` is unset or
    1. ``backend``: NCCL where a card is visible, else gloo, by default.
    Under NCCL the rank's current card becomes ``LOCAL_RANK``'s."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "MASTER_ADDR" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    return True


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def spawn(target: str, world: int, payload: Any = None,
          backend: str = "gloo", timeout: Optional[float] = 600.0,
          cards: Optional[List[int]] = None) -> list:
    """Run ``target(payload)`` on ``world`` ranks and return their results
    in rank order. ``target`` is ``"module:function"``, importable in a
    new process (the children get this process's ``sys.path``); each rank
    runs RANK_THREADS threads. ``cards``: each rank's ``LOCAL_RANK`` (by
    default its rank). Raises RuntimeError naming the
    first rank that failed, TimeoutError past ``timeout`` seconds (None:
    no limit; a collective still raises after COLLECTIVE_TIMEOUT); every
    child is stopped either way."""
    tmp = tempfile.mkdtemp(prefix="bayeslm_ranks_")
    procs: List[subprocess.Popen] = []
    try:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        path = os.pathsep.join(p for p in sys.path if p and os.path.isdir(p))
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r if cards is None else cards[r]),
                       OMP_NUM_THREADS=str(RANK_THREADS), PYTHONPATH=path)
            env.pop("MASTER_ADDR", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bayeslms_tpu_torch.parallel.multihost",
                 target, tmp, backend, str(timeout or COLLECTIVE_TIMEOUT)],
                env=env))
        deadline = time.monotonic() + (timeout or float("inf"))
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            now = time.monotonic()
            if bad and failed_at is None:
                failed_at = now
            if failed_at is not None and now > failed_at + GRACE:
                break
            if now > deadline:
                raise TimeoutError(f"spawn {target}: {world} ranks still "
                                   f"running after {timeout:.0f} s")
            time.sleep(0.02)
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c != 0]
        if bad:
            raise RuntimeError(f"spawn {target}: rank {bad[0][0]} exited "
                               f"with {bad[0][1]} (ranks and codes {bad})")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(target: str, tmp: str, backend: str, timeout: str) -> None:
    """A spawned rank: join the group through the FileStore in ``tmp``,
    call ``target(payload)``, write its result beside the payload."""
    torch.set_num_threads(RANK_THREADS)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(payload)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
