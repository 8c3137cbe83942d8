"""Tracing and profiling, counterpart of ``bayeslms_tpu/utils/profiling.py``.

- ``trace(logdir)``: a ``torch.profiler.profile`` context (CPU and, where
  the card is present, CUDA activities) around any region; on exit it
  writes one Chrome trace file into ``logdir`` (view it in
  ``chrome://tracing`` or Perfetto). The card's kernels appear there by
  their CUDA names (``lstm_fwd_persistent``, ``ce_stats_split``, ...).
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``).
- ``StepTimer``: an exponential moving average of step times, wall clock
  only: it injects no device synchronisation.
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` per device, ``{}``
  without a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region; writes ``logdir/trace_<pid>_<n>.json``
    (a Chrome trace) when the region ends, also when it raises."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Exponential-moving-average step timer; wall-clock only (no device
    syncs injected)."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ema_ms: Optional[float] = None
        self._last: Optional[float] = None

    def update(self, ms: float) -> float:
        """Feed an externally measured ms/batch sample into the EMA (the
        train loop's, at its log points, where the wall clock over the
        interval is the measure)."""
        self.ema_ms = ms if self.ema_ms is None else (
            self.alpha * ms + (1 - self.alpha) * self.ema_ms)
        return self.ema_ms

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self.update((now - self._last) * 1000.0)
        self._last = now
        return self.ema_ms


def device_memory_stats() -> dict:
    """{device name: ``torch.cuda.memory_stats``} for every card, ``{}``
    without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
