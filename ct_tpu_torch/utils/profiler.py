"""Profiling: device traces, host span labels and step timing.

The port of ``ct_tpu/utils/profiler.py`` on ``torch.profiler``:

  * ``trace(logdir)`` records the CPU and, on a card, CUDA activity of the
    enclosed block and writes it to ``logdir/trace.json`` (Chrome trace
    format: ``chrome://tracing``, Perfetto; ``python -m
    ct_tpu_torch.tools.trace_summary logdir`` reads the device's busy
    share from it);
  * ``annotate(name)`` labels a host span inside a trace;
  * ``StepTimer`` gives per-step wall times to the metric storage.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Record the enclosed block with torch.profiler into
    ``logdir/trace.json``. The card's queued work is waited for before the
    trace closes, so the kernels the block launched are in it."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Label a host-side span inside an active trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall-clock timing with warmup skip (the first steps are
    left out of the average)."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._seen = 0
        self._last: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def tick(self) -> Optional[float]:
        """Call once per step; returns this step's duration (or None)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._seen += 1
            if self._seen > self.skip_first:
                self.total += dt
                self.count += 1
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
