"""Profiling: device traces, host span labels and step timing.

The port of ``ct_tpu/utils/profiler.py`` on ``torch.profiler``:

  * ``trace(logdir)`` records the CPU and, on a card, CUDA activity of the
    enclosed block and writes it to ``logdir/trace.json`` (Chrome trace
    format: ``chrome://tracing``, Perfetto; ``python -m
    ct_tpu_torch.tools.trace_summary logdir`` reads the device's busy
    share from it);
  * ``annotate(name, device=False)`` marks a span of the port's work
    (the eval and train steps, the int8 convs, the CT head; the train
    CLI's ``data``, ``augment`` and ``step``): a label in a trace, and,
    for a listener on the logger ``ct_tpu_torch.spans``, a record of its
    host and device times;
  * ``StepTimer`` gives per-step wall times to the metric storage.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"

# the spans' channel: a record a span for a handler at DEBUG; it does not
# propagate, so the CLIs' log files never fill with spans
SPANS = logging.getLogger("ct_tpu_torch.spans")
SPANS.propagate = False


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


_OFF = contextlib.nullcontext()
_DEPTH = threading.local()


def annotate(name: str, device: bool = False):
    """A span of the port's work, as a context manager.

    Off (no ``torch.profiler`` session records in this thread) it is a
    shared no-op: no label, time stamp, CUDA event or log record. In a
    session it enters ``record_function(name)``, which labels the trace.
    If a handler also listens on ``SPANS`` at DEBUG, the span takes
    ``time.time_ns()`` at entry and exit (the wall clock, which a trace
    maps onto its own by its ``baseTimeNanoseconds``) and, with
    ``device`` on a card, a pair of timing CUDA events on the current
    stream; at exit it emits one record whose attributes are ``span``
    (the name), ``depth`` (spans open around it in this thread),
    ``t0_ns``, ``t1_ns`` and ``device_ms``: a function giving the stream's
    time from the first event to the second, once the stream has passed
    the second (None without events). That time includes any idle of the
    device inside the span."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _span(name, device)


@contextlib.contextmanager
def _span(name: str, device: bool):
    with torch.autograd.profiler.record_function(name):
        if not SPANS.isEnabledFor(logging.DEBUG):
            yield
            return
        depth = getattr(_DEPTH, "n", 0)
        _DEPTH.n = depth + 1
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            if events is not None:
                events[1].record()
            _DEPTH.n = depth

            def device_ms() -> Optional[float]:
                if events is None:
                    return None
                events[1].synchronize()
                return events[0].elapsed_time(events[1])

            SPANS.handle(SPANS.makeRecord(
                SPANS.name, logging.DEBUG, __file__, 0,
                "%s depth %d host %.3f ms",
                (name, depth, (t1 - t0) / 1e6), None,
                extra={"span": name, "depth": depth, "t0_ns": t0,
                       "t1_ns": t1, "device_ms": device_ms}))


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
