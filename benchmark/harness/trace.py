"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` session
recording the device alone (CUDA activity: kernels, copies, memsets and
the runtime calls that launch them) around a steady stretch of the
window, and its reduction.

The session records no host operators: with them a train step of the
512 cell took 1.8× as long on an H100's host and starved the card; with
the device alone, 1.25×. The stretch is bounded on the device by two
marker kernels (``torch.cuda._sleep``) launched into the stream at its
start and end, so it holds exactly the work launched between them.
Within it:

* the device's busy time is the union of its kernel, copy and memset
  intervals (overlapping work counts once), ``window_s`` the time from the
  end of the first marker to the start of the second;
* each idle stretch of the device is put down to the benchmark's host
  span (``Spans``, wall-clock stamps aligned to the trace's clock) that
  covers its middle: what the host was doing meanwhile;
* device work is kept with its names, starts and durations, for the
  per-layer readers.

The Chrome trace goes to a temporary file in ``TMPDIR`` and is deleted
once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 1000


class Kernel(NamedTuple):
    name: str
    start_s: float
    dur_s: float


class TraceData(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Kernel]          # device work (kernels, copies,
                                   # memsets) in the window
    idle_by_span: Dict[str, float]  # idle seconds by the host's span
    spans: Dict[str, int]          # count of each host span in the window


class Spans:
    """Host spans by wall-clock stamps: cheap, and kept only while
    ``on``."""

    def __init__(self):
        self.on = False
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


class Profiler:
    """``start()`` opens the session, ``mark()`` launches a marker kernel
    (call it at the stretch's start and end), ``stop()`` closes it →
    ``TraceData``."""

    def __init__(self, spans: Spans):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts)
        self.spans = spans
        self.marks: List[int] = []

    def start(self) -> None:
        self.prof.__enter__()
        self.spans.on = True

    def mark(self) -> None:
        self.marks.append(time.time_ns())
        if torch.cuda.is_available():
            torch.cuda._sleep(MARKER_CYCLES)

    def stop(self) -> TraceData:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.spans.on = False
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        base_us = raw.get("baseTimeNanoseconds", 0) / 1e3
        spans = [(n, a / 1e3 - base_us, b / 1e3 - base_us)
                 for n, a, b in self.spans.items]
        self.spans.items = []
        marks = [m / 1e3 - base_us for m in self.marks]
        return reduce(raw["traceEvents"], spans, marks)


def _union(intervals):
    busy, reach = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    return busy


def reduce(events: list, spans: List[tuple],
           host_marks: List[float]) -> TraceData:
    """Chrome trace events (µs) → ``TraceData`` between the two marker
    kernels; without them (a trace of the CPU alone) between the host's
    two marks. ``spans``: (name, start, end) in the trace's clock."""
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    markers = sorted((e for e in done if e.get("cat") == "kernel"
                      and MARKER in str(e.get("name"))), key=lambda e: e["ts"])
    if len(markers) >= 2:
        w0 = markers[0]["ts"] + markers[0]["dur"]
        w1 = markers[-1]["ts"]
    elif len(host_marks) >= 2:
        w0, w1 = host_marks[0], host_marks[-1]
    else:
        raise RuntimeError("trace: the stretch has no marks")
    dev = [e for e in done if e.get("cat") in DEVICE_CATEGORIES
           and MARKER not in str(e.get("name"))
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    clipped = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                     for e in dev)
    inside = [s for s in spans if s[1] < w1 and s[2] > w0]
    idle: Dict[str, float] = {}
    reach = w0
    for t0, t1 in clipped + [(w1, w1)]:
        if t0 > reach:
            mid = (t0 + reach) / 2
            over = [s for s in inside if s[1] <= mid <= s[2]]
            label = (min(over, key=lambda s: s[2] - s[1])[0] if over
                     else "host.other")
            idle[label] = idle.get(label, 0.0) + (t0 - reach) / 1e6
        reach = max(reach, t1)
    counts: Dict[str, int] = {}
    for s in inside:
        counts[s[0]] = counts.get(s[0], 0) + 1
    return TraceData(
        (w1 - w0) / 1e6, _union(clipped) / 1e6,
        [Kernel(e["name"], e["ts"] / 1e6, e["dur"] / 1e6) for e in dev
         if e["ts"] >= w0],
        idle, counts)


def kernel_seconds(trace: Optional[TraceData], names) -> Dict[str, dict]:
    """Device seconds and launches of the kernels whose names hold one of
    ``names`` (the first that matches), keyed by that name."""
    out = {n: 0.0 for n in names}
    counts = {n: 0 for n in names}
    for k in (trace.kernels if trace else []):
        hit = next((n for n in names if n in k.name), None)
        if hit is not None:
            out[hit] += k.dur_s
            counts[hit] += 1
    return {"seconds": out, "launches": counts}


def breakdown(trace: TraceData, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each at most ``top`` entries."""
    by_name: Dict[str, float] = {}
    for k in trace.kernels:
        by_name[k.name[:160]] = by_name.get(k.name[:160], 0.0) + k.dur_s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
