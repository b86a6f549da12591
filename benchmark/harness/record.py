"""What one run leaves for the metric readers and the result line."""

from __future__ import annotations

import sys
import time

from typing import Dict, List, NamedTuple, Optional

from benchmark.harness.trace import TraceData


class Run(NamedTuple):
    kind: str                     # "serve" or "train"
    setup_s: float                # process start → the window
    window_s: float               # the window, host clock
    attempted: int                # requests due / steps run in the window
    failed: int
    latencies_s: List[float]      # serve: due → detections on the host
    service_s: List[float]        # serve: copy start → detections on host
    images: int                   # images answered / trained in the window
    shapes: Dict[str, object]     # size, batch, priors, keys, classes ...
    flops: Dict[str, float]       # one image's forward (``arith``)
    event_ms: Dict[str, List[float]]  # CUDA-event spans of the traced run
    trace: Optional[TraceData]
    memory_peak: int
    checks: Dict[str, float]      # the numbers that decide ``correct``
    checks_s: float               # seconds the comparison took


class Phases:
    """Set-up's phases, each printed on standard error as it ends (host
    clock, seconds since the run's start)."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"set-up {name}: {now - self.last:.2f} s "
              f"(at {now - self.t_start:.2f} s)", file=sys.stderr)
        self.last = now
