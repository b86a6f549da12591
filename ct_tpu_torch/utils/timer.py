"""Wall-clock tic/toc timing with a running average.

The port of ``ct_tpu/utils/timer.py``, which the eval CLI uses for its
per-batch detection time.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self) -> None:
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        """The time since ``tic``, added to the total: the running average
        (``average``) or this interval."""
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff
