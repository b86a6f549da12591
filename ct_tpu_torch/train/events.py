"""Metric storage and writers: scalar history with median smoothing.

The port of ``ct_tpu/train/events.py``: ``EventStorage`` keeps each
scalar's history (``HistoryBuffer``) with a smoothing hint (smoothed
scalars report the median of their last 20 values), and the train loop
hands it to three writers: ``CommonMetricPrinter`` (a log line with ETA,
smoothed losses, lr, iteration time and the card's peak memory),
``JSONWriter`` (one line of ``metrics.json`` per write) and
``TensorboardWriter`` (a no-op where the library is missing). Under a
data-parallel group the train CLI builds the writers on rank 0 only: the
losses it stores are the global batch's, equal on every rank.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class HistoryBuffer:
    """Bounded scalar series with median-of-window and global average."""

    def __init__(self, window: int = 20, max_len: int = 1_000_000):
        self._window = window
        self._values: deque = deque(maxlen=max_len)
        self._total = 0.0
        self._count = 0

    def update(self, value: float, iteration: int):
        self._values.append((iteration, float(value)))
        self._total += float(value)
        self._count += 1

    def latest(self) -> float:
        return self._values[-1][1]

    def median(self, window: Optional[int] = None) -> float:
        window = window or self._window
        vals = sorted(v for _, v in list(self._values)[-window:])
        return vals[len(vals) // 2]

    def avg(self) -> float:
        return self._total / max(self._count, 1)

    def values(self):
        return list(self._values)


class EventStorage:
    """Scalars by name; ``smoothing_hint`` picks the windowed median (True)
    or the latest value (False) for the writers."""

    def __init__(self, start_iter: int = 0):
        self._histories: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing: Dict[str, bool] = {}
        self.iter = start_iter

    def put_scalar(self, name: str, value, smoothing_hint: bool = True,
                   iteration: Optional[int] = None):
        """``iteration`` overrides the storage cursor: the train loop
        records several past iterations' losses in one fetch from the
        card."""
        it = self.iter if iteration is None else iteration
        self._histories[name].update(float(value), it)
        self._smoothing[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True,
                    iteration: Optional[int] = None, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint, iteration=iteration)

    def step(self):
        self.iter += 1

    def histories(self) -> Dict[str, HistoryBuffer]:
        return dict(self._histories)

    def smoothed(self) -> Dict[str, float]:
        return {k: h.median() if self._smoothing.get(k, True) else h.latest()
                for k, h in self._histories.items()}


class JSONWriter:
    """One JSON line per ``write()``: the iteration and every smoothed
    scalar."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        row = {"iteration": storage.iter}
        row.update(storage.smoothed())
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CommonMetricPrinter:
    """Log line: ETA, smoothed losses, lr, iteration time and ``max_mem``,
    the card's peak allocated memory (``torch.cuda.max_memory_allocated``,
    the reference printer's own source); left out where the process has not
    used the card."""

    def __init__(self, max_iter: int):
        self._max_iter = max_iter
        self._last = None  # (iter, time)

    @staticmethod
    def _max_mem_mb():
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)

    def write(self, storage: EventStorage):
        it = storage.iter
        now = time.perf_counter()
        eta = ""
        if self._last is not None and it > self._last[0]:
            per_iter = (now - self._last[1]) / (it - self._last[0])
            remaining = per_iter * (self._max_iter - it)
            eta = f"eta: {datetime.timedelta(seconds=int(remaining))}  "
            storage.put_scalar("time", per_iter, smoothing_hint=True)
        self._last = (it, now)

        metrics = storage.smoothed()
        losses = "  ".join(f"{k}: {v:.4g}" for k, v in metrics.items()
                           if "loss" in k)
        lr = metrics.get("lr")
        lr_s = f"  lr: {lr:.6g}" if lr is not None else ""
        t = metrics.get("time")
        t_s = f"  time: {t:.4f}" if t is not None else ""
        mem = self._max_mem_mb()
        mem_s = f"  max_mem: {mem:.0f}M" if mem is not None else ""
        logger.info(f"{eta}iter: {it}  {losses}{lr_s}{t_s}{mem_s}")


class TensorboardWriter:
    """TensorBoard scalars; a no-op where the library is missing."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except ImportError:
            logger.warning("TensorBoard unavailable; writer disabled")

    def write(self, storage: EventStorage):
        if self._writer is None:
            return
        for k, h in storage.histories().items():
            self._writer.add_scalar(k, h.latest(), storage.iter)

    def close(self):
        if self._writer is not None:
            self._writer.close()
