"""The program's spans, read as its output.

Inside a profiler session the program's spans emit one ``logging`` record
each on the logger ``ct_tpu_torch.spans``, for a handler that listens at
DEBUG. A record carries ``span`` (the name), ``depth`` (spans open around
it), ``t0_ns`` and ``t1_ns`` (``time.time_ns`` at entry and exit, the
clock of ``trace.Spans``) and ``device_ms()``: the stream's time between
a CUDA event at entry and one at exit, idle included, or None without
them (no card, or a host span). This module takes them through
``logging`` alone, so the benchmark reads them without importing the
program.

Each reader of a span metric calls ``listen()`` as it is loaded: one
collector on the logger, which then records at DEBUG and does not
propagate; a later call changes nothing. A run's records are those that
arrived after the run before it was read (``_of``): in a ``--trace 1``
run, the spans of its profiler session. Of those a reader takes the
traced stretch: the harness opens its session ``OPENING`` requests or
steps before the stretch's first marker (``serve.py``, ``train.py``) and
keeps them out of the stretch, as their work carries the profiler's
start. A program without the spans emits nothing, and every reader reads
None.
"""

from __future__ import annotations

import logging

CHANNEL = "ct_tpu_torch.spans"
OPENING = 2     # units of the session before the stretch


class _Collector(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


_COLLECTOR = _Collector()
_read = (None, [])      # the run read last and its records


def listen() -> None:
    """Collect the channel's records (module docstring)."""
    log = logging.getLogger(CHANNEL)
    if _COLLECTOR not in log.handlers:
        log.addHandler(_COLLECTOR)
    log.setLevel(logging.DEBUG)
    log.propagate = False


def _of(run) -> list:
    """The records of ``run``: at its first read, those collected since
    the run read before it."""
    global _read
    if _read[0] is not run:
        _read = (run, _COLLECTOR.records)
        _COLLECTOR.records = []
    return _read[1]


def stretch(records: list, per: str) -> list:
    """The records of the traced stretch: from the start of the first
    unit named ``per`` after the session's ``OPENING`` on."""
    units = sorted(r.t0_ns for r in records if r.span == per)
    if len(units) <= OPENING:
        return []
    return [r for r in records if r.t0_ns >= units[OPENING]]


def mean_ms(run, kind: str, span: str, per: str, device: bool):
    """Milliseconds in the spans named ``span`` a span named ``per`` (a
    request's ``eval.step``, a train step's ``train.step``), summed over
    the traced stretch's records: device time (``device_ms``) or host
    time. None outside a traced run of ``kind``, without a ``per`` or
    ``span`` record in the stretch, or, for device time, without a
    card."""
    records = _of(run)
    if run.kind != kind or run.trace is None:
        return None
    records = stretch(records, per)
    units = sum(1 for r in records if r.span == per)
    hits = [r for r in records if r.span == span]
    if not units or not hits:
        return None
    if device:
        ms = [r.device_ms() for r in hits]
        if any(m is None for m in ms):
            return None
        return sum(ms) / units
    return sum(r.t1_ns - r.t0_ns for r in hits) / 1e6 / units
