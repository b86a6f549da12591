"""The port's rank-aware logger and eval timer vs the JAX package's.

* ``setup_logger`` at rank 0: the console and ``log.txt``; at rank 1: no
  console, ``log.txt.rank1``; the rank read from ``torch.distributed``
  (0 outside a group); a second call keeps the handlers, and
  ``close_logger`` releases them. Its records also reach the root logger.
* ``log_first_n``, ``log_every_n`` and ``log_every_n_seconds``: the same
  messages in the same order as the JAX module's, on one clock.
* ``Timer``: the same averages and intervals as the JAX one, on one clock.
"""

import logging
import time
import types

import pytest

from ct_tpu.utils import logger as J
from ct_tpu.utils.timer import Timer as JTimer
from ct_tpu_torch.utils import logger as T
from ct_tpu_torch.utils.timer import Timer


@pytest.fixture
def fresh(request):
    names = []

    def make(name):
        names.append(name)
        return name

    yield make
    for name in names:
        T.close_logger(name)


def test_setup_logger_by_rank(tmp_path, capsys, fresh):
    assert T.process_rank() == 0
    zero = T.setup_logger(str(tmp_path), name=fresh("ct_tpu_torch.t0"))
    one = T.setup_logger(str(tmp_path), name=fresh("ct_tpu_torch.t1"),
                         distributed_rank=1)
    zero.info("from rank zero")
    one.info("from rank one")
    one.warning("a warning on rank one")
    out = capsys.readouterr().out
    assert "from rank zero" in out and "rank one" not in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "log.txt", "log.txt.rank1"]
    for h in zero.handlers + one.handlers:
        h.flush()
    assert "from rank zero" in (tmp_path / "log.txt").read_text()
    rank1 = (tmp_path / "log.txt.rank1").read_text()
    assert "from rank one" in rank1 and "WARNING" in rank1
    assert "from rank zero" not in rank1
    # a second call keeps the handlers; close_logger releases them
    assert T.setup_logger(str(tmp_path / "other"),
                          name="ct_tpu_torch.t0") is zero
    assert len(zero.handlers) == 2 and not (tmp_path / "other").exists()
    T.close_logger("ct_tpu_torch.t0")
    assert zero.handlers == [] and zero.level == logging.NOTSET


def test_setup_logger_records_reach_the_root(tmp_path, caplog, fresh):
    log = T.setup_logger(str(tmp_path), name=fresh("ct_tpu_torch.t2"))
    with caplog.at_level(logging.INFO):
        log.info("seen by the root")
    assert "seen by the root" in caplog.text


def run_helpers(mod, logger, clock, monkeypatch):
    # the module's clock only: logging reads the time for its records too
    ticks = iter(clock)
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(time=lambda: next(ticks)))
    for i in range(7):
        mod.log_first_n(logger, "first", n=2)
        mod.log_every_n(logger, f"every {i}", n=3, key="every")
        mod.log_every_n_seconds(logger, f"second {i}", n=1.0, key="sec")


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_rate_limited_helpers_match_jax(monkeypatch):
    clock = [0.0, 0.4, 1.0, 1.9, 2.05, 2.1, 3.5]
    seen = []
    for mod, name in ((J, "jax_helpers"), (T, "torch_helpers")):
        monkeypatch.setattr(mod, "_LOG_COUNTER", type(mod._LOG_COUNTER)())
        monkeypatch.setattr(mod, "_LOG_TIMER", {})
        logger = logging.getLogger(name)
        logger.setLevel(logging.INFO)
        handler = _Collect()
        logger.addHandler(handler)
        try:
            run_helpers(mod, logger, clock, monkeypatch)
        finally:
            logger.removeHandler(handler)
        seen.append(handler.messages)
    assert seen[0] == seen[1]
    assert seen[1].count("first") == 2
    assert [m for m in seen[1] if m.startswith("every")] == [
        "every 0", "every 3", "every 6"]
    assert [m for m in seen[1] if m.startswith("second")] == [
        "second 0", "second 2", "second 4", "second 6"]


def test_timer_matches_jax(monkeypatch):
    clock = [1.0, 1.5, 2.0, 2.25, 4.0, 7.0]
    runs = []
    for timer in (JTimer(), Timer()):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        got = []
        for average in (True, False, True):
            timer.tic()
            got.append(timer.toc(average=average))
        runs.append((got, timer.total_time, timer.calls,
                     timer.average_time, timer.diff))
        timer.clear()
        assert (timer.calls, timer.total_time) == (0, 0.0)
    assert runs[0] == runs[1]
    assert runs[1][0] == [0.5, 0.25, 1.25]
