"""Console and file logging, rank-aware.

The port of ``ct_tpu/utils/logger.py``: ``setup_logger`` logs to stdout
(WARNING and ERROR coloured on a terminal) on rank 0 only, and to
``log.txt`` in the output folder, ``log.txt.rank{N}`` on the other ranks
of a data-parallel group; ``log_first_n``, ``log_every_n`` and
``log_every_n_seconds`` rate-limit a message by a key. The rank is read
from ``torch.distributed`` (0 outside a group).

Unlike the JAX module's, the logger's records also propagate to the root
logger, which has no handler in a CLI's process (so nothing is printed
twice) and where a test harness captures them.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import Counter

_LOG_COUNTER: Counter = Counter()
_LOG_TIMER: dict = {}

_RED = "\x1b[31;1m"
_YELLOW = "\x1b[33;1m"
_RESET = "\x1b[0m"
_FORMAT = "[%(asctime)s %(name)s %(levelname)s] %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


class _ColorFormatter(logging.Formatter):
    """WARNING in yellow, ERROR in red."""

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if record.levelno >= logging.ERROR:
            return _RED + out + _RESET
        if record.levelno >= logging.WARNING:
            return _YELLOW + out + _RESET
        return out


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 outside
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logger(output: str | None = None, name: str = "ct_tpu_torch",
                 level: int = logging.INFO,
                 distributed_rank: int | None = None) -> logging.Logger:
    """The logger ``name`` with its handlers (set once; a second call
    returns it as it is): the console on rank 0, and ``output``'s
    ``log.txt`` (``log.txt.rank{N}`` on rank N > 0). The port's modules
    log under ``ct_tpu_torch.*``, so they reach these handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logger.handlers:
        return logger
    rank = process_rank() if distributed_rank is None else distributed_rank
    plain = logging.Formatter(_FORMAT, datefmt=_DATEFMT)
    if rank == 0:
        sh = logging.StreamHandler(stream=sys.stdout)
        color = hasattr(sys.stdout, "isatty") and sys.stdout.isatty()
        sh.setFormatter(_ColorFormatter(_FORMAT, datefmt=_DATEFMT)
                        if color else plain)
        logger.addHandler(sh)
    if output:
        os.makedirs(output, exist_ok=True)
        fname = "log.txt" if rank == 0 else f"log.txt.rank{rank}"
        fh = logging.FileHandler(os.path.join(output, fname))
        fh.setFormatter(plain)
        logger.addHandler(fh)
    return logger


def close_logger(name: str = "ct_tpu_torch") -> None:
    """Close and remove the handlers ``setup_logger`` gave ``name`` and
    reset its level to the root's, so that the next call sets it up for
    its own output folder."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.NOTSET)


def log_first_n(logger: logging.Logger, msg: str, n: int = 1,
                key: str | None = None) -> None:
    """Log ``msg`` the first ``n`` times its key is seen."""
    key = key or msg
    _LOG_COUNTER[key] += 1
    if _LOG_COUNTER[key] <= n:
        logger.info(msg)


def log_every_n(logger: logging.Logger, msg: str, n: int = 1,
                key: str | None = None) -> None:
    """Log ``msg`` on the 1st, (n+1)-th, (2n+1)-th... time its key is
    seen."""
    key = key or msg
    _LOG_COUNTER[key] += 1
    if (_LOG_COUNTER[key] - 1) % n == 0:
        logger.info(msg)


def log_every_n_seconds(logger: logging.Logger, msg: str, n: float = 1.0,
                        key: str | None = None) -> None:
    """Log ``msg`` if its key was last logged ``n`` seconds ago or more."""
    key = key or msg
    now = time.time()
    last = _LOG_TIMER.get(key)
    if last is None or now - last >= n:
        logger.info(msg)
        _LOG_TIMER[key] = now
