"""Device synchronization for wall-clock timing.

The port's counterpart of ``ct_tpu/utils/timing.py``. PyTorch queues CUDA
kernels and returns before they run, so a host clock read after a call
measures only the enqueue. ``fetch_sync(out)`` ends a timing window only
after the card has finished everything queued so far on the devices that
hold ``out``'s tensors; tensors on the CPU are ready when the call
returns.
"""

from __future__ import annotations

import time

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fetch_sync(tree) -> None:
    """Block until every kernel queued so far on the CUDA devices of the
    tensors in ``tree`` (a tensor, or nested lists, tuples and dicts of
    them) has run: ``torch.cuda.synchronize`` on each such device."""
    for device in {t.device for t in _tensors(tree)
                   if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


def time_calls(fn, args, iters: int, rounds: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: one call to warm up, then the
    best of ``rounds`` windows of ``iters`` back-to-back calls, each
    window closed by ``fetch_sync`` (host clock)."""
    fetch_sync(fn(*args))
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        fetch_sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best
