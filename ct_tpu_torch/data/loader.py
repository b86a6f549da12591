"""Host data pipeline: thread workers → padded numpy batches.

The port of ``Loader`` (``ct_tpu/data/loader.py``) with thread workers
(process workers are not ported). Batches are dicts of numpy arrays:

  image [B,S,S,3] (HWC, the samples' own dtype: float32 from the host
  augmentation, uint8 canvases for the device one) · boxes [B,M,4] ·
  labels [B,M] · weights [B,M] · valid [B,M]

Samples are put back into sequence order before they are collated, so for
one seed the batch stream does not depend on the number of workers. The
next batches are assembled while the device runs the current step.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ct_tpu_torch.data.targets import pad_targets
from ct_tpu_torch.train.sampler import TrainingSampler


def _put(q: queue.Queue, item, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            continue


def to_device(array, device) -> torch.Tensor:
    """A host array (or tensor) on ``device``. Onto the card it goes
    through pinned memory without blocking, so the host does not wait for
    the work already queued there."""
    t = torch.as_tensor(array)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Loader:
    PREFETCH = 2   # batches assembled ahead of the consumer

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 max_objs: int = 100, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.max_objs = max_objs
        self.seed = seed
        self._generation = 0
        self._start()

    def _start(self) -> None:
        # Each generation has its own stop event and queues, captured by its
        # threads: a worker still inside dataset[idx] across a restart() can
        # only touch its own, stopped generation.
        try:
            import cv2

            # OpenCV's own thread pool fights the worker threads
            cv2.setNumThreads(1)
        except ImportError:
            pass
        qsize = self.batch_size * (self.PREFETCH + 1)
        self._stop = stop = threading.Event()
        self._index_q = index_q = queue.Queue(maxsize=qsize)
        self._sample_q = sample_q = queue.Queue(maxsize=qsize)
        self._batch_q = batch_q = queue.Queue(maxsize=self.PREFETCH)
        self._errors = errors = []
        targets = [(self._work, (stop, index_q, sample_q, errors))
                   ] * self.num_workers
        targets += [(self._feed_indices, (stop, index_q)),
                    (self._assemble, (stop, sample_q, batch_q))]
        self._threads = [threading.Thread(target=fn, args=args, daemon=True)
                         for fn, args in targets]
        for t in self._threads:
            t.start()

    def restart(self) -> None:
        """Tear down and rebuild the workers (after toggling mixup)."""
        self.stop()
        self._generation += 1
        self._start()

    def stop(self) -> None:
        self._stop.set()
        for q in (self._index_q, self._sample_q, self._batch_q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)

    def _feed_indices(self, stop, index_q) -> None:
        sampler = TrainingSampler(
            len(self.dataset),
            seed=None if self.seed is None else self.seed + self._generation)
        for seq, idx in enumerate(sampler):
            if stop.is_set():
                return
            _put(index_q, (seq, idx), stop)

    def _work(self, stop, index_q, sample_q, errors) -> None:
        while not stop.is_set():
            try:
                seq, idx = index_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                sample = self.dataset[idx]
            except Exception as e:  # noqa: BLE001 — handed to next()
                errors.append(e)
                stop.set()
                return
            _put(sample_q, (seq, sample), stop)

    def _assemble(self, stop, sample_q, batch_q) -> None:
        pending: Dict[int, tuple] = {}
        next_seq = 0
        buf = []
        while not stop.is_set():
            try:
                seq, sample = sample_q.get(timeout=0.2)
            except queue.Empty:
                continue
            pending[seq] = sample
            while next_seq in pending:
                buf.append(pending.pop(next_seq))
                next_seq += 1
                if len(buf) == self.batch_size:
                    _put(batch_q, self._collate(buf), stop)
                    buf = []

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        padded = pad_targets([s[1] for s in samples], self.max_objs)
        # the images keep their dtype: uint8 canvases ship 4x fewer bytes
        return {"image": np.stack([s[0] for s in samples]),
                "boxes": padded.boxes, "labels": padded.labels,
                "weights": padded.weights, "valid": padded.valid}

    def next(self) -> Dict[str, np.ndarray]:
        """The next batch; a worker's exception is raised here."""
        while True:
            if self._errors:
                raise RuntimeError("a loader worker failed") \
                    from self._errors[0]
            try:
                return self._batch_q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set() and not self._errors:
                    raise RuntimeError("Loader is stopped")
