"""Host data pipeline: thread or process workers → padded numpy batches.

The port of ``Loader`` (``ct_tpu/data/loader.py``). Two worker kinds:

  * ``workers="thread"`` (default): a thread pool, for the device-augment
    route, whose host work (JPEG decode, cv2 resize) releases the GIL;
  * ``workers="process"``: a pool of spawned processes, for the host
    augmentation, whose numpy work holds the GIL. Each worker unpickles
    the dataset once; it imports neither torch nor CUDA (the parent's
    ``start()`` of a spawned child waits while the child imports its
    target's module).

Batches are dicts of numpy arrays:

  image [B,S,S,3] (HWC, the samples' own dtype: float32 from the host
  augmentation, uint8 canvases for the device one) · boxes [B,M,4] ·
  labels [B,M] · weights [B,M] · valid [B,M]

Samples are put back into sequence order before they are collated, so for
one seed the batch stream depends on neither the number nor the kind of
workers (given a dataset whose samples depend only on their index). The
next batches are assembled while the device runs the current step.

Data parallel (``rank`` of ``world`` ranks): every rank draws the same
index stream from the shared seed, cuts it into global batches of
``batch_size`` and decodes only its contiguous block of each,
``batch_size / world`` samples. Over k batches the ranks' blocks, in rank
order, are the single process's k batches.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
import traceback
from typing import Dict, Optional

import numpy as np

from ct_tpu_torch.data.targets import pad_targets
from ct_tpu_torch.train.sampler import TrainingSampler

# the sequence number with which a worker process reports its failure
_FAILED = -1


def _put(q, item, stop) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return
        except queue.Full:
            continue


def _single_threaded_cv2() -> None:
    try:
        import cv2

        # OpenCV's own thread pool fights the workers
        cv2.setNumThreads(1)
    except ImportError:
        pass


def _process_worker(dataset_bytes: bytes, index_q, sample_q, stop) -> None:
    """A worker process: unpickle the dataset once, then map indices to
    samples; a failure goes back as (_FAILED, its traceback). Top-level so
    that a spawned process can import it."""
    _single_threaded_cv2()
    dataset = pickle.loads(dataset_bytes)
    while not stop.is_set():
        try:
            seq, idx = index_q.get(timeout=0.2)
        except queue.Empty:
            continue
        try:
            sample = dataset[idx]
        except Exception:  # noqa: BLE001 — reported to the parent
            _put(sample_q, (_FAILED, traceback.format_exc()), stop)
            return
        _put(sample_q, (seq, sample), stop)


def to_device(array, device) -> "torch.Tensor":
    """A host array (or tensor) on ``device``. Onto the card it goes
    through pinned memory without blocking, so the host does not wait for
    the work already queued there."""
    # imported here: a worker process imports this module without torch
    import torch

    t = torch.as_tensor(array)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Loader:
    PREFETCH = 2   # batches assembled ahead of the consumer

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 max_objs: int = 100, seed: Optional[int] = None,
                 workers: str = "thread", rank: int = 0, world: int = 1):
        if workers not in ("thread", "process"):
            raise ValueError(f"workers must be thread or process, got "
                             f"{workers!r}")
        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"a batch of {batch_size} does not divide over "
                             f"{world} ranks (rank {rank})")
        self.dataset = dataset
        self.global_batch = batch_size
        self.batch_size = batch_size // world     # this rank's block
        self.rank = rank
        self.num_workers = max(1, num_workers)
        self.max_objs = max_objs
        self.seed = seed
        self.workers = workers
        self._generation = 0
        self._start()

    def _start(self) -> None:
        # Each generation has its own stop event and queues, captured by its
        # threads and processes: a worker still inside dataset[idx] across a
        # restart() can only touch its own, stopped generation.
        _single_threaded_cv2()
        qsize = self.batch_size * (self.PREFETCH + 1)
        self._batch_q = batch_q = queue.Queue(maxsize=self.PREFETCH)
        self._errors = errors = []
        self._procs = []
        if self.workers == "process":
            import multiprocessing as mp

            # spawn, not fork: the parent holds threads (and CUDA)
            ctx = mp.get_context("spawn")
            self._stop = stop = ctx.Event()
            self._index_q = index_q = ctx.Queue(maxsize=qsize)
            self._sample_q = sample_q = ctx.Queue(maxsize=qsize)
            payload = pickle.dumps(self.dataset)
            self._procs = [
                ctx.Process(target=_process_worker,
                            args=(payload, index_q, sample_q, stop),
                            daemon=True)
                for _ in range(self.num_workers)]
            for p in self._procs:
                p.start()
            targets = []
        else:
            self._stop = stop = threading.Event()
            self._index_q = index_q = queue.Queue(maxsize=qsize)
            self._sample_q = sample_q = queue.Queue(maxsize=qsize)
            targets = [(self._work, (stop, index_q, sample_q, errors))
                       ] * self.num_workers
        targets += [(self._feed_indices, (stop, index_q)),
                    (self._assemble, (stop, sample_q, batch_q, errors))]
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
        queues = (self._index_q, self._sample_q, self._batch_q)
        for q in queues:
            _drain(q)
        for t in self._threads:
            t.join(timeout=5.0)
        # a process that put samples exits only once they left its pipe:
        # keep draining while it winds down
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                _drain(self._sample_q)
                p.join(timeout=0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        if self._procs:
            for q in queues[:2]:
                q.close()
                # the feeder thread may hold indices no worker will read
                q.cancel_join_thread()

    def _feed_indices(self, stop, index_q) -> None:
        sampler = TrainingSampler(
            len(self.dataset),
            seed=None if self.seed is None else self.seed + self._generation)
        lo = self.rank * self.batch_size
        seq = 0
        for pos, idx in enumerate(sampler):
            if stop.is_set():
                return
            if lo <= pos % self.global_batch < lo + self.batch_size:
                _put(index_q, (seq, idx), stop)
                seq += 1

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

    def _assemble(self, stop, sample_q, batch_q, errors) -> None:
        pending: Dict[int, tuple] = {}
        next_seq = 0
        buf = []
        while not stop.is_set():
            try:
                seq, sample = sample_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if seq == _FAILED:
                errors.append(RuntimeError(
                    f"in a loader worker process:\n{sample}"))
                stop.set()
                return
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
                # a process that died before it could report (killed, or
                # its dataset would not unpickle)
                for p in self._procs:
                    if p.exitcode not in (None, 0):
                        raise RuntimeError(f"a loader worker process exited "
                                           f"with code {p.exitcode}")


def _drain(q) -> None:
    # OSError / ValueError: a process queue that an earlier stop() closed
    try:
        while True:
            q.get_nowait()
    except (queue.Empty, OSError, ValueError):
        pass
