"""Asynchronous checkpoints (``--orbax``): a snapshot now, the write later.

The port of ``ct_tpu/train/orbax_ckpt.py`` without orbax. ``save`` copies
the model's, the optimizer's and the schedule's state into host memory
before it returns, and a background thread writes it to
``<save_dir>/<iteration + 1>/checkpoint.pth`` (under a temporary name,
then renamed), then the step into the ``last_checkpoint`` tag, while
training goes on. The copy is what makes a save a snapshot: the optimizer
updates the parameters in place, so a thread that wrote the live tensors
would save a later step. At most one save is in flight: a second ``save``
first waits for the one before, and ``wait`` drains it (the train CLI
calls it before it exits).

The file holds what ``Checkpointer`` writes (``{"model", "optimizer",
"scheduler", "iteration"}``), so the eval CLI loads it with
``--load-file``, or with ``--resume --save-folder <save_folder>/orbax``,
whose tag names the step directory (``checkpoint_file``). Under a process
group rank 0 writes and every rank reads.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
from typing import Any, Optional

import torch

from ct_tpu_torch.train.checkpointer import LAST_CHECKPOINT_TAG, load_matching

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "checkpoint.pth"


def checkpoint_file(path: str) -> str:
    """The ``.pth`` of a step directory, or ``path`` itself."""
    return (os.path.join(path, CHECKPOINT_FILE) if os.path.isdir(path)
            else path)


def host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied into host memory (a CPU tensor
    too: a copy, not a view) and every container copied."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return copy.deepcopy(obj)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


class AsyncCheckpointer:
    """``save`` / ``wait`` / ``has_checkpoint`` / ``resume`` / ``close``
    over step directories of ``save_dir``."""

    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _tag_path(self) -> str:
        return os.path.join(self.save_dir, LAST_CHECKPOINT_TAG)

    # -- save ---------------------------------------------------------------

    def save(self, name: str, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             scheduler=None, iteration: int = 0) -> str:
        """Snapshot the state now and write it in the background (rank 0
        only); ``name`` goes to the log, as orbax's checkpointer records
        it. Returns the step directory."""
        step = int(iteration) + 1
        path = os.path.join(self.save_dir, str(step))
        if _rank() != 0:
            return path
        self.wait()
        payload = {"model": host_copy(model.state_dict()),
                   "iteration": int(iteration)}
        if optimizer is not None:
            payload["optimizer"] = host_copy(optimizer.state_dict())
        if scheduler is not None:
            payload["scheduler"] = host_copy(scheduler.state_dict())
        self._thread = threading.Thread(
            target=self._write, args=(payload, path, step), daemon=True)
        self._thread.start()
        logger.info("Queued checkpoint %s for step %d", name, iteration)
        return path

    def _write(self, payload: dict, path: str, step: int) -> None:
        try:
            os.makedirs(path, exist_ok=True)
            target = os.path.join(path, CHECKPOINT_FILE)
            torch.save(payload, target + ".tmp")
            os.replace(target + ".tmp", target)
            with open(self._tag_path() + ".tmp", "w") as f:
                f.write(str(step))
            os.replace(self._tag_path() + ".tmp", self._tag_path())
        except Exception as e:  # noqa: BLE001 — raised by wait()
            self._error = e

    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint failed") from err

    # -- load ---------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The newest step directory whose file is complete."""
        steps = [int(d) for d in os.listdir(self.save_dir) if d.isdigit()
                 and os.path.exists(os.path.join(self.save_dir, d,
                                                 CHECKPOINT_FILE))]
        return max(steps) if steps else None

    def has_checkpoint(self) -> bool:
        return self.latest_step() is not None

    def resume(self, model: torch.nn.Module, optimizer=None,
               scheduler=None) -> int:
        """Load the newest step into ``model``, ``optimizer`` and
        ``scheduler``; returns its iteration, -1 where there is none."""
        step = self.latest_step()
        if step is None:
            return -1
        path = os.path.join(self.save_dir, str(step), CHECKPOINT_FILE)
        logger.info("Resuming from %s", path)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        load_matching(model, payload["model"])
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and "scheduler" in payload:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload["iteration"])

    def close(self) -> None:
        self.wait()
