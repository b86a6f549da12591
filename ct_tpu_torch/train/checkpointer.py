"""Checkpoints as ``.pth`` in the reference key space, with resume.

The port of ``ct_tpu/train/checkpointer.py``, storing what the reference
stores: ``{"model": state_dict, "optimizer": ..., "scheduler": ...,
"iteration": it}`` in ``model_{iter:07d}.pth`` and ``model_final.pth``, and
the name of the newest one in the ``last_checkpoint`` tag file. The port's
eval CLI (``load_reference_pth``) reads these files as it reads the
reference's.

``resume_or_load`` keeps the reference's dispatch: with ``resume`` and a
tag, load the tagged checkpoint with its optimizer state and iteration;
otherwise load ``path`` as weights only (the phase-2 fresh start, and the
phase-1 VGG basenet, whose keys gain the ``base.`` prefix). Keys whose
shapes do not match the model are skipped with one log line each, so a
phase-1 checkpoint loads into a phase-2 model.

Both ``--fused-opt`` flavours write ``torch.optim.SGD``'s state, told apart
by its groups' ``fused`` entry: a resume whose checkpoint was written by the
other flavour warns and goes on with that flavour, momentum and schedule
carried over, as ``train.py`` does.

Under a data-parallel process group rank 0 writes, and the other ranks
wait at a barrier until the file is on disk; every rank reads.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

LAST_CHECKPOINT_TAG = "last_checkpoint"


def _fused(param_groups) -> bool:
    """Whether SGD's groups are the fused flavour's."""
    return bool(param_groups[0].get("fused"))


def _read(path: str) -> dict:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "model" in obj):
        obj = {"model": obj}
    model = {}
    for key, val in obj["model"].items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            val = val.reshape(())
        model[key] = val
    if model and all(k.split(".", 1)[0].isdigit() for k in model):
        # the VGG basenet: a bare trunk state_dict
        model = {"base." + k: v for k, v in model.items()}
    obj["model"] = model
    return obj


def load_matching(model: torch.nn.Module,
                  state: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Load the keys of ``state`` whose shapes match ``model``'s; the rest
    of the model keeps its values. Returns {"skipped", "missing"}."""
    own = model.state_dict()
    merged, skipped = dict(own), []
    for key, val in state.items():
        if key not in own:
            continue
        if tuple(val.shape) != tuple(own[key].shape):
            logger.warning("Skip loading %s: shape %s in the checkpoint, %s "
                           "in the model", key, tuple(val.shape),
                           tuple(own[key].shape))
            skipped.append(key)
            continue
        merged[key] = val
    missing = [k for k in own if k not in state]
    if missing:
        logger.info("%d keys not in the checkpoint keep their init (e.g. "
                    "%s)", len(missing), missing[:4])
    model.load_state_dict(merged)
    return {"skipped": skipped, "missing": missing}


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    def _tag_path(self) -> str:
        return os.path.join(self.save_dir, LAST_CHECKPOINT_TAG)

    def save(self, name: str, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None,
             scheduler=None, iteration: int = 0) -> str:
        path = os.path.join(self.save_dir, f"{name}.pth")
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._write(path, model, optimizer, scheduler, iteration)
        if dist.is_initialized():
            dist.barrier()
        return path

    def _write(self, path, model, optimizer, scheduler, iteration) -> None:
        payload = {"model": {k: v.detach().cpu()
                             for k, v in model.state_dict().items()},
                   "iteration": int(iteration)}
        if optimizer is not None:
            payload["optimizer"] = optimizer.state_dict()
        if scheduler is not None:
            payload["scheduler"] = scheduler.state_dict()
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        with open(self._tag_path(), "w") as f:
            f.write(os.path.basename(path))
        logger.info("Saved checkpoint to %s", path)

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_path())

    def get_checkpoint_file(self) -> Optional[str]:
        try:
            with open(self._tag_path()) as f:
                name = f.read().strip()
        except OSError:
            # the tag may be deleted concurrently: no checkpoint then
            return None
        return os.path.join(self.save_dir, name)

    def resume_or_load(self, path: Optional[str], model: torch.nn.Module,
                       optimizer=None, scheduler=None, resume: bool = False,
                       load_optimizer: bool = True) -> int:
        """Load into ``model`` (and, when resuming, ``optimizer`` and
        ``scheduler``); returns the iteration the checkpoint ended at, -1
        for a fresh start."""
        use_path, use_opt = path, False
        if resume and self.has_checkpoint():
            use_path = self.get_checkpoint_file()
            use_opt = load_optimizer
        if not use_path or not os.path.exists(use_path):
            logger.info("No checkpoint found; training from scratch")
            return -1
        logger.info("Loading checkpoint from %s", use_path)
        payload = _read(use_path)
        load_matching(model, payload["model"])
        if not use_opt:
            return -1
        if optimizer is not None and "optimizer" in payload:
            saved = payload["optimizer"]
            fused = _fused(optimizer.param_groups)
            if _fused(saved["param_groups"]) != fused:
                logger.warning("optimizer state in checkpoint does not "
                               "match --fused-opt=%s; resuming with the "
                               "other flavor", "on" if fused else "off")
            optimizer.load_state_dict(saved)
        if scheduler is not None and "scheduler" in payload:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload.get("iteration", -1))


class PeriodicCheckpointer:
    """Save every ``period`` iterations and ``model_final`` at the last."""

    def __init__(self, checkpointer: Checkpointer, period: int,
                 max_iter: int):
        self.checkpointer = checkpointer
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int, **state) -> None:
        if (iteration + 1) % self.period == 0:
            self.checkpointer.save(f"model_{iteration:07d}",
                                   iteration=iteration, **state)
        if iteration >= self.max_iter - 1:
            self.checkpointer.save("model_final", iteration=iteration,
                                   **state)
