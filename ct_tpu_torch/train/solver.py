"""SGD with momentum, per-group learning rates, warmup-multistep schedule.

The port of ``ct_tpu/train/solver.py`` (``SolverConfig``,
``warmup_multistep_schedule``, ``lr_multipliers``, ``build_optimizer``):

* phase 2 ``ours`` runs the VGG trunk (``base.*``) at 0.1× the learning
  rate and the ``extras.*``/``Norm.*`` blocks at 0.5×, everything else at
  1×; other tasks run all parameters at 1×;
* the schedule warms up linearly from factor 1e-6 over ``warmup_iters``
  updates, then multiplies by ``gamma`` at each milestone; it counts
  updates from 0, as optax's ``scale_by_schedule`` does.

``torch.optim.SGD`` applies weight decay to the gradient, accumulates the
decayed gradient in the momentum buffer (the first update starts the
buffer at the gradient) and scales the buffer by the group's learning rate
— the order of the JAX package's ``add_decayed_weights → trace →
multiplier → -schedule`` chain. A ``LambdaLR`` stepped once per update
carries the schedule.

``fused=True`` (``--fused-opt on``, JAX's ``build_fused_optimizer``) runs
the same update through ``torch.optim.SGD``'s fused multi-tensor step in
place of its per-tensor (or ``foreach``) one. Both keep a momentum buffer
per parameter, so a checkpoint of either flavour resumes under either
flag; the flag itself is stored in the optimizer state's groups and
carries over with it (``checkpointer.resume_or_load`` warns when it
differs, as ``train.py`` does). JAX's flat vector (``ravel_pytree`` of
the parameters and gradients at each step) is not copied: it adds passes
over every parameter, and JAX's own measurement found it slower than its
per-leaf chain.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from ct_tpu_torch.config import TaskSpec


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    lr: float = 4e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    gamma: float = 0.1
    steps: Sequence[int] = (120000, 150000)
    warmup_iters: int = 5000
    warmup_factor: float = 1e-6


def warmup_multistep_factor(cfg: SolverConfig) -> Callable[[int], float]:
    """count → the learning-rate factor after ``count`` updates."""
    milestones = sorted(cfg.steps)

    def factor(count: int) -> float:
        if count >= cfg.warmup_iters:
            warm = 1.0
        else:
            alpha = count / cfg.warmup_iters
            warm = cfg.warmup_factor * (1 - alpha) + alpha
        decays = sum(count >= m for m in milestones)
        return warm * cfg.gamma ** decays

    return factor


def warmup_multistep_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """count → the learning rate after ``count`` updates."""
    factor = warmup_multistep_factor(cfg)
    return lambda count: cfg.lr * factor(count)


def lr_multiplier(name: str, task: TaskSpec) -> float:
    """The learning-rate multiplier of parameter ``name`` (reference key
    space)."""
    if not (task.phase == 2 and task.method == "ours"):
        return 1.0
    top = name.split(".", 1)[0]
    if top == "base":
        return 0.1
    if top in ("extras", "Norm"):
        return 0.5
    return 1.0


def build_optimizer(
    model: torch.nn.Module, task: TaskSpec, cfg: SolverConfig = SolverConfig(),
    fused: bool = False,
) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD over ``model``'s parameters, one group per multiplier, and the
    schedule; call ``scheduler.step()`` after each ``optimizer.step()``.
    ``fused`` takes torch's fused SGD step (``--fused-opt on``)."""
    groups = {}
    for name, p in model.named_parameters():
        groups.setdefault(lr_multiplier(name, task), []).append(p)
    opt = torch.optim.SGD(
        [{"params": ps, "lr": cfg.lr * mult}
         for mult, ps in sorted(groups.items())],
        lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        fused=fused)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              warmup_multistep_factor(cfg))
    return opt, sched
