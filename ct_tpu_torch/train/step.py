"""The train step: forward → matching → loss → backward → SGD → renorm.

The port of ``ct_tpu/train/step.py`` (``TrainState``,
``normalize_obj_target``, ``make_train_step``). One step:

  1. the forward in train mode (BatchNorm on batch statistics, running
     statistics updated at momentum 0.01);
  2. matching of the padded targets against the priors;
  3. the unnormalised loss sums and the positive count N;
  4. the backward of their sum, then every gradient divided by
     N = max(N, 1);
  5. one SGD update and one schedule step;
  6. with the CT head, the ``OBJ_Target`` rows renormalised to unit length.

With ``accum_steps > 1`` (gradient accumulation, JAX's ``accumulate``)
the batch is split along dim 0 into ``accum_steps`` contiguous
micro-batches, and steps 1–4 run on each in order: BatchNorm normalises
by the micro-batch's statistics and updates its running statistics once a
micro-batch, each micro-batch mines its own anchors, and the gradients of
the unnormalised sums add up in ``.grad``. After the last, every gradient
and loss sum is divided once by the whole batch's N. Only a batch whose
micro-batches are equal gives the single-batch step's result: BatchNorm
sees B / accum_steps images.

With a ``mesh`` of several ranks (``parallel/mesh.py``; JAX's
``shard_map`` step, ``step_body`` with an axis name) each rank runs steps
1–3 on its block of the global batch, in its ``accum_steps``
micro-batches, and leaves the gradients and loss sums unnormalised. Then
one all-reduce sums the gradients, the loss sums and N over the ranks
(JAX's three ``psum``) and averages BatchNorm's running statistics (JAX's
``pmean``): they travel in one flat float32 buffer, so the step makes one
collective. Only then is everything divided by max(N, 1). BatchNorm
normalises by each rank's statistics, as under the reference's
``DataParallel``; ``num_batches_tracked`` is equal on every rank and stays
unreduced. The model is not wrapped in ``DistributedDataParallel``, which
divides the gradients by the number of ranks instead of by N and
broadcasts rank 0's BatchNorm buffers instead of averaging them.

Its spans (``utils/profiler``), on the host: ``train.step``; inside it
``train.forward`` (step 1), ``train.loss`` (2, 3) and ``train.backward``
(4's backward) a micro-batch, and ``train.update`` twice: 4's division by
N, then 5 and 6. The step is host-paced, so they time where its wall
time goes.

``loss_and_grads`` is steps 1–4 alone: it leaves the gradients on the
parameters and returns the N-normalised losses. It can be handed the
anchors to count instead of mining them, so that two devices can be held
to the same loss where near-tied negatives would rank in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ct_tpu_torch.data.loader import to_device
from ct_tpu_torch.models.rfbnet import RFBNet
from ct_tpu_torch.ops.losses import loss_mask, masked_loss_sums
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.parallel.mesh import (
    Mesh, all_reduce_flat, bn_running_stats,
)
from ct_tpu_torch.utils.profiler import annotate

LOSS_KEYS = ("loss_box_reg", "loss_cls", "loss_obj")


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, and the update count."""

    model: RFBNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


@torch.no_grad()
def normalize_obj_target(model: RFBNet) -> None:
    """ℓ2-normalise the ``OBJ_Target`` prototype rows in place."""
    w = model.OBJ_Target.weight
    w.div_(torch.linalg.vector_norm(w, dim=1, keepdim=True))


def batch_to(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy, NHWC images) → tensors on ``device``, with
    NCHW images; the copies to the card do not wait for it."""
    out = {}
    for key, val in batch.items():
        t = to_device(val, device)
        if key == "image" and t.shape[-1] == 3:
            t = t.permute(0, 3, 1, 2)
        out[key] = t.contiguous()
    return out


def loss_and_grads(model: RFBNet, batch: Mapping[str, torch.Tensor],
                   priors_cs: torch.Tensor, match_threshold: float = 0.5,
                   mask: Optional[torch.Tensor] = None,
                   accum_steps: int = 1, mesh: Optional[Mesh] = None):
    """Steps 1–4: the gradients of the N-normalised total loss land in each
    parameter's ``.grad``, over ``accum_steps`` micro-batches of this
    rank's ``batch``, summed over the ranks of ``mesh`` and divided by the
    global N. Returns (the normalised losses and the global N as detached
    scalars, the [B, P] mask of the anchors this rank counted: positives
    and mined hard negatives, or ``mask`` where given)."""
    b = batch["image"].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not divide by accum_steps "
                         f"{accum_steps}")
    micro = b // accum_steps
    model.train()
    model.zero_grad(set_to_none=True)
    totals, n, masks = dict.fromkeys(LOSS_KEYS, 0.0), 0.0, []
    for i in range(accum_steps):
        part = slice(i * micro, (i + 1) * micro)
        mb = {k: v[part] for k, v in batch.items()}
        with annotate("train.forward"):
            preds = model(mb["image"])
        with annotate("train.loss"):
            matched = match_batch(mb["boxes"], mb["labels"], mb["weights"],
                                  mb["valid"], priors_cs, match_threshold)
            mined, num_pos = loss_mask(preds.obj, matched)
            counted = mined if mask is None else mask[part]
            sums = masked_loss_sums(preds.loc, preds.conf, preds.obj,
                                    matched, counted)
            total = sum(sums[k] for k in LOSS_KEYS)
        with annotate("train.backward"):
            total.backward()
        totals = {k: totals[k] + sums[k].detach() for k in LOSS_KEYS}
        n = n + num_pos.sum().detach()
        masks.append(counted)
    if mesh is not None and mesh.distributed:
        totals, n = reduce_over_ranks(model, totals, n, mesh)
    n = torch.clamp(n, min=1.0)
    with annotate("train.update"):
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(n)
    losses = {k: totals[k] / n for k in LOSS_KEYS}
    losses["total_loss"] = sum(losses[k] for k in LOSS_KEYS)
    losses["num_pos"] = n
    return losses, torch.cat(masks)


@torch.no_grad()
def reduce_over_ranks(model: RFBNet, totals: Dict[str, torch.Tensor],
                      n: torch.Tensor, mesh: Mesh):
    """The ranks' unnormalised gradients, loss sums and N summed, and
    BatchNorm's running statistics averaged, in place and in one
    all-reduce of one float32 buffer; returns the summed (totals, N)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    stats = bn_running_stats(model)
    scalars = torch.stack([totals[k] for k in LOSS_KEYS] + [n]).float()
    for t in grads + stats:
        if t.dtype != torch.float32:
            raise TypeError(f"the step reduces float32 tensors, got "
                            f"{t.dtype}")
    all_reduce_flat(mesh, grads + stats + [scalars])
    for t in stats:
        t.div_(mesh.world_size)
    return dict(zip(LOSS_KEYS, scalars[:3])), scalars[3]


def make_train_step(priors_cs: torch.Tensor, match_threshold: float = 0.5,
                    accum_steps: int = 1, mesh: Optional[Mesh] = None):
    """The train step: ``step(state, batch) → losses`` updates ``state`` in
    place (model, optimizer, schedule, ``state.step``), the batch (this
    rank's block under ``mesh``) taken in ``accum_steps`` micro-batches."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        with annotate("train.step"):
            losses, _ = loss_and_grads(state.model, batch, priors_cs,
                                       match_threshold,
                                       accum_steps=accum_steps, mesh=mesh)
            with annotate("train.update"):
                state.optimizer.step()
                state.scheduler.step()
                if state.model.task.has_ct_head:
                    normalize_obj_target(state.model)
            state.step += 1
        return losses

    return step
