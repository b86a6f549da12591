"""The train step: forward → matching → loss → backward → SGD → renorm.

The port of ``ct_tpu/train/step.py`` (``TrainState``,
``normalize_obj_target``, ``make_train_step`` with ``mesh=None`` and
``accum_steps=1``). One step:

  1. the forward in train mode (BatchNorm on batch statistics, running
     statistics updated at momentum 0.01);
  2. matching of the padded targets against the priors;
  3. the unnormalised loss sums and the positive count N;
  4. the backward of their sum, then every gradient divided by
     N = max(N, 1);
  5. one SGD update and one schedule step;
  6. with the CT head, the ``OBJ_Target`` rows renormalised to unit length.

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
                   mask: Optional[torch.Tensor] = None):
    """Steps 1–4: the gradients of the N-normalised total loss land in each
    parameter's ``.grad``. Returns (the normalised losses and N as detached
    scalars, the [B, P] mask of the anchors counted: positives and mined
    hard negatives, or ``mask`` where given)."""
    model.train()
    preds = model(batch["image"])
    matched = match_batch(batch["boxes"], batch["labels"], batch["weights"],
                          batch["valid"], priors_cs, match_threshold)
    mined, num_pos = loss_mask(preds.obj, matched)
    mask = mined if mask is None else mask
    sums = masked_loss_sums(preds.loc, preds.conf, preds.obj, matched, mask)
    n = num_pos.sum()
    model.zero_grad(set_to_none=True)
    sum(sums[k] for k in LOSS_KEYS).backward()
    n = torch.clamp(n.detach(), min=1.0)
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(n)
    losses = {k: sums[k].detach() / n for k in LOSS_KEYS}
    losses["total_loss"] = sum(losses[k] for k in LOSS_KEYS)
    losses["num_pos"] = n
    return losses, mask


def make_train_step(priors_cs: torch.Tensor, match_threshold: float = 0.5):
    """The train step: ``step(state, batch) → losses`` updates ``state`` in
    place (model, optimizer, schedule, ``state.step``)."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        losses, _ = loss_and_grads(state.model, batch, priors_cs,
                                   match_threshold)
        state.optimizer.step()
        state.scheduler.step()
        if state.model.task.has_ct_head:
            normalize_obj_target(state.model)
        state.step += 1
        return losses

    return step
