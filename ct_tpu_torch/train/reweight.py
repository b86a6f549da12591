"""OBJ_Target prototype initialisation from source-class embeddings.

The port of ``ct_tpu/train/reweight.py`` (``init_reweight``): run
``init_iter`` forward-only batches in train mode (BatchNorm normalises
with batch statistics and updates its running statistics, as the
reference's ``model(data, init=True)`` under ``model.train()`` does), match
the priors to the ground truth, sum each positive anchor's ℓ2-normalised
pre-CT conf feature per class, average, renormalise the class means and
install them as the ``OBJ_Target`` rows. In the incremental setting all 20
classes are accumulated and the last 5 (the novel classes) kept.

Under a ``mesh`` of several ranks each rank runs its block of each batch;
one all-reduce then sums the per-class sums and counts before the means,
and averages the BatchNorm running statistics that the train-mode
forwards moved, so every rank installs the same ``OBJ_Target``: one
process's over the union of the blocks, each block a batch of its own.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.nn.functional as F

from ct_tpu_torch.config import TaskSpec
from ct_tpu_torch.models.rfbnet import RFBNet
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.parallel.mesh import Mesh, all_reduce_flat, bn_running_stats
from ct_tpu_torch.train.step import batch_to

logger = logging.getLogger(__name__)


@torch.no_grad()
def init_reweight(model: RFBNet, loader, priors_cs: torch.Tensor,
                  task: TaskSpec, init_iter: int,
                  match_threshold: float = 0.5,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Compute and install ``OBJ_Target`` from ``init_iter`` batches of
    ``loader.next()`` (this rank's blocks under ``mesh``); returns the
    installed prototypes [N, C]."""
    logger.info("Initializing the OBJ_Target parameters...")
    num_classes = 20 if task.setting == "incre" else task.num_classes - 1
    device = priors_cs.device
    sums = torch.zeros(num_classes, task.src_cls_dim, device=device)
    counts = torch.zeros(num_classes, device=device)
    model.train()
    for _ in range(init_iter):
        batch = batch_to(loader.next(), device)
        feats = model(batch["image"]).conf_feat                 # [B, P, D]
        matched = match_batch(batch["boxes"], batch["labels"],
                              batch["weights"], batch["valid"], priors_cs,
                              match_threshold)
        unit = feats / torch.clamp(
            torch.linalg.vector_norm(feats, dim=-1, keepdim=True), min=1e-12)
        cls = matched.cls_t
        onehot = (F.one_hot((cls - 1).clamp(min=0), num_classes).to(
            unit.dtype) * (cls > 0)[..., None])              # [B, P, C]
        sums += torch.einsum("bpc,bpd->cd", onehot, unit)
        counts += onehot.sum(dim=(0, 1))

    if mesh is not None and mesh.distributed:
        stats = bn_running_stats(model)
        all_reduce_flat(mesh, [sums, counts] + stats)
        for t in stats:
            t.div_(mesh.world_size)
    means = sums / torch.clamp(counts[:, None], min=1)
    if task.setting == "incre":
        means = means[15:]
    prototypes = means / torch.clamp(
        torch.linalg.vector_norm(means, dim=1, keepdim=True), min=1e-12)
    if prototypes.shape != model.OBJ_Target.weight.shape:
        raise ValueError(f"init_reweight: prototypes {tuple(prototypes.shape)}"
                         f" do not fit OBJ_Target "
                         f"{tuple(model.OBJ_Target.weight.shape)}")
    model.OBJ_Target.weight.copy_(prototypes)
    return prototypes
