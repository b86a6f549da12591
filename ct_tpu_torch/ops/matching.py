"""Ground truth ↔ prior matching on padded targets, batched.

The port of ``ct_tpu/ops/matching.py`` (``match_single``/``match_batch``).
Targets are padded to M rows per image:

  boxes   [B, M, 4]  point form, percent coordinates
  labels  [B, M]     1..C real classes, -1 = ignore (instance shots)
  weights [B, M]     mixup weights (1.0 without mixup)
  valid   [B, M]     False for padding rows

Semantics kept:
  * each prior takes its best-overlapping gt;
  * each gt's best prior is forced to that gt with overlap 2, and where two
    gts claim one prior the later gt wins;
  * priors whose overlap is below the threshold become background (label
    0, weight 1);
  * ``obj_t = label != 0``: ignored (-1) anchors count as objects.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ct_tpu_torch.ops import boxes as box_ops


class MatchResult(NamedTuple):
    loc_t: torch.Tensor   # [B, P, 4] encoded regression targets
    cls_t: torch.Tensor   # [B, P] int64 class label (0 = background)
    w_t: torch.Tensor     # [B, P] float32 per-anchor loss weight
    obj_t: torch.Tensor   # [B, P] bool objectness target


@torch.no_grad()
def match_batch(
    gt_boxes: torch.Tensor,     # [B, M, 4]
    gt_labels: torch.Tensor,    # [B, M]
    gt_weights: torch.Tensor,   # [B, M]
    gt_valid: torch.Tensor,     # [B, M]
    priors_cs: torch.Tensor,    # [P, 4] center-size form
    threshold: float = 0.5,
    variances: Sequence[float] = (0.1, 0.2),
) -> MatchResult:
    """Match every image's padded ground truth against all priors."""
    b, m = gt_labels.shape
    num_priors = priors_cs.shape[0]
    valid = gt_valid.bool()

    overlaps = box_ops.iou(gt_boxes, box_ops.point_form(priors_cs))  # [B,M,P]
    overlaps = torch.where(valid[..., None], overlaps, -1.0)

    # best gt per prior (first of equal overlaps)
    best_truth_overlap = overlaps.amax(dim=1)                 # [B, P]
    best_truth_idx = overlaps.argmax(dim=1)                   # [B, P]

    # force each valid gt's best prior to that gt; the later gt wins
    best_prior_idx = overlaps.argmax(dim=2)                   # [B, M]
    obj_ids = torch.arange(m, device=gt_labels.device).expand(b, m)
    claimed_by = torch.full((b, num_priors), -1, dtype=torch.long,
                            device=gt_labels.device)
    claimed_by.scatter_reduce_(1, best_prior_idx,
                               torch.where(valid, obj_ids, -1),
                               reduce="amax")
    forced = claimed_by >= 0
    best_truth_idx = torch.where(forced, claimed_by, best_truth_idx)
    best_truth_overlap = torch.where(forced, 2.0, best_truth_overlap)

    matched = torch.gather(gt_boxes, 1,
                           best_truth_idx[..., None].expand(b, num_priors, 4))
    cls_t = torch.gather(gt_labels.long(), 1, best_truth_idx)
    w_t = torch.gather(gt_weights.float(), 1, best_truth_idx)

    below = best_truth_overlap < threshold
    cls_t = torch.where(below, 0, cls_t)
    w_t = torch.where(below, 1.0, w_t)

    loc_t = box_ops.encode(matched, priors_cs, variances)
    return MatchResult(loc_t, cls_t, w_t, cls_t != 0)
