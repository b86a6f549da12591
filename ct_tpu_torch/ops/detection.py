"""Test-time detection: batched decode + obj×conf score fusion + NMS.

The port of ``ct_tpu/ops/detection.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ct_tpu_torch.ops import boxes as box_ops
from ct_tpu_torch.ops.nms import Detections, batched_nms


def fuse_scores(conf_probs: torch.Tensor,
                obj_probs: torch.Tensor) -> torch.Tensor:
    """[B,P,C]×[B,P,2] → [B,P,C+1]: [obj_bg, obj_fg·conf_k]."""
    fg = obj_probs[..., 1:2] * conf_probs
    return torch.cat([obj_probs[..., 0:1], fg], dim=-1)


def decode_and_fuse(
    loc: torch.Tensor,          # [B, P, 4] raw regressions
    conf_probs: torch.Tensor,   # [B, P, C] softmaxed class scores
    obj_probs: torch.Tensor,    # [B, P, 2] softmaxed objectness
    priors: torch.Tensor,       # [P, 4] center-size form
    variances: Tuple[float, float] = (0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (boxes [B,P,4] point-form percent coords, scores [B,P,C+1])."""
    boxes = box_ops.decode(loc, priors, variances)
    return boxes, fuse_scores(conf_probs, obj_probs)


def postprocess(
    loc: torch.Tensor,
    conf_probs: torch.Tensor,
    obj_probs: torch.Tensor,
    priors: torch.Tensor,
    image_sizes: Optional[torch.Tensor] = None,  # [B, 2] (height, width)
    variances: Tuple[float, float] = (0.1, 0.2),
    score_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    max_per_image: int = 200,
    approx_top_k: bool = False,
    pool_size: int = 0,
) -> Detections:
    """Full eval-path post-processing for a batch.

    With ``image_sizes`` the boxes are scaled to pixel coordinates before
    NMS and IoU uses the +1 pixel area, like the reference; without, boxes
    stay in percent coordinates and the +1 is dropped. ``top_k``,
    ``approx_top_k`` and ``pool_size`` are ``batched_nms``'s.
    """
    boxes, scores = decode_and_fuse(loc, conf_probs, obj_probs, priors,
                                    variances)
    if image_sizes is not None:
        hw = image_sizes.to(device=boxes.device, dtype=torch.float32)
        h, w = hw[:, 0:1], hw[:, 1:2]
        boxes = boxes * torch.stack([w, h, w, h], dim=-1)   # [B, 1, 4]
        pixel_offset = 1.0
    else:
        pixel_offset = 0.0
    return batched_nms(
        boxes, scores,
        score_threshold=score_threshold,
        iou_threshold=iou_threshold,
        top_k=top_k,
        max_per_image=max_per_image,
        pixel_offset=pixel_offset,
        approx_top_k=approx_top_k,
        pool_size=pool_size,
    )
