"""Box geometry: form conversion, IoU, variance encode/decode.

The port of ``ct_tpu/ops/boxes.py``. Every function takes boxes on the
last axis ([..., 4]) and works on any device; decode runs in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → (xmin, ymin, xmax, ymax). Shape [..., 4]."""
    center, size = boxes[..., :2], boxes[..., 2:]
    return torch.cat([center - size / 2, center + size / 2], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """(xmin, ymin, xmax, ymax) → (cx, cy, w, h). Shape [..., 4]."""
    mins, maxs = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(maxs + mins) / 2, maxs - mins], dim=-1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area. [..., A, 4] × [..., B, 4] → [..., A, B]
    (leading dims broadcast)."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    inter = (max_xy - min_xy).clamp(min=0)
    return inter[..., 0] * inter[..., 1]


def iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (jaccard overlap) of point-form boxes.
    [..., A, 4] × [..., B, 4] → [..., A, B]."""
    inter = intersect(box_a, box_b)
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union


def matrix_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU variant of the augmentation pipeline: the intersection is zeroed
    (not clamped per axis) unless the boxes overlap on every axis.
    [A, 4] × [B, 4] → [A, B]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    area_i = torch.prod(rb - lt, dim=2) * (lt < rb).all(dim=2)
    area_a = torch.prod(a[:, 2:] - a[:, :2], dim=1)
    area_b = torch.prod(b[:, 2:] - b[:, :2], dim=1)
    return area_i / (area_a[:, None] + area_b[None, :] - area_i)


def encode(
    matched: torch.Tensor,
    priors: torch.Tensor,
    variances: Sequence[float] = (0.1, 0.2),
) -> torch.Tensor:
    """Encode matched gt boxes (point form) against priors (center-size
    form) into regression targets. [..., P, 4] × [P, 4] → [..., P, 4]."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    # the log in float64, rounded once: torch's multithreaded float32 log
    # on the CPU has been measured off by up to 1.4e-4 (relative) on one
    # worker thread's share of a tensor, in processes that also run XLA
    # (ROADMAP Queue 3 item 1); the float64 one was exact in the same runs
    g_wh = torch.log(g_wh.double()).to(g_wh.dtype) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(
    loc: torch.Tensor,
    priors: torch.Tensor,
    variances: Sequence[float] = (0.1, 0.2),
) -> torch.Tensor:
    """Decode loc regressions against priors back to point-form boxes.

    [..., P, 4] × [P, 4] → [..., P, 4]; computed in float32.
    """
    loc = loc.float()
    priors = priors.float()
    centers = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    sizes = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = centers - sizes / 2
    maxs = mins + sizes
    return torch.cat([mins, maxs], dim=-1)
