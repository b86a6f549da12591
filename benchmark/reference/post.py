"""Plain post-processing of the detector: anchors, box decode, obj×conf
score fusion, per-class greedy NMS and the per-image cap.

A frozen copy of the semantics of the reference implementation's
``PriorBox``, ``decode`` and per-class NMS eval, with the serving options
of the JAX package that the port serves with: candidates chosen per class
by an approximate top-k (the ``passes`` largest of each ``group``-wide
slice, then an exact top-k of those), and a per-image pool of the priors
of highest best-class score. Plain PyTorch; NMS is the fixpoint of
``keep_i = valid_i ∧ ¬∃ j < i (IoU_ji > t ∧ keep_j)`` over score-sorted
candidates, which is the greedy solution. IoU uses the +1 pixel area.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

SCORE_THRESHOLD = 0.01
IOU_THRESHOLD = 0.45
MAX_PER_IMAGE = 200
VARIANCES = (0.1, 0.2)

# (feature maps, steps, min sizes, max sizes, aspect ratios) of the
# published VOC_300 and VOC_512 configs, and the CPU tests' size-64 model
PRIORS = {
    300: ((38, 19, 10, 5, 3, 1), (8, 16, 32, 64, 100, 300),
          (30, 60, 111, 162, 213, 264), (60, 111, 162, 213, 264, 315),
          ((2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,))),
    512: ((64, 32, 16, 8, 4, 2, 1), (8, 16, 32, 64, 128, 256, 512),
          (35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8),
          (76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6),
          ((2, 3), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,))),
    64: ((16, 8), (4, 8), (16, 28), (28, 44), ((2,), (2,))),
}


class Detections(NamedTuple):
    boxes: torch.Tensor      # [B, D, 4] pixels
    scores: torch.Tensor     # [B, D]
    classes: torch.Tensor    # [B, D] 1-based
    valid: torch.Tensor      # [B, D]


def priors(size: int) -> torch.Tensor:
    """[P, 4] center-size anchors in [0, 1], row-major over cells, anchors
    innermost: min size, geometric mean, then (√r, 1/√r), (1/√r, √r) per
    aspect ratio r; clipped to [0, 1]."""
    maps, steps, mins, maxs, ratios = PRIORS[size]
    out = []
    for k, f in enumerate(maps):
        f_k = size / steps[k]
        s = mins[k] / size
        s2 = math.sqrt(s * (maxs[k] / size))
        whs = [(s, s), (s2, s2)]
        for r in ratios[k]:
            whs += [(s * math.sqrt(r), s / math.sqrt(r)),
                    (s / math.sqrt(r), s * math.sqrt(r))]
        for i in range(f):
            for j in range(f):
                cx, cy = (j + 0.5) / f_k, (i + 0.5) / f_k
                out += [(cx, cy, w, h) for w, h in whs]
    return torch.from_numpy(np.clip(np.asarray(out, np.float64), 0, 1)
                            .astype(np.float32))


def decode(loc: torch.Tensor, pri: torch.Tensor,
           variances: Sequence[float] = VARIANCES) -> torch.Tensor:
    """[B, P, 4] regressions → point-form boxes in [0, 1] coordinates."""
    centers = pri[:, :2] + loc[..., :2] * variances[0] * pri[:, 2:]
    sizes = pri[:, 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = centers - sizes / 2
    return torch.cat([mins, mins + sizes], -1)


def fuse(conf: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """[B, P, C] × [B, P, 2] → [B, P, C+1]: [obj_bg, obj_fg · conf_k]."""
    return torch.cat([obj[..., :1], obj[..., 1:2] * conf], -1)


def top(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The n largest along the last axis, descending, lower index first
    among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def grouped_top(x: torch.Tensor, k: int, passes: int = 6,
                group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate top-k: the ``passes`` largest of each group (first
    maximum first), then the exact top-k of those survivors; exact when
    they are fewer than k."""
    p = x.shape[-1]
    groups = -(-p // group)
    if passes * groups < k:
        return top(x, k)
    xg = torch.nn.functional.pad(x, (0, groups * group - p),
                                 value=float("-inf"))
    xg = xg.reshape(*x.shape[:-1], groups, group)
    lane = torch.arange(group, device=x.device)
    vals, idxs = [], []
    for _ in range(passes):
        i = torch.argmax(xg, -1)
        vals.append(torch.amax(xg, -1))
        idxs.append(torch.arange(groups, device=x.device) * group + i)
        xg = torch.where(lane == i[..., None], float("-inf"), xg)
    tv, ti = top(torch.cat(vals, -1), k)
    return tv, torch.clamp(torch.gather(torch.cat(idxs, -1), -1, ti),
                           max=p - 1)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             threshold: float) -> torch.Tensor:
    """Greedy suppression of score-sorted [..., K, 4] pixel boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = (torch.minimum(x2[..., :, None], x2[..., None, :])
         - torch.maximum(x1[..., :, None], x1[..., None, :]) + 1).clamp(min=0)
    h = (torch.minimum(y2[..., :, None], y2[..., None, :])
         - torch.maximum(y1[..., :, None], y1[..., None, :]) + 1).clamp(min=0)
    inter = w * h
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    sup = (iou > threshold) & (idx[:, None] < idx[None, :])
    keep = valid
    for _ in range(k):
        new = valid & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def detect(boxes: torch.Tensor, fused: torch.Tensor, top_k: int,
           approx: bool, pool_size: int) -> Detections:
    """Per-class NMS and the per-image cap over [B, P, 4] pixel boxes and
    [B, P, C+1] fused scores: per class at most ``top_k`` candidates above
    the score threshold (among the image's ``pool_size`` priors of highest
    best-class score when it is not 0), suppressed at IoU 0.45; then the
    200 best of the image, ties with the 200th kept."""
    b, _, n_cls = fused.shape
    ninf = float("-inf")
    fg = fused[..., 1:]
    select = grouped_top if approx else top
    k = top_k
    if pool_size:
        m = min(pool_size, boxes.shape[1])
        best = fg.amax(-1)
        _, pool = grouped_top(torch.where(best > SCORE_THRESHOLD, best,
                                          torch.full_like(best, ninf)), m)
        boxes = torch.gather(boxes, 1, pool[..., None].expand(-1, -1, 4))
        fg = torch.gather(fg, 1, pool[..., None].expand(-1, -1, n_cls - 1))
        select, k = top, min(top_k, m)
    fg = fg.transpose(1, 2)
    s = torch.where(fg > SCORE_THRESHOLD, fg, torch.full_like(fg, ninf))
    cs, ci = select(s, k)                                  # [B, C, K]
    cb = torch.gather(boxes[:, None].expand(-1, n_cls - 1, -1, -1), 2,
                      ci[..., None].expand(-1, -1, -1, 4))
    keep = nms_keep(cb, torch.isfinite(cs), IOU_THRESHOLD)
    cs = torch.where(keep, cs, torch.full_like(cs, ninf))
    flat = cs.reshape(b, -1)
    cap = min(MAX_PER_IMAGE, flat.shape[1])
    top_s, order = top(flat, min(flat.shape[1], cap + 32))
    kth = top_s[:, cap - 1:cap]
    sel = torch.where(top_s >= kth, top_s, torch.full_like(top_s, ninf))
    valid = torch.isfinite(sel)
    cls = torch.arange(1, n_cls, device=fused.device)[None, :, None]
    cls = cls.expand_as(cs).reshape(b, -1)
    return Detections(
        torch.gather(cb.reshape(b, -1, 4), 1,
                     order[..., None].expand(-1, -1, 4)),
        torch.where(valid, sel, torch.zeros_like(sel)),
        torch.where(valid, torch.gather(cls, 1, order), 0), valid)


def pixel_boxes(loc: torch.Tensor, pri: torch.Tensor,
                sizes: torch.Tensor) -> torch.Tensor:
    """Decoded boxes scaled to each image's (h, w) in pixels."""
    hw = sizes.float()
    h, w = hw[:, 0:1], hw[:, 1:2]
    return decode(loc, pri) * torch.stack([w, h, w, h], -1)
