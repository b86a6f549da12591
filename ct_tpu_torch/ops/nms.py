"""Batched fixed-shape NMS, the exact path of ``ct_tpu/ops/nms.py``.

  scores [B, P, C] → per-class top-K candidate selection → pairwise-IoU
  greedy suppression (fixpoint over a [K, K] mask, batched over images
  and classes) → per-image cap of the ``max_per_image`` best scores.

Kept from the reference eval loop: the +1 pixel area in IoU
(``pixel_offset``) and the ``>=`` k-th-score cap, with 32 rows of slack
for score ties. Ties in the candidate and cap orderings resolve to the
lower index first (a stable sort), as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    """Fixed-shape detection results.

    boxes  [B, D, 4] float32 (same coords as input boxes)
    scores [B, D]    float32
    classes[B, D]    int32   (1-based, background = 0 never emitted)
    valid  [B, D]    bool
    D = min((num_classes-1) × top_k, max_per_image + 32), score-sorted per
    image.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def _pairwise_iou_offset(boxes: torch.Tensor, offset: float) -> torch.Tensor:
    """[..., K, 4] → [..., K, K] IoU with the legacy +offset area."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + offset) * (y2 - y1 + offset)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = (xx2 - xx1 + offset).clamp(min=0.0)
    h = (yy2 - yy1 + offset).clamp(min=0.0)
    inter = w * h
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def nms_mask(
    boxes: torch.Tensor,    # [..., K, 4] sorted by descending score
    valid: torch.Tensor,    # [..., K] bool
    iou_threshold: float,
    pixel_offset: float = 0.0,
) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates → keep mask [..., K].

    Iterates ``keep_i ← valid_i ∧ ¬∃j<i (IoU_ji>t ∧ keep_j)`` to its
    fixpoint, which is the greedy solution; each sweep settles one more
    level of the suppression chain, so the loop runs (longest chain)
    sweeps over all leading dims at once.
    """
    k = boxes.shape[-2]
    iou = _pairwise_iou_offset(boxes, pixel_offset)
    idx = torch.arange(k, device=boxes.device)
    # sup[..., j, i]: candidate j (higher score, j < i) can suppress i
    sup = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    keep = valid
    for _ in range(k):
        suppressed = (sup & keep[..., :, None]).any(dim=-2)
        new = valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _sort_desc(x: torch.Tensor, n: int):
    """The n largest along the last axis, descending, ties lower-index
    first (what ``jax.lax.top_k`` returns)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def batched_nms(
    boxes: torch.Tensor,    # [B, P, 4]
    scores: torch.Tensor,   # [B, P, C] incl. background at class 0
    score_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    max_per_image: int = 200,
    pixel_offset: float = 1.0,
) -> Detections:
    """Per-class NMS + per-image score cap, batched, static shapes.

    Per foreground class, candidates above ``score_threshold`` (at most
    ``top_k``) are suppressed at ``iou_threshold``; the survivors across
    classes are capped at the ``max_per_image`` highest scores, ties with
    the cap-th score kept (``>=``).
    """
    batch, _, num_classes = scores.shape
    fg = scores[:, :, 1:].transpose(1, 2)                # [B, C-1, P]
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    s = torch.where(fg > score_threshold, fg, neg_inf)
    cs, top_i = _sort_desc(s, top_k)                     # [B, C-1, K]
    cb = torch.gather(
        boxes[:, None].expand(-1, num_classes - 1, -1, -1), 2,
        top_i[..., None].expand(-1, -1, -1, 4))          # [B, C-1, K, 4]
    keep = nms_mask(cb, torch.isfinite(cs), iou_threshold, pixel_offset)
    cs = torch.where(keep, cs, neg_inf)

    flat_s = cs.reshape(batch, -1)
    cap = min(max_per_image, flat_s.shape[1])
    d = min(flat_s.shape[1], cap + 32)
    top_s, order = _sort_desc(flat_s, d)
    kth = top_s[:, cap - 1:cap]
    kth = torch.where(torch.isfinite(kth), kth, neg_inf)
    sel = torch.where(top_s >= kth, top_s, neg_inf)
    valid = torch.isfinite(sel)
    c_ids = torch.arange(1, num_classes, dtype=torch.int32,
                         device=scores.device)
    c_ids = c_ids[None, :, None].expand_as(cs).reshape(batch, -1)
    out_b = torch.gather(cb.reshape(batch, -1, 4), 1,
                         order[..., None].expand(-1, -1, 4))
    out_c = torch.gather(c_ids, 1, order)
    zero = torch.zeros((), device=scores.device)
    return Detections(out_b, torch.where(valid, sel, zero),
                      torch.where(valid, out_c, torch.zeros_like(out_c)),
                      valid)
