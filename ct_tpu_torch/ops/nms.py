"""Batched fixed-shape NMS, the port of ``ct_tpu/ops/nms.py``.

  scores [B, P, C] → per-class top-K candidate selection → pairwise-IoU
  greedy suppression (batched over images and classes) → per-image cap of
  the ``max_per_image`` best scores.

Kept from the reference eval loop: the +1 pixel area in IoU
(``pixel_offset``) and the ``>=`` k-th-score cap, with 32 rows of slack
for score ties. bf16 scores (the bf16 serving path) are ranked and
thresholded in bf16, as the JAX package ranks them, where ties are common;
the detections' scores come out float32. Ties in the candidate and cap orderings resolve to the
lower index first (a stable sort), as ``jax.lax.top_k`` does. The serving
options of the JAX package carry over: ``approx_top_k`` (candidates by
``grouped_topk``) and ``pool_size`` (per-class work inside a pool of each
image's best priors).

The suppression itself, ``nms_mask``, runs as a hand-written CUDA kernel
on CUDA tensors (``csrc/nms.cu``, the port of ``nms_pallas``) on every eval
path, and as its plain version, a fixpoint loop, on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ct_tpu_torch import kernels

MAX_NMS_K = 1024   # the kernel's most candidates per row


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


def nms_mask_reference(
    boxes: torch.Tensor,    # [..., K, 4] sorted by descending score
    valid: torch.Tensor,    # [..., K] bool
    iou_threshold: float,
    pixel_offset: float = 0.0,
) -> torch.Tensor:
    """The plain suppression → keep mask [..., K].

    Iterates ``keep_i ← valid_i ∧ ¬∃j<i (IoU_ji>t ∧ keep_j)`` to its
    fixpoint, which is the greedy solution; each sweep settles one more
    level of the suppression chain, so the loop runs (longest chain)
    sweeps over all leading dims at once, each ending in a host sync. The
    sweeps of the last call are left in ``nms_mask_reference.sweeps``.
    """
    k = boxes.shape[-2]
    iou = _pairwise_iou_offset(boxes, pixel_offset)
    idx = torch.arange(k, device=boxes.device)
    # sup[..., j, i]: candidate j (higher score, j < i) can suppress i
    sup = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    keep = valid
    sweeps = 0
    for _ in range(k):
        sweeps += 1
        suppressed = (sup & keep[..., :, None]).any(dim=-2)
        new = valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    nms_mask_reference.sweeps = sweeps
    return keep


nms_mask_reference.sweeps = 0


def nms_mask(
    boxes: torch.Tensor,    # [..., K, 4] float32, sorted by descending score
    valid: torch.Tensor,    # [..., K] bool
    iou_threshold: float,
    pixel_offset: float = 0.0,
) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates → keep mask [..., K]
    (bool), the same mask on both devices.

    CUDA tensors go to the NMS kernel, one launch for all leading dims and
    no host sync, counted on ``nms_mask.launches``; CPU tensors to the
    plain fixpoint loop. The JAX package chooses between its Pallas kernel
    and its XLA loop with ``use_pallas``; the port has no such switch, as
    the device of the tensors decides.
    """
    if boxes.device.type == "cpu":
        return nms_mask_reference(boxes, valid, iou_threshold, pixel_offset)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_mask: no kernel for {boxes.device}")
    k = boxes.shape[-2]
    lead = tuple(boxes.shape[:-2])
    if (boxes.dtype != torch.float32 or boxes.shape[-1] != 4
            or valid.dtype != torch.bool or tuple(valid.shape) != lead + (k,)
            or valid.device != boxes.device):
        raise ValueError(f"nms_mask: boxes must be float32 [..., K, 4] and "
                         f"valid bool [..., K] on one device, got "
                         f"{boxes.dtype} {tuple(boxes.shape)} and "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if k > MAX_NMS_K:
        raise ValueError(f"nms_mask: K={k} candidates, the kernel takes at "
                         f"most {MAX_NMS_K}")
    # the kernel writes every entry: no fill
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    n = keep.numel() // max(k, 1)
    if n and k:
        kernels.launch(nms_mask, "nms_mask",
                       (boxes.contiguous(), valid.contiguous(), keep),
                       (n, k, float(iou_threshold), float(pixel_offset)))
    return keep


nms_mask.launches = 0


def _sort_desc(x: torch.Tensor, n: int):
    """The n largest along the last axis, descending, ties lower-index
    first (what ``jax.lax.top_k`` returns for the scores NMS ranks, which
    are above its threshold or -inf; unlike it, -0.0 ties with +0.0)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def grouped_topk(x: torch.Tensor, k: int, passes: int = 6,
                 group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over the last axis (``grouped_topk`` of the JAX
    package): the ``passes`` largest of each ``group``-wide slice by
    argmax-and-mask sweeps, then an exact top-k over those survivors. An
    element of the true top-k is missed only where its group holds more
    than ``passes`` of them. Falls back to the exact top-k when
    ``passes · groups < k``. Ties go to the lower index, as in JAX."""
    p = x.shape[-1]
    groups = -(-p // group)
    if passes * groups < k:
        return _sort_desc(x, k)
    xg = torch.nn.functional.pad(x, (0, groups * group - p),
                                 value=float("-inf"))
    xg = xg.reshape(*x.shape[:-1], groups, group)
    goff = torch.arange(groups, device=x.device) * group
    lane = torch.arange(group, device=x.device)
    vals, idxs = [], []
    for _ in range(passes):
        i = torch.argmax(xg, dim=-1)                    # first maximum
        vals.append(torch.amax(xg, dim=-1))
        idxs.append(goff + i)
        xg = torch.where(lane == i[..., None], float("-inf"), xg)
    tv, ti = _sort_desc(torch.cat(vals, -1), k)
    ci = torch.gather(torch.cat(idxs, -1), -1, ti)
    return tv, torch.clamp(ci, max=p - 1)


def batched_nms(
    boxes: torch.Tensor,    # [B, P, 4]
    scores: torch.Tensor,   # [B, P, C] incl. background at class 0
    score_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    max_per_image: int = 200,
    pixel_offset: float = 1.0,
    approx_top_k: bool = False,
    pool_size: int = 0,
) -> Detections:
    """Per-class NMS + per-image score cap, batched, static shapes.

    Per foreground class, candidates above ``score_threshold`` (at most
    ``top_k``) are suppressed at ``iou_threshold``; the survivors across
    classes are capped at the ``max_per_image`` highest scores, ties with
    the cap-th score kept (``>=``).

    ``approx_top_k`` picks each class's candidates with ``grouped_topk``.
    ``pool_size`` first restricts each image to its ``pool_size`` priors of
    highest best-class score (by ``grouped_topk``) and runs the per-class
    selection inside that pool; 0 is the exact path.
    """
    batch, _, num_classes = scores.shape
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    fg = scores[:, :, 1:]                                    # [B, P, C-1]
    select = grouped_topk if approx_top_k else _sort_desc
    k = top_k
    if pool_size:
        m = min(pool_size, boxes.shape[1])
        best = fg.amax(dim=-1)
        best = torch.where(best > score_threshold, best, neg_inf)
        _, pool_i = grouped_topk(best, m)                    # [B, M]
        boxes = torch.gather(boxes, 1, pool_i[..., None].expand(-1, -1, 4))
        # float32 from here, as the JAX package gathers the scores beside
        # the boxes (one float32 payload): bf16 scores then meet the
        # threshold in float32, where the exact path compares them in bf16
        fg = torch.gather(fg, 1, pool_i[..., None].expand(
            -1, -1, num_classes - 1)).float()
        select, k = _sort_desc, min(top_k, m)
    fg = fg.transpose(1, 2)                                  # [B, C-1, P|M]
    s = torch.where(fg > score_threshold, fg, neg_inf)
    cs, top_i = select(s, k)                                 # [B, C-1, K]
    cb = torch.gather(
        boxes[:, None].expand(-1, num_classes - 1, -1, -1), 2,
        top_i[..., None].expand(-1, -1, -1, 4))              # [B, C-1, K, 4]
    if k < top_k:  # a pool smaller than top_k: keep the output shape
        cb = torch.nn.functional.pad(cb, (0, 0, 0, top_k - k))
        cs = torch.nn.functional.pad(cs, (0, top_k - k),
                                     value=float("-inf"))
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
    return Detections(out_b, torch.where(valid, sel, zero).float(),
                      torch.where(valid, out_c, torch.zeros_like(out_c)),
                      valid)
