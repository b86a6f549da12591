"""The numbers that decide ``correct``, from the program's outputs and
the plain reference's.

Serving (every request of the window; identical answers are judged once):

* ``score_gap``: for each detection the program returned, the anchor of
  the reference's dense output that explains it best, by the larger of
  the score gap at the detection's class and 1 − IoU of the two boxes
  (pixels); the number is the widest such gap over all detections. It
  holds the forward, box decode and score fusion to the reference for
  every answer, whatever NMS kept. ``score_gap_mean`` is the mean of the
  same gaps over every detection.
* ``unmatched_pct``: of the confident detections (score ≥ 0.3) of both
  sides, the share with no detection of the same class at IoU ≥ 0.5 on
  the other side. It holds the candidate selection, NMS and the cap: a
  detection missing, surplus or of another class shows.

Training (the first three steps of the window's own call and feed):

* ``loss_gap``: the largest relative gap of a step's total loss;
* ``grad_gap``: of the first step's gradient, as the optimizer got it
  (worked out from its momentum buffer after one step), the worst leaf's
  gap between the program's norm and the reference's, over the larger of
  that leaf's reference norm and the median leaf's;
* ``change_gap``: the same of each parameter's change over the three
  steps, over the leaves whose reference gradient is not nought to
  rounding (its norm at least a thousandth of the median leaf's);
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gaps;
* ``ct_grad_gap``, ``ct_change_gap``: the worst leaf's gaps among the
  Context-Transformer head's leaves alone (``CT_HEAD``: θ, φ, g, ``Wz``,
  ``OBJ_Target``, ``fc_base``, ``scale``), each over the same larger of
  its own and the median leaf's norm: a fault of the head's kernels or of
  its update shows here whatever the trunk's leaves read.

A cell compares the numbers its workload file gives limits to.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

CONFIDENT = 0.3
MATCH_IOU = 0.5
# the top-level names of the Context-Transformer head's parameters
CT_HEAD = ("theta", "phi", "g", "Wz", "OBJ_Target", "fc_base", "scale")


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A, 4] × [..., B, 4] pixel boxes → [..., A, B]."""
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area = lambda t: (t[..., 2] - t[..., 0]).clamp(min=0) * (
        t[..., 3] - t[..., 1]).clamp(min=0)
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter
                    ).clamp(min=1e-9)


def score_gaps(boxes, scores, classes, valid, ref_boxes,
               ref_scores) -> torch.Tensor:
    """Each of the program's detections [B, D, ...]: its gap to the dense
    reference output (boxes [B, P, 4] pixels, fused scores [B, P, C+1]) at
    the anchor that explains it best."""
    out = [torch.zeros(0, device=boxes.device)]
    for i in range(boxes.shape[0]):
        v = valid[i]
        if not bool(v.any()):
            continue
        b, s, c = boxes[i][v], scores[i][v], classes[i][v].long()
        iou = _iou(b, ref_boxes[i])                        # [D, P]
        gap = (s[:, None] - ref_scores[i][:, c].T).abs()   # [D, P]
        out.append(torch.maximum(gap, 1 - iou).amin(1))
    return torch.cat(out)


def unmatched(boxes, scores, classes, valid, rboxes, rscores, rclasses,
              rvalid) -> List[int]:
    """[unmatched, confident] detections of both sides, over the batch."""
    miss = total = 0
    for i in range(boxes.shape[0]):
        sides = []
        for bx, sc, cl, va in ((boxes, scores, classes, valid),
                               (rboxes, rscores, rclasses, rvalid)):
            keep = va[i] & (sc[i] >= CONFIDENT)
            sides.append((bx[i][keep], cl[i][keep].long()))
        for (b1, c1), (b2, c2) in ((sides[0], sides[1]),
                                   (sides[1], sides[0])):
            total += len(c1)
            if not len(c1):
                continue
            if not len(c2):
                miss += len(c1)
                continue
            ok = (_iou(b1, b2) >= MATCH_IOU) & (c1[:, None] == c2[None, :])
            miss += int((~ok.any(1)).sum())
    return [miss, total]


def serve_numbers(per_batch: Sequence[dict]) -> Dict[str, float]:
    """``per_batch``: {prog: (boxes, scores, classes, valid), dense:
    (boxes, scores), ref: (boxes, scores, classes, valid)} of each distinct
    (request batch, answer) pair, tensors on one device."""
    gaps, miss, total = [], 0, 0
    for item in per_batch:
        gaps.append(score_gaps(*item["prog"], *item["dense"]))
        m, t = unmatched(*item["prog"], *item["ref"])
        miss, total = miss + m, total + t
    gaps = torch.cat(gaps)
    return {"score_gap": float(gaps.max()) if len(gaps) else 0.0,
            "score_gap_mean": float(gaps.mean()) if len(gaps) else 0.0,
            "unmatched_pct": 100.0 * miss / total if total else 0.0}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keys) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the leaf's reference norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    median = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], median, 1e-30) for k in keys}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2]


def train_numbers(prog_losses: Sequence[float], ref_losses: Sequence[float],
                  prog_grad: Dict[str, torch.Tensor],
                  ref_grad: Dict[str, torch.Tensor],
                  prog_change: Dict[str, torch.Tensor],
                  ref_change: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The worst leaf's gaps (``grad_gap``, ``change_gap``), the median
    leaf's (``grad_gap_median``, ``change_gap_median``), the CT head's
    worst leaf's (``ct_grad_gap``, ``ct_change_gap``) and the largest
    relative loss gap over the steps (``loss_gap``); ``worst`` names the
    worst leaves."""
    keys = sorted(ref_grad)
    norms = {k: float(torch.linalg.vector_norm(ref_grad[k].double()))
             for k in keys}
    median = sorted(norms.values())[len(norms) // 2]
    moving = [k for k in keys if norms[k] >= 1e-3 * median]
    grad = _leaf_gaps(prog_grad, ref_grad, keys)
    change = _leaf_gaps(prog_change, ref_change, moving)
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    head = lambda gaps: max((v for k, v in gaps.items()
                             if k.split(".")[0] in CT_HEAD), default=0.0)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(prog_losses, ref_losses)),
        "grad_gap": grad[worst_g], "change_gap": change[worst_c],
        "grad_gap_median": _median(grad.values()),
        "change_gap_median": _median(change.values()),
        "ct_grad_gap": head(grad), "ct_change_gap": head(change),
        "worst": {"grad": worst_g, "change": worst_c,
                  "grad_top": sorted(grad.items(), key=lambda kv: -kv[1])[:6],
                  "change_top": sorted(change.items(),
                                       key=lambda kv: -kv[1])[:6]},
    }
