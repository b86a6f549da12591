"""COCO bbox evaluation in numpy on the host.

The port of ``ct_tpu/data/cocoeval.py``, the COCO detection metric of the
reference's ``COCOeval`` (bbox):

  * IoU thresholds 0.5:0.05:0.95, recall thresholds 0:0.01:1;
  * area ranges all/small/medium/large, maxDets 1/10/100;
  * greedy per-image matching (detections by descending score, each picks
    the highest-IoU unmatched GT; crowd GTs can be matched repeatedly and
    ignored GTs don't count);
  * precision envelope accumulation, the 12 summary numbers and the AP of
    each category.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """IoU of [D,4] vs [G,4] xywh boxes; crowd GT uses intersection/det-area
    (the pycocotools ``iou`` convention for iscrowd)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) -
        np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) -
        np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


class COCOEvaluator:
    """Evaluate detection results (COCO json rows) against a CocoIndex."""

    def __init__(self, coco_index, cat_id_to_contiguous: Dict[int, int]):
        self.coco = coco_index
        self.cat_ids = sorted(cat_id_to_contiguous.keys())
        self.img_ids = coco_index.get_img_ids()
        self.eval_result = None  # precision array after evaluate()

    def evaluate(self, results: Sequence[dict]) -> Dict[str, float]:
        dts = defaultdict(list)
        for r in results:
            dts[(r["image_id"], r["category_id"])].append(r)

        n_iou, n_rec = len(IOU_THRS), len(REC_THRS)
        n_cat, n_area, n_md = len(self.cat_ids), len(AREA_RANGES), len(MAX_DETS)
        precision = -np.ones((n_iou, n_rec, n_cat, n_area, n_md))
        recall = -np.ones((n_iou, n_cat, n_area, n_md))

        area_items = list(AREA_RANGES.items())
        for ci, cat_id in enumerate(self.cat_ids):
            # gather per-image matches once per (cat, area, maxdet) combo
            per_image = [
                self._match_image(img_id, cat_id, dts)
                for img_id in self.img_ids
            ]
            for ai, (_, area_rng) in enumerate(area_items):
                for mi, max_det in enumerate(MAX_DETS):
                    self._accumulate(
                        per_image, area_rng, max_det, precision, recall,
                        ci, ai, mi,
                    )

        self.eval_result = {"precision": precision, "recall": recall}
        return self._summarize(precision, recall)

    # -- matching ----------------------------------------------------------

    def _match_image(self, img_id: int, cat_id: int, dts):
        """Returns dict with sorted det scores, per-IoU-thr matched gt
        indices, gt ignore flags and gt areas for one (image, category)."""
        gt = [a for a in self.coco.load_anns_for_img(img_id)
              if a["category_id"] == cat_id]
        dt = sorted(dts.get((img_id, cat_id), []),
                    key=lambda r: -r["score"])

        g_boxes = np.asarray([g["bbox"] for g in gt]).reshape(-1, 4)
        g_crowd = np.asarray(
            [bool(g.get("iscrowd", 0)) for g in gt], dtype=bool
        )
        # COCOeval overwrites any explicit json 'ignore' field: GT ignore
        # ⇔ iscrowd
        g_ignore_base = g_crowd.copy()
        g_area = np.asarray([g.get("area", b[2] * b[3])
                             for g, b in zip(gt, g_boxes)], dtype=float)
        d_boxes = np.asarray([d["bbox"] for d in dt]).reshape(-1, 4)
        d_scores = np.asarray([d["score"] for d in dt], dtype=float)

        ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd)
        return {
            "scores": d_scores, "d_areas": d_boxes[:, 2] * d_boxes[:, 3],
            "ious": ious, "g_ignore": g_ignore_base, "g_crowd": g_crowd,
            "g_area": g_area,
        }

    def _accumulate(self, per_image, area_rng, max_det, precision, recall,
                    ci, ai, mi):
        n_iou = len(IOU_THRS)
        all_scores, all_tp, all_ignore = [], [], []
        npig = 0
        for m in per_image:
            g_ig = m["g_ignore"] | (m["g_area"] < area_rng[0]) | (
                m["g_area"] > area_rng[1])
            npig += int((~g_ig).sum())
            # pycocotools orders GTs non-ignored-first (stable) before
            # matching; the "prefer real GT" early-break below relies on
            # every GT after the first ignored one also being ignored
            g_order = np.argsort(g_ig, kind="mergesort")
            g_ig = g_ig[g_order]
            g_crowd = m["g_crowd"][g_order]
            scores = m["scores"][:max_det]
            ious = m["ious"][:max_det][:, g_order]
            nd, ng = ious.shape

            tp = np.zeros((n_iou, nd), dtype=bool)
            d_ig = np.zeros((n_iou, nd), dtype=bool)
            for ti, thr in enumerate(IOU_THRS):
                g_matched = np.zeros(ng, dtype=bool)
                for di in range(nd):
                    best, best_iou = -1, min(thr, 1 - 1e-10)
                    for gi in range(ng):
                        # crowds can absorb multiple detections
                        if g_matched[gi] and not g_crowd[gi]:
                            continue
                        # prefer real GT: once matched to a non-ignored gt,
                        # stop at the ignored tail
                        if (best > -1 and not g_ig[best] and g_ig[gi]):
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best = gi
                    if best == -1:
                        # unmatched det in a filtered area range is ignored
                        d_ig[ti, di] = (
                            m["d_areas"][di] < area_rng[0]
                            or m["d_areas"][di] > area_rng[1]
                        )
                        continue
                    g_matched[best] = True
                    d_ig[ti, di] = g_ig[best]
                    tp[ti, di] = not g_ig[best]
            all_scores.append(scores)
            all_tp.append(tp)
            all_ignore.append(d_ig)

        if npig == 0:
            return
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        order = np.argsort(-scores, kind="mergesort")
        tp = np.concatenate(all_tp, axis=1)[:, order] if all_scores else \
            np.zeros((n_iou, 0), bool)
        ig = np.concatenate(all_ignore, axis=1)[:, order] if all_scores else \
            np.zeros((n_iou, 0), bool)

        for ti in range(n_iou):
            keep = ~ig[ti]
            tps = np.cumsum(tp[ti][keep])
            fps = np.cumsum(~tp[ti][keep])
            nd = len(tps)
            rc = tps / npig
            pr = tps / np.maximum(tps + fps, np.finfo(float).eps)
            recall[ti, ci, ai, mi] = rc[-1] if nd else 0.0
            # precision envelope (monotone non-increasing from the right)
            pr = np.maximum.accumulate(pr[::-1])[::-1] if nd else pr
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[ti, :, ci, ai, mi] = q

    # -- summaries ---------------------------------------------------------

    @staticmethod
    def _mean_valid(x: np.ndarray) -> float:
        x = x[x > -1]
        return float(np.mean(x)) if x.size else -1.0

    def _summarize(self, precision, recall) -> Dict[str, float]:
        area_keys = list(AREA_RANGES.keys())
        md100 = MAX_DETS.index(100)
        a_all = area_keys.index("all")

        def ap(iou=None, area=a_all, md=md100):
            p = precision[:, :, :, area, md]
            if iou is not None:
                p = p[np.isclose(IOU_THRS, iou)]
            return self._mean_valid(p)

        def ar(area=a_all, md=md100):
            return self._mean_valid(recall[:, :, area, md])

        stats = {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "APs": ap(area=area_keys.index("small")),
            "APm": ap(area=area_keys.index("medium")),
            "APl": ap(area=area_keys.index("large")),
            "AR1": ar(md=MAX_DETS.index(1)),
            "AR10": ar(md=MAX_DETS.index(10)),
            "AR100": ar(),
            "ARs": ar(area=area_keys.index("small")),
            "ARm": ar(area=area_keys.index("medium")),
            "ARl": ar(area=area_keys.index("large")),
        }
        for k, v in stats.items():
            logger.info("%s = %.3f", k, v)
        return stats

    def per_category_ap(self, class_names: Sequence[str]) -> Dict[str, float]:
        if self.eval_result is None:
            raise RuntimeError("run evaluate() first")
        precision = self.eval_result["precision"]
        out = {}
        for ci, name in enumerate(class_names):
            p = precision[:, :, ci, 0, -1]
            p = p[p > -1]
            out[name] = float(np.mean(p)) if p.size else float("nan")
        return out
