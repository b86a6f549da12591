"""PASCAL VOC per-class average precision (numpy only).

The port's own copy of ``ct_tpu/data/voc_eval.py``: per-class PR curves
from result files, greedy highest-IoU matching against non-difficult GT,
the VOC07 11-point metric for 2007 (the continuous AUC variant otherwise),
and an annotation pickle cache keyed by image id.
"""

from __future__ import annotations

import logging
import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def parse_annotation(path: str) -> List[dict]:
    """Parse one VOC XML file into a list of object dicts."""
    objects = []
    for obj in ET.parse(path).findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "difficult": int(obj.find("difficult").text),
            "bbox": [
                int(bbox.find("xmin").text),
                int(bbox.find("ymin").text),
                int(bbox.find("xmax").text),
                int(bbox.find("ymax").text),
            ],
        })
    return objects


def average_precision(rec: np.ndarray, prec: np.ndarray,
                      use_07_metric: bool = False) -> float:
    if use_07_metric:
        # 11-point interpolation at recall 0.0, 0.1, …, 1.0
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # area under the monotonized PR curve
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    change = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[change + 1] - mrec[change]) * mpre[change + 1]))


def _load_gt(annopath: str, imagesetfile: str, cachedir: str) -> Dict:
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    with open(imagesetfile) as f:
        imagenames = [line.strip() for line in f]
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return pickle.load(f)
    recs = {
        name: parse_annotation(annopath.format(name)) for name in imagenames
    }
    with open(cachefile, "wb") as f:
        pickle.dump(recs, f)
    return recs


def voc_eval(
    detfile: str,
    annopath: str,
    imagesetfile: str,
    classname: str,
    cachedir: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evaluate one class's detection results file → (recall, precision, AP).

    ``detfile`` rows: ``image_id score x1 y1 x2 y2`` (1-based pixel coords).
    """
    recs = _load_gt(annopath, imagesetfile, cachedir)
    with open(imagesetfile) as f:
        imagenames = [line.strip() for line in f]

    # per-image GT for this class
    class_gt = {}
    npos = 0
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        bbox = np.asarray([o["bbox"] for o in objs], dtype=float)
        difficult = np.asarray([o["difficult"] for o in objs], dtype=bool)
        npos += int((~difficult).sum())
        class_gt[name] = {
            "bbox": bbox, "difficult": difficult,
            "matched": np.zeros(len(objs), dtype=bool),
        }

    # detections, sorted by confidence
    if not os.path.exists(detfile):
        return np.zeros(0), np.zeros(0), 0.0
    with open(detfile) as f:
        rows = [line.strip().split(" ") for line in f if line.strip()]
    if not rows:
        return np.zeros(0), np.zeros(0), 0.0
    image_ids = [r[0] for r in rows]
    confidence = np.asarray([float(r[1]) for r in rows])
    boxes = np.asarray([[float(z) for z in r[2:]] for r in rows])

    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    boxes = boxes[order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        gt = class_gt[image_ids[d]]
        box = boxes[d]
        best_iou, best_j = -np.inf, -1
        if gt["bbox"].size > 0:
            g = gt["bbox"]
            ixmin = np.maximum(g[:, 0], box[0])
            iymin = np.maximum(g[:, 1], box[1])
            ixmax = np.minimum(g[:, 2], box[2])
            iymax = np.minimum(g[:, 3], box[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inter = iw * ih
            union = (
                (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
                + (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
                - inter
            )
            ious = inter / union
            best_j = int(np.argmax(ious))
            best_iou = ious[best_j]

        if best_iou > ovthresh:
            if not gt["difficult"][best_j]:
                if not gt["matched"][best_j]:
                    tp[d] = 1.0
                    gt["matched"][best_j] = True
                else:
                    fp[d] = 1.0  # duplicate detection of a matched GT
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = average_precision(rec, prec, use_07_metric)
    return rec, prec, ap
