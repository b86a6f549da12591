"""Compare two detections.pkl files, detection by detection.

The port's own copy of ``ct_tpu/tools/diff_detections.py`` (numpy only).
Both files hold ``all_boxes[class][image] = [n, 5]`` (x1, y1, x2, y2,
score), as the eval CLIs of both packages write them.

Usage:
    python -m ct_tpu_torch.tools.diff_detections A.pkl B.pkl [--iou 0.75]

Reports per-class detection counts, the matching rate (greedy match in
score order at the IoU threshold), and box and score deltas among matched
pairs.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def _match_dets(a: np.ndarray, b: np.ndarray, iou_thr: float):
    """Greedy score-order matching between two [n,5] det arrays.
    Returns (pairs, unmatched_a, unmatched_b)."""
    a = np.asarray(a, np.float64).reshape(-1, 5)
    b = np.asarray(b, np.float64).reshape(-1, 5)
    used_b = np.zeros(len(b), bool)
    pairs = []
    for i in np.argsort(-a[:, 4]):
        if len(b) == 0:
            break
        ax1, ay1, ax2, ay2 = a[i, :4]
        iw = np.maximum(0, np.minimum(ax2, b[:, 2]) - np.maximum(ax1, b[:, 0]))
        ih = np.maximum(0, np.minimum(ay2, b[:, 3]) - np.maximum(ay1, b[:, 1]))
        inter = iw * ih
        union = ((ax2 - ax1) * (ay2 - ay1)
                 + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
        iou = np.where(union > 0, inter / union, 0.0)
        iou[used_b] = -1
        j = int(np.argmax(iou))
        if iou[j] >= iou_thr:
            used_b[j] = True
            pairs.append((i, j, iou[j]))
    unmatched_a = len(a) - len(pairs)
    unmatched_b = int((~used_b).sum())
    return pairs, unmatched_a, unmatched_b


def diff(path_a: str, path_b: str, iou_thr: float = 0.75,
         score_floor: float = 0.05) -> dict:
    """The agreement of the detections in ``path_a`` and ``path_b`` at
    scores of at least ``score_floor``."""
    with open(path_a, "rb") as f:
        det_a = pickle.load(f)
    with open(path_b, "rb") as f:
        det_b = pickle.load(f)
    if len(det_a) != len(det_b):
        raise ValueError(f"class count differs: {len(det_a)} vs "
                         f"{len(det_b)}")
    num_classes = len(det_a)
    num_images = len(det_a[1]) if num_classes > 1 else 0

    total_a = total_b = matched = miss_a = miss_b = 0
    box_err, score_err, ious = [], [], []
    for c in range(1, num_classes):
        for i in range(num_images):
            a = np.asarray(det_a[c][i], np.float64).reshape(-1, 5)
            b = np.asarray(det_b[c][i], np.float64).reshape(-1, 5)
            a = a[a[:, 4] >= score_floor]
            b = b[b[:, 4] >= score_floor]
            total_a += len(a)
            total_b += len(b)
            pairs, ua, ub = _match_dets(a, b, iou_thr)
            matched += len(pairs)
            miss_a += ua
            miss_b += ub
            for i_a, j_b, iou in pairs:
                box_err.append(np.abs(a[i_a, :4] - b[j_b, :4]).max())
                score_err.append(abs(a[i_a, 4] - b[j_b, 4]))
                ious.append(iou)

    return {
        "detections_a": total_a,
        "detections_b": total_b,
        "matched": matched,
        "only_in_a": miss_a,
        "only_in_b": miss_b,
        "match_rate": matched / max(total_a, 1),
        "mean_matched_iou": float(np.mean(ious)) if ious else float("nan"),
        "p99_box_err_px": float(np.percentile(box_err, 99)) if box_err
        else float("nan"),
        "p99_score_err": float(np.percentile(score_err, 99)) if score_err
        else float("nan"),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--iou", type=float, default=0.75)
    parser.add_argument("--score-floor", type=float, default=0.05)
    args = parser.parse_args(argv)
    res = diff(args.a, args.b, args.iou, args.score_floor)
    for k, v in res.items():
        print(f"{k}: {v}")
    return res


if __name__ == "__main__":
    main()
