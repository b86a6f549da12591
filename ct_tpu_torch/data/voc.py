"""PASCAL VOC test-set reader and mAP evaluation.

The test path of ``ct_tpu/data/voc.py``: the per-split class orderings
(novel classes last for the incremental setting), the ``test`` image list,
image decoding, the eval-time resize and mean subtraction, and VOC mAP
with the base/novel breakdown. ``cv2`` is imported only where an image is
decoded or resized. Result files and the annotation cache go under the
output directory, never into the dataset tree.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Sequence

import numpy as np

from ct_tpu_torch.data.voc_eval import voc_eval

logger = logging.getLogger(__name__)

# Class orderings per base/novel split; split 0 = canonical order (transfer
# setting), splits 1-3 put the 5 novel classes last (incremental setting).
VOC_CLASSES = {
    0: ("__background__",
        "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
        "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor"),
    1: ("__background__",
        "aeroplane", "bicycle", "boat", "bottle", "car", "cat", "chair",
        "diningtable", "dog", "horse", "person", "pottedplant", "sheep",
        "train", "tvmonitor",
        "bird", "bus", "cow", "motorbike", "sofa"),
    2: ("__background__",
        "bicycle", "bird", "boat", "bus", "car", "cat", "chair",
        "diningtable", "dog", "motorbike", "person", "pottedplant", "sheep",
        "train", "tvmonitor",
        "aeroplane", "bottle", "cow", "horse", "sofa"),
    3: ("__background__",
        "aeroplane", "bicycle", "bird", "bottle", "bus", "car", "chair",
        "cow", "diningtable", "dog", "horse", "person", "pottedplant",
        "train", "tvmonitor",
        "boat", "cat", "motorbike", "sheep", "sofa"),
}


def eval_transform(image: np.ndarray, size: int,
                   means: Sequence[float]) -> np.ndarray:
    """Test-time preprocessing: bilinear resize to size×size, subtract the
    BGR mean → [size, size, 3] float32 (HWC)."""
    import cv2

    out = cv2.resize(image, (size, size), interpolation=cv2.INTER_LINEAR)
    return out.astype(np.float32) - np.asarray(means, np.float32)


class VOCTestSet:
    """The ``<year>/<image_set>`` test list of one VOC root."""

    def __init__(self, root: str, year: str = "2007", image_set: str = "test",
                 *, phase: int = 2, setting: str = "incre", split: int = 1):
        self.root = root
        self.year = year
        self.image_set = image_set
        self.phase = phase
        self.setting = setting
        self.split = 0 if setting == "transfer" else split
        self.rootpath = os.path.join(root, "VOC" + year)
        listfile = os.path.join(self.rootpath, "ImageSets", "Main",
                                image_set + ".txt")
        with open(listfile) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def pull_image(self, index: int) -> np.ndarray:
        """Image ``index`` decoded as BGR uint8 [H, W, 3]."""
        import cv2

        path = os.path.join(self.rootpath, "JPEGImages",
                            self.ids[index] + ".jpg")
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot decode {path}")
        return img

    # -- evaluation --------------------------------------------------------

    @property
    def classes(self):
        num = 16 if self.phase == 1 else 21
        return VOC_CLASSES[self.split][:num]

    def write_results(self, all_boxes, results_dir: str) -> Dict[str, str]:
        """all_boxes[class_idx][image_idx] = [] | [n,5] (x1y1x2y2, score)
        → one ``comp4_det_test_<cls>.txt`` per class; returns their paths."""
        os.makedirs(results_dir, exist_ok=True)
        files = {}
        for cls_ind, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            path = os.path.join(results_dir, f"comp4_det_test_{cls}.txt")
            files[cls] = path
            with open(path, "w") as f:
                for im_ind, index in enumerate(self.ids):
                    dets = all_boxes[cls_ind][im_ind]
                    if len(dets) == 0:
                        continue
                    for k in range(dets.shape[0]):
                        f.write(
                            "{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n".format(
                                index, dets[k, -1],
                                dets[k, 0] + 1, dets[k, 1] + 1,
                                dets[k, 2] + 1, dets[k, 3] + 1,
                            )
                        )
        return files

    def evaluate_detections(self, all_boxes, output_dir: str) -> dict:
        """VOC mAP of ``all_boxes``; results, PR curves and the annotation
        cache are written under ``output_dir``."""
        files = self.write_results(all_boxes,
                                   os.path.join(output_dir, "results"))
        annopath = os.path.join(self.rootpath, "Annotations", "{:s}.xml")
        imagesetfile = os.path.join(self.rootpath, "ImageSets", "Main",
                                    self.image_set + ".txt")
        cachedir = os.path.join(output_dir, "annotations_cache")
        use_07_metric = int(self.year) < 2010
        aps = []
        names = [c for c in self.classes if c != "__background__"]
        for cls in names:
            rec, prec, ap = voc_eval(
                files[cls], annopath, imagesetfile, cls, cachedir,
                ovthresh=0.5, use_07_metric=use_07_metric,
            )
            aps.append(ap)
            logger.info("AP for %s = %.4f", cls, ap)
            with open(os.path.join(output_dir, cls + "_pr.pkl"), "wb") as f:
                pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)
        result = {"mAP": float(np.mean(aps)),
                  "APs": {c: float(a) for c, a in zip(names, aps)}}
        logger.info("Mean AP = %.4f", result["mAP"])
        if self.setting == "incre" and self.phase == 2:
            result["base_mAP"] = float(np.mean(aps[:15]))
            result["novel_mAP"] = float(np.mean(aps[15:]))
            logger.info("Base AP = %.4f\tNovel AP = %.4f",
                        result["base_mAP"], result["novel_mAP"])
        return result
