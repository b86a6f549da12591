"""PASCAL VOC readers: the training set, the test set and mAP evaluation.

The port of ``ct_tpu/data/voc.py``: the per-split class orderings (novel
classes last for the incremental setting), the XML annotation transform,
the training set with the few-shot id selection, the ignore labels and
dataset-level mixup (``VOCDetection``), the ``test`` image list, the
eval-time resize and mean subtraction, and VOC mAP with the base/novel
breakdown. ``cv2`` is imported only where an image is decoded or resized.
Result files and the annotation cache go under the output directory,
never into the dataset tree.
"""

from __future__ import annotations

import logging
import os
import pickle
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def read_image(path: str) -> np.ndarray:
    """The image at ``path`` decoded as BGR uint8 [H, W, 3]."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot decode {path}")
    return img


class AnnotationTransform:
    """VOC XML annotation → [N, 5] array (pixel coordinates - 1, class
    index in the split's ordering)."""

    def __init__(self, split: int, keep_difficult: bool = True):
        self.class_to_ind = {name: i
                             for i, name in enumerate(VOC_CLASSES[split])}
        self.keep_difficult = keep_difficult

    def __call__(self, target: ET.Element) -> np.ndarray:
        rows = []
        for obj in target.iter("object"):
            if not self.keep_difficult and int(obj.find("difficult").text):
                continue
            name = obj.find("name").text.lower().strip()
            bbox = obj.find("bndbox")
            coords = [int(bbox.find(pt).text) - 1
                      for pt in ("xmin", "ymin", "xmax", "ymax")]
            rows.append(coords + [self.class_to_ind[name]])
        if not rows:
            return np.empty((0, 5))
        return np.asarray(rows, dtype=np.float64)


class VOCDetection:
    """The VOC training set over one or more (year, image_set) roots.

    Image ids follow the few-shot protocol: ``<set>_split<k>`` lists in
    phase 1; in phase 2 the ``<set>_<shot>shot`` image-shot lists for
    ``transfer``, or the first ``shot`` ids of each class's
    ``1_box/<class>.txt`` instance-shot list for ``incre`` (and for
    ``transfer`` with ``instance_shot``). In those instance-shot sets every
    object after the first becomes an ignore label (-1). Samples are
    ``(image, [N, 6] percent-coordinate targets with mixup weights)``.
    """

    def __init__(self, root: str, image_sets: Sequence[Tuple[str, str]],
                 preproc: Optional[Callable] = None,
                 target_transform: Optional[AnnotationTransform] = None, *,
                 phase: int = 1, setting: str = "transfer", split: int = 1,
                 shot: int = 5, instance_shot: bool = False):
        self.root = root
        self.preproc = preproc
        self.target_transform = target_transform
        self.phase = phase
        self.setting = setting
        self.instance_shot = instance_shot
        self.mixup: Optional[Callable] = None
        self.mixup_args: tuple = ()
        self.ids: List[Tuple[str, str]] = []
        for year, name in image_sets:
            rootpath = os.path.join(root, "VOC" + year)
            main = os.path.join(rootpath, "ImageSets", "Main")
            if phase == 1:
                self._extend(rootpath, os.path.join(
                    main, f"{name}_split{split}.txt"))
            elif phase == 2 and setting == "transfer" and not instance_shot:
                self._extend(rootpath, os.path.join(
                    main, f"{name}_{shot}shot.txt"))
            elif phase == 2:
                classes = VOC_CLASSES[0 if setting == "transfer"
                                      else split][1:]
                for cls in classes:
                    with open(os.path.join(main, "1_box",
                                           cls + ".txt")) as f:
                        for line in f.readlines()[:shot]:
                            self.ids.append((rootpath, line.strip()))
            else:
                raise ValueError(f"Unknown phase: {phase}")

    def _extend(self, rootpath: str, listfile: str) -> None:
        with open(listfile) as f:
            self.ids += [(rootpath, line.strip()) for line in f
                         if line.strip()]

    def __len__(self) -> int:
        return len(self.ids)

    def set_mixup(self, sampler: Optional[Callable], *args) -> None:
        """Mix every sample with another at weight ``sampler(*args)``
        (clipped to [0, 1]); ``None`` turns mixup off."""
        self.mixup = sampler
        self.mixup_args = args

    def _load_one(self, index: int):
        rootpath, img_id = self.ids[index]
        target = ET.parse(os.path.join(rootpath, "Annotations",
                                       img_id + ".xml")).getroot()
        img = read_image(os.path.join(rootpath, "JPEGImages",
                                      img_id + ".jpg"))
        if self.target_transform is not None:
            target = self.target_transform(target)
        if self.preproc is not None:
            img, target = self.preproc(img, target)
        target = np.asarray(target, dtype=np.float64).reshape(-1, 5)
        if self.phase == 2 and (self.setting == "incre"
                                or self.instance_shot):
            # all but the first (shot) object become ignore labels
            target = target.copy()
            target[1:, -1] = -1
        return img, target

    def __getitem__(self, index: int):
        img1, target1 = self._load_one(index)
        lambd = 1.0
        if self.mixup is not None:
            lambd = max(0.0, min(1.0, self.mixup(*self.mixup_args)))
        if lambd >= 1.0:
            return img1, np.hstack([target1, np.ones((len(target1), 1))])

        index2 = np.random.choice(np.delete(np.arange(len(self)), index))
        img2, target2 = self._load_one(int(index2))
        mixed = img1 * lambd + img2 * (1.0 - lambd)
        y1 = np.hstack([target1, np.full((len(target1), 1), lambd)])
        y2 = np.hstack([target2, np.full((len(target2), 1), 1.0 - lambd)])
        mix_target = np.vstack([y1, y2])
        if self.setting == "incre" and self.phase == 2:
            # ignore-labelled rows drop out of the loss under mixup
            mix_target[mix_target[:, -2] == -1, -1] = 0
        return mixed, mix_target


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
        return read_image(os.path.join(self.rootpath, "JPEGImages",
                                       self.ids[index] + ".jpg"))

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
