"""The benchmark's inputs from the repository's VOC fixture.

The fixture (``.parity_p2/voc/VOCdevkit``: 2007 and 2012 trees of
synthetic images with XML boxes, 500 test and 1,200 trainval images) and
the trained weights (``.parity_p2/ref_model.pth``) lie outside the
benchmark's folder; a configuration names them with their SHA-256, and a
run refuses files that differ, so that both sides of a comparison read
the inputs the benchmark was defined on.

JPEGs are decoded with OpenCV in threads; each image is resized to the
detector's square input by bilinear interpolation, as the evaluation and
serving paths preprocess it.
"""

from __future__ import annotations

import hashlib
import os
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

BGR_MEANS = (104.0, 117.0, 123.0)
# class orderings: split 0 is VOC's own (transfer), split 1 puts the five
# novel classes of the incremental setting's first split last
VOC_CLASSES = {
    0: ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
        "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
        "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor"),
    1: ("aeroplane", "bicycle", "boat", "bottle", "car", "cat", "chair",
        "diningtable", "dog", "horse", "person", "pottedplant", "sheep",
        "train", "tvmonitor", "bird", "bus", "cow", "motorbike", "sofa"),
}


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def sha256_tree(root: str, rel_paths: Sequence[str]) -> str:
    """One digest over the named files of ``root``, names and bytes."""
    h = hashlib.sha256()
    for rel in sorted(rel_paths):
        h.update(rel.encode())
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def check_digest(what: str, got: str, want: str) -> None:
    if got != want:
        raise RuntimeError(f"{what}: SHA-256 {got} is not the {want} this "
                           "configuration was measured on")


class Fixture:
    """The image lists of one VOC root. ``split`` picks the class order."""

    def __init__(self, root: str, split: int):
        self.root = root
        self.classes = VOC_CLASSES[split]

    def ids(self, year: str, image_set: str) -> List[Tuple[str, str]]:
        path = os.path.join(self.root, f"VOC{year}", "ImageSets", "Main",
                            image_set + ".txt")
        with open(path) as f:
            return [(year, line.strip()) for line in f if line.strip()]

    def files(self, ids) -> List[str]:
        return [os.path.join(f"VOC{y}", d, i + ext) for y, i in ids
                for d, ext in (("JPEGImages", ".jpg"), ("Annotations", ".xml"))]

    def digest(self, ids) -> str:
        return sha256_tree(self.root, self.files(ids))

    def boxes(self, year: str, img_id: str) -> np.ndarray:
        """[N, 5]: (x1, y1, x2, y2) in pixels, less one as VOC's loaders
        take them, and the class (1-based, in this split's order)."""
        tree = ET.parse(os.path.join(self.root, f"VOC{year}", "Annotations",
                                     img_id + ".xml"))
        rows = []
        for obj in tree.iter("object"):
            bb = obj.find("bndbox")
            rows.append([int(bb.find(k).text) - 1
                         for k in ("xmin", "ymin", "xmax", "ymax")]
                        + [self.classes.index(obj.find("name").text.strip())
                           + 1])
        return np.asarray(rows, np.float32).reshape(-1, 5)

    def load(self, ids, size: int, threads: int = 8) -> "Images":
        """Decode and resize ``ids`` → uint8 [n, S, S, 3] BGR, the original
        (h, w) of each, and their boxes."""
        import cv2

        def one(yi):
            year, img_id = yi
            img = cv2.imread(os.path.join(self.root, f"VOC{year}",
                                          "JPEGImages", img_id + ".jpg"),
                             cv2.IMREAD_COLOR)
            if img is None:
                raise FileNotFoundError(f"cannot decode {img_id}")
            return (cv2.resize(img, (size, size),
                               interpolation=cv2.INTER_LINEAR),
                    img.shape[:2], self.boxes(year, img_id))

        with ThreadPoolExecutor(threads) as pool:
            out = list(pool.map(one, ids))
        return Images(np.stack([o[0] for o in out]),
                      np.asarray([o[1] for o in out], np.int64),
                      [o[2] for o in out])


class Images(NamedTuple):
    pixels: np.ndarray           # [n, S, S, 3] uint8 BGR, resized
    sizes: np.ndarray            # [n, 2] original (h, w)
    boxes: List[np.ndarray]      # n × [N_i, 5] pixels and class


def normalized(pixels: np.ndarray) -> np.ndarray:
    """uint8 [n, S, S, 3] BGR → float32 [n, 3, S, S], the mean subtracted."""
    x = pixels.astype(np.float32) - np.asarray(BGR_MEANS, np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def padded_targets(images: Images, max_objs: int) -> Dict[str, np.ndarray]:
    """Boxes in [0, 1] coordinates of the original image, padded to
    ``max_objs`` rows (padding: valid False, a unit box)."""
    n = len(images.boxes)
    boxes = np.tile(np.asarray([0, 0, 1, 1], np.float32), (n, max_objs, 1))
    labels = np.zeros((n, max_objs), np.int64)
    valid = np.zeros((n, max_objs), bool)
    for i, (b, (h, w)) in enumerate(zip(images.boxes, images.sizes)):
        m = min(len(b), max_objs)
        boxes[i, :m] = b[:m, :4] / np.asarray([w, h, w, h], np.float32)
        labels[i, :m] = b[:m, 4]
        valid[i, :m] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}
