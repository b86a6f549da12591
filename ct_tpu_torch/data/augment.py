"""SSD training augmentation on the host (numpy, cv2).

The port of ``TrainAugment`` (``ct_tpu/data/augment.py``), the reference's
``preproc``: an IoU-constrained random crop keeping box centres, a
photometric distortion, a mean-filled expand (probability 0.6), a
horizontal flip and a resize with a random interpolation followed by BGR
mean subtraction, falling back to the unaugmented image when nothing
usable is left. It draws from Python's ``random``, with the JAX package's
probabilities and order of draws. ``cv2`` is imported inside the functions
that use it.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np


def _matrix_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    area_i = np.prod(rb - lt, axis=2) * (lt < rb).all(axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return area_i / (area_a[:, None] + area_b[None, :] - area_i)


CROP_MODES = (
    None, (0.1, None), (0.3, None), (0.5, None), (0.7, None), (0.9, None),
    (None, None),
)


def random_crop(image, boxes, labels, required_label: Optional[int] = None):
    """Sampled IoU-constrained crop; keeps the boxes whose centres fall
    inside. ``required_label`` forces the crop to keep a box of that
    class."""
    height, width, _ = image.shape
    if len(boxes) == 0:
        return image, boxes, labels

    while True:
        mode = random.choice(CROP_MODES)
        if mode is None:
            return image, boxes, labels
        min_iou = mode[0] if mode[0] is not None else float("-inf")
        max_iou = mode[1] if mode[1] is not None else float("inf")

        for _ in range(50):
            scale = random.uniform(0.3, 1.0)
            min_ratio = max(0.5, scale * scale)
            max_ratio = min(2.0, 1.0 / scale / scale)
            ratio = math.sqrt(random.uniform(min_ratio, max_ratio))
            w = int(scale * ratio * width)
            h = int((scale / ratio) * height)
            left = random.randrange(width - w)
            top = random.randrange(height - h)
            roi = np.array((left, top, left + w, top + h))

            iou = _matrix_iou_np(boxes, roi[None])
            if not (min_iou <= iou.min() and iou.max() <= max_iou):
                continue

            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            inside = np.logical_and(roi[:2] < centers,
                                    centers < roi[2:]).all(axis=1)
            kept_boxes = boxes[inside].copy()
            kept_labels = labels[inside].copy()
            if len(kept_boxes) == 0:
                continue
            if required_label is not None and (
                    kept_labels != required_label).all():
                continue

            out = image[roi[1]:roi[3], roi[0]:roi[2]]
            kept_boxes[:, :2] = np.maximum(kept_boxes[:, :2],
                                           roi[:2]) - roi[:2]
            kept_boxes[:, 2:] = np.minimum(kept_boxes[:, 2:],
                                           roi[2:]) - roi[:2]
            return out, kept_boxes, kept_labels


def photometric_distort(image: np.ndarray) -> np.ndarray:
    """Random brightness and contrast in BGR, hue and saturation in HSV."""
    import cv2

    def blend(img, alpha=1.0, beta=0.0):
        out = img.astype(float) * alpha + beta
        np.clip(out, 0, 255, out=out)
        img[:] = out

    image = image.copy()
    if random.randrange(2):
        blend(image, beta=random.uniform(-32, 32))
    if random.randrange(2):
        blend(image, alpha=random.uniform(0.5, 1.5))
    image = cv2.cvtColor(image, cv2.COLOR_BGR2HSV)
    if random.randrange(2):
        hue = image[:, :, 0].astype(int) + random.randint(-18, 18)
        image[:, :, 0] = hue % 180
    if random.randrange(2):
        blend(image[:, :, 1], alpha=random.uniform(0.5, 1.5))
    return cv2.cvtColor(image, cv2.COLOR_HSV2BGR)


def random_expand(image, boxes, fill, prob: float):
    """Place the image in a larger mean-filled canvas (zoom out)."""
    if random.random() > prob:
        return image, boxes
    height, width, depth = image.shape
    while True:
        scale = random.uniform(1, 4)
        min_ratio = max(0.5, 1.0 / scale / scale)
        max_ratio = min(2.0, scale * scale)
        ratio = math.sqrt(random.uniform(min_ratio, max_ratio))
        ws, hs = scale * ratio, scale / ratio
        if ws < 1 or hs < 1:
            continue
        w, h = int(ws * width), int(hs * height)
        left = random.randint(0, w - width)
        top = random.randint(0, h - height)

        out_boxes = boxes.copy()
        out_boxes[:, :2] += (left, top)
        out_boxes[:, 2:] += (left, top)
        canvas = np.empty((h, w, depth), dtype=image.dtype)
        canvas[:, :] = fill
        canvas[top:top + height, left:left + width] = image
        return canvas, out_boxes


def random_mirror(image, boxes):
    _, width, _ = image.shape
    if random.randrange(2):
        image = image[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


def resize_subtract(image: np.ndarray, size: int, mean,
                    random_interp: bool = True) -> np.ndarray:
    """Resize to size×size (a random one of five interpolations, or
    bilinear) and subtract the BGR mean → [S, S, 3] float32."""
    import cv2

    interps = (cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA,
               cv2.INTER_NEAREST, cv2.INTER_LANCZOS4)
    interp = interps[random.randrange(5)] if random_interp else interps[0]
    out = cv2.resize(image, (size, size), interpolation=interp)
    return out.astype(np.float32) - np.asarray(mean, np.float32)


class TrainAugment:
    """The SSD training pipeline: ``(image BGR uint8, targets [N, 5] pixel
    coordinates + label) → (image [S, S, 3] float32, targets [N', 5]
    percent coordinates + label)``."""

    def __init__(self, size: int, rgb_means, expand_prob: float = 0.6):
        self.size = size
        self.means = rgb_means
        self.expand_prob = expand_prob

    def __call__(self, image, targets, required_label: Optional[int] = None):
        boxes = targets[:, :-1].copy()
        labels = targets[:, -1].copy()

        height_o, width_o, _ = image.shape
        boxes_pct = targets[:, :-1].copy()
        boxes_pct[:, 0::2] /= width_o
        boxes_pct[:, 1::2] /= height_o
        fallback_targets = np.hstack([boxes_pct, labels[:, None]])

        img_t, boxes, labels = random_crop(image, boxes, labels,
                                           required_label)
        img_t = photometric_distort(img_t)
        img_t, boxes = random_expand(img_t, boxes, self.means,
                                     self.expand_prob)
        img_t, boxes = random_mirror(img_t, boxes)

        height, width, _ = img_t.shape
        img_out = resize_subtract(img_t, self.size, self.means)
        boxes = boxes.copy().astype(np.float64)
        boxes[:, 0::2] /= width
        boxes[:, 1::2] /= height
        wh_min = np.minimum(boxes[:, 2] - boxes[:, 0],
                            boxes[:, 3] - boxes[:, 1])
        keep = wh_min > 0.01
        boxes, labels = boxes[keep], labels[keep]

        if len(boxes) == 0 or (required_label is not None
                               and (labels != required_label).all()):
            img_out = resize_subtract(image, self.size, self.means)
            return img_out, fallback_targets
        return img_out, np.hstack([boxes, labels[:, None]])
