"""Synthetic COCO trees for the port's tests and its card check.

    python -m ct_tpu_torch.tools.coco_fixture OUT [--n-train 1800]
        [--n-val 128] [--seed 0]

``make_coco60`` writes the COCO-60 transfer-pretraining fixture: JPEG
images under ``images/{train,val}2014`` and the ``split_nonvoc_instances_
{train,valminusminival,minival}2014.json`` files of a real split, with
the full 80-category registry but only the 60 non-VOC categories
annotated, each painted in a colour of its own so that a detector can
learn them (the command line writes this one). ``make_mini_coco`` writes
a tiny tree whose split files hold only six categories. Both are the port's copies of the JAX package's test
fixtures (``make_coco60`` and ``make_mini_coco`` of ``tests/fixtures.py``)
and write the same files for one seed; the same arguments give the same
tree.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Tuple

import numpy as np

from ct_tpu_torch.data.coco import COCO_80_CATEGORIES, NONVOC_CAT_INDICES
from ct_tpu_torch.tools.voc_fixture import class_color

NONVOC_60 = [COCO_80_CATEGORIES[i] for i in NONVOC_CAT_INDICES]

MINI_COCO_CATS = [
    {"id": 2, "name": "bicycle", "supercategory": "vehicle"},
    {"id": 13, "name": "stop sign", "supercategory": "outdoor"},
    {"id": 25, "name": "giraffe", "supercategory": "animal"},
    {"id": 34, "name": "frisbee", "supercategory": "sports"},
    {"id": 46, "name": "wine glass", "supercategory": "kitchen"},
    {"id": 59, "name": "pizza", "supercategory": "food"},
]

SPLIT_FILES = ("split_nonvoc_instances_train2014.json",
               "split_nonvoc_instances_valminusminival2014.json",
               "split_nonvoc_instances_minival2014.json")


def sep_color(idx: int) -> Tuple[int, int, int]:
    """Deterministic BGR colour for ``idx`` from a 5³ grid with ≥55-level
    channel spacing, without the colours too close to the 110-grey canvas
    (the objectness must stay learnable): ≥60 usable entries, and a ±10
    paint jitter never crosses half a gap."""
    levels = (25, 80, 150, 210, 250)
    colors = []
    for i in range(125):
        c = (levels[i % 5], levels[(i // 5) % 5], levels[(i // 25) % 5])
        if all(abs(ch - 110) < 50 for ch in c):
            continue
        colors.append(c)
    return colors[idx % len(colors)]


def _write_splits(root: str, train, val, categories) -> None:
    for fname, (images, annos) in zip(SPLIT_FILES, (train, ([], []), val)):
        with open(os.path.join(root, "annotations", fname), "w") as f:
            json.dump({"images": images, "annotations": annos,
                       "categories": categories}, f)


def make_coco60(root: str, n_train: int = 480, n_val: int = 128,
                seed: int = 0) -> str:
    """The COCO-60 fixture (module docstring) under ``root``."""
    import cv2

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": cid, "name": name, "supercategory": "thing"}
            for cid, name in COCO_80_CATEGORIES]

    def build(img_dir: str, count: int, first_id: int):
        d = os.path.join(root, "images", img_dir)
        os.makedirs(d, exist_ok=True)
        images, annos = [], []
        aid = first_id * 1000
        for i in range(count):
            img_id = first_id + i
            name = f"COCO_{img_dir}_{img_id:012d}.jpg"
            h, w = int(rng.randint(260, 420)), int(rng.randint(260, 420))
            img = np.full((h, w, 3), 110, np.uint8)
            for _ in range(int(rng.randint(1, 4))):
                ci = int(rng.randint(len(NONVOC_60)))
                cid = NONVOC_60[ci][0]
                bw = int(rng.randint(40, max(41, w // 2)))
                bh = int(rng.randint(40, max(41, h // 2)))
                x = int(rng.randint(0, w - bw))
                y = int(rng.randint(0, h - bh))
                color = tuple(int(np.clip(c + rng.randint(-10, 11), 0, 255))
                              for c in sep_color(ci))
                cv2.rectangle(img, (x, y), (x + bw, y + bh), color, -1)
                annos.append({
                    "id": aid, "image_id": img_id, "category_id": cid,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0,
                })
                aid += 1
            cv2.imwrite(os.path.join(d, name), img)
            images.append({"id": img_id, "file_name": name,
                           "width": w, "height": h})
        return images, annos

    train = build("train2014", n_train, 1000)
    val = build("val2014", n_val, 100000)
    _write_splits(root, train, val, cats)
    return root


def make_mini_coco(root: str, n_train: int = 8, n_val: int = 6,
                   seed: int = 0) -> str:
    """A tiny tree whose split files carry only ``MINI_COCO_CATS``."""
    import cv2

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)

    def build(img_dir: str, count: int, first_id: int):
        d = os.path.join(root, "images", img_dir)
        os.makedirs(d, exist_ok=True)
        images, annos = [], []
        aid = first_id * 1000
        for i in range(count):
            img_id = first_id + i
            name = f"COCO_{img_dir}_{img_id:012d}.jpg"
            h, w = int(rng.randint(240, 321)), int(rng.randint(280, 401))
            img = np.full((h, w, 3), 110, np.uint8)
            for _ in range(int(rng.randint(1, 4))):
                cat = MINI_COCO_CATS[int(rng.randint(len(MINI_COCO_CATS)))]
                bw = int(rng.randint(40, max(41, w // 2)))
                bh = int(rng.randint(40, max(41, h // 2)))
                x = int(rng.randint(0, w - bw))
                y = int(rng.randint(0, h - bh))
                cv2.rectangle(img, (x, y), (x + bw, y + bh),
                              class_color(cat["id"]), -1)
                annos.append({
                    "id": aid, "image_id": img_id,
                    "category_id": cat["id"],
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": float(bw * bh), "iscrowd": 0,
                })
                aid += 1
            cv2.imwrite(os.path.join(d, name), img)
            images.append({"id": img_id, "file_name": name,
                           "width": w, "height": h})
        return images, annos

    train = build("train2014", n_train, 1000)
    val = build("val2014", n_val, 2000)
    _write_splits(root, train, val, MINI_COCO_CATS)
    return root


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the tree's root (COCO_ROOT)")
    ap.add_argument("--n-train", type=int, default=1800)
    ap.add_argument("--n-val", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    make_coco60(args.out, args.n_train, args.n_val, args.seed)
    print(f"{args.out}: {args.n_train} train / {args.n_val} minival images "
          f"in {time.perf_counter() - t0:.1f} s")
    return args.out


if __name__ == "__main__":
    main()
