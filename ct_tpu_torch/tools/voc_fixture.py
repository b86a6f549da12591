"""Synthetic VOC trees for the port's tests, its chain and its card check.

    python -m ct_tpu_torch.tools.voc_fixture OUT [--images 600]
        [--test-images 128]

``make_mini_voc`` writes one ``VOCdevkit/VOC{year}`` tree: JPEG images of
filled rectangles on a grey canvas, their XML annotations and image-set
lists in which every list names every image (``test.txt`` capped to its
first ``max_test_ids``). With ``class_colors`` each class is painted in a
colour of its own, so that a detector can learn it. ``build_fewshot_voc``
(the command line) writes the all-20-class few-shot fixture of the
transfer and incremental chains: both years over the split-1 class order,
each class in its colour, and the few-shot lists regenerated from the
annotations by ``data/make_shots.py`` (base split 1, image shots 1 and 5,
instance shots to depth 10). Both are the port's copies of the JAX
package's generators (``make_mini_voc`` of ``tests/fixtures.py`` and
``scripts/real_parity.py build2``) and write the same files for the same
arguments.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Tuple

import numpy as np

from ct_tpu_torch.data import make_shots
from ct_tpu_torch.data.voc import VOC_CLASSES

XML_TEMPLATE = """<annotation>
  <folder>VOC2007</folder><filename>{name}.jpg</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>
"""

OBJ_TEMPLATE = """<object>
    <name>{cls}</name><pose>Left</pose><truncated>0</truncated>
    <difficult>{difficult}</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""

# the split-1 class order, novel classes last
ALL20 = tuple(VOC_CLASSES[1][1:21])
YEAR_SEEDS = (("2007", 0), ("2012", 1))


def class_color(idx: int) -> Tuple[int, int, int]:
    """Deterministic, well-separated BGR colour for class ``idx``."""
    rng = np.random.RandomState(977 + idx)
    return tuple(int(c) for c in rng.randint(30, 226, 3))


def make_mini_voc_all(root: str, **kw) -> str:
    """Both VOC2007 and VOC2012 trees (phase 1 reads 07+12 trainval)."""
    make_mini_voc(root, year="2007", **kw)
    return make_mini_voc(root, year="2012", seed=1, **kw)


def make_mini_voc(root: str, year: str = "2007", num_images: int = 8,
                  classes: Tuple[str, ...] = ("aeroplane", "bicycle",
                                              "bird", "car"),
                  seed: int = 0, class_colors: bool = False,
                  max_test_ids: int = 0) -> str:
    """``VOCdevkit/VOC{year}`` under ``root`` (module docstring); returns
    the devkit's path. ``max_test_ids`` 0 lists every image in
    ``test.txt``."""
    import cv2

    rng = np.random.RandomState(seed)
    devkit = os.path.join(root, "VOCdevkit")
    base = os.path.join(devkit, "VOC" + year)
    for sub in ("JPEGImages", "Annotations",
                os.path.join("ImageSets", "Main"),
                os.path.join("ImageSets", "Main", "1_box")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    ids: List[str] = []
    by_class = {c: [] for c in VOC_CLASSES[0][1:]}
    for i in range(num_images):
        name = f"{i:06d}"
        ids.append(name)
        h, w = int(rng.randint(240, 480)), int(rng.randint(240, 480))
        img = np.full((h, w, 3), 128, np.uint8)
        objects = []
        for _ in range(int(rng.randint(1, 4))):
            ci = int(rng.randint(len(classes)))
            cls = classes[ci]
            x1 = int(rng.randint(1, w - 60))
            y1 = int(rng.randint(1, h - 60))
            x2 = x1 + int(rng.randint(40, min(120, w - x1)))
            y2 = y1 + int(rng.randint(40, min(120, h - y1)))
            if class_colors:
                color = tuple(int(np.clip(c + rng.randint(-18, 19), 0, 255))
                              for c in class_color(ci))
            else:
                color = tuple(int(c) for c in rng.randint(0, 255, 3))
            cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
            objects.append(OBJ_TEMPLATE.format(
                cls=cls, difficult=0, x1=x1, y1=y1, x2=x2, y2=y2))
            if not by_class[cls] or by_class[cls][-1] != name:
                by_class[cls].append(name)
        cv2.imwrite(os.path.join(base, "JPEGImages", name + ".jpg"), img)
        with open(os.path.join(base, "Annotations", name + ".xml"),
                  "w") as f:
            f.write(XML_TEMPLATE.format(name=name, w=w, h=h,
                                        objects="\n  ".join(objects)))

    main = os.path.join(base, "ImageSets", "Main")
    listing = "\n".join(ids) + "\n"
    test_ids = ids[:max_test_ids] if max_test_ids else ids
    for fname in ("trainval.txt", "trainval_split1.txt",
                  "trainval_split2.txt", "trainval_split3.txt",
                  "trainval_1shot.txt", "trainval_5shot.txt"):
        with open(os.path.join(main, fname), "w") as f:
            f.write(listing)
    with open(os.path.join(main, "test.txt"), "w") as f:
        f.write("\n".join(test_ids) + "\n")
    # every class has an instance-shot file (the first two ids for a class
    # no image holds: the loader only needs ids that resolve)
    for cls in VOC_CLASSES[0][1:]:
        shots = by_class[cls] or ids[:2]
        with open(os.path.join(main, "1_box", cls + ".txt"), "w") as f:
            f.write("\n".join(shots) + "\n")
    return devkit


def build_fewshot_voc(root: str, images: int, test_images: int) -> dict:
    """The all-20-class few-shot fixture (module docstring) under
    ``root``: ``images`` images a year, ``test.txt`` capped to the first
    ``test_images``. Returns its devkit's path, the list files written and
    the count of 2007 base-split images."""
    for year, seed in YEAR_SEEDS:
        make_mini_voc(root, year=year, num_images=images, classes=ALL20,
                      seed=seed, class_colors=True,
                      max_test_ids=test_images)
    devkit = os.path.join(root, "VOCdevkit")
    years = [year for year, _ in YEAR_SEEDS]
    records = make_shots._load_annotations(devkit, years)
    written = make_shots.write_lists(
        devkit, years,
        make_shots.make_base_split_lists(records, splits=(1,)),
        make_shots.make_image_shot_lists(records, shots=(1, 5)),
        make_shots.make_instance_shot_lists(records, depth=10))
    with open(os.path.join(devkit, "VOC2007", "ImageSets", "Main",
                           "trainval_split1.txt")) as f:
        n_split = sum(1 for _ in f)
    return {"devkit": devkit, "lists": written, "split1_2007": n_split}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the tree's root (VOC_ROOT is "
                                "OUT/VOCdevkit)")
    ap.add_argument("--images", type=int, default=600)
    ap.add_argument("--test-images", type=int, default=128)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = build_fewshot_voc(args.out, args.images, args.test_images)
    print(f"{res['devkit']}: 2x{args.images} images, 20 split-1 classes, "
          f"{len(res['lists'])} list files, split1(2007)="
          f"{res['split1_2007']} base images, test set {args.test_images}, "
          f"{time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
