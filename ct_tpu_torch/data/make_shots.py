"""Few-shot list generator for VOC.

The port of ``ct_tpu/data/make_shots.py``. The reference distributes its
few-shot selections as data (per-year ``ImageSets/Main`` archives); this
regenerates the three kinds of list from a VOC tree with a seeded RNG,
where the port's ``VOCDetection`` reads them:

  * ``trainval_split{1,2,3}.txt``: phase-1 base pretraining lists, the
    trainval images holding *no* novel-class object of the split
    (difficult ones included);
  * ``trainval_{k}shot.txt``: image-shot lists for the transfer setting,
    k images per class (each holding a non-difficult object of it), each
    in the file of the year its image belongs to;
  * ``1_box/<cls>.txt``: instance-shot lists, image ids whose FIRST
    annotated object is a non-difficult ``cls`` (``VOCDetection`` turns
    every later object into an ignore label, so the first is the shot).

    python -m ct_tpu_torch.data.make_shots --voc-root data/VOCdevkit \
        --years 2007 2012 --shots 1 2 3 5 10 30 --seed 0
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ct_tpu_torch.data.voc import VOC_CLASSES


def _iter_objects(anno: ET.Element):
    for obj in anno.iter("object"):
        name = obj.find("name").text.lower().strip()
        difficult = int(obj.find("difficult").text) == 1
        yield name, difficult


def _load_annotations(
    voc_root: str, years: Sequence[str], image_set: str = "trainval"
) -> List[Tuple[str, str, List[Tuple[str, bool]]]]:
    """→ [(year, image_id, [(class_name, difficult), ...])] in list order."""
    records = []
    for year in years:
        base = os.path.join(voc_root, "VOC" + year)
        listfile = os.path.join(base, "ImageSets", "Main",
                                image_set + ".txt")
        with open(listfile) as f:
            ids = [line.strip() for line in f if line.strip()]
        for img_id in ids:
            anno = ET.parse(
                os.path.join(base, "Annotations", img_id + ".xml")
            ).getroot()
            records.append((year, img_id, list(_iter_objects(anno))))
    return records


def make_base_split_lists(
    records, splits: Sequence[int] = (1, 2, 3)
) -> Dict[Tuple[str, int], List[str]]:
    """Images with no novel-class object (label index > 15 in the split's
    ordering) — the reference's ``split_voc_dataset.py`` semantics, which
    considers difficult objects too. → {(year, split): [ids]}."""
    out: Dict[Tuple[str, int], List[str]] = {}
    for split in splits:
        class_to_ind = {n: i for i, n in enumerate(VOC_CLASSES[split])}
        for year, img_id, objs in records:
            if all(class_to_ind[name] <= 15 for name, _ in objs):
                out.setdefault((year, split), []).append(img_id)
    return out


def make_image_shot_lists(
    records, shots: Sequence[int], seed: int = 0
) -> Dict[Tuple[str, int], List[str]]:
    """k-shot image lists: for each class (canonical order), k images that
    contain at least one non-difficult object of the class, sampled with a
    seeded shuffle; an image already selected (for this k, any class) is
    not drawn again. → {(year, k): [ids]} (each id goes to its own year's
    file, like the reference's per-year zips)."""
    by_class: Dict[str, List[Tuple[str, str]]] = {
        c: [] for c in VOC_CLASSES[0][1:]
    }
    for year, img_id, objs in records:
        present = {name for name, difficult in objs if not difficult}
        for name in present:
            by_class[name].append((year, img_id))

    out: Dict[Tuple[str, int], List[str]] = {}
    for k in shots:
        rng = np.random.RandomState(seed + k)
        chosen: List[Tuple[str, str]] = []
        taken = set()
        for cls in VOC_CLASSES[0][1:]:
            pool = list(by_class[cls])
            rng.shuffle(pool)
            picked = 0
            for year, img_id in pool:
                if picked == k:
                    break
                if (year, img_id) in taken:
                    continue
                taken.add((year, img_id))
                chosen.append((year, img_id))
                picked += 1
        for year, img_id in chosen:
            out.setdefault((year, k), []).append(img_id)
    return out


def make_instance_shot_lists(
    records, depth: int = 10, seed: int = 0
) -> Dict[Tuple[str, str], List[str]]:
    """1_box lists: ``depth`` image ids per class whose FIRST annotated
    object is a non-difficult instance of the class (the first object is
    the one VOCDetection keeps as the shot). Sampled per year — each
    year's tree gets a complete per-class list, like the reference zips
    (Main2007.zip ships 10 ids per class, all from VOC2007).
    → {(year, class): [ids]}."""
    first_obj: Dict[Tuple[str, str], List[str]] = {}
    for year, img_id, objs in records:
        if not objs:
            continue
        name, difficult = objs[0]
        if not difficult:
            first_obj.setdefault((year, name), []).append(img_id)

    out: Dict[Tuple[str, str], List[str]] = {}
    rng = np.random.RandomState(seed)
    years = sorted({year for year, _, _ in records})
    for year in years:  # fixed iteration order → deterministic draws
        for cls in VOC_CLASSES[0][1:]:
            pool = list(first_obj.get((year, cls), []))
            rng.shuffle(pool)
            if pool:
                out[(year, cls)] = pool[:depth]
    return out


def write_lists(voc_root: str, years: Sequence[str],
                base_splits, image_shots, instance_shots) -> List[str]:
    """Write all list files under each year's ImageSets/Main. → paths."""
    written = []

    def _write(path: str, ids: List[str]):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(ids) + "\n")
        written.append(path)

    for year in years:
        main = os.path.join(voc_root, "VOC" + year, "ImageSets", "Main")
        for (y, split), ids in sorted(base_splits.items()):
            if y == year:
                _write(os.path.join(main, f"trainval_split{split}.txt"), ids)
        for (y, k), ids in sorted(image_shots.items()):
            if y == year:
                _write(os.path.join(main, f"trainval_{k}shot.txt"), ids)
        for (y, cls), ids in sorted(instance_shots.items()):
            if y == year:
                _write(os.path.join(main, "1_box", cls + ".txt"), ids)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate VOC few-shot split/shot lists")
    parser.add_argument("--voc-root", default="data/VOCdevkit")
    parser.add_argument("--years", nargs="+", default=["2007", "2012"])
    parser.add_argument("--shots", type=int, nargs="+",
                        default=[1, 2, 3, 5, 10, 30])
    parser.add_argument("--instance-depth", type=int, default=10,
                        help="ids per class in the 1_box lists")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    records = _load_annotations(args.voc_root, args.years)
    print(f"{len(records)} trainval images across {args.years}")
    base = make_base_split_lists(records)
    img_shots = make_image_shot_lists(records, args.shots, args.seed)
    inst = make_instance_shot_lists(records, args.instance_depth, args.seed)
    for path in write_lists(args.voc_root, args.years, base, img_shots,
                            inst):
        print("wrote", path)


if __name__ == "__main__":
    main()
