"""Split COCO annotation JSONs into voc / nonvoc category subsets.

The port of ``ct_tpu/data/split_coco.py``: from an 80-category
``instances_*.json`` it writes ``split_voc_instances_*.json`` and
``split_nonvoc_instances_*.json`` beside it (or into ``--out-dir``), the
files the COCO-60 source-pretraining splits of ``data/coco.py`` read.
Each holds the images with at least one annotation of its subset, those
annotations and the subset's categories.

    python -m ct_tpu_torch.data.split_coco \
        data/COCO/annotations/instances_train2014.json [--out-dir D]
"""

from __future__ import annotations

import argparse
import json
import os

VOC_CLASS_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "boat", "bird", "cat", "dog", "horse", "sheep", "cow", "bottle",
    "chair", "couch", "potted plant", "dining table", "tv",
)


def split_dataset(annofile: str, out_dir: str | None = None):
    """Write split_voc_/split_nonvoc_ versions of one instances json."""
    with open(annofile) as f:
        dataset = json.load(f)

    cats = dataset["categories"]
    voc_cat_ids = {c["id"] for c in cats if c["name"] in VOC_CLASS_NAMES}
    nonvoc_cat_ids = {c["id"] for c in cats} - voc_cat_ids

    out_dir = out_dir or os.path.dirname(annofile)
    base = os.path.basename(annofile)
    outputs = {}
    for tag, keep in (("voc", voc_cat_ids), ("nonvoc", nonvoc_cat_ids)):
        anns = [a for a in dataset["annotations"]
                if a["category_id"] in keep]
        img_ids = {a["image_id"] for a in anns}
        out = {
            "info": dataset.get("info", {}),
            "licenses": dataset.get("licenses", []),
            "images": [im for im in dataset["images"]
                       if im["id"] in img_ids],
            "annotations": anns,
            "categories": [c for c in cats if c["id"] in keep],
        }
        path = os.path.join(out_dir, f"split_{tag}_{base}")
        with open(path, "w") as f:
            json.dump(out, f)
        outputs[tag] = path
        print(f"{tag}: {len(out['images'])} images, {len(anns)} annotations "
              f"→ {path}")
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("annofiles", nargs="+",
                        help="instances_*.json files to split")
    parser.add_argument("--out-dir", default=None)
    args = parser.parse_args(argv)
    for f in args.annofiles:
        split_dataset(f, args.out_dir)


if __name__ == "__main__":
    main()
