"""Base-class-only VOC image lists for incremental pretraining.

The port of ``ct_tpu/data/split_voc.py``: writes
``<image-set>_split{1,2,3}.txt`` beside ``<image-set>.txt``, listing the
images that hold no object of the split's novel classes (the last 5 of
the split's ordering in ``data/voc.py``'s ``VOC_CLASSES``), difficult ones
included.

    python -m ct_tpu_torch.data.split_voc data/VOCdevkit/VOC2007 \
        [--splits 1 2 3] [--image-set trainval]
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

from ct_tpu_torch.data.voc import VOC_CLASSES


def split_voc(rootpath: str, split: int, image_set: str = "trainval"):
    novel = set(VOC_CLASSES[split][-5:])
    listfile = os.path.join(rootpath, "ImageSets", "Main",
                            image_set + ".txt")
    outfile = os.path.join(rootpath, "ImageSets", "Main",
                           f"{image_set}_split{split}.txt")
    kept = []
    with open(listfile) as f:
        ids = [line.strip() for line in f if line.strip()]
    for img_id in ids:
        anno = os.path.join(rootpath, "Annotations", img_id + ".xml")
        names = {
            obj.find("name").text.lower().strip()
            for obj in ET.parse(anno).getroot().iter("object")
        }
        if not (names & novel):
            kept.append(img_id)
    with open(outfile, "w") as f:
        f.write("\n".join(kept) + "\n")
    print(f"split {split}: kept {len(kept)}/{len(ids)} images → {outfile}")
    return outfile


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("rootpath", help="e.g. data/VOCdevkit/VOC2007")
    parser.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--image-set", default="trainval")
    args = parser.parse_args(argv)
    for s in args.splits:
        split_voc(args.rootpath, s, args.image_set)


if __name__ == "__main__":
    main()
