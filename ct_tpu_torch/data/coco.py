"""COCO detection dataset with the voc/nonvoc split remapping.

The port of ``ct_tpu/data/coco.py``: the predefined split registry, the
80-category table with the voc(20)/nonvoc(60) index tables, a pure-Python
annotation index with the pycocotools ``COCO`` API (``CocoIndex``) and
``COCODetection``: the remap of a split's categories to contiguous 1-based
labels, the pixel-box clipping and ``area > 0`` filter, the gt-roidb
pickle cache under ``<root>/cache``, [N, 6] targets with a unit mixup
weight, and COCO-json result writing scored by ``data/cocoeval.py``.
Images are decoded with cv2, imported only where an image is read.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ct_tpu_torch.data.voc import read_image

logger = logging.getLogger(__name__)

PREDEFINED_SPLITS_COCO = {
    "train2014": ("train2014", "annotations/instances_train2014.json"),
    "val2014": ("val2014", "annotations/instances_val2014.json"),
    "minival2014": ("val2014", "annotations/instances_minival2014.json"),
    "valminusminival2014": (
        "val2014", "annotations/instances_valminusminival2014.json"),
    "split_nonvoc_train2014": (
        "train2014", "annotations/split_nonvoc_instances_train2014.json"),
    "split_voc_train2014": (
        "train2014", "annotations/split_voc_instances_train2014.json"),
    "split_nonvoc_val2014": (
        "val2014", "annotations/split_nonvoc_instances_val2014.json"),
    "split_voc_val2014": (
        "val2014", "annotations/split_voc_instances_val2014.json"),
    "split_nonvoc_minival2014": (
        "val2014", "annotations/split_nonvoc_instances_minival2014.json"),
    "split_voc_minival2014": (
        "val2014", "annotations/split_voc_instances_minival2014.json"),
    "split_nonvoc_valminusminival2014": (
        "val2014",
        "annotations/split_nonvoc_instances_valminusminival2014.json"),
    "split_voc_valminusminival_2014": (
        "val2014",
        "annotations/split_voc_instances_valminusminival2014.json"),
}

# The 80 COCO categories (id, name) of the 2014/2017 instances files, in id
# order. A split file made from a full instances file keeps all 80 (the
# class mapping indexes the subset's positions into them).
COCO_80_CATEGORIES = (
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"),
    (5, "airplane"), (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"),
    (10, "traffic light"), (11, "fire hydrant"), (13, "stop sign"),
    (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"),
    (22, "elephant"), (23, "bear"), (24, "zebra"), (25, "giraffe"),
    (27, "backpack"), (28, "umbrella"), (31, "handbag"), (32, "tie"),
    (33, "suitcase"), (34, "frisbee"), (35, "skis"), (36, "snowboard"),
    (37, "sports ball"), (38, "kite"), (39, "baseball bat"),
    (40, "baseball glove"), (41, "skateboard"), (42, "surfboard"),
    (43, "tennis racket"), (44, "bottle"), (46, "wine glass"),
    (47, "cup"), (48, "fork"), (49, "knife"), (50, "spoon"), (51, "bowl"),
    (52, "banana"), (53, "apple"), (54, "sandwich"), (55, "orange"),
    (56, "broccoli"), (57, "carrot"), (58, "hot dog"), (59, "pizza"),
    (60, "donut"), (61, "cake"), (62, "chair"), (63, "couch"),
    (64, "potted plant"), (65, "bed"), (67, "dining table"),
    (70, "toilet"), (72, "tv"), (73, "laptop"), (74, "mouse"),
    (75, "remote"), (76, "keyboard"), (77, "cell phone"),
    (78, "microwave"), (79, "oven"), (80, "toaster"), (81, "sink"),
    (82, "refrigerator"), (84, "book"), (85, "clock"), (86, "vase"),
    (87, "scissors"), (88, "teddy bear"), (89, "hair drier"),
    (90, "toothbrush"),
)

# indices (into the 80 sorted COCO categories) of the 20 VOC classes
VOC_CAT_INDICES = (0, 1, 2, 3, 4, 5, 6, 8, 14, 15, 16, 17, 18, 19, 39, 56,
                   57, 58, 60, 62)
NONVOC_CAT_INDICES = tuple(i for i in range(80) if i not in VOC_CAT_INDICES)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple, np.ndarray)) else [x]


class CocoIndex:
    """Pure-Python COCO annotation index with the pycocotools ``COCO`` API:
    the index, the ``getAnnIds``/``getCatIds``/``getImgIds`` filters,
    ``loadAnns``/``loadCats``/``loadImgs``, ``loadRes``,
    ``loadNumpyAnnotations`` and ``annToRLE``/``annToMask`` (over
    ``data/mask.py``)."""

    def __init__(self, annotation_source=None):
        if annotation_source is None:
            dataset = {"images": [], "annotations": [], "categories": []}
        elif isinstance(annotation_source, dict):
            dataset = annotation_source
        else:
            with open(annotation_source) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self._build_index()

    def _build_index(self):
        dataset = self.dataset
        self.imgs: Dict[int, dict] = {
            img["id"]: img for img in dataset.get("images", [])}
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in dataset.get("categories", [])}
        self.anns: Dict[int, dict] = {
            a["id"]: a for a in dataset.get("annotations", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        for a in dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)
            self.cat_to_imgs[a["category_id"]].append(a["image_id"])

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def load_anns_for_img(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    # -- pycocotools-compatible surface -------------------------------------

    def info(self):
        for k, v in self.dataset.get("info", {}).items():
            logger.info("%s: %s", k, v)

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        """Annotation ids passing all given filters (dataset order).
        ``areaRng`` filters strictly inside (lo, hi); ``iscrowd`` matches
        the flag exactly when given."""
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        areaRng = list(areaRng)
        if imgIds:
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        else:
            anns = self.dataset.get("annotations", [])
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a["iscrowd"] == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        """Category ids filtered by name / supercategory / id."""
        catNms, supNms = _as_list(catNms), _as_list(supNms)
        catIds = _as_list(catIds)
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c["supercategory"] in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=(), catIds=()):
        """Image ids restricted to ``imgIds`` that contain *all* given
        categories."""
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds)
        for i, cat_id in enumerate(catIds):
            if i == 0 and not ids:
                ids = set(self.cat_to_imgs[cat_id])
            else:
                ids &= set(self.cat_to_imgs[cat_id])
        return list(ids)

    def loadAnns(self, ids=()):
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids=()):
        return [self.cats[i] for i in _as_list(ids)]

    def loadImgs(self, ids=()):
        return [self.imgs[i] for i in _as_list(ids)]

    def loadNumpyAnnotations(self, data: np.ndarray) -> List[dict]:
        """[N,7] array rows {imageID,x1,y1,w,h,score,class} → result dicts."""
        data = np.asarray(data)
        if data.ndim != 2 or data.shape[1] != 7:
            raise ValueError(f"expected an [N, 7] array, got {data.shape}")
        return [{"image_id": int(row[0]),
                 "bbox": [row[1], row[2], row[3], row[4]],
                 "score": row[5], "category_id": int(row[6])}
                for row in data]

    def loadRes(self, res) -> "CocoIndex":
        """Build a result index over this GT's images from a results json
        path, a list of result dicts, or an [N,7] numpy array."""
        if isinstance(res, str):
            with open(res) as f:
                anns = json.load(f)
        elif isinstance(res, np.ndarray):
            anns = self.loadNumpyAnnotations(res)
        else:
            anns = list(res)
        if not isinstance(anns, list):
            raise ValueError("results must be a list of objects")
        res_img_ids = set(a["image_id"] for a in anns)
        if not res_img_ids <= set(self.getImgIds()):
            raise ValueError("Results do not correspond to current coco set")

        out = {"images": list(self.dataset.get("images", []))}
        if anns and "caption" in anns[0]:
            out["images"] = [im for im in out["images"]
                             if im["id"] in res_img_ids]
            anns = [dict(a, id=i) for i, a in enumerate(anns, 1)]
        elif anns and anns[0].get("bbox"):
            out["categories"] = [dict(c) for c in
                                 self.dataset.get("categories", [])]
            filled = []
            for i, a in enumerate(anns, 1):
                x, y, w, h = a["bbox"]
                a = dict(a, id=i, area=w * h, iscrowd=0)
                a.setdefault("segmentation",
                             [[x, y, x, y + h, x + w, y + h, x + w, y]])
                filled.append(a)
            anns = filled
        elif anns and "segmentation" in anns[0]:
            from ct_tpu_torch.data import mask as mask_api

            out["categories"] = [dict(c) for c in
                                 self.dataset.get("categories", [])]
            filled = []
            for i, a in enumerate(anns, 1):
                a = dict(a, id=i, iscrowd=0,
                         area=float(mask_api.area(a["segmentation"])))
                if "bbox" not in a:
                    a["bbox"] = mask_api.toBbox(a["segmentation"]).tolist()
                filled.append(a)
            anns = filled
        elif anns and "keypoints" in anns[0]:
            out["categories"] = [dict(c) for c in
                                 self.dataset.get("categories", [])]
            filled = []
            for i, a in enumerate(anns, 1):
                kp = np.asarray(a["keypoints"], float)
                x, y = kp[0::3], kp[1::3]
                x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
                filled.append(dict(a, id=i, area=(x1 - x0) * (y1 - y0),
                                   bbox=[x0, y0, x1 - x0, y1 - y0]))
            anns = filled
        out["annotations"] = anns
        return CocoIndex(out)

    def annToRLE(self, ann: dict) -> dict:
        """Polygon / uncompressed-RLE / RLE segmentation → compressed RLE."""
        from ct_tpu_torch.data import mask as mask_api

        im = self.imgs[ann["image_id"]]
        h, w = im["height"], im["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            # multi-part polygon: merge part masks into one RLE
            return mask_api.merge(mask_api.frPyObjects(segm, h, w))
        if isinstance(segm["counts"], list):
            return mask_api.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann: dict) -> np.ndarray:
        from ct_tpu_torch.data import mask as mask_api

        return mask_api.decode(self.annToRLE(ann))


class COCODetection:
    """COCO dataset over predefined (year, image_set) splits.

    Annotations are [N, 5] pixel-coord rows ``[x1,y1,x2,y2,label]`` with
    contiguous 1-based labels under the split's remap; ``__getitem__``
    appends a unit mixup-weight column → [N, 6]. As in the JAX package,
    ``coco``, ``img_ids`` and the class mapping are those of the last image
    set: training reads only ``ids`` and ``annotations``, evaluation runs
    on one set.
    """

    def __init__(self, root: str, image_sets: Sequence[Tuple[str, str]],
                 preproc: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None,
                 dataset_name: str = "COCO"):
        self.root = root
        self.cache_path = os.path.join(root, "cache")
        self.image_set = list(image_sets)
        self.preproc = preproc
        self.target_transform = target_transform
        self.name = dataset_name
        self.ids: List[str] = []
        self.annotations: List[np.ndarray] = []

        for year, image_set in image_sets:
            coco_name = image_set + year
            image_dir, annofile = PREDEFINED_SPLITS_COCO[coco_name]
            image_root = os.path.join(root, "images", image_dir)
            self.coco = CocoIndex(os.path.join(root, annofile))
            self.coco_name = coco_name
            self.class_names = self._build_class_mapping(coco_name)
            self.num_classes = len(self.class_names)
            self.img_ids = self.coco.get_img_ids()
            self.ids.extend(
                os.path.join(image_root, self.coco.imgs[i]["file_name"])
                for i in self.img_ids)
            self.annotations.extend(
                self._load_annotations(coco_name, self.img_ids))

    # -- class mapping -----------------------------------------------------

    def _build_class_mapping(self, coco_name: str) -> List[str]:
        cat_ids = self.coco.get_cat_ids()
        cat_names = [self.coco.cats[c]["name"] for c in cat_ids]
        self.class_to_coco_cat_id = dict(zip(cat_names, cat_ids))

        if "nonvoc" in coco_name:
            self.id_map = NONVOC_CAT_INDICES
        elif "voc" in coco_name:
            self.id_map = VOC_CAT_INDICES
        else:
            self.id_map = tuple(range(len(cat_ids)))
        # a split file may hold only its subset's categories; the index
        # tables apply to a file that keeps all 80
        if len(cat_ids) == 80:
            use_ids = [cat_ids[i] for i in self.id_map]
            use_names = [cat_names[i] for i in self.id_map]
        else:
            use_ids, use_names = cat_ids, cat_names
        self.coco_cat_id_to_contiguous = {
            cid: i for i, cid in enumerate(use_ids, 1)}
        return use_names

    # -- annotations -------------------------------------------------------

    def _load_annotations(self, coco_name: str, img_ids) -> List[np.ndarray]:
        # keyed by the split's name only, as in the JAX package: a root
        # whose annotation files change needs its cache/ removed
        cache_file = os.path.join(self.cache_path,
                                  coco_name + "_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                roidb = pickle.load(f)
            logger.info("%s gt roidb loaded from %s", coco_name, cache_file)
            return roidb
        roidb = [self._annotation_for(i) for i in img_ids]
        os.makedirs(self.cache_path, exist_ok=True)
        with open(cache_file, "wb") as f:
            pickle.dump(roidb, f, pickle.HIGHEST_PROTOCOL)
        logger.info("wrote gt roidb to %s", cache_file)
        return roidb

    def _annotation_for(self, img_id: int) -> np.ndarray:
        im = self.coco.imgs[img_id]
        width, height = im["width"], im["height"]
        rows = []
        for obj in self.coco.load_anns_for_img(img_id):
            x, y, w, h = obj["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(width - 1.0, x1 + max(0.0, w - 1.0))
            y2 = min(height - 1.0, y1 + max(0.0, h - 1.0))
            if obj.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
                cls = self.coco_cat_id_to_contiguous.get(obj["category_id"])
                if cls is not None:
                    rows.append([x1, y1, x2, y2, cls])
        return np.asarray(rows, dtype=np.float64).reshape(-1, 5)

    # -- samples -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int):
        img = read_image(self.ids[index])
        target = self.annotations[index]
        if self.target_transform is not None:
            target = self.target_transform(target)
        if self.preproc is not None:
            img, target = self.preproc(img, target)
        target = np.asarray(target, dtype=np.float64).reshape(-1, 5)
        weight = np.ones((target.shape[0], 1))
        return img, np.hstack([target, weight])

    def pull_image(self, index: int) -> np.ndarray:
        """Image ``index`` decoded as BGR uint8 [H, W, 3]."""
        return read_image(self.ids[index])

    # -- evaluation --------------------------------------------------------

    def write_results(self, all_boxes, res_file: str) -> List[dict]:
        """all_boxes[class][image] = [n, 5] (x1, y1, x2, y2, score) in
        pixels → COCO result rows (xywh with the +1 pixel width) in
        ``res_file``; returns the rows."""
        results = []
        for cls_ind, cls in enumerate(self.class_names, 1):
            cat_id = self.class_to_coco_cat_id[cls]
            for im_ind, img_id in enumerate(self.img_ids):
                dets = np.asarray(all_boxes[cls_ind][im_ind],
                                  dtype=np.float64).reshape(-1, 5)
                for k in range(dets.shape[0]):
                    x1, y1, x2, y2, score = dets[k]
                    results.append({
                        "image_id": int(img_id),
                        "category_id": int(cat_id),
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1 + 1), float(y2 - y1 + 1)],
                        "score": float(score),
                    })
        os.makedirs(os.path.dirname(res_file) or ".", exist_ok=True)
        with open(res_file, "w") as f:
            json.dump(results, f)
        return results

    def evaluate_detections(self, all_boxes, output_dir: str):
        """The 12 COCO summary numbers and ``AP-<class>`` of ``all_boxes``
        (None for a test split, which has no ground truth); the results
        json goes to ``output_dir``."""
        res_file = os.path.join(output_dir,
                                f"detections_{self.coco_name}_results.json")
        results = self.write_results(all_boxes, res_file)
        if "test" in self.coco_name:
            return None
        from ct_tpu_torch.data.cocoeval import COCOEvaluator

        evaluator = COCOEvaluator(self.coco, self.coco_cat_id_to_contiguous)
        stats = evaluator.evaluate(results)
        per_cat = evaluator.per_category_ap(self.class_names)
        for name, ap in per_cat.items():
            logger.info("AP-%s: %.3f", name, ap)
        return dict(stats, **{f"AP-{k}": v for k, v in per_cat.items()})
