"""The port's COCO data layer vs the JAX package's, on the same trees.

``ct_tpu_torch.data.coco`` (``CocoIndex``, ``COCODetection``),
``data/cocoeval.py``, the fixture generator ``tools/coco_fixture.py``, the
loader's process workers and the data scripts (``split_coco``,
``split_voc``, ``make_shots``) against their ``ct_tpu`` counterparts and
the JAX test fixtures. The evaluator is held to the JAX package's tracked
record: its detections of the COCO-60 minival
(``.parity_tr/ours_eval_coco/inference/detections.pkl``), scored over the
fixture rebuilt by the port's generator, must give every number of
``.parity_tr/ours_eval_coco.json`` within 1e-12.
"""

import filecmp
import json
import math
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ct_tpu.data import coco as J
from ct_tpu.data.augment import RawCanvasTransform as JRawCanvas
from ct_tpu.data.cocoeval import COCOEvaluator as JEvaluator
from ct_tpu.data.loader import Loader as JLoader
from ct_tpu_torch.data import coco as T
from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment
from ct_tpu_torch.data.cocoeval import COCOEvaluator
from ct_tpu_torch.data.loader import Loader
from ct_tpu_torch.tools import coco_fixture
from fixtures import make_coco60 as j_make_coco60
from fixtures import make_mini_coco as j_make_mini_coco
from fixtures import make_mini_voc
from test_coco_api import make_dataset
from test_cocoeval_oracle import make_synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, ".parity_tr", "ours_eval_coco")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The mini tree from the port's generator and the JAX fixture's, and a
    small COCO-60 tree from each (separate roots: each dataset writes its
    own roidb cache)."""
    root = tmp_path_factory.mktemp("coco")
    out = {}
    for name, make, kw in (("mini", "make_mini_coco", {}),
                           ("coco60", "make_coco60",
                            {"n_train": 12, "n_val": 5})):
        out[name] = getattr(coco_fixture, make)(str(root / name), **kw)
        jmake = j_make_mini_coco if name == "mini" else j_make_coco60
        out["j_" + name] = jmake(str(root / ("j_" + name)), **kw)
    return out


@pytest.fixture(scope="module")
def coco60_full(tmp_path_factory):
    """The COCO-60 fixture at the size of its tracked record (1,800 train
    and 128 minival images, seed 0), from the port's generator."""
    return coco_fixture.make_coco60(
        str(tmp_path_factory.mktemp("coco60") / "coco"), n_train=1800,
        n_val=128)


@pytest.mark.parametrize("name", ["mini", "coco60"])
def test_fixture_generator_writes_the_jax_fixtures_tree(trees, name):
    ours, ref = trees[name], trees["j_" + name]
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    ref_files = sorted(os.path.relpath(os.path.join(d, f), ref)
                       for d, _, fs in os.walk(ref) for f in fs)
    assert files == ref_files and len(files) > 3
    for rel in files:   # the annotation JSON and the JPEG bytes
        assert filecmp.cmp(os.path.join(ours, rel), os.path.join(ref, rel),
                           shallow=False), rel


def test_coco_index_api_matches_jax():
    gt = make_dataset()
    ours, ref = T.CocoIndex(gt), J.CocoIndex(gt)
    for kw in (dict(), dict(imgIds=[1, 3]), dict(imgIds=2),
               dict(catIds=[7]), dict(catIds=[3, 11]),
               dict(imgIds=[1, 2, 4], catIds=[7, 3]),
               dict(areaRng=[50, 400]), dict(iscrowd=True),
               dict(iscrowd=False), dict(imgIds=[999]),
               dict(imgIds=[1], catIds=[7], areaRng=[0, 1e5], iscrowd=0)):
        assert ours.getAnnIds(**kw) == ref.getAnnIds(**kw), kw
    for kw in (dict(), dict(catNms=["dog", "car"]), dict(supNms="vehicle"),
               dict(catNms=["dog", "cat"], supNms=["animal"], catIds=[3]),
               dict(catNms=["nothing"])):
        assert ours.getCatIds(**kw) == ref.getCatIds(**kw), kw
    for kw in (dict(), dict(imgIds=[1, 2]), dict(catIds=[7, 3]),
               dict(imgIds=[1, 2, 3], catIds=[11]), dict(catIds=[999])):
        assert sorted(ours.getImgIds(**kw)) == sorted(ref.getImgIds(**kw))
    ids = ref.getAnnIds(imgIds=[1, 2])
    assert ours.loadAnns(ids) == ref.loadAnns(ids)
    assert ours.loadCats([7, 11]) == ref.loadCats([7, 11])
    assert ours.loadImgs(3) == ref.loadImgs(3)
    assert ours.get_cat_ids() == ref.get_cat_ids()
    assert ours.get_img_ids() == ref.get_img_ids()
    for aid in sorted(ours.anns):
        assert ours.annToRLE(ours.anns[aid]) == ref.annToRLE(ref.anns[aid])
        np.testing.assert_array_equal(ours.annToMask(ours.anns[aid]),
                                      ref.annToMask(ref.anns[aid]))


def test_load_res_matches_jax(tmp_path):
    gt = make_dataset()
    ours, ref = T.CocoIndex(gt), J.CocoIndex(gt)
    rng = np.random.RandomState(1)
    dets = [{"image_id": i, "category_id": int([7, 3, 11][rng.randint(3)]),
             "bbox": [float(v) for v in rng.uniform(1, 30, 4)],
             "score": float(rng.rand())} for i in (1, 2, 3) for _ in range(5)]
    path = str(tmp_path / "dt.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    segm = [{"image_id": 2, "category_id": 7, "score": 0.5,
             "segmentation": ours.annToRLE(ours.anns[1])}]
    arr = np.asarray([[1, 2.0, 3.0, 10.0, 12.0, 0.9, 7],
                      [4, 5.0, 1.0, 3.0, 4.0, 0.2, 3]])
    for res in (path, dets, arr, segm):
        a, b = ours.loadRes(res), ref.loadRes(res)
        assert a.dataset == b.dataset
        assert a.getAnnIds(catIds=[7]) == b.getAnnIds(catIds=[7])
    with pytest.raises(ValueError, match="do not correspond"):
        ours.loadRes([{"image_id": 777, "category_id": 7,
                       "bbox": [0, 0, 1, 1], "score": 0.5}])


SETS = {"train": [("2014", "split_nonvoc_train")],
        "train+valminusminival": [("2014", "split_nonvoc_train"),
                                  ("2014", "split_nonvoc_valminusminival")],
        "minival": [("2014", "split_nonvoc_minival")]}


@pytest.mark.parametrize("tree", ["mini", "coco60"])
@pytest.mark.parametrize("sets", list(SETS))
def test_coco_detection_matches_jax(trees, tree, sets):
    ours = T.COCODetection(trees[tree], SETS[sets])
    ref = J.COCODetection(trees["j_" + tree], SETS[sets])
    assert len(ours) == len(ref) > 0
    assert [os.path.relpath(p, trees[tree]) for p in ours.ids] == \
        [os.path.relpath(p, trees["j_" + tree]) for p in ref.ids]
    for a, b in zip(ours.annotations, ref.annotations):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for attr in ("class_names", "num_classes", "coco_cat_id_to_contiguous",
                 "class_to_coco_cat_id", "id_map", "img_ids", "coco_name"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    # COCO-60: 60 contiguous labels from the 80-category registry
    if tree == "coco60":
        assert ours.num_classes == 60 and ours.class_names == [
            name for _, name in coco_fixture.NONVOC_60]
    # the roidb cache: written once, read back, in the JAX package's format
    cache = os.path.join(trees[tree], "cache",
                         SETS[sets][-1][1] + "2014_gt_roidb.pkl")
    with open(cache, "rb") as f:
        cached = pickle.load(f)
    assert all(isinstance(a, np.ndarray) for a in cached)
    again = T.COCODetection(trees[tree], SETS[sets])
    for a, b in zip(again.annotations, ours.annotations):
        np.testing.assert_array_equal(a, b)


def test_samples_match_jax_through_the_ports_transforms(trees):
    ours = T.COCODetection(trees["coco60"], SETS["train"])
    ref = J.COCODetection(trees["j_coco60"], SETS["train"])
    for i in (0, 5):
        (img, t), (j_img, j_t) = ours[i], ref[i]
        np.testing.assert_array_equal(img, j_img)
        np.testing.assert_array_equal(t, j_t)
        assert t.shape[1] == 6 and (t[:, 5] == 1).all()
        np.testing.assert_array_equal(ours.pull_image(i), ref.pull_image(i))
    ours.preproc, ref.preproc = RawCanvasTransform(96), JRawCanvas(96)
    (img, t), (j_img, j_t) = ours[3], ref[3]
    assert img.shape == (96, 96, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(t, j_t)
    ours.preproc = TrainAugment(300, (104, 117, 123), 0.6)
    img, t = ours[3]
    assert img.shape == (300, 300, 3) and img.dtype == np.float32
    assert t.shape[1] == 6 and (t[:, :4] >= 0).all() and (t[:, :4] <= 1).all()


def test_results_json_matches_jax(trees, tmp_path):
    ours = T.COCODetection(trees["mini"], SETS["minival"])
    ref = J.COCODetection(trees["j_mini"], SETS["minival"])
    rng = np.random.RandomState(3)
    all_boxes = [[[] for _ in ours.img_ids]]
    for _ in ours.class_names:
        row = []
        for _ in ours.img_ids:
            n = rng.randint(0, 4)
            xy = rng.uniform(0, 200, (n, 2))
            row.append(np.hstack([xy, xy + rng.uniform(1, 90, (n, 2)),
                                  rng.rand(n, 1)]).astype(np.float32))
        all_boxes.append(row)
    a = ours.write_results(all_boxes, str(tmp_path / "a" / "r.json"))
    b = ref.write_results(all_boxes, str(tmp_path / "b" / "r.json"))
    assert a == b and len(a) > 0
    assert filecmp.cmp(tmp_path / "a" / "r.json", tmp_path / "b" / "r.json",
                       shallow=False)
    _same_numbers(ours.evaluate_detections(all_boxes, str(tmp_path / "a")),
                  ref.evaluate_detections(all_boxes, str(tmp_path / "b")))


def _same_numbers(a: dict, b: dict, tol: float = 0.0):
    assert set(a) == set(b)
    for k in a:
        if math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])


@pytest.mark.parametrize("seed", [0, 7])
def test_evaluator_matches_jax_bit_for_bit(seed):
    """Crowds, ignore flags, every area range, a category without ground
    truth, an image without annotations, more than 100 detections an
    image."""
    gt, dets = make_synthetic(seed=seed)
    cat_map = {c["id"]: i for i, c in enumerate(
        sorted(gt["categories"], key=lambda c: c["id"]), 1)}
    ours = COCOEvaluator(T.CocoIndex(gt), cat_map)
    ref = JEvaluator(J.CocoIndex(gt), cat_map)
    _same_numbers(ours.evaluate(dets), ref.evaluate(dets))
    for key in ("precision", "recall"):
        np.testing.assert_array_equal(ours.eval_result[key],
                                      ref.eval_result[key])
    names = [f"c{i}" for i in range(len(cat_map))]
    _same_numbers(ours.per_category_ap(names), ref.per_category_ap(names))


def test_evaluate_detections_reproduces_the_jax_record(coco60_full,
                                                       tmp_path):
    with open(os.path.join(RECORD, "inference", "detections.pkl"),
              "rb") as f:
        all_boxes = pickle.load(f)
    with open(RECORD + ".json") as f:
        record = json.load(f)
    ds = T.COCODetection(coco60_full, SETS["minival"])
    assert len(ds) == 128 and ds.num_classes == 60
    result = ds.evaluate_detections(all_boxes, str(tmp_path))
    _same_numbers(result, record, tol=1e-12)
    assert result["AP"] == pytest.approx(0.45094172478625794, abs=1e-12)
    # the results file: the one the JAX package wrote, row for row
    name = "detections_split_nonvoc_minival2014_results.json"
    with open(os.path.join(tmp_path, name)) as f:
        ours = json.load(f)
    with open(os.path.join(RECORD, "inference", name)) as f:
        assert ours == json.load(f)


def _batches(loader, n):
    try:
        return [loader.next() for _ in range(n)]
    finally:
        loader.stop()


def test_process_workers_match_threads_and_jax(trees):
    ds = T.COCODetection(trees["coco60"], SETS["train"],
                         RawCanvasTransform(64))
    j_ds = J.COCODetection(trees["j_coco60"], SETS["train"], JRawCanvas(64))
    kw = dict(num_workers=3, max_objs=6, seed=5)
    thread = _batches(Loader(ds, 4, **kw), 5)
    process = Loader(ds, 4, workers="process", **kw)
    try:
        first = [process.next() for _ in range(2)]
        process.restart()   # a new generation: new processes, seed + 1
        after = [process.next() for _ in range(2)]
    finally:
        process.stop()
    ref = _batches(JLoader(j_ds, 4, workers="process", **kw), 5)
    restarted = Loader(ds, 4, **kw)
    restarted.restart()
    after_ref = _batches(restarted, 2)
    assert not any(p.is_alive() for p in process._procs)
    for a, b in zip(first + after, thread[:2] + after_ref):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for a, b in zip(thread, ref):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert thread[0]["image"].dtype == np.uint8


def test_worker_processes_import_no_torch():
    """What a worker process imports to run a COCO or VOC dataset with
    either augmentation: no torch (each worker would import it before its
    parent's start() returns)."""
    code = ("import sys; import ct_tpu_torch.data.loader, "
            "ct_tpu_torch.data.coco, ct_tpu_torch.data.augment; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_process_worker_error_reaches_next(trees, tmp_path):
    root = shutil.copytree(trees["coco60"], tmp_path / "broken")
    ds = T.COCODetection(str(root), SETS["train"], RawCanvasTransform(32))
    for path in ds.ids:
        os.remove(path)
    loader = Loader(ds, 2, num_workers=2, workers="process")
    try:
        with pytest.raises(RuntimeError, match="worker failed") as err:
            loader.next()
        assert "cannot decode" in str(err.value.__cause__)
    finally:
        loader.stop()
    with pytest.raises(ValueError, match="thread or process"):
        Loader(ds, 2, workers="fork")


def _same_trees(a, b):
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


def test_split_coco_matches_jax(trees, tmp_path):
    from ct_tpu.data.split_coco import split_dataset as j_split
    from ct_tpu_torch.data.split_coco import main, split_dataset

    # an 80-category instances file: the COCO-60 train annotations plus
    # some VOC-category ones on their images
    src = os.path.join(trees["coco60"], "annotations",
                       "split_nonvoc_instances_train2014.json")
    with open(src) as f:
        full = json.load(f)
    rng = np.random.RandomState(0)
    for k, im in enumerate(full["images"][::2]):
        cid = T.COCO_80_CATEGORIES[T.VOC_CAT_INDICES[rng.randint(20)]][0]
        full["annotations"].append({
            "id": 9000 + k, "image_id": im["id"], "category_id": cid,
            "bbox": [1.0, 2.0, 30.0, 40.0], "area": 1200.0, "iscrowd": 0})
    for d in ("ours", "ref", "cli"):
        os.makedirs(tmp_path / d)
    annofile = str(tmp_path / "instances_train2014.json")
    with open(annofile, "w") as f:
        json.dump(full, f)
    ours = split_dataset(annofile, str(tmp_path / "ours"))
    j_split(annofile, str(tmp_path / "ref"))
    main([annofile, "--out-dir", str(tmp_path / "cli")])
    _same_trees(tmp_path / "ours", tmp_path / "ref")
    _same_trees(tmp_path / "ours", tmp_path / "cli")
    with open(ours["voc"]) as f:
        voc = json.load(f)
    assert len(voc["categories"]) == 20 and len(voc["annotations"]) == 6


@pytest.fixture(scope="module")
def voc_trees(tmp_path_factory):
    """Two copies of a VOC 2007+2012 tree with all 20 classes."""
    from ct_tpu_torch.data.voc import VOC_CLASSES

    root = tmp_path_factory.mktemp("voc")
    devkit = make_mini_voc(str(root / "a"), year="2007", num_images=60,
                           classes=VOC_CLASSES[0][1:], seed=3)
    make_mini_voc(str(root / "a"), year="2012", num_images=60,
                  classes=VOC_CLASSES[0][1:], seed=4)
    copies = []
    for name in ("ours", "ref"):
        shutil.copytree(devkit, root / name)
        copies.append(str(root / name))
    return copies


def test_split_voc_and_make_shots_match_jax(voc_trees):
    from ct_tpu.data import make_shots as j_make_shots
    from ct_tpu.data import split_voc as j_split_voc
    from ct_tpu_torch.data import make_shots, split_voc
    from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection

    ours, ref = voc_trees
    argv = ["--years", "2007", "2012", "--shots", "1", "3",
            "--instance-depth", "4", "--seed", "2"]
    make_shots.main(["--voc-root", ours] + argv)
    j_make_shots.main(["--voc-root", ref] + argv)
    for year in ("2007", "2012"):
        split_voc.main([os.path.join(ours, "VOC" + year), "--image-set",
                        "trainval", "--splits", "1", "3"])
        for s in (1, 3):
            j_split_voc.split_voc(os.path.join(ref, "VOC" + year), s)
    _same_trees(ours, ref)
    # the lists land where the port's VOCDetection reads them
    ds = VOCDetection(ours, [("2007", "trainval"), ("2012", "trainval")],
                      None, AnnotationTransform(0), phase=2,
                      setting="transfer", shot=3)
    assert len(ds) >= 20
    ds = VOCDetection(ours, [("2007", "trainval")], None,
                      AnnotationTransform(1), phase=2, setting="incre",
                      split=1, shot=2)
    assert (ds[0][1][1:, 4] == -1).all()
