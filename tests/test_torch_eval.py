"""The port's eval path vs the JAX package's, on the CPU.

* ``decode_and_fuse``, ``batched_nms`` and ``postprocess`` on seeded
  inputs with tie-heavy scores: identical detections (the same boxes,
  scores, classes and order; ties resolve lower index first in both).
* The slice as a whole: ``.parity_p2/ref_model.pth`` through the JAX eval
  step and the port's, on two images of the ``.parity_p2`` VOC fixture.
  Detections match per image: the same count, and per box IoU ≥ 0.999 and
  |Δscore| ≤ 1e-4 (f32 convolutions sum in another order in XLA and in
  PyTorch; scores move by ~1e-6).
* The port's eval CLI on a 3-image VOC root: files written, ``--retest``,
  and per-class AP against the JAX package's ``voc_eval``.
* Gated by ``CT_TPU_SLOW_TESTS``: the CLI over all 500 fixture images
  against the JAX package's recorded mAP (|ΔmAP| ≤ 0.003) and detections,
  in f32, on the int8 serving path (``--int8 --calib-images 8``) and in the
  JAX bench's full serving config (``--int8 --int8-heads --bf16
  --approx-topk on --top-k 128 --pool-size 512``); and
  the int8 path quantized from the JAX package's own calibration, against
  the JAX package's int8 eval on the CPU.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import VOC_300 as J_VOC_300
from ct_tpu.config import RGB_MEANS as J_RGB_MEANS
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data.augment import EvalTransform
from ct_tpu.data.voc_eval import voc_eval as j_voc_eval
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu.ops.detection import decode_and_fuse as j_decode_and_fuse
from ct_tpu.ops.detection import postprocess as j_postprocess
from ct_tpu.ops.nms import batched_nms as j_batched_nms
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu.train.step import make_eval_step as j_make_eval_step
from ct_tpu_torch.config import RGB_MEANS, VOC_300, resolve_task
from ct_tpu_torch.data.voc import VOCTestSet, eval_transform
from ct_tpu_torch.eval import compare_detections, make_eval_step
from ct_tpu_torch.models.convert import load_reference_pth
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.detection import decode_and_fuse, postprocess
from ct_tpu_torch.ops.nms import Detections, batched_nms
from ct_tpu_torch.ops.priors import prior_boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, ".parity_p2")
REF_MODEL = os.path.join(PARITY, "ref_model.pth")
VOC_ROOT = os.path.join(PARITY, "voc", "VOCdevkit")


def assert_dets_equal(ours, ref):
    for name in ("boxes", "scores", "classes", "valid"):
        a = getattr(ours, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def tie_heavy_scores(rng, b, p, c):
    """Softmax-like scores on a coarse grid: many exact ties within and
    across classes."""
    s = rng.integers(0, 12, (b, p, c)).astype(np.float32) / 16.0
    s[..., 0] = 1.0 - s[..., 1:].max(-1)
    return s


def test_decode_and_fuse_match_jax():
    rng = np.random.default_rng(0)
    priors = j_prior_boxes(J_VOC_300)[:400]
    loc = rng.standard_normal((2, 400, 4)).astype(np.float32)
    conf = rng.dirichlet(np.ones(15), (2, 400)).astype(np.float32)
    obj = rng.dirichlet(np.ones(2), (2, 400)).astype(np.float32)
    jb, js = j_decode_and_fuse(*map(jnp.asarray, (loc, conf, obj)), priors)
    tb, ts = decode_and_fuse(*map(torch.from_numpy, (loc, conf, obj)),
                             torch.from_numpy(np.array(priors)))
    # decode goes through exp: XLA's and PyTorch's agree to 2 ulp of f32
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2.4e-7,
                               atol=1e-7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("top_k,cap", [(50, 40), (200, 200)])
def test_batched_nms_matches_jax_on_ties(top_k, cap):
    rng = np.random.default_rng(top_k)
    b, p, c = 2, 300, 6
    mins = rng.uniform(0, 400, (b, p, 2))
    sizes = rng.uniform(10, 150, (b, p, 2))
    boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    boxes[:, 100:150] = boxes[:, 50:100]          # exact duplicate boxes
    scores = tie_heavy_scores(rng, b, p, c)
    ref = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                        top_k=top_k, max_per_image=cap)
    ours = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       top_k=top_k, max_per_image=cap)
    assert ours.valid.sum() > 0
    assert_dets_equal(ours, ref)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(5)
    priors = np.array(j_prior_boxes(J_VOC_300))
    p = priors.shape[0]
    loc = (rng.standard_normal((2, p, 4)) * 0.5).astype(np.float32)
    conf = tie_heavy_scores(rng, 2, p, 16)[..., 1:] * 1.2
    obj = rng.dirichlet(np.ones(2), (2, p)).astype(np.float32)
    sizes = np.asarray([[375, 500], [333, 250]], np.int32)
    ref = j_postprocess(*map(jnp.asarray, (loc, conf, obj)),
                        jnp.asarray(priors), image_sizes=jnp.asarray(sizes))
    ours = postprocess(*map(torch.from_numpy, (loc, conf, obj, priors)),
                       image_sizes=torch.from_numpy(sizes))
    # boxes are decoded (exp) then scaled: 2 ulp; everything else exact
    np.testing.assert_allclose(ours.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=2.4e-7, atol=1e-4)
    for name in ("scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_slice_matches_jax_on_fixture_images():
    import cv2

    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    ds = VOCTestSet(VOC_ROOT, phase=2, setting="incre", split=1)
    raw = [ds.pull_image(i) for i in (0, 1)]
    # the port's reader and transform are the JAX package's
    first = os.path.join(VOC_ROOT, "VOC2007", "JPEGImages",
                         ds.ids[0] + ".jpg")
    np.testing.assert_array_equal(raw[0], cv2.imread(first))
    jt = EvalTransform(300, J_RGB_MEANS)
    images = np.stack([eval_transform(im, 300, RGB_MEANS) for im in raw])
    np.testing.assert_array_equal(images, np.stack([jt(im) for im in raw]))
    sizes = np.asarray([im.shape[:2] for im in raw], np.int32)

    jnet = j_build_net(jtask, 300)
    variables = torch_state_to_variables(state)
    jstep = j_make_eval_step(jnet, j_prior_boxes(J_VOC_300))
    ref = jstep(variables["params"], variables["batch_stats"],
                jnp.asarray(images), jnp.asarray(sizes))

    net = build_net(task, 300, device="cpu")
    net.load_state_dict(state)
    step = make_eval_step(net, prior_boxes(VOC_300))
    ours = step(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(sizes))
    for i in range(2):
        agree = compare_detections(ours, ref, image=i)
        assert agree["ok"] and agree["count_a"] > 0, agree


def _mini_voc(tmp_path, n):
    """A VOC root with the first ``n`` fixture test images (symlinks)."""
    src = os.path.join(VOC_ROOT, "VOC2007")
    dst = tmp_path / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (dst / sub).mkdir(parents=True)
    with open(os.path.join(src, "ImageSets", "Main", "test.txt")) as f:
        ids = [line.strip() for line in f][:n]
    for i in ids:
        os.symlink(os.path.join(src, "Annotations", i + ".xml"),
                   dst / "Annotations" / (i + ".xml"))
        os.symlink(os.path.join(src, "JPEGImages", i + ".jpg"),
                   dst / "JPEGImages" / (i + ".jpg"))
    (dst / "ImageSets" / "Main" / "test.txt").write_text(
        "".join(i + "\n" for i in ids))
    return str(tmp_path / "VOCdevkit")


def test_eval_cli_on_a_small_voc_root(tmp_path, monkeypatch):
    from ct_tpu_torch import test as cli

    root = _mini_voc(tmp_path, 3)
    monkeypatch.setenv("VOC_ROOT", root)
    save = str(tmp_path / "out")
    argv = ["-p", "2", "--setting", "incre", "--split", "1",
            "--load_file", REF_MODEL, "--save_folder", save, "-b", "2",
            "--device", "cpu"]
    res = cli.main(argv)
    inference = os.path.join(save, "inference")
    with open(os.path.join(inference, "eval.json")) as f:
        assert json.load(f) == res
    assert set(res) == {"mAP", "APs", "base_mAP", "novel_mAP"}
    assert len(res["APs"]) == 20
    with open(os.path.join(inference, "detections.pkl"), "rb") as f:
        all_boxes = pickle.load(f)
    assert len(all_boxes) == 21 and len(all_boxes[1]) == 3
    assert sum(len(all_boxes[c][i]) for c in range(1, 21)
               for i in range(3)) > 0
    assert cli.main(argv + ["--retest"]) == res
    # per-class AP agrees with the JAX package's VOC evaluation
    voc = os.path.join(root, "VOC2007")
    for cls, ap in res["APs"].items():
        _, _, j_ap = j_voc_eval(
            os.path.join(inference, "results", f"comp4_det_test_{cls}.txt"),
            os.path.join(voc, "Annotations", "{:s}.xml"),
            os.path.join(voc, "ImageSets", "Main", "test.txt"), cls,
            str(tmp_path / "jax_cache"), ovthresh=0.5, use_07_metric=True)
        assert ap == j_ap, cls


# the JAX package's recorded evals of ref_model.pth on the 500 images
# (docs/PARITY.md): f32, the int8 backbone calibrated on 8 images, and the
# JAX bench's full serving config (int8 with the heads, bf16, approximate
# top-k 128 in a pool of 512)
VOC500 = {
    "f32": ([], "ours_eval", 0.74351, 0.61613),
    "int8": (["--int8", "--calib-images", "8"], "ours_eval_int8", 0.74366,
             0.61692),
    "bf16_full": (["--int8", "--int8-heads", "--calib-images", "8", "--bf16",
                   "--approx-topk", "on", "--top-k", "128", "--pool-size",
                   "512"], "ours_eval_int8h_bf16_approx_pool", 0.73870,
                  0.61636),
}
# the JAX package's own CPU run of the full config (the command is in
# .parity_p2/ours_eval_int8h_bf16_approx_pool_cpu/inference/log.txt): the
# port's CPU run misses the TPU record's novel mAP by 0.0052, as int8 did
# (ROADMAP Queue 3 items 3 and 6), and is held to this record as well
VOC500["bf16_full_cpu"] = (VOC500["bf16_full"][0],
                           "ours_eval_int8h_bf16_approx_pool_cpu", 0.74040,
                           0.62140)


@pytest.mark.skipif(not os.environ.get("CT_TPU_SLOW_TESTS"),
                    reason="needs CT_TPU_SLOW_TESTS=1 (500-image eval on "
                           "the CPU, ~10 min)")
@pytest.mark.parametrize("config", list(VOC500))
def test_voc500_map_matches_jax(tmp_path, monkeypatch, config):
    """The port's CLI over the 500-image fixture vs the JAX package's
    recorded eval of the same weights (.parity_p2/ours_eval*.json)."""
    from ct_tpu.tools.diff_detections import diff
    from ct_tpu_torch import test as cli

    flags, ref_dir, ref_map, ref_novel = VOC500[config]
    monkeypatch.setenv("VOC_ROOT", VOC_ROOT)
    save = str(tmp_path / "out")
    res = cli.main(["-p", "2", "--setting", "incre", "--split", "1",
                    "--load-file", REF_MODEL, "--save-folder", save,
                    "-b", "8", "--device", "cpu"] + flags)
    with open(os.path.join(PARITY, ref_dir + ".json")) as f:
        ref = json.load(f)
    stats = diff(os.path.join(save, "inference", "detections.pkl"),
                 os.path.join(PARITY, ref_dir, "inference",
                              "detections.pkl"))
    print(json.dumps({"port": res, "jax": ref, "diff": stats},
                     default=float))
    assert abs(res["mAP"] - ref_map) <= 0.003
    assert abs(res["novel_mAP"] - ref_novel) <= 0.003
    assert stats["match_rate"] > 0.95


# the JAX package's int8 eval of the 500 images on the CPU, calibrated on
# the same 8 images (its recorded int8 eval above ran on the TPU):
#   JAX_PLATFORMS=cpu VOC_ROOT=.parity_p2/voc/VOCdevkit python test.py -p 2 \
#     --setting incre --split 1 --load-file .parity_p2/ref_model.pth \
#     --save-folder .parity_p2/ours_eval_int8_cpu -b 8 --int8 \
#     --calib-images 8
# with its result (the same command with --retest) in ours_eval_int8_cpu.json
JAX_INT8_CPU = "ours_eval_int8_cpu"


@pytest.mark.skipif(not os.environ.get("CT_TPU_SLOW_TESTS"),
                    reason="needs CT_TPU_SLOW_TESTS=1 (500-image eval on "
                           "the CPU, ~10 min)")
def test_voc500_int8_on_jax_calibration(tmp_path, monkeypatch):
    """The port's CPU int8 eval of the 500 images, quantized from the JAX
    package's calibration of the same 8 train-split images instead of its
    own, held to the JAX package's int8 eval on the CPU at the band of
    ``test_voc500_map_matches_jax``. It tells apart a fault of the port's
    int8 path (it would miss this record too) from the difference between
    the CPU's and the TPU's arithmetic, on which JAX's recorded int8 eval
    ran; its distance to that record is printed beside."""
    import argparse
    import dataclasses

    from ct_tpu.models.fold_bn import fold_variables
    from ct_tpu.models.quantize import calibrate as j_calibrate
    from ct_tpu.tools.diff_detections import diff
    from ct_tpu_torch import test as cli
    from ct_tpu_torch.models import quantize
    from ct_tpu_torch.models.fold_bn import fold_bn
    from test_torch_serving import by_name

    flags, tpu_dir, _, _ = VOC500["int8"]
    monkeypatch.setenv("VOC_ROOT", VOC_ROOT)
    args = argparse.Namespace(phase=2, setting="incre", split=1)
    images = cli.calibration_images(args, 300, 8)           # NCHW
    state = load_reference_pth(REF_MODEL)
    jnet = dataclasses.replace(
        j_build_net(j_resolve_task(2, "incre", "ours", "VOC"), 300),
        fold_bn=True)
    folded = fold_variables(torch_state_to_variables(state))
    j_calib = by_name(j_calibrate(
        jnet, folded, [jnp.asarray(images.transpose(0, 2, 3, 1))]))
    net = build_net(resolve_task(2, "incre", "ours", "VOC"), 300,
                    device="cpu")
    net.load_state_dict(state)
    own = quantize.calibrate(fold_bn(net), [torch.from_numpy(images)])
    assert set(own) == set(j_calib)
    rel = {n: abs(own[n].item() - float(v)) / float(v)
           for n, v in j_calib.items()}

    calib = {n: torch.tensor(v) for n, v in j_calib.items()}
    monkeypatch.setattr(quantize, "calibrate", lambda _net, _batches: calib)
    save = str(tmp_path / "out")
    res = cli.main(["-p", "2", "--setting", "incre", "--split", "1",
                    "--load-file", REF_MODEL, "--save-folder", save,
                    "-b", "8", "--device", "cpu"] + flags)
    dets = os.path.join(save, "inference", "detections.pkl")
    with open(os.path.join(PARITY, JAX_INT8_CPU + ".json")) as f:
        ref = json.load(f)
    stats = {name: diff(dets, os.path.join(PARITY, d, "inference",
                                           "detections.pkl"))
             for name, d in (("jax_cpu", JAX_INT8_CPU), ("jax_tpu", tpu_dir))}
    print(json.dumps({"port_on_jax_calibration": res, "jax_cpu": ref,
                      "diff": stats,
                      "absmax_differ": sum(r > 0 for r in rel.values()),
                      "absmax_max_rel": max(rel.values())}, default=float))
    assert abs(res["mAP"] - ref["mAP"]) <= 0.003
    assert abs(res["novel_mAP"] - ref["novel_mAP"]) <= 0.003
    assert stats["jax_cpu"]["match_rate"] > 0.95


def test_compare_detections_flags_what_differs():
    rng = np.random.default_rng(9)
    boxes = np.asarray(rng.uniform(0, 300, (1, 30, 4)), np.float32)
    boxes[..., 2:] = boxes[..., :2] + 20
    scores = np.sort(rng.uniform(0.01, 1, (1, 30)).astype(np.float32))[:, ::-1]
    classes = rng.integers(1, 4, (1, 30)).astype(np.int32)
    valid = np.ones((1, 30), bool)
    valid[:, 25:] = False
    dets = Detections(torch.from_numpy(boxes), torch.from_numpy(scores.copy()),
                      torch.from_numpy(classes), torch.from_numpy(valid))
    same = compare_detections(dets, dets)
    assert same["ok"] and same["count_a"] == 25 and same["min_iou"] == 1.0
    moved = dets._replace(boxes=dets.boxes + 3.0)
    assert not compare_detections(dets, moved)["ok"]
    fewer = dets._replace(valid=dets.valid.clone().index_fill_(1,
                          torch.tensor([3]), False))
    assert not compare_detections(dets, fewer)["ok"]
    rescored = dets._replace(scores=dets.scores + 1e-3)
    assert not compare_detections(dets, rescored)["ok"]
    relabeled = dets._replace(classes=dets.classes % 3 + 1)
    assert not compare_detections(dets, relabeled)["ok"]
