"""``-d COCO``, ``--worker-type process`` and ``--host-nms`` through the
port's CLIs, against the JAX package.

* The train CLI runs phase-1 COCO-60 pretraining (``--setting transfer``,
  61 classes) for two iterations at batch 2 on a small COCO-60 tree from
  the port's generator: with the device augmentation and thread workers,
  and with the host augmentation in spawned worker processes.
* The eval CLI scores that model with ``-d COCO``; the JAX package's
  ``COCODetection`` must give the same numbers for the same
  ``detections.pkl``, and ``--retest`` reproduces them.
* ``--host-nms``: on the COCO model, and on ``.parity_p2/ref_model.pth``
  over three VOC fixture images, where it must meet the JAX package's own
  band against the card-NMS eval (``tests/test_cli_e2e.py``: match rate >
  0.95 at IoU 0.75, p99 box error 0 px). At size 64, on seeded weights,
  the host stage (threshold, native NMS, per-image cap) given the JAX
  package's decoded boxes and scores gives its detections bit for bit
  (f32 and bf16, phase 1 COCO and phase 2 VOC), and the whole path with
  the weights carried across by ``models/convert.py`` gives the same
  detections in the same order, boxes within 1e-5 of the image's size and
  scores within 1e-5.
"""

import argparse
import importlib.util
import json
import logging
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import TINY_64 as J_TINY_64
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data.coco import COCODetection as JCOCODetection
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu_torch import eval as port_eval
from ct_tpu_torch import test as eval_cli
from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.data.voc import VOCTestSet
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.tools.coco_fixture import make_coco60
from ct_tpu_torch.tools.diff_detections import diff
from ct_tpu_torch.train import cli as train_cli
from test_torch_eval import REF_MODEL, REPO, VOC_ROOT, _mini_voc

PHASE1_COCO = ["-d", "COCO", "-p", "1", "--setting", "transfer"]
TRAIN = PHASE1_COCO + ["-b", "2", "--max-iter", "2", "--warmup-iter", "0",
                       "--num-workers", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = make_coco60(str(tmp_path_factory.mktemp("coco") / "coco"),
                       n_train=4, n_val=3)
    mp = pytest.MonkeyPatch()
    mp.setenv("COCO_ROOT", root)
    yield root
    mp.undo()


@pytest.fixture(scope="module")
def trained(coco_root, tmp_path_factory):
    """Two phase-1 COCO iterations with the device augmentation."""
    save = str(tmp_path_factory.mktemp("train") / "w")
    last = train_cli.main(TRAIN + ["--device-augment", "--canvas", "320",
                                   "--save-folder", save])
    return save, last


def _finite(losses: dict) -> bool:
    return all(math.isfinite(v) for v in losses.values())


def test_train_cli_runs_coco_phase1(trained):
    save, last = trained
    assert last["iteration"] == 1 and _finite(last)
    assert {"loss_box_reg", "loss_cls", "loss_obj", "total_loss"} <= set(last)
    assert os.path.exists(os.path.join(save, "model_final.pth"))
    state = torch.load(os.path.join(save, "model_final.pth"),
                       weights_only=True)["model"]
    # the phase-1 COCO-60 conf head: 60 source classes per anchor
    assert state["conf.0.weight"].shape[0] % 60 == 0
    with open(os.path.join(save, "log.txt")) as f:
        log = f.read()
    assert "No checkpoint found" in log   # a seeded init, no basenet


def test_train_cli_runs_process_workers_on_the_host_augmentation(
        coco_root, tmp_path):
    last = train_cli.main(TRAIN + ["--worker-type", "process",
                                   "--save-folder", str(tmp_path)])
    assert last["iteration"] == 1 and _finite(last)
    assert os.path.exists(tmp_path / "model_final.pth")


def _same_numbers(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k], k


def test_eval_cli_coco_matches_the_jax_evaluator(trained, coco_root,
                                                 tmp_path):
    save, _ = trained
    argv = PHASE1_COCO + ["--load-file", os.path.join(save,
                                                      "model_final.pth"),
                          "--save-folder", str(tmp_path), "-b", "2",
                          "--device", "cpu"]
    res = eval_cli.main(argv)
    names = [k for k in res if k.startswith("AP-")]
    assert len(names) == 60 and len(res) == 72
    assert all(0 <= res[k] <= 1 or res[k] == -1 for k in ("AP", "AP50"))
    inference = tmp_path / "inference"
    with open(inference / "eval.json") as f:
        _same_numbers(json.load(f), res)
    with open(inference / "detections.pkl", "rb") as f:
        all_boxes = pickle.load(f)
    assert len(all_boxes) == 61 and len(all_boxes[1]) == 3
    assert sum(len(all_boxes[c][i]) for c in range(1, 61)
               for i in range(3)) > 0
    ref = JCOCODetection(coco_root, [("2014", "split_nonvoc_minival")])
    _same_numbers(res, ref.evaluate_detections(all_boxes,
                                               str(tmp_path / "jax")))
    _same_numbers(eval_cli.main(argv + ["--retest"]), res)


def test_eval_cli_coco_host_nms(trained, coco_root, tmp_path):
    save, _ = trained
    res = eval_cli.main(PHASE1_COCO + [
        "--host-nms", "--load-file", os.path.join(save, "model_final.pth"),
        "--save-folder", str(tmp_path), "-b", "2", "--device", "cpu"])
    assert len(res) == 72
    with open(tmp_path / "inference" / "speed.json") as f:
        speed = json.load(f)
    assert speed["host_nms"] and speed["images"] == 3


def test_calibration_reads_the_coco_train_split(coco_root):
    from ct_tpu_torch.config import RGB_MEANS
    from ct_tpu_torch.data.coco import COCODetection
    from ct_tpu_torch.data.voc import eval_transform

    args = eval_cli.parse_args(PHASE1_COCO)
    images = eval_cli.calibration_images(args, 96, 3)
    ds = COCODetection(coco_root, [("2014", "split_nonvoc_train")])
    want = np.stack([eval_transform(ds.pull_image(i), 96, RGB_MEANS)
                     for i in range(3)]).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(images, want)


def test_eval_cli_host_nms_meets_the_jax_band_on_voc(tmp_path, monkeypatch):
    monkeypatch.setenv("VOC_ROOT", _mini_voc(tmp_path, 3))
    argv = ["-p", "2", "--setting", "incre", "--split", "1",
            "--load-file", REF_MODEL, "-b", "3", "--device", "cpu"]
    res = {}
    for name, flags in (("card", []), ("host", ["--host-nms"])):
        res[name] = eval_cli.main(argv + flags + [
            "--save-folder", str(tmp_path / name)])
    fid = diff(str(tmp_path / "card" / "inference" / "detections.pkl"),
               str(tmp_path / "host" / "inference" / "detections.pkl"),
               iou_thr=0.75)
    assert fid["detections_a"] > 10 and fid["match_rate"] > 0.95, fid
    assert fid["p99_box_err_px"] == 0.0, fid
    assert set(res["host"]) == {"mAP", "APs", "base_mAP", "novel_mAP"}


class _Images:
    """The first ``n`` images of the VOC fixture's test set."""

    def __init__(self, n):
        self.ds = VOCTestSet(VOC_ROOT, phase=2, setting="incre", split=1)
        self.n = n

    def __len__(self):
        return self.n

    def pull_image(self, i):
        return self.ds.pull_image(i)


TASKS = {"phase2_incre": (2, "incre", "VOC"),
         "phase1_coco": (1, "transfer", "COCO")}


def seeded_variables(task, seed):
    """JAX variables of a size-64 model from the port's seeded init, its BN
    statistics and CT parameters randomized (their inits are zeros or
    ones), through the JAX package's importer of reference state dicts."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, val in build_net(task, 64, device="cpu").state_dict().items():
        if key.endswith("running_mean"):
            val = torch.randn(val.shape, generator=gen) * 0.1
        elif key.endswith("running_var"):
            val = torch.rand(val.shape, generator=gen) + 0.5
        elif key.startswith(("Wz", "OBJ_Target", "fc_base")):
            val = torch.randn(val.shape, generator=gen) * 0.3
        state[key] = val
    return torch_state_to_variables(state)


def _jax_eval_cli():
    """The JAX package's ``test.py``, by path (``import test`` may find the
    standard library's package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_cli", os.path.join(REPO, "test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_host_nms():
    """(key, bf16) → (variables, the JAX package's all_boxes, its decoded
    (boxes, scores) of each batch), computed once."""
    cli, cache = _jax_eval_cli(), {}

    def run(key, bf16):
        if (key, bf16) in cache:
            return cache[key, bf16]
        jtask = j_resolve_task(*TASKS[key][:2], "ours", TASKS[key][2])
        variables = seeded_variables(
            resolve_task(*TASKS[key][:2], "ours", TASKS[key][2]),
            TASKS[key][0])
        jnet = j_build_net(jtask, 64, dtype=jnp.bfloat16 if bf16 else None)
        # what its decode step hands to the host, batch by batch (its run
        # fetches boxes, then scores, with jax.device_get)
        fetched = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "device_get",
                       lambda x: fetched.append(np.asarray(x)) or fetched[-1])
            ref = cli.run_inference_host_nms(
                argparse.Namespace(batch_size=2), jnet, variables,
                _Images(3), jtask, j_prior_boxes(J_TINY_64), 64,
                logging.getLogger(__name__))
        decoded = list(zip(fetched[0::2], fetched[1::2]))
        cache[key, bf16] = variables, ref, decoded
        return cache[key, bf16]

    return run


def _assert_same_detections(ours, ref, tol=0.0):
    """The same detections in the same order; boxes within ``tol`` of the
    image's size, scores within ``tol``."""
    sizes = [max(_Images(3).pull_image(i).shape[:2]) for i in range(3)]
    assert len(ours) == len(ref)
    for c in range(1, len(ref)):
        for i in range(len(ref[c])):
            a, b = np.asarray(ours[c][i]), np.asarray(ref[c][i])
            assert a.dtype == np.float32 and a.shape == b.shape, (c, i)
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0,
                                       atol=tol * sizes[i])
            np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=tol)
    assert sum(len(ref[c][i]) for c in range(1, len(ref))
               for i in range(len(ref[1]))) > 0


@pytest.mark.parametrize("key,bf16", [("phase2_incre", False),
                                      ("phase1_coco", False),
                                      ("phase2_incre", True)])
def test_host_stage_matches_jax_bit_for_bit(key, bf16, jax_host_nms,
                                            monkeypatch):
    _, ref, decoded = jax_host_nms(key, bf16)
    batches = iter(decoded)

    def decode_step(net, priors_cs, score_threshold):
        def step(images):
            boxes, scores = next(batches)
            scores = torch.from_numpy(np.array(scores, np.float32))
            typed = scores.to(torch.bfloat16) if bf16 else scores
            return (torch.from_numpy(np.array(boxes, np.float32)), scores,
                    typed > score_threshold)
        return step

    monkeypatch.setattr(port_eval, "make_decode_step", decode_step)
    task = resolve_task(*TASKS[key][:2], "ours", TASKS[key][2])
    ours = port_eval.run_inference_host_nms(
        None, _Images(3), task, prior_boxes(TINY_64), 64, batch_size=2)
    _assert_same_detections(ours, ref)


@pytest.mark.parametrize("key", list(TASKS))
def test_host_nms_matches_jax_with_converted_weights(key, jax_host_nms):
    variables, ref, _ = jax_host_nms(key, False)
    task = resolve_task(*TASKS[key][:2], "ours", TASKS[key][2])
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(from_jax_variables(variables))
    ours = port_eval.run_inference_host_nms(
        net, _Images(3), task, prior_boxes(TINY_64), 64, batch_size=2)
    _assert_same_detections(ours, ref, tol=1e-5)


def test_host_nms_runs_a_bf16_model():
    task = resolve_task(1, "transfer", "ours", "COCO")
    torch.manual_seed(0)
    net = build_net(task, 64, device="cpu", dtype=torch.bfloat16)
    ours = port_eval.run_inference_host_nms(
        net, _Images(2), task, prior_boxes(TINY_64), 64, batch_size=2)
    assert len(ours) == 61
    rows = [ours[c][i] for c in range(1, 61) for i in range(2)]
    assert all(r.dtype == np.float32 and r.shape[1:] == (5,) for r in rows)
    per_image = [sum(len(ours[c][i]) for c in range(1, 61))
                 for i in range(2)]
    assert all(0 < n for n in per_image)
