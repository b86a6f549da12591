"""The port's trained-parity chain vs the JAX package's
``scripts/real_parity.py``, and its VOC fixture vs ``tests/fixtures.py``.

* ``tools/voc_fixture.make_mini_voc`` writes ``tests/fixtures.py``'s tree
  byte for byte (JPEGs, XML, every list), colours on and off, ``test.txt``
  capped and not, both years; the ``build``, ``build2`` and ``build3``
  sub-commands write the JAX script's trees at a small size.
* ``build_fewshot_voc(600, 500)`` reproduces the tracked
  ``.parity_p2/voc/VOCdevkit`` byte for byte (its ``results/`` and
  ``annotations_cache/`` are eval artifacts, not the fixture's).
* The port's VOC evaluator scores JAX's tracked transfer detections
  (``.parity_tr/ours_eval/inference/detections.pkl``) over the port-built
  600/128 tree to every number of ``.parity_tr/ours_eval.json`` within
  1e-12.
* ``DeviceDataset`` draws JAX's ``_device_dataset`` index stream and
  gathers the same batches, bit for bit (COCO-60, VOC transfer and incre
  shots).
* Both schedules give every parameter JAX's ``build_fused_optimizer``
  learning rate at every iteration of a short run; the mixup window is
  the JAX script's; ``diff``'s PASS rule is ``cmd_diff``'s.
* A tiny chain on the CPU at 300, batch 2: ``build3``, ``train --dataset
  COCO`` and ``train2 --setting transfer`` for 2 iterations each, their
  evals, and the incre pair (``build2``, ``train``, ``train2 --setting
  incre``). Each export loads strictly through JAX's ``load_pth``; JAX's
  forward of the transfer export on a fixture image equals the port's in
  ``tests/test_torch_model.py``'s bands (logits atol 2e-3, scores 1e-4,
  rtol 1e-3); ``eval-ours`` writes the JAX script's JSON form and
  ``diff`` reports what JAX's reports.
"""

import argparse
import filecmp
import importlib.util
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data import coco as JC
from ct_tpu.data import voc as JV
from ct_tpu.data.augment import RawCanvasTransform as JRawCanvas
from ct_tpu.models.torch_import import load_pth
from ct_tpu.tools.diff_detections import diff as j_diff
from ct_tpu.train.solver import FusedSGDState, build_fused_optimizer
from ct_tpu.train.solver import SolverConfig as JSolverConfig
from ct_tpu_torch.config import RGB_MEANS, resolve_task
from ct_tpu_torch.data import augment_device
from ct_tpu_torch.data import coco as TC
from ct_tpu_torch.data import voc as TV
from ct_tpu_torch.data.augment import RawCanvasTransform
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.scripts import real_parity as rp
from ct_tpu_torch.tools import voc_fixture
from ct_tpu_torch.train.solver import build_optimizer
from fixtures import make_mini_voc as j_make_mini_voc
from fixtures import make_mini_voc_all as j_make_mini_voc_all
from test_torch_model import assert_preds_close, jax_forward, port_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED_VOC = os.path.join(REPO, ".parity_p2", "voc", "VOCdevkit")
TRANSFER_RECORD = os.path.join(REPO, ".parity_tr", "ours_eval")
EVAL_ARTIFACTS = ("results", "annotations_cache")
CHAIN_IMAGES, CHAIN_TEST = 8, 2


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "j_real_parity", os.path.join(REPO, "scripts", "real_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _jax_script()


def _files(root, skip=()):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, dirs, fs in os.walk(root)
                  if not set(os.path.relpath(d, root).split(os.sep)) & set(
                      skip)
                  for f in fs)


def assert_same_tree(ours, ref, skip=()):
    files = _files(ours, skip)
    assert files == _files(ref, skip) and len(files) > 3
    for rel in files:
        assert filecmp.cmp(os.path.join(ours, rel), os.path.join(ref, rel),
                           shallow=False), rel


def _args(**kw):
    """The JAX script's argument namespace with its defaults."""
    ns = rp.parse_args(["build"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("year,colors,test_ids", [
    ("2007", False, 0), ("2012", True, 3), ("2007", True, 0),
    ("2012", False, 2)])
def test_make_mini_voc_writes_the_jax_fixtures_tree(tmp_path, year, colors,
                                                    test_ids):
    kw = dict(year=year, num_images=7, classes=voc_fixture.ALL20,
              seed=int(year) % 5, class_colors=colors,
              max_test_ids=test_ids)
    ours = voc_fixture.make_mini_voc(str(tmp_path / "ours"), **kw)
    ref = j_make_mini_voc(str(tmp_path / "ref"), **kw)
    assert_same_tree(ours, ref)


def test_make_mini_voc_all_writes_the_jax_fixtures_tree(tmp_path):
    ours = voc_fixture.make_mini_voc_all(str(tmp_path / "ours"),
                                         num_images=5)
    ref = j_make_mini_voc_all(str(tmp_path / "ref"), num_images=5)
    assert_same_tree(os.path.dirname(ours), os.path.dirname(ref))


@pytest.mark.parametrize("cmd", ["build", "build2", "build3"])
def test_build_commands_write_the_jax_scripts_trees(tmp_path, cmd):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    rp.main([cmd, "--out", ours, "--images", "9", "--test-images", "4"])
    os.makedirs(ref)
    getattr(J, "cmd_" + cmd)(argparse.Namespace(out=ref, images=9,
                                                test_images=4))
    assert_same_tree(ours, ref)


def test_build_fewshot_voc_reproduces_the_tracked_fixture(tmp_path):
    res = voc_fixture.build_fewshot_voc(str(tmp_path / "voc"), 600, 500)
    assert res["split1_2007"] == 350 and len(res["lists"]) == 46
    assert_same_tree(res["devkit"], TRACKED_VOC, skip=EVAL_ARTIFACTS)
    assert set(os.listdir(TRACKED_VOC)) - set(os.listdir(res["devkit"])) \
        == set(EVAL_ARTIFACTS)


def test_evaluator_reproduces_the_jax_transfer_record(tmp_path):
    devkit = voc_fixture.build_fewshot_voc(str(tmp_path / "voc"), 600,
                                           128)["devkit"]
    with open(os.path.join(TRANSFER_RECORD, "inference", "detections.pkl"),
              "rb") as f:
        all_boxes = pickle.load(f)
    with open(TRANSFER_RECORD + ".json") as f:
        record = json.load(f)
    ds = TV.VOCTestSet(devkit, "2007", "test", phase=2, setting="transfer",
                       split=1)
    assert len(ds) == 128
    result = ds.evaluate_detections(all_boxes, str(tmp_path / "eval"))
    assert set(result) == set(record) and set(result["APs"]) == set(
        record["APs"]) and len(record["APs"]) == 20
    assert abs(result["mAP"] - record["mAP"]) <= 1e-12
    assert result["mAP"] == pytest.approx(0.7869802864448794, abs=1e-12)
    for cls, ap in record["APs"].items():
        assert abs(result["APs"][cls] - ap) <= 1e-12, cls


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The tiny transfer and incre chains, run through the port's command
    line on the CPU; {"tr": out, "p2": out, name: result}."""
    root = tmp_path_factory.mktemp("chain")
    tr, p2 = str(root / "tr"), str(root / "p2")
    small = ["--images", str(CHAIN_IMAGES), "--test-images",
             str(CHAIN_TEST)]
    run = ["--iters", "2", "--batch", "2", "--device", "cpu"]
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    mixed = []

    def recording(rng, batch, **kw):
        mixed.append(kw)
        return real_mixup(rng, batch, **kw)

    real_mixup = augment_device.mixup_batch
    out = {"tr": tr, "p2": p2}
    try:
        out["build3"] = rp.main(["build3", "--out", tr] + small)
        out["train"] = rp.main(["train", "--out", tr, "--dataset", "COCO",
                                "--export-name", "phase1.pth"] + run)
        out["eval_coco"] = rp.main([
            "eval-ours", "--out", tr, "--dataset", "COCO", "--phase", "1",
            "--setting", "transfer", "--load-name", "phase1.pth",
            "--eval-batch", "2", "--device", "cpu"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(augment_device, "mixup_batch", recording)
            out["train2"] = rp.main(["train2", "--out", tr, "--setting",
                                     "transfer", "--init-iter", "1",
                                     "--no-mixup-iter", "1"] + run)
        out["mixed"] = mixed
        out["eval"] = rp.main(["eval-ours", "--out", tr, "--phase", "2",
                               "--setting", "transfer", "--eval-batch", "2",
                               "--device", "cpu"])
        out["build2"] = rp.main(["build2", "--out", p2] + small)
        out["train_incre"] = rp.main(["train", "--out", p2,
                                      "--export-name", "phase1.pth"] + run)
        out["train2_incre"] = rp.main(["train2", "--out", p2, "--setting",
                                       "incre", "--init-iter", "1",
                                       "--no-mixup-iter", "1"] + run)
    finally:
        torch.set_num_threads(before)
    return out


@pytest.mark.parametrize("out,name,task", [
    ("tr", "phase1.pth", (1, "transfer", "ours", "COCO")),
    ("tr", "ref_model.pth", (2, "transfer", "ours", "VOC")),
    ("p2", "phase1.pth", (1, "incre", "ours", "VOC")),
    ("p2", "ref_model.pth", (2, "incre", "ours", "VOC"))])
def test_chain_exports_load_strictly_into_jax(chain, out, name, task):
    path = os.path.join(chain[out], name)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"model", "iteration"} and raw["iteration"] == 1
    variables = load_pth(path, strict=True)
    net = build_net(resolve_task(*task), 300, device="cpu")
    net.load_state_dict(raw["model"])      # strict in the port too
    back = from_jax_variables(variables)
    for key, val in back.items():
        if not key.endswith("num_batches_tracked"):   # not JAX state
            torch.testing.assert_close(val, raw["model"][key].float(),
                                       rtol=0, atol=0, msg=key)
    for res in ("train", "train2") if out == "tr" else ("train_incre",
                                                         "train2_incre"):
        assert all(np.isfinite(v) for v in chain[res]["last"].values())


def test_jax_forward_of_the_transfer_export_matches_the_port(chain):
    tr = chain["tr"]
    devkit = os.path.join(tr, "voc", "VOCdevkit")
    img = TV.read_image(os.path.join(devkit, "VOC2007", "JPEGImages",
                                     "000000.jpg"))
    x = TV.eval_transform(img, 300, RGB_MEANS).transpose(2, 0, 1)[None]
    state = torch.load(os.path.join(tr, "ref_model.pth"),
                       map_location="cpu", weights_only=True)["model"]
    variables = load_pth(os.path.join(tr, "ref_model.pth"))
    ref = jax_forward(j_resolve_task(2, "transfer", "ours", "VOC"), 300,
                      variables, x)
    ours = port_forward(resolve_task(2, "transfer", "ours", "VOC"), 300,
                        state, x)
    assert ours[0].conf.shape == (1, 11620, 20)
    assert_preds_close(ours, ref, atol=2e-3)


def test_eval_ours_writes_the_jax_scripts_json(chain):
    tr = chain["tr"]
    with open(os.path.join(tr, "ours_eval.json")) as f:
        voc = json.load(f)
    with open(TRANSFER_RECORD + ".json") as f:
        assert set(voc) == set(json.load(f))   # mAP, APs
    assert voc == chain["eval"] and len(voc["APs"]) == 20
    with open(os.path.join(tr, "ours_eval_coco.json")) as f:
        coco = json.load(f)
    with open(os.path.join(REPO, ".parity_tr", "ours_eval_coco.json")) as f:
        assert set(coco) == set(json.load(f))
    assert os.path.exists(os.path.join(tr, "ours_eval", "inference",
                                       "detections.pkl"))
    # the first of the two iterations mixes, the last (--no-mixup-iter 1)
    # does not, and ignore rows weigh 0 (JAX's zero_ignored=True)
    assert chain["mixed"] == [{"zero_ignored": True}]


@pytest.mark.parametrize("dataset", ["VOC", "COCO"])
def test_diff_reports_what_the_jax_script_reports(chain, dataset):
    """The chain's own scores and detections as the reference's: |Δ| 0
    and FAIL (the reference's mAP is under 0.3), as JAX's ``cmd_diff``
    says on the same files, and JAX's detection report (a 2-iteration
    model emits degenerate boxes, whose IoU with themselves is not a
    number, so not every detection matches itself)."""
    tr = chain["tr"]
    stem = "ours_eval" if dataset == "VOC" else "ours_eval_coco"
    suffix = "" if dataset == "VOC" else "_coco"
    shutil.copy(os.path.join(tr, stem + ".json"),
                os.path.join(tr, f"ref_eval{suffix}.json"))
    shutil.copy(os.path.join(tr, stem, "inference", "detections.pkl"),
                os.path.join(tr, f"detections_ref{suffix}.pkl"))
    phase = 2 if dataset == "VOC" else 1
    ours = rp.main(["diff", "--out", tr, "--dataset", dataset, "--phase",
                    str(phase), "--setting", "transfer"])
    rc = J.cmd_diff(_args(out=tr, dataset=dataset, phase=phase,
                          setting="transfer"))
    assert ours["ok"] == (rc == 0) and not ours["ok"]
    assert ours["detections"] == j_diff(
        os.path.join(tr, stem, "inference", "detections.pkl"),
        os.path.join(tr, f"detections_ref{suffix}.pkl"))


@pytest.mark.parametrize("case", [
    ("VOC", 2, "incre", {"mAP": 0.5, "novel_mAP": 0.4},
     {"mAP": 0.501, "novel_mAP": 0.401}),
    ("VOC", 2, "incre", {"mAP": 0.5, "novel_mAP": 0.4},
     {"mAP": 0.501, "novel_mAP": 0.41}),
    ("VOC", 2, "transfer", {"mAP": 0.5}, {"mAP": 0.5029}),
    ("VOC", 1, "incre", {"mAP": 0.5}, {"mAP": 0.5031}),
    ("VOC", 2, "transfer", {"mAP": 0.2}, {"mAP": 0.2}),
    ("COCO", 1, "transfer", {"AP50": 0.5, "AP": 0.4},
     {"AP50": 0.5029, "AP": 0.3}),
    ("COCO", 1, "transfer", {"AP50": 0.5, "AP": 0.4},
     {"AP50": 0.4969, "AP": 0.4})])
def test_diff_pass_rule_is_the_jax_scripts(tmp_path, case):
    dataset, phase, setting, ref, ours = case
    suffix = "_coco" if dataset == "COCO" else ""
    with open(tmp_path / f"ref_eval{suffix}.json", "w") as f:
        json.dump(ref, f)
    with open(tmp_path / "mine.json", "w") as f:
        json.dump(ours, f)
    res = rp.main(["diff", "--out", str(tmp_path), "--dataset", dataset,
                   "--phase", str(phase), "--setting", setting,
                   "--name", "mine"])
    rc = J.cmd_diff(_args(out=str(tmp_path), dataset=dataset, phase=phase,
                          setting=setting, name="mine"))
    assert res["ok"] == (rc == 0)


@pytest.fixture(scope="module")
def trees(chain):
    return {"tr": chain["tr"], "p2": chain["p2"]}


@pytest.mark.parametrize("which", ["coco60", "voc_transfer", "voc_incre"])
def test_device_dataset_draws_the_jax_scripts_batches(trees, which):
    canvas = rp.canvas_of(300)
    if which == "coco60":
        root, sets = os.path.join(trees["tr"], "coco"), [
            ("2014", "split_nonvoc_train")]
        ours = TC.COCODetection(root, sets, RawCanvasTransform(canvas))
        ref = JC.COCODetection(root, sets, JRawCanvas(canvas))
    else:
        setting = which.split("_")[1]
        devkit = os.path.join(trees["tr" if setting == "transfer" else "p2"],
                              "voc", "VOCdevkit")
        sets = [("2007", "trainval")] + (
            [("2012", "trainval")] if setting == "transfer" else [])
        kw = dict(phase=2, setting=setting, split=1, shot=5)
        at = 0 if setting == "transfer" else 1
        ours = TV.VOCDetection(devkit, sets, RawCanvasTransform(canvas),
                               TV.AnnotationTransform(at), **kw)
        ref = JV.VOCDetection(devkit, sets, JRawCanvas(canvas),
                              JV.AnnotationTransform(at), **kw)
    loader = rp.DeviceDataset(ours, 4, torch.device("cpu"))
    jloader = J._device_dataset(ref, 4)
    for _ in range(3):
        a, b = loader.next(), jloader.next()
        assert set(a) == set(b)
        for key in a:
            got = a[key].numpy()
            if key == "image":
                got = got.transpose(0, 2, 3, 1)
            want = np.asarray(b[key])
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("phase,task", [
    (1, (1, "transfer", "ours", "COCO")), (2, (2, "transfer", "ours", "VOC")),
    (2, (2, "incre", "ours", "VOC"))])
def test_schedules_give_jax_fused_learning_rates(phase, task):
    iters, lr = 48, 4e-3
    if phase == 1:
        ours_cfg = rp.phase1_solver(lr, iters)
        ref_cfg = JSolverConfig(lr=lr, steps=(int(iters * 0.7),
                                              int(iters * 0.9)),
                                warmup_iters=min(500, iters // 6))
    else:
        ours_cfg = rp.phase2_solver(lr, iters)
        ref_cfg = JSolverConfig(lr=lr, steps=(int(iters * 0.875),),
                                warmup_iters=0)
    jtask = j_resolve_task(*task)
    from ct_tpu.models import build_net as j_build_net

    shapes = jax.eval_shape(
        lambda k: j_build_net(jtask, 64).init(
            k, jax.numpy.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    ones = jax.tree_util.tree_map(np.ones_like, params)
    tx = build_fused_optimizer(params, jtask, ref_cfg)
    trace = tx.init(params).trace
    model = build_net(resolve_task(*task), 64, device="cpu")
    optimizer, scheduler = build_optimizer(model, resolve_task(*task),
                                           ours_cfg, fused=True)
    group_of = {id(p): g for g in optimizer.param_groups
                for p in g["params"]}
    names = dict(model.named_parameters())
    for count in range(iters):
        # zero momentum and parameters: the update is -lr(count)·mult
        upd, _ = tx.update(ones, FusedSGDState(trace, np.int32(count)),
                           params)
        want = from_jax_variables({"params": jax.tree_util.tree_map(
            lambda u: -np.asarray(u), upd)})
        for name, p in names.items():
            got = group_of[id(p)]["lr"]
            w = want[name].flatten()
            assert torch.all(w == w[0]), name
            assert got == pytest.approx(float(w[0]), rel=1e-6), (count,
                                                                 name)
        optimizer.step()      # no gradients: it moves nothing
        scheduler.step()


@pytest.mark.parametrize("iters,tail", [(10, 3), (600, 100), (5, 5),
                                        (3, 8)])
def test_mixup_window_is_the_jax_scripts(iters, tail):
    # train2's loop: no_mixup_from = iters - no_mixup_iter; mix if below
    assert [rp.mixup_on(it, iters, tail) for it in range(iters)] == [
        it < iters - tail for it in range(iters)]
