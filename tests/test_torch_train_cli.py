"""The port's training data, checkpoints, metrics and CLI vs the JAX
package's.

* ``TrainAugment`` from the same Python ``random`` seed: identical images
  and targets (both draw the same numbers in the same order);
  ``RawCanvasTransform`` (the host half of the device augmentation):
  identical canvases and targets.
* ``VOCDetection`` (training side) on the mini VOC of tests/fixtures.py:
  the same ids, targets, ignore labels and, from the same numpy seed, the
  same mixed images and mixup weights (ignored rows weigh 0 in ``incre``).
* ``Loader`` with thread workers: the same padded batches as the JAX
  package's ``Loader`` for one seed, before and after a restart, with the
  samples' own image dtype (float32, or uint8 canvases).
* The checkpointer: round trip, the ``last_checkpoint`` tag, resume with
  the optimizer state, the phase-2 fresh start (weights only), a skip with
  a log line per key whose shape differs, the VGG basenet's prefix.
* ``train/events.py`` and ``StepTimer`` against the JAX package's, fed the
  same scalars (and clock); ``train.py``'s write points.
* The CLI at 300 on the CPU, three steps of batch 2: phase 2 incre
  ``ours`` (shot 1, mixup, two OBJ_Target init batches), the same with the
  device augmentation and batch-level mixup, phase 2 transfer ``ours``
  from ``.parity_p2/ref_model.pth``, and phase 1 from scratch: finite
  losses, checkpoints, no ``metrics.json`` row yet (``train.py`` writes
  its first after 5 iterations), and the port's eval CLI scores
  ``model_final.pth``. Twelve steps with the device route and
  ``--profile-dir``: a ``metrics.json`` row with ``train.py``'s keys at the
  last iteration, its log line, and a trace. ``--pallas-ct``, which the
  port does not run, raises and says why.
* ``tools/diff_detections``: the JAX tool's report on the same two
  ``detections.pkl`` files; ``tools/trace_summary`` on a known trace.
"""

import json
import logging
import os
import random

import numpy as np
import pytest
import torch

from ct_tpu.config import RGB_MEANS as J_RGB_MEANS
from ct_tpu.data.augment import RawCanvasTransform as JRawCanvasTransform
from ct_tpu.data.augment import TrainAugment as JTrainAugment
from ct_tpu.data.loader import Loader as JLoader
from ct_tpu.data.voc import AnnotationTransform as JAnnotationTransform
from ct_tpu.data.voc import VOCDetection as JVOCDetection
from ct_tpu_torch.config import RGB_MEANS, resolve_task
from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment
from ct_tpu_torch.data.loader import Loader
from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.train import cli
from ct_tpu_torch.train.checkpointer import Checkpointer, PeriodicCheckpointer
from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
from fixtures import make_mini_voc, make_mini_voc_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODEL = os.path.join(REPO, ".parity_p2", "ref_model.pth")


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return make_mini_voc(str(tmp_path_factory.mktemp("voc")))


@pytest.fixture(scope="module")
def devkit_0712(tmp_path_factory):
    return make_mini_voc_all(str(tmp_path_factory.mktemp("voc0712")))


def test_train_augment_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (240, 320, 3)).astype(np.uint8)
    targets = np.asarray([[20.0, 30.0, 120.0, 140.0, 3.0],
                          [150.0, 60.0, 300.0, 200.0, 7.0]])
    ours, ref = TrainAugment(300, RGB_MEANS), JTrainAugment(300, J_RGB_MEANS)
    for seed in range(12):
        random.seed(seed)
        a_img, a_t = ours(img.copy(), targets.copy())
        random.seed(seed)
        b_img, b_t = ref(img.copy(), targets.copy())
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_t, b_t)


def test_raw_canvas_transform_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (240, 320, 3)).astype(np.uint8)
    targets = np.asarray([[20.0, 30.0, 120.0, 140.0, 3.0],
                          [150.0, 60.0, 300.0, 200.0, -1.0]])
    for canvas in (384, 100):
        a_img, a_t = RawCanvasTransform(canvas)(img.copy(), targets.copy())
        b_img, b_t = JRawCanvasTransform(canvas)(img.copy(), targets.copy())
        assert a_img.dtype == np.uint8 and a_img.shape == (canvas, canvas, 3)
        np.testing.assert_array_equal(a_img, b_img)
        np.testing.assert_array_equal(a_t, b_t)


@pytest.mark.parametrize("phase,setting,instance_shot", [
    (2, "incre", False), (2, "transfer", False), (2, "transfer", True),
    (1, "transfer", False)])
def test_voc_train_set_matches_jax(devkit, phase, setting, instance_shot):
    kw = dict(phase=phase, setting=setting, split=1, shot=1,
              instance_shot=instance_shot)
    split = 0 if setting == "transfer" else 1
    sets = [("2007", "trainval")]
    ours = VOCDetection(devkit, sets, TrainAugment(300, RGB_MEANS),
                        AnnotationTransform(split), **kw)
    ref = JVOCDetection(devkit, sets, JTrainAugment(300, J_RGB_MEANS),
                        JAnnotationTransform(split), **kw)
    assert ours.ids == ref.ids and len(ours) > 1
    for mixup in (False, True):
        for ds in (ours, ref):
            ds.set_mixup(np.random.beta if mixup else None, 1.5, 1.5)
        for i in range(min(3, len(ours))):
            samples = []
            for ds in (ours, ref):
                random.seed(i)
                np.random.seed(i)
                samples.append(ds[i])
            (a_img, a_t), (b_img, b_t) = samples
            np.testing.assert_array_equal(a_img, b_img)
            np.testing.assert_array_equal(a_t, b_t)
            if phase == 2 and (setting == "incre" or instance_shot):
                assert (a_t[1:, 4] == -1).all() or mixup
            if mixup and setting == "incre":
                assert (a_t[a_t[:, 4] == -1, 5] == 0).all()


class _Fixed:
    """Seven fixed-size samples with ragged targets; float32 images, or
    uint8 ones as the device route's canvases."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype

    def __len__(self):
        return 7

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        n = 1 + i % 3
        t = np.hstack([rng.uniform(0, 0.5, (n, 2)),
                       rng.uniform(0.5, 1, (n, 2)),
                       rng.randint(1, 20, (n, 1)), np.ones((n, 1))])
        img = rng.uniform(0, 255, (8, 8, 3)).astype(self.dtype)
        return img, t


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_loader_batches_match_jax(dtype):
    ours = Loader(_Fixed(dtype), 3, num_workers=2, max_objs=5, seed=4)
    ref = JLoader(_Fixed(dtype), 3, num_workers=3, max_objs=5, seed=4)
    try:
        for restart in (False, True):
            if restart:
                ours.restart()
                ref.restart()
            for _ in range(4):
                a, b = ours.next(), ref.next()
                assert set(a) == set(b)
                assert a["image"].dtype == dtype
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key],
                                                  err_msg=key)
    finally:
        ours.stop()
        ref.stop()


def test_loader_raises_a_worker_error():
    class Broken(_Fixed):
        def __getitem__(self, i):
            raise OSError("unreadable sample")

    loader = Loader(Broken(), 2, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="worker failed"):
            loader.next()
    finally:
        loader.stop()


def _model_and_opt(setting="incre", seed=0):
    torch.manual_seed(seed)
    task = resolve_task(2, setting, "ours", "VOC")
    net = build_net(task, 64, device="cpu").train()
    opt, sched = build_optimizer(net, task, SolverConfig(warmup_iters=2))
    return net, opt, sched


def _take_step(net, opt, sched):
    out = net(torch.ones(2, 3, 64, 64))
    (out.loc.sum() + out.conf.square().mean()).backward()
    opt.step()
    sched.step()
    opt.zero_grad()


def test_checkpointer_round_trip_tag_and_resume(tmp_path):
    net, opt, sched = _model_and_opt()
    ck = Checkpointer(str(tmp_path))
    periodic = PeriodicCheckpointer(ck, period=2, max_iter=4)
    for it in range(4):
        _take_step(net, opt, sched)
        periodic.step(it, model=net, optimizer=opt, scheduler=sched)
    assert sorted(os.listdir(tmp_path)) == [
        "last_checkpoint", "model_0000001.pth", "model_0000003.pth",
        "model_final.pth"]
    assert ck.get_checkpoint_file() == str(tmp_path / "model_final.pth")

    # resume: weights, optimizer state and iteration
    net2, opt2, sched2 = _model_and_opt(seed=1)
    assert Checkpointer(str(tmp_path)).resume_or_load(
        None, net2, opt2, sched2, resume=True) == 3
    for key, val in net.state_dict().items():
        assert torch.equal(val, net2.state_dict()[key]), key
    bufs = [opt.state[p].get("momentum_buffer") for p in net.parameters()]
    bufs2 = [opt2.state[p].get("momentum_buffer") for p in net2.parameters()]
    assert sum(b is not None for b in bufs) > 10
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(bufs, bufs2))
    assert sched2.last_epoch == sched.last_epoch == 4
    _take_step(net, opt, sched)
    _take_step(net2, opt2, sched2)
    for key, val in net.state_dict().items():
        assert torch.equal(val, net2.state_dict()[key]), key

    # the phase-2 fresh start: weights only, iteration restarts
    net3, opt3, sched3 = _model_and_opt(seed=2)
    assert Checkpointer(str(tmp_path)).resume_or_load(
        None, net3, opt3, sched3, resume=True, load_optimizer=False) == -1
    assert not opt3.state
    for key, val in torch.load(tmp_path / "model_0000003.pth",
                               weights_only=True)["model"].items():
        assert torch.equal(val, net3.state_dict()[key]), key


def test_checkpointer_skips_mismatched_shapes_and_prefixes_basenet(
        tmp_path, caplog):
    src, _, _ = _model_and_opt("transfer")            # 60 source classes
    path = Checkpointer(str(tmp_path)).save("model_final", src)
    dst, _, _ = _model_and_opt("incre", seed=3)       # 15 source classes
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        assert Checkpointer(str(tmp_path / "x")).resume_or_load(
            path, dst) == -1
    skipped = [k for k, v in src.state_dict().items()
               if k in before and v.shape != before[k].shape]
    assert skipped and all(f"Skip loading {k}:" in caplog.text
                           for k in skipped)
    for key, val in dst.state_dict().items():
        want = before[key] if key in skipped or key not in src.state_dict() \
            else src.state_dict()[key]
        assert torch.equal(val, want), key

    # the VGG basenet: a bare trunk state_dict
    trunk = {k[len("base."):]: v for k, v in src.state_dict().items()
             if k.startswith("base.")}
    torch.save(trunk, tmp_path / "vgg.pth")
    Checkpointer(str(tmp_path / "y")).resume_or_load(
        str(tmp_path / "vgg.pth"), dst)
    assert torch.equal(dst.base[0].weight, src.base[0].weight)


# each flag the port refuses, with the reason its message names
REFUSED = {"--pallas-ct": "the port always runs its CT kernels"}


@pytest.mark.parametrize("flag", [["--pallas-ct", "on"]])
def test_cli_refuses_what_is_not_ported(flag, tmp_path):
    with pytest.raises(SystemExit, match=f"ROADMAP: .*{REFUSED[flag[0]]}"):
        cli.main(flag + ["--save-folder", str(tmp_path), "--device", "cpu"])


def test_events_match_jax(caplog, tmp_path):
    from ct_tpu.train import events as J
    from ct_tpu_torch.train import events as T

    rng = np.random.RandomState(0)
    stores = (J.EventStorage(3), T.EventStorage(3))
    for it in range(3, 40):
        vals = {"loss_cls": rng.rand(), "total_loss": 3 * rng.rand()}
        for st in stores:
            st.step()
            st.put_scalars(iteration=it, **vals)
            st.put_scalar("lr", 1e-3 * it, smoothing_hint=False,
                          iteration=it)
            if it % 3:
                st.put_scalar("time", 0.1 * (it % 7))
    ref, ours = stores
    assert ours.iter == ref.iter == 40
    assert ours.smoothed() == ref.smoothed()
    for name, h in ref.histories().items():
        g = ours.histories()[name]
        assert g.values() == h.values()
        assert (g.median(), g.avg(), g.latest()) == (h.median(), h.avg(),
                                                     h.latest())
        assert g.median(5) == h.median(5)
    rows = []
    for mod, st, name in ((J, ref, "j.json"), (T, ours, "t.json")):
        w = mod.JSONWriter(str(tmp_path / name))
        w.write(st)
        w.close()
        rows.append((tmp_path / name).read_text())
    assert rows[0] == rows[1] and json.loads(rows[1])["iteration"] == 40
    with caplog.at_level(logging.INFO):
        J.CommonMetricPrinter(100).write(ref)
        T.CommonMetricPrinter(100).write(ours)
    lines = [r.getMessage() for r in caplog.records
             if r.name.endswith("events")]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert "loss_cls" in lines[1] and "max_mem" not in lines[1]


def test_step_timer_matches_jax(monkeypatch):
    import time

    from ct_tpu.utils.profiler import StepTimer as JStepTimer
    from ct_tpu_torch.utils.profiler import StepTimer

    clock = [0.0, 0.5, 0.7, 1.6, 1.8, 2.9, 3.0]
    ticks = []
    for timer in (JStepTimer(), StepTimer()):
        it = iter(clock)
        with monkeypatch.context() as m:
            m.setattr(time, "perf_counter", lambda: next(it))
            ticks.append(([timer.tick() for _ in clock], timer.mean,
                          timer.count))
    assert ticks[0] == ticks[1] and ticks[1][2] == 4


def test_write_points_are_train_py_s():
    assert [i for i in range(26) if cli.is_write_point(i, 0, 26)] == [20, 25]
    assert [i for i in range(3) if cli.is_write_point(i, 0, 3)] == []
    assert [i for i in range(5, 50) if cli.is_write_point(i, 5, 50)] == [
        20, 40, 49]


# (train flags, eval flags, APs scored): phase 2 incre from the trained
# phase-2 model, with the host or the device augmentation; phase 2
# transfer from it too (its 15-class conf heads are skipped for the
# 60-class model); phase 1 from scratch (no basenet here)
INCRE = ["-p", "2", "--setting", "incre", "--split", "1", "--shot", "1",
         "--mixup", "--init-iter", "2", "--load-file", REF_MODEL]
CLI_CASES = {
    "incre": (INCRE, ["-p", "2", "--setting", "incre", "--split", "1"], 20),
    "incre_device_augment": (INCRE + ["--device-augment", "--canvas", "320"],
                             ["-p", "2", "--setting", "incre", "--split",
                              "1"], 20),
    "transfer": (["-p", "2", "--setting", "transfer", "--shot", "5",
                  "--init-iter", "1", "--load-file", REF_MODEL],
                 ["-p", "2", "--setting", "transfer"], 20),
    "phase1": (["-p", "1", "--setting", "transfer", "--basenet",
                "no_such_basenet.pth"], ["-p", "1", "--setting",
                                         "transfer"], 15),
}


@pytest.fixture
def two_threads():
    """The full-width CPU runs below take two intra-op threads: the suite
    runs several test processes side by side, and more threads per process
    than that oversubscribe the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_trains_three_steps_and_the_eval_cli_scores_them(
        case, devkit, devkit_0712, tmp_path, monkeypatch, two_threads):
    from ct_tpu_torch import test as test_cli

    train_flags, eval_flags, n_aps = CLI_CASES[case]
    assert cli.parse_args([]).device == "cuda"
    monkeypatch.setenv("VOC_ROOT", devkit if case.startswith("incre")
                       else devkit_0712)
    save = str(tmp_path / "w")
    row = cli.main(["-d", "VOC", "--max-iter", "3", "-b", "2",
                    "--num-workers", "2", "--checkpoint-period", "2",
                    "--save-folder", save, "--device", "cpu"] + train_flags)
    assert row["iteration"] == 2
    assert set(row) == {"iteration", "loss_box_reg", "loss_cls", "loss_obj",
                        "total_loss", "lr"}
    assert all(np.isfinite(v) for v in row.values())
    assert set(os.listdir(save)) >= {"last_checkpoint", "model_0000001.pth",
                                     "model_final.pth", "metrics.json",
                                     "log.txt"}
    # train.py's first write point comes after 5 iterations
    with open(os.path.join(save, "metrics.json")) as f:
        assert f.read() == ""

    res = test_cli.main(eval_flags + [
        "--load-file", os.path.join(save, "model_final.pth"),
        "--save-folder", save, "-b", "4", "--device", "cpu"])
    assert len(res["APs"]) == n_aps and np.isfinite(res["mAP"])
    if case.startswith("incre"):
        assert set(res) == {"mAP", "APs", "base_mAP", "novel_mAP"}


def test_cli_writes_train_py_metrics_and_a_trace(devkit, tmp_path,
                                                 monkeypatch, two_threads):
    """Twelve steps on the device route: one write point (the last
    iteration, which train.py labels 12, the iterations done), a trace of
    iterations 10 and 11 (the window closes with the run)."""
    from ct_tpu_torch.tools import trace_summary

    monkeypatch.setenv("VOC_ROOT", devkit)
    save, prof = str(tmp_path / "w"), str(tmp_path / "prof")
    row = cli.main(INCRE + [
        "-d", "VOC", "--max-iter", "12", "-b", "2", "--num-workers", "2",
        "--checkpoint-period", "100", "--device-augment",
        "--no-mixup-iter", "4", "--profile-dir", prof,
        "--save-folder", save, "--device", "cpu"])
    assert row["iteration"] == 11
    with open(os.path.join(save, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [12]
    assert set(rows[0]) == {"iteration", "data_time", "time", "loss_box_reg",
                            "loss_cls", "loss_obj", "total_loss", "lr"}
    assert all(np.isfinite(v) for v in rows[0].values())
    assert rows[0]["lr"] == row["lr"]
    with open(os.path.join(save, "log.txt")) as f:
        printed = [line for line in f if "ct_tpu_torch.train.events" in line]
    assert len(printed) == 1 and "iter: 12" in printed[0]
    assert "total_loss" in printed[0] and "time: " in printed[0]
    summary = trace_summary.summarize(prof)
    assert summary["window_ms"] > 0 and summary["device_busy_share"] == 0


def test_trace_summary_counts_overlapping_kernels_once(tmp_path):
    from ct_tpu_torch.tools import trace_summary

    events = [{"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0,
               "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 30},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 30},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70,
               "dur": 10},
              {"ph": "i", "cat": "kernel", "name": "mark", "ts": 90}]
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    res = trace_summary.summarize(str(tmp_path))
    assert res["window_ms"] == 0.1 and res["device_busy_ms"] == 0.05
    assert res["device_busy_share"] == 0.5
    assert res["by_category"]["kernel"] == {"ms": 0.06, "count": 2}


def test_profiler_trace_and_annotate(tmp_path):
    from ct_tpu_torch.utils.profiler import annotate, trace

    with trace(str(tmp_path)):
        with annotate("labelled_span"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "labelled_span" in names


def test_diff_detections_matches_jax(capsys):
    from ct_tpu.tools.diff_detections import diff as jdiff
    from ct_tpu_torch.tools import diff_detections

    a = os.path.join(REPO, ".parity_p2", "ours_eval", "inference",
                     "detections.pkl")
    b = os.path.join(REPO, ".parity_p2", "ours_eval_int8", "inference",
                     "detections.pkl")
    for kw in ({}, {"iou_thr": 0.9, "score_floor": 0.3}):
        ref = jdiff(a, b, **kw)
        ours = diff_detections.diff(a, b, **kw)
        assert ours == ref and 0 < ref["matched"] < ref["detections_a"]
    assert diff_detections.main([a, a]) == dict(
        jdiff(a, a), match_rate=1.0)
    assert "match_rate: 1.0" in capsys.readouterr().out
