"""Asynchronous checkpoints (``--orbax``) and the CLIs' data parallelism
on the CPU.

``train/async_ckpt.py`` is the port of ``ct_tpu/train/orbax_ckpt.py``:

* a save is a snapshot: the model is changed after ``save`` (while the
  write is held back), then ``wait``, and the file holds the state as it
  was at ``save``;
* the step directory ``<iteration + 1>``, the ``last_checkpoint`` tag, the
  eval CLI's reading of it (``checkpoint_file``), and ``resume`` of the
  model, optimizer and schedule; an empty folder resumes nothing;
* at most one save in flight, a failed write raised by ``wait``, and no
  write on a rank other than 0;
* the train CLI's dispatch (``load_or_resume``): phase 1 with
  ``--resume`` resumes from the newest asynchronous checkpoint, phase 2
  loads ``--load-file`` as ``train.py`` does.

The CLIs at 300 on the CPU, over two gloo ranks spawned by ``--ndev 2``
(batch 4: two images a rank, as BatchNorm over the 1×1 extras map needs
two in train mode): phase 1 with ``--orbax`` for 2 iterations, then
``--resume`` continues from the asynchronous checkpoint for a third; rank
0 writes the checkpoints, ``metrics.json`` and ``log.txt``, rank 1 its
``log.txt.rank1``. The eval CLI with ``--ndev 2`` (``--resume`` on the
``orbax`` folder) gives the detections of ``--ndev 1`` (``--load-file`` on the
step's file) bit for bit: each forward takes the same two images.
``--ndev 2 -b 3`` exits with ``test.py``'s message.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.train import async_ckpt, cli
from ct_tpu_torch.train.async_ckpt import (
    CHECKPOINT_FILE, AsyncCheckpointer, checkpoint_file,
)
from ct_tpu_torch.train.checkpointer import Checkpointer
from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
from fixtures import make_mini_voc_all


def small_state(seed=0):
    torch.manual_seed(seed)
    task = resolve_task(2, "incre", "ours", "VOC")
    net = build_net(task, 64, device="cpu").train()
    opt, sched = build_optimizer(net, task, SolverConfig(warmup_iters=2))
    net(torch.ones(2, 3, 64, 64)).loc.sum().backward()
    opt.step()
    sched.step()
    return net, opt, sched


@pytest.fixture
def held_save(monkeypatch):
    """torch.save held until ``release`` is set; records concurrency."""
    release, state = threading.Event(), {"now": 0, "most": 0, "calls": 0}
    real = torch.save

    def slow(obj, path):
        state["now"] += 1
        state["calls"] += 1
        state["most"] = max(state["most"], state["now"])
        release.wait(timeout=60)
        real(obj, path)
        state["now"] -= 1

    monkeypatch.setattr(torch, "save", slow)
    return release, state


def test_save_is_a_snapshot(tmp_path, held_save):
    release, _ = held_save
    net, opt, sched = small_state()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    momentum = {k: v["momentum_buffer"].clone()
                for k, v in opt.state_dict()["state"].items()}
    ck = AsyncCheckpointer(str(tmp_path / "orbax"))
    path = ck.save("model_0000004", net, opt, sched, iteration=4)
    assert path == str(tmp_path / "orbax" / "5") and ck.in_flight()
    with torch.no_grad():                     # training goes on in place
        for p in net.parameters():
            p.add_(1.0)
    opt.step()
    release.set()
    ck.wait()
    assert not ck.in_flight()
    saved = torch.load(os.path.join(path, CHECKPOINT_FILE),
                       weights_only=True)
    assert saved["iteration"] == 4
    for key, val in before.items():
        assert torch.equal(saved["model"][key], val), key
    for key, val in momentum.items():
        assert torch.equal(saved["optimizer"]["state"][key][
            "momentum_buffer"], val)
    assert not torch.equal(saved["model"]["loc.0.weight"],
                           net.state_dict()["loc.0.weight"])


def test_tag_resume_and_the_eval_path(tmp_path):
    net, opt, sched = small_state()
    ck = AsyncCheckpointer(str(tmp_path))
    assert not ck.has_checkpoint() and ck.latest_step() is None
    assert ck.resume(*small_state(1)) == -1
    ck.save("model_0000001", net, opt, sched, iteration=1)
    ck.save("model_0000009", net, opt, sched, iteration=9)
    ck.close()
    assert (tmp_path / "last_checkpoint").read_text() == "10"
    assert sorted(os.listdir(tmp_path)) == ["10", "2", "last_checkpoint"]
    assert ck.latest_step() == 10
    # the eval CLI's --resume: the tag names the step directory
    step_dir = Checkpointer(str(tmp_path)).get_checkpoint_file()
    assert checkpoint_file(step_dir) == str(tmp_path / "10" /
                                            CHECKPOINT_FILE)
    assert checkpoint_file(str(tmp_path / "x.pth")) == str(
        tmp_path / "x.pth")

    other, opt2, sched2 = small_state(seed=3)
    assert AsyncCheckpointer(str(tmp_path)).resume(other, opt2, sched2) == 9
    for key, val in net.state_dict().items():
        assert torch.equal(other.state_dict()[key], val), key
    assert sched2.last_epoch == sched.last_epoch
    a, b = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert all(torch.equal(a[k]["momentum_buffer"], b[k]["momentum_buffer"])
               for k in a)


def test_one_save_in_flight_and_errors(tmp_path, held_save, monkeypatch):
    release, state = held_save
    net, opt, sched = small_state()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save("a", net, opt, sched, iteration=0)
    second = threading.Thread(target=ck.save,
                              args=("b", net, opt, sched, 1))
    second.start()
    second.join(timeout=0.5)
    assert second.is_alive()            # waits for the first write
    release.set()
    second.join(timeout=60)
    ck.wait()
    assert state["most"] == 1 and state["calls"] == 2
    assert ck.latest_step() == 2

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ck.save("c", net, iteration=5)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint") as e:
        ck.wait()
    assert isinstance(e.value.__cause__, OSError)
    assert ck.latest_step() == 2

    monkeypatch.setattr(async_ckpt, "_rank", lambda: 1)
    ck.save("d", net, iteration=7)
    assert not ck.in_flight() and ck.latest_step() == 2


def test_orbax_resumes_in_phase_1_only(tmp_path):
    net, opt, sched = small_state()
    async_ck = AsyncCheckpointer(str(tmp_path / "orbax"))
    async_ck.save("model_0000005", net, opt, sched, iteration=5)
    async_ck.wait()
    weights = Checkpointer(str(tmp_path / "w")).save("model_final",
                                                     small_state(4)[0])
    ck = Checkpointer(str(tmp_path))
    args = cli.parse_args(["--orbax", "--resume", "-p", "1", "--basenet",
                           "none.pth", "--load-file", weights])
    fresh = small_state(seed=6)
    assert cli.load_or_resume(args, ck, async_ck, *fresh) == 5
    assert torch.equal(fresh[0].OBJ_Target.weight, net.OBJ_Target.weight)
    args.phase = 2
    fresh = small_state(seed=6)
    assert cli.load_or_resume(args, ck, async_ck, *fresh) == -1
    assert torch.equal(fresh[0].OBJ_Target.weight,
                       small_state(4)[0].OBJ_Target.weight)
    args.phase, args.resume = 1, False
    assert cli.load_or_resume(args, ck, async_ck, *small_state(6)) == -1


@pytest.fixture(scope="module")
def devkit_0712(tmp_path_factory):
    return make_mini_voc_all(str(tmp_path_factory.mktemp("voc0712")))


PHASE1 = ["-d", "VOC", "-p", "1", "--setting", "transfer", "--basenet",
          "no_such_basenet.pth", "-b", "4", "--num-workers", "1",
          "--checkpoint-period", "1", "--device", "cpu", "--ndev", "2"]


def test_two_rank_clis_with_async_checkpoints(devkit_0712, tmp_path,
                                              monkeypatch):
    from ct_tpu_torch import test as test_cli

    monkeypatch.setenv("VOC_ROOT", devkit_0712)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")   # each rank's torch threads
    save = str(tmp_path / "w")
    row = cli.main(PHASE1 + ["--max-iter", "2", "--orbax",
                             "--save-folder", save])
    assert row["iteration"] == 1 and np.isfinite(row["total_loss"])
    orbax = os.path.join(save, "orbax")
    assert sorted(os.listdir(orbax)) == ["1", "2", "last_checkpoint"]
    assert {"log.txt", "log.txt.rank1", "metrics.json"} <= set(
        os.listdir(save))
    assert not any(name.endswith(".pth") for name in os.listdir(save))
    with open(os.path.join(save, "log.txt.rank1")) as f:
        assert "Mesh: 2 rank(s) (gloo), this one 1" in f.read()

    row = cli.main(PHASE1 + ["--max-iter", "3", "--orbax", "--resume",
                             "--save-folder", save])
    assert row["iteration"] == 2
    assert sorted(os.listdir(orbax)) == ["1", "2", "3", "last_checkpoint"]
    with open(os.path.join(save, "log.txt")) as f:
        log = f.read()
    assert "Starting training from iteration 2" in log

    eval_flags = ["-p", "1", "--setting", "transfer", "--device", "cpu"]
    one = str(tmp_path / "one")
    res1 = test_cli.main(eval_flags + [
        "--load-file", os.path.join(orbax, "3", CHECKPOINT_FILE), "-b", "2",
        "--save-folder", one])
    res2 = test_cli.main(eval_flags + ["--ndev", "2", "-b", "4", "--resume",
                                       "--save-folder", orbax])
    assert res2 == res1 and np.isfinite(res1["mAP"])
    dets = []
    for folder in (one, orbax):
        with open(os.path.join(folder, "inference", "detections.pkl"),
                  "rb") as f:
            dets.append(pickle.load(f))
    assert sum(len(d) for cls in dets[0] for d in cls) > 0
    for cls_a, cls_b in zip(*dets):
        for a, b in zip(cls_a, cls_b):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="must be divisible by --ndev 2"):
        test_cli.main(eval_flags + ["--ndev", "2", "-b", "3"])
