"""The benchmark's plain reference held against ``ct_tpu_torch`` on the
CPU at small sizes: widths, forward, BN folding, the int8 serving path,
post-processing and the training step."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness.weights import draw  # noqa: E402
from benchmark.reference import post  # noqa: E402
from benchmark.reference.model import (  # noqa: E402
    Model, Numerics, Task, calibrate, fold_bn, param_shapes,
)
from benchmark.reference.train import Trainer  # noqa: E402
from ct_tpu_torch.config import TINY_64, get_config, resolve_task  # noqa: E402
from ct_tpu_torch.models.rfbnet import build_net  # noqa: E402
from ct_tpu_torch.ops.priors import prior_boxes  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tasks(setting):
    t = resolve_task(2, setting, "ours", "VOC")
    return t, Task(setting, t.src_cls_dim, t.num_classes)


def seeded(setting, size=64, seed=5, gain=1.0):
    state = draw(tasks(setting)[1], size, seed, "cpu")
    for k in state:
        if k.split(".")[0] in ("conf", "obj") and k.endswith("weight"):
            state[k] = state[k] * gain
    return state


@pytest.mark.parametrize("setting", ["incre", "transfer"])
@pytest.mark.parametrize("size", [64, 300, 512])
def test_param_shapes_are_the_programs(setting, size):
    task, ref_task = tasks(setting)
    net = build_net(task, size, device="cpu")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert param_shapes(ref_task, size) == want


@pytest.mark.parametrize("setting", ["incre", "transfer"])
def test_forward_matches(setting):
    task, ref_task = tasks(setting)
    state = seeded(setting)
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(state)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)
                    ) * 50
    with torch.no_grad():
        p = net(x)
        r = Model(state, ref_task, 64).forward(x)
    for a, b in zip((p.loc, p.conf, p.obj), r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_forward_matches_trained_300():
    from benchmark.harness.weights import load_checkpoint
    task, ref_task = tasks("incre")
    state = load_checkpoint(str(REPO / ".parity_p2" / "ref_model.pth"))
    net = build_net(task, 300, device="cpu")
    net.load_state_dict(state)
    x = torch.randn(1, 3, 300, 300, generator=torch.Generator().manual_seed(
        2)) * 50
    with torch.no_grad():
        p = net(x)
        r = Model(state, ref_task, 300).forward(x)
    for a, b in zip((p.loc, p.conf, p.obj), r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [64, 300, 512])
def test_priors_match(size):
    cfg = TINY_64 if size == 64 else get_config("VOC", size)
    torch.testing.assert_close(post.priors(size), prior_boxes(cfg),
                               rtol=0, atol=0)


def test_fold_matches():
    from ct_tpu_torch.models.fold_bn import fold_state_dict
    state = seeded("incre")
    for k in state:
        if k.endswith("running_var"):
            state[k] = torch.rand(state[k].shape) + 0.5
        elif k.endswith("running_mean"):
            state[k] = torch.randn(state[k].shape)
    want = fold_state_dict(state)
    got = fold_bn(state)
    assert set(got) == {k for k in want}
    for k in want:
        torch.testing.assert_close(got[k], want[k].float(), rtol=0, atol=0)


def program_serving(state, calib, int8_heads=True):
    from ct_tpu_torch.test import serving_model
    task, _ = tasks("incre")
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(state)
    return serving_model(net, calib, int8_heads=int8_heads)[0]


@pytest.mark.parametrize("int8_heads", [True, False])
def test_int8_serving_matches(int8_heads):
    """The reference's exact integer sums and the program's int8 path, on
    the same calibration, agree to float32 rounding of the rescale."""
    state = seeded("incre", gain=4.0)
    _, ref_task = tasks("incre")
    gen = torch.Generator().manual_seed(3)
    calib = torch.randn(4, 3, 64, 64, generator=gen) * 50
    x = torch.randn(2, 3, 64, 64, generator=gen) * 50
    net = program_serving(state, calib, int8_heads)
    folded = fold_bn(state)
    absmax = calibrate(folded, ref_task, 64, [calib])
    model = Model(folded, ref_task, 64, folded=True, numerics=Numerics(
        "int", 8, absmax, quantize_heads=int8_heads))
    with torch.no_grad():
        p = net(x)
        r = model.forward(x)
    for a, b in zip((p.loc, p.conf, p.obj), r):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_postprocess_matches():
    """The reference's candidate pool, approximate top-k, NMS and cap give
    the program's detections on the same outputs."""
    from ct_tpu_torch.ops.detection import postprocess
    gen = torch.Generator().manual_seed(4)
    b, p, c = 2, 1280, 20
    loc = torch.randn(b, p, 4, generator=gen)
    conf = torch.softmax(torch.randn(b, p, c, generator=gen) * 4, -1)
    obj = torch.softmax(torch.randn(b, p, 2, generator=gen) * 3, -1)
    hw = torch.tensor([[300, 400], [250, 200]])
    pri = post.priors(64)
    for approx, pool in ((True, 512), (False, 0)):
        want = postprocess(loc, conf, obj, pri, image_sizes=hw, top_k=64,
                           approx_top_k=approx, pool_size=pool)
        got = post.detect(post.pixel_boxes(loc, pri, hw), post.fuse(conf, obj),
                          64, approx, pool)
        assert torch.equal(want.valid, got.valid)
        v = want.valid
        torch.testing.assert_close(want.scores[v], got.scores[v])
        torch.testing.assert_close(want.boxes[v], got.boxes[v])
        assert torch.equal(want.classes[v].long(), got.classes[v].long())


def test_train_steps_match():
    """Three reference steps against the program's train step, float32,
    batch 4 in two micro-batches: losses, gradients and parameters."""
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, make_train_step
    from benchmark.harness.data import Fixture, padded_targets, normalized

    task, ref_task = tasks("incre")
    state = seeded("incre")
    fx = Fixture(str(REPO / ".parity_p2" / "voc" / "VOCdevkit"), 1)
    imgs = fx.load(fx.ids("2007", "trainval")[:12], 64)
    t = padded_targets(imgs, 3)
    x = torch.from_numpy(normalized(imgs.pixels))
    batches = [{"image": x[i * 4:(i + 1) * 4],
                **{k: torch.from_numpy(v[i * 4:(i + 1) * 4])
                   for k, v in t.items()}} for i in range(3)]
    for bt in batches:
        bt["weights"] = bt["valid"].float()
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(state)
    net.train()
    opt, sched = build_optimizer(net, task, SolverConfig(
        lr=0.004, warmup_iters=0, steps=(10 ** 9,)))
    ts = TrainState(net, opt, sched)
    pri = prior_boxes(TINY_64)
    step = make_train_step(pri, accum_steps=2)
    trainer = Trainer(state, dict(task=ref_task, size=64), lr=0.004, accum=2)
    for bt in batches:
        want = float(step(ts, bt)["total_loss"])
        got, _ = trainer.loss_and_grads(bt, post.priors(64))
        trainer.update()
        assert abs(got - want) <= 1e-5 * abs(want)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(trainer.params[name].detach().numpy(),
                                   p.detach().numpy(), rtol=1e-4, atol=1e-6)
