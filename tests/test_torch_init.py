"""The port's fresh-weight initialisation vs the JAX package's.

``models/init.py`` (``init_like_jax``) against JAX's ``init_train_state``
at 300 for the three trained tasks (phase-1 COCO-60, phase-2 transfer,
phase-2 incre), JAX's variables mapped into the reference key space by
``from_jax_variables``:

* every tensor that JAX initialises to zero is zero in the port, and
  BatchNorm (scale, bias, running statistics) and the buffers are equal;
* each tensor of at least 4,096 entries has its standard deviation within
  5% of JAX's (two draws of one distribution: ~1.6% of sampling error at
  4,096 entries), and no kernel entry lies beyond flax's truncation bound
  of two standard deviations of the untruncated normal;
* the train CLI, phase 2 from ``.parity_p2/phase1.pth`` at learning rate
  0, writes a ``model_final.pth`` whose θ/φ/g kernels have the
  ``he_normal`` spread and bound, whose biases and ``fc_base`` are zero,
  and whose every tensor ``phase1.pth`` holds is ``phase1.pth``'s.
"""

import math
import os

import jax
import pytest
import torch

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.train.step import init_train_state
from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models import init as port_init
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.tools.voc_fixture import make_mini_voc
from ct_tpu_torch.train import cli
from ct_tpu_torch.train.checkpointer import _read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE1 = os.path.join(REPO, ".parity_p2", "phase1.pth")
TASKS = {"phase1_coco60": (1, "transfer", "ours", "COCO"),
         "phase2_transfer": (2, "transfer", "ours", "VOC"),
         "phase2_incre": (2, "incre", "ours", "VOC")}
STD_RTOL = 0.05
STD_MIN_ENTRIES = 4096
CT_KERNELS = ("theta.weight", "phi.weight", "g.weight")


def _bound(name: str, t: torch.Tensor, model) -> float:
    """Flax's truncation bound of kernel ``name``: 2·sqrt(scale/fan_in)
    / 0.8796…, scale 2 (he_normal) or 1 (lecun_normal)."""
    rule = port_init.initializers(model)[name]
    scale = 2.0 if rule is port_init.he_normal else 1.0
    return 2 * port_init.variance_scaling_std(scale, port_init.fan_in(t))


@pytest.fixture(scope="module")
def inits():
    """{task: (JAX's init in the key space, the port's init, the port's
    model)} at 300, JAX from PRNGKey(0), the port from seed 0."""
    out = {}
    for key, spec in TASKS.items():
        state = init_train_state(j_build_net(j_resolve_task(*spec), 300),
                                 None, jax.random.PRNGKey(0), 300)
        ref = from_jax_variables({"params": jax.device_get(state.params),
                                  "batch_stats":
                                  jax.device_get(state.batch_stats)})
        model = build_net(resolve_task(*spec), 300, device="cpu")
        port_init.init_like_jax(model, torch.Generator().manual_seed(0))
        out[key] = (ref, model.state_dict(), model)
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_init_like_jax_matches_jax_init_train_state(inits, task):
    ref, ours, model = inits[task]
    assert set(ours) == set(ref)
    params = dict(model.named_parameters())
    checked = 0
    for name, want in ref.items():
        got = ours[name]
        assert got.shape == want.shape, name
        if name.endswith("num_batches_tracked"):
            continue
        if (".bn." in name or name not in params
                or not torch.count_nonzero(want)):
            # zeros (biases, Wz, fc_base), BN scale 1 / bias 0, the
            # buffers (running statistics 0 / 1, the CT scale 5): equal,
            # not just alike
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       msg=name)
            continue
        if name.endswith("weight") and name != "OBJ_Target.weight":
            assert float(got.abs().max()) <= _bound(name, got, model), name
        if got.numel() >= STD_MIN_ENTRIES:
            ratio = float(got.std() / want.std())
            assert abs(ratio - 1) <= STD_RTOL, (name, ratio)
            checked += 1
    # the trunk's and the heads' conv kernels: 83 to 85 of them a task
    assert checked >= 80


def test_init_like_jax_draws_from_its_seeded_cpu_generator():
    task = resolve_task(2, "transfer", "ours", "VOC")
    a, b, c = (port_init.init_like_jax(build_net(task, 64, device="cpu"),
                                       torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["base.0.weight"], sc["base.0.weight"])
    # a draw is a CPU tensor from the CPU generator, copied to the
    # parameter's device: a card's model gets the CPU model's values
    rule = port_init.initializers(a)["theta.weight"]
    assert rule(a.theta.weight, torch.Generator().manual_seed(0)).is_cpu


def test_initializers_refuse_an_unknown_parameter():
    task = resolve_task(1, "transfer", "ours", "VOC")
    model = build_net(task, 64, device="cpu")
    model.extra = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        port_init.initializers(model)


@pytest.fixture
def two_threads():
    """The full-width CPU run takes two intra-op threads: the suite runs
    several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_cli_starts_phase2_from_jax_initialisers(tmp_path,
                                                       monkeypatch,
                                                       two_threads):
    root = str(tmp_path / "voc")
    make_mini_voc(root, year="2007", num_images=6)
    monkeypatch.setenv("VOC_ROOT", os.path.join(root, "VOCdevkit"))
    save = str(tmp_path / "out")
    cli.main(["-p", "2", "--setting", "incre", "--split", "1", "--shot",
              "1", "--init-iter", "1", "--max-iter", "1", "-b", "2",
              "--lr", "0", "--num-workers", "1", "--load-file", PHASE1,
              "--save-folder", save, "--device", "cpu"])
    final = _read(os.path.join(save, "model_final.pth"))["model"]
    phase1 = _read(PHASE1)["model"]
    model = build_net(resolve_task(2, "incre", "ours", "VOC"), 300,
                      device="cpu")
    for name, val in phase1.items():
        if name in final and final[name].shape == val.shape \
                and not name.endswith(("running_mean", "running_var",
                                       "num_batches_tracked")):
            # lr 0: loaded and left as loaded (BN statistics move in the
            # train-mode forwards)
            torch.testing.assert_close(final[name], val, rtol=0, atol=0,
                                       msg=name)
    for name in ("theta.bias", "phi.bias", "g.bias", "fc_base.weight",
                 "fc_base.bias", "Wz"):
        assert not torch.count_nonzero(final[name]), name
    kernels = torch.cat([final[n].flatten() for n in CT_KERNELS])
    c = final["theta.weight"].shape[1]
    std = port_init.variance_scaling_std(2.0, c)
    assert float(kernels.abs().max()) <= 2 * std
    # he_normal's spread: the truncated normal's std is sqrt(2/fan_in)
    # (3 × 225 entries: ~2.7% of sampling error)
    assert abs(float(kernels.std()) / math.sqrt(2.0 / c) - 1) < 0.1
    assert all(_bound(n, final[n], model) == 2 * std for n in CT_KERNELS)
