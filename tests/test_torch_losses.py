"""The port's matching, multibox loss and solver vs the JAX package's.

Same seeded numpy targets and predictions into ``match_batch`` /
``multibox_loss_sums`` of both packages, at the full 300 prior set, with
ignore labels and mixup weights as tests/test_matching_loss.py varies
them, and with tie-heavy objectness logits (hard-negative mining breaks
ties by anchor index in both). Labels, weights and objectness targets are
equal; box targets agree to rtol 1e-5 (``log`` in XLA and in PyTorch);
the loss sums to rtol 1e-5 and N exactly. The schedule agrees with
``warmup_multistep_schedule`` to rtol 1e-6, and three SGD updates with the
phase-2 ``ours`` multipliers with ``build_optimizer``'s to rtol 1e-5 /
atol 1e-6 (the band of tests/test_train_stack.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data.targets import pad_targets as j_pad_targets
from ct_tpu.ops.losses import multibox_loss_sums as j_loss_sums
from ct_tpu.ops.matching import match_batch as j_match_batch
from ct_tpu.train.solver import SolverConfig as JSolverConfig
from ct_tpu.train.solver import build_optimizer as j_build_optimizer
from ct_tpu.train.solver import (
    warmup_multistep_schedule as j_warmup_multistep_schedule,
)
from ct_tpu_torch.config import VOC_300, resolve_task
from ct_tpu_torch.data.targets import pad_targets
from ct_tpu_torch.ops.losses import multibox_loss_sums
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.train.solver import (
    SolverConfig, build_optimizer, lr_multiplier, warmup_multistep_schedule,
)


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX at full float32 precision in its products: the comparison is of
    the algorithms in float32, and a DEFAULT-precision product on the CPU
    backend is not guaranteed to be a full float32 one."""
    with jax.default_matmul_precision("highest"):
        yield


def make_annos(rng, batch, max_n=8, ignore_frac=0.0, mixup=False, ncls=15):
    """Random [N_i, 6] percent-coordinate annotations."""
    annos = []
    for _ in range(batch):
        n = rng.randint(1, max_n + 1)
        mins = rng.uniform(0, 0.7, size=(n, 2))
        sizes = rng.uniform(0.05, 0.3, size=(n, 2))
        boxes = np.concatenate([mins, np.minimum(mins + sizes, 1.0)], axis=1)
        labels = rng.randint(1, ncls + 1, size=(n, 1)).astype(np.float64)
        if ignore_frac > 0 and n > 1:
            labels[-max(1, int(n * ignore_frac)):] = -1
        w = rng.uniform(0.2, 1.0, (n, 1)) if mixup else np.ones((n, 1))
        annos.append(np.concatenate([boxes, labels, w], 1).astype(np.float32))
    return annos


def both_matches(annos, max_objs=16):
    priors = prior_boxes(VOC_300)
    pt = pad_targets(annos, max_objs)
    jpt = j_pad_targets(annos, max_objs)
    for a, b in zip(pt, jpt):
        np.testing.assert_array_equal(a, b)
    ours = match_batch(*map(torch.from_numpy, pt), priors)
    ref = j_match_batch(*map(jnp.asarray, jpt), jnp.asarray(priors.numpy()))
    return ours, ref


CASES = [(0.0, False), (0.3, False), (0.0, True), (0.3, True)]


@pytest.mark.parametrize("ignore_frac,mixup", CASES)
def test_match_batch_matches_jax(ignore_frac, mixup):
    rng = np.random.RandomState(7)
    ours, ref = both_matches(make_annos(rng, 4, ignore_frac=ignore_frac,
                                        mixup=mixup))
    np.testing.assert_array_equal(ours.cls_t.numpy(), np.asarray(ref.cls_t))
    np.testing.assert_array_equal(ours.w_t.numpy(), np.asarray(ref.w_t))
    np.testing.assert_array_equal(ours.obj_t.numpy(), np.asarray(ref.obj_t))
    np.testing.assert_allclose(ours.loc_t.numpy(), np.asarray(ref.loc_t),
                               rtol=1e-5, atol=1e-5)
    assert (ours.cls_t > 0).sum() > 0
    if ignore_frac:
        assert (ours.cls_t == -1).sum() > 0


@pytest.mark.parametrize("ignore_frac,mixup", CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_loss_sums_match_jax(ignore_frac, mixup, ties):
    rng = np.random.RandomState(11)
    batch, ncls = 3, 15
    ours_m, ref_m = both_matches(make_annos(rng, batch,
                                            ignore_frac=ignore_frac,
                                            mixup=mixup, ncls=ncls))
    p = ours_m.cls_t.shape[1]
    loc = rng.randn(batch, p, 4).astype(np.float32) * 0.5
    conf = rng.randn(batch, p, ncls).astype(np.float32)
    obj = rng.randn(batch, p, 2).astype(np.float32)
    if ties:   # few distinct objectness logits: many exactly tied negatives
        obj = np.round(obj * 2) / 2
    sums, n = multibox_loss_sums(*map(torch.from_numpy, (loc, conf, obj)),
                                 ours_m)
    jsums, jn = j_loss_sums(*map(jnp.asarray, (loc, conf, obj)), ref_m)
    assert float(n) == float(jn) > 0
    for key in ("loss_box_reg", "loss_cls", "loss_obj"):
        np.testing.assert_allclose(float(sums[key]), float(jsums[key]),
                                   rtol=1e-5, err_msg=key)


def test_loss_without_positives_is_finite():
    ours, _ = both_matches([np.zeros((0, 6), np.float32)], max_objs=4)
    p = ours.cls_t.shape[1]
    rng = np.random.default_rng(3)
    sums, n = multibox_loss_sums(
        torch.from_numpy(rng.standard_normal((1, p, 4), np.float32)),
        torch.from_numpy(rng.standard_normal((1, p, 15), np.float32)),
        torch.from_numpy(rng.standard_normal((1, p, 2), np.float32)), ours)
    assert float(n) == 0
    assert all(np.isfinite(float(v)) for v in sums.values())


def test_schedule_matches_jax():
    cfg = SolverConfig(lr=4e-3, steps=(60, 120), warmup_iters=30)
    jcfg = JSolverConfig(lr=4e-3, steps=(60, 120), warmup_iters=30)
    ours, ref = warmup_multistep_schedule(cfg), j_warmup_multistep_schedule(
        jcfg)
    its = list(range(0, 35)) + [59, 60, 61, 119, 120, 121, 500]
    np.testing.assert_allclose([ours(i) for i in its],
                               [float(ref(i)) for i in its], rtol=1e-6)


class _Tiny(torch.nn.Module):
    """One parameter in each learning-rate group of phase-2 ``ours``."""

    def __init__(self, arrays):
        super().__init__()
        self.base = torch.nn.ParameterList([torch.nn.Parameter(
            torch.from_numpy(arrays["vgg_0"].copy()))])
        self.extras = torch.nn.ParameterList([torch.nn.Parameter(
            torch.from_numpy(arrays["extras_0"].copy()))])
        self.Norm = torch.nn.Parameter(torch.from_numpy(
            arrays["Norm"].copy()))
        self.loc = torch.nn.Parameter(torch.from_numpy(
            arrays["loc_0"].copy()))


def test_three_sgd_steps_match_jax():
    task = resolve_task(2, "incre", "ours", "VOC")
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    rng = np.random.RandomState(0)
    names = ("vgg_0", "extras_0", "Norm", "loc_0")
    w0 = {k: rng.randn(4, 3).astype(np.float32) for k in names}
    grads = [{k: rng.randn(4, 3).astype(np.float32) for k in names}
             for _ in range(3)]
    # warmup over 2 updates and a milestone at 2: the rate changes each step
    kw = dict(lr=0.01, steps=(2,), warmup_iters=2)

    params = {k: {"kernel": jnp.asarray(v)} for k, v in w0.items()}
    tx = j_build_optimizer(params, jtask, JSolverConfig(**kw))
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(
            {k: {"kernel": jnp.asarray(v)} for k, v in g.items()}, state,
            params)
        params = optax.apply_updates(params, updates)

    model = _Tiny(w0)
    assert {n: lr_multiplier(n, task) for n, _ in model.named_parameters()} \
        == {"base.0": 0.1, "extras.0": 0.5, "Norm": 0.5, "loc": 1.0}
    opt, sched = build_optimizer(model, task, SolverConfig(**kw))
    tensors = dict(zip(names, (model.base[0], model.extras[0], model.Norm,
                               model.loc)))
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[k]["kernel"]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
