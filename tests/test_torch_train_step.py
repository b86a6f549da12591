"""The port's train step and OBJ_Target init vs the JAX package's.

The size-64 phase-2 incre model starts in both packages from the same JAX
variables (randomised BN statistics and CT parameters, moved over with
``from_jax_variables``) and takes the same seeded batch (unit-scale
images: at image scale these untrained weights saturate the CT softmax).

* One ``make_train_step`` step (JAX: ``mesh=None``): the N-normalised
  loss terms to rtol 1e-5; every gradient (JAX: ``jax.grad`` of the same
  loss sums, divided by N) to rtol 1e-4 / atol max(1e-6, 1e-4·max|g|)
  (see GRAD_ATOL); the updated
  parameters, OBJ_Target rows renormalised, to rtol 1e-5 / atol 1e-6.
* ``init_reweight`` over two batches: the prototypes to 1e-4.

BatchNorm running statistics: the running means agree to rtol 1e-5. The
running variances differ by design: PyTorch's BatchNorm (the reference's)
folds the unbiased batch variance into its running variance, flax's the
biased one. Over k updates at momentum 0.01 both start from the same
value v0, so ``torch - 0.99^k·v0 = n/(n-1) · (jax - 0.99^k·v0)`` with n the
elements per channel of that layer; that identity is checked to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import TINY_64 as J_TINY_64
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data.targets import pad_targets as j_pad_targets
from ct_tpu.models import build_net as j_build_net
from ct_tpu.ops.losses import multibox_loss_sums as j_loss_sums
from ct_tpu.ops.matching import match_batch as j_match_batch
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu.train.reweight import init_reweight as j_init_reweight
from ct_tpu.train.solver import SolverConfig as JSolverConfig
from ct_tpu.train.solver import build_optimizer as j_build_optimizer
from ct_tpu.train.step import TrainState as JTrainState
from ct_tpu.train.step import make_train_step as j_make_train_step
from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.data.targets import pad_targets
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.train.reweight import init_reweight
from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
from ct_tpu_torch.train.step import (
    TrainState, batch_to, loss_and_grads, make_train_step,
)
from test_torch_model import random_jax_variables

SOLVER = dict(lr=0.01, steps=(100,), warmup_iters=0)
# a gradient is a sum over every anchor and pixel of the batch, with
# cancellation: its rounding error follows the size of the summands, not of
# the sum, so the absolute band is relative to the tensor's largest entry
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX at full float32 precision in its products: the comparison is of
    the algorithms in float32, and a DEFAULT-precision product on the CPU
    backend is not guaranteed to be a full float32 one."""
    with jax.default_matmul_precision("highest"):
        yield


def make_batch(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    annos = []
    for _ in range(b):
        n = rng.randint(1, 4)
        mins = rng.uniform(0, 0.6, (n, 2))
        boxes = np.concatenate([mins, mins + rng.uniform(0.2, 0.4, (n, 2))],
                               1).clip(0, 1)
        labels = rng.randint(1, 21, (n, 1)).astype(np.float32)
        labels[1:] = -1                     # incre: objects after the first
        annos.append(np.hstack([boxes, labels, np.ones((n, 1))]).astype(
            np.float32))
    padded = j_pad_targets(annos, 8)
    np.testing.assert_array_equal(padded.boxes, pad_targets(annos, 8).boxes)
    image = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    return {"image": image, "boxes": padded.boxes, "labels": padded.labels,
            "weights": padded.weights, "valid": padded.valid}


def bn_counts(net, x):
    """Elements per channel seen by each BatchNorm in a forward of x."""
    counts, hooks = {}, []
    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: counts.__setitem__(
                    name, i[0].numel() // i[0].shape[1])))
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return counts


def assert_running_stats(ours, ref, start, counts, updates):
    decay = 0.99 ** updates
    for key, val in ours.items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(val.numpy(), ref[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        elif key.endswith("running_var"):
            n = counts[key[:-len(".running_var")]]
            v0 = start[key].numpy()
            np.testing.assert_allclose(
                val.numpy() - decay * v0,
                n / (n - 1) * (ref[key].numpy() - decay * v0),
                rtol=1e-4, atol=1e-7, err_msg=key)


@pytest.fixture(scope="module")
def setup():
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    task = resolve_task(2, "incre", "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=5)
    return jtask, task, variables


def port_model(task, variables):
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(from_jax_variables(variables))
    return net.train()


def test_train_step_matches_jax(setup):
    jtask, task, variables = setup
    batch = make_batch(0)
    jnet = j_build_net(jtask, 64)
    jpriors = j_prior_boxes(J_TINY_64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def sums_fn(params):
        preds, _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch["image"], train=True, mutable=["batch_stats"])
        matched = j_match_batch(jbatch["boxes"], jbatch["labels"],
                                jbatch["weights"], jbatch["valid"], jpriors)
        sums, n = j_loss_sums(preds.loc, preds.conf, preds.obj, matched)
        return sum(sums.values()), n

    (_, jn), jgrads = jax.jit(jax.value_and_grad(sums_fn, has_aux=True))(
        variables["params"])
    jgrads = jax.tree_util.tree_map(
        lambda g: np.asarray(g) / max(float(jn), 1.0), jgrads)

    tx = j_build_optimizer(variables["params"], jtask,
                           JSolverConfig(**SOLVER))
    jstate = JTrainState(variables["params"], variables["batch_stats"],
                         tx.init(variables["params"]),
                         jnp.asarray(0, jnp.int32))
    jstep = j_make_train_step(jnet, jpriors, jtask, tx, 0.5, mesh=None)
    jstate, jmetrics = jstep(jstate, jbatch)
    jafter = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))

    pbatch = batch_to(batch, "cpu")
    priors = prior_boxes(TINY_64)
    counts = bn_counts(port_model(task, variables), pbatch["image"])
    probe = port_model(task, variables)
    _, mask = loss_and_grads(probe, pbatch, priors)
    grads = {n: p.grad for n, p in probe.named_parameters()}

    net = port_model(task, variables)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    opt, sched = build_optimizer(net, task, SolverConfig(**SOLVER))
    state = TrainState(net, opt, sched)
    losses = make_train_step(priors)(state, pbatch)
    assert state.step == 1
    assert mask.dtype == torch.bool and mask.sum() > 0

    for key in ("loss_box_reg", "loss_cls", "loss_obj", "total_loss"):
        np.testing.assert_allclose(float(losses[key]), float(jmetrics[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(losses["num_pos"]) == max(float(jn), 1.0)

    ref_grads = from_jax_variables({"params": jgrads})
    assert set(grads) <= set(ref_grads)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=1e-4,
            atol=max(1e-6, GRAD_ATOL * np.abs(ref).max()), err_msg=name)

    after = net.state_dict()
    for name, _ in net.named_parameters():
        np.testing.assert_allclose(after[name].numpy(),
                                   jafter[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(after["OBJ_Target.weight"], dim=1).numpy(),
        1.0, rtol=1e-6)
    assert_running_stats(after, jafter, start, counts, updates=1)


class _Batches:
    def __init__(self, batches):
        self.batches = list(batches)

    def next(self):
        return self.batches.pop(0)


def test_init_reweight_matches_jax(setup):
    jtask, task, variables = setup
    batches = [make_batch(1), make_batch(2)]
    jnet = j_build_net(jtask, 64)
    jstate = JTrainState(variables["params"], variables["batch_stats"],
                         None, jnp.asarray(0, jnp.int32))

    class Args:
        init_iter = 2

    jstate = j_init_reweight(Args, jnet, jstate, _Batches(batches),
                             j_prior_boxes(J_TINY_64), jtask)
    jafter = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))

    counts = bn_counts(port_model(task, variables),
                       batch_to(batches[0], "cpu")["image"])
    net = port_model(task, variables)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    protos = init_reweight(net, _Batches(batches), prior_boxes(TINY_64),
                           task, init_iter=2)
    np.testing.assert_allclose(protos.numpy(),
                               jafter["OBJ_Target.weight"].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(net.OBJ_Target.weight.detach().numpy(),
                                  protos.numpy())
    assert_running_stats(net.state_dict(), jafter, start, counts, updates=2)
    assert not torch.equal(net.state_dict()["Norm.branch0.0.bn.running_mean"],
                           start["Norm.branch0.0.bn.running_mean"])
