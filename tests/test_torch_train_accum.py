"""Gradient accumulation (``--accum-steps``) and the fused optimizer
(``--fused-opt on``) of the port vs the JAX package's, on the CPU.

The size-64 models start from the port's seeded init (BN statistics and
CT parameters randomized), carried into JAX by the JAX package's importer
of reference state dicts, so no test pays a JAX init.

* The accumulated step (``make_train_step(..., accum_steps=2)``) on a
  batch of 4 against JAX's ``make_train_step(..., accum_steps=2)`` on the
  same state, with the bands of ``test_train_step_matches_jax``: the
  N-normalised losses to rtol 1e-5, the parameters after the update to
  rtol 1e-5 / atol 1e-6, BatchNorm's running statistics after two
  updates (one a micro-batch) by the n/(n-1) identity.
* On a duplicated batch ``[v, v]`` accum 2 equals accum 1 (BatchNorm
  sees the same statistics), within JAX's own bands
  (``tests/test_train_opt.py``): losses rtol 2e-5, parameters rtol 1e-4
  / atol 1e-6; with either optimizer flavour.
* bf16: the accumulated step of the bf16 model against JAX's
  ``accumulate`` in bf16 (``jax.value_and_grad`` of the loss sums of each
  micro-batch, the Pallas CT kernels in interpret mode and the packed
  conv1 stage, summed, divided once by the whole batch's N), on the
  anchors JAX mined in each micro-batch, with the bf16-effect bands of
  ``test_torch_bf16_train.py`` (each loss and the gradient vector within
  half of what bf16 moves JAX's result; each tensor, biases included,
  within its own effect or 1% of the vector's), but for ``obj.0.bias``,
  which is held to the f32 gradient within 1% of the vector's effect
  (see the test); the biases together within half of their joint effect
  besides.
* The fused flavour (``build_optimizer(..., fused=True)``, torch's
  fused SGD step) against JAX's ``build_fused_optimizer`` over 3 updates
  of seeded gradients, through warmup, with the phase-2 ``ours`` groups
  (0.1×, 0.5×, 1×) and phase 1's uniform multiplier; against the port's
  per-leaf flavour on the same gradients; a resume across flavours
  (``Checkpointer.resume_or_load``) that warns, keeps the writer's
  flavour and whose next update equals the uninterrupted run's bit for
  bit, and a resume in the same flavour that does not warn.
  FUSED_RTOL / FUSED_ATOL are JAX's own band between its two flavours;
  the port's two flavours and JAX's agree within it.
* The train CLI with ``--accum-steps 2 --fused-opt on`` at 300, batch 4,
  2 phase-1 iterations (the checkpoint holds the fused flavour's state);
  ``-b 4 --accum-steps 3`` exits with ``train.py``'s message.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ct_tpu.config import TINY_64 as J_TINY_64
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu.ops.losses import multibox_loss_sums as j_loss_sums
from ct_tpu.ops.matching import match_batch as j_match_batch
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu.train.solver import SolverConfig as JSolverConfig
from ct_tpu.train.solver import build_fused_optimizer as j_build_fused
from ct_tpu.train.solver import build_optimizer as j_build_optimizer
from ct_tpu.train.step import TrainState as JTrainState
from ct_tpu.train.step import make_train_step as j_make_train_step
from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.losses import loss_mask
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.train import cli
from ct_tpu_torch.train.checkpointer import Checkpointer
from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
from ct_tpu_torch.train.step import (
    LOSS_KEYS, TrainState, batch_to, loss_and_grads, make_train_step,
)
from test_torch_bf16 import STRICT
from test_torch_bf16_train import (
    EFFECT_SHARE, TENSOR_FLOOR, TENSOR_SHARE,
)
from test_torch_train_cli import two_threads  # noqa: F401
from test_torch_train_step import (
    SOLVER, bn_counts, make_batch,
)

BF16 = torch.bfloat16
# JAX's band between its per-leaf and fused flavours
# (tests/test_train_opt.py::test_fused_sgd_matches_per_leaf_chain)
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _f32_dots(two_threads):
    """JAX's products at full float32 precision, as in
    tests/test_torch_train_step.py; two torch threads (the suite runs its
    files in parallel processes)."""
    with jax.default_matmul_precision("highest"):
        yield


def seeded_state(task, size, seed):
    """The port's seeded init of a ``size`` model, its BN statistics and CT
    parameters randomized (their inits are zeros or ones)."""
    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, val in build_net(task, size, device="cpu").state_dict().items():
        if key.endswith("running_mean"):
            val = torch.randn(val.shape, generator=gen) * 0.1
        elif key.endswith("running_var"):
            val = torch.rand(val.shape, generator=gen) + 0.5
        elif key.startswith(("Wz", "OBJ_Target", "fc_base")):
            val = torch.randn(val.shape, generator=gen) * 0.3
        state[key] = val
    return state


def port_net(task, state, size=64, dtype=torch.float32):
    net = build_net(task, size, device="cpu", dtype=dtype)
    net.load_state_dict(state)
    return net.train()


@pytest.fixture(scope="module")
def incre():
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    task = resolve_task(2, "incre", "ours", "VOC")
    state = seeded_state(task, 64, seed=5)
    return jtask, task, state, torch_state_to_variables(state)


def four_images():
    """Two seeded batches of two, one batch of four."""
    a, b = make_batch(0), make_batch(1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


# --- the accumulated step ----------------------------------------------------

def test_accum_step_matches_jax(incre):
    jtask, task, state, variables = incre
    batch = four_images()
    jnet = j_build_net(jtask, 64)
    tx = j_build_optimizer(variables["params"], jtask,
                           JSolverConfig(**SOLVER))
    jstate = JTrainState(variables["params"], variables["batch_stats"],
                         tx.init(variables["params"]),
                         jnp.asarray(0, jnp.int32))
    jstep = j_make_train_step(jnet, j_prior_boxes(J_TINY_64), jtask, tx,
                              0.5, mesh=None, accum_steps=2)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    jafter = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))

    pbatch = batch_to(batch, "cpu")
    counts = bn_counts(port_net(task, state), pbatch["image"][:2])
    net = port_net(task, state)
    opt, sched = build_optimizer(net, task, SolverConfig(**SOLVER))
    losses = make_train_step(prior_boxes(TINY_64), accum_steps=2)(
        TrainState(net, opt, sched), pbatch)

    for key in ("loss_box_reg", "loss_cls", "loss_obj", "total_loss"):
        np.testing.assert_allclose(float(losses[key]), float(jmetrics[key]),
                                   rtol=1e-5, err_msg=key)
    after = net.state_dict()
    for name, _ in net.named_parameters():
        np.testing.assert_allclose(after[name].numpy(),
                                   jafter[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert_running_stats(after, jafter, state, counts, updates=2)


def assert_running_stats(ours, ref, start, counts, updates):
    """``test_torch_train_step.assert_running_stats`` after ``updates``
    updates: each update rounds the stored statistic to float32 in both
    packages, so the running variances' identity holds to one float32
    spacing of the stored value per update in each (at a variance near 1
    a spacing is 1.2e-7; the batch's share it is checked on is ~1e-5)."""
    decay = 0.99 ** updates
    for key, val in ours.items():
        if key.endswith("running_mean"):
            np.testing.assert_allclose(val.numpy(), ref[key].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        elif key.endswith("running_var"):
            n = counts[key[:-len(".running_var")]]
            v0 = start[key].numpy()
            a = val.numpy() - decay * v0
            b = n / (n - 1) * (ref[key].numpy() - decay * v0)
            atol = 2 * updates * np.spacing(np.abs(val.numpy()))
            assert np.all(np.abs(a - b) <= atol + 1e-4 * np.abs(b)), key


@pytest.mark.parametrize("fused", [False, True])
def test_accum_on_duplicated_batch_equals_accum1(incre, fused):
    _, task, state, _ = incre
    half = make_batch(2)
    batch = batch_to({k: np.concatenate([v, v]) for k, v in half.items()},
                     "cpu")
    runs = []
    for accum in (1, 2):
        net = port_net(task, state)
        opt, sched = build_optimizer(net, task, SolverConfig(**SOLVER),
                                     fused=fused)
        losses = make_train_step(prior_boxes(TINY_64), accum_steps=accum)(
            TrainState(net, opt, sched), batch)
        runs.append((losses, net.state_dict()))
    (l1, s1), (l2, s2) = runs
    for key in LOSS_KEYS + ("total_loss",):
        np.testing.assert_allclose(float(l2[key]), float(l1[key]),
                                   rtol=2e-5, err_msg=key)
    assert float(l2["num_pos"]) == float(l1["num_pos"])
    for name, _ in port_net(task, state).named_parameters():
        np.testing.assert_allclose(s2[name].numpy(), s1[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_loss_and_grads_refuses_a_ragged_split(incre):
    _, task, state, _ = incre
    with pytest.raises(ValueError, match="does not divide"):
        loss_and_grads(port_net(task, state),
                       batch_to(four_images(), "cpu"),
                       prior_boxes(TINY_64), accum_steps=3)


def test_bf16_accum_step_matches_jax(incre, record_property):
    jtask, task, state, variables = incre
    batch = four_images()
    jpriors = j_prior_boxes(J_TINY_64)
    jnet = dataclasses.replace(
        j_build_net(jtask, 64, dtype=jnp.bfloat16, pack_conv1=True),
        use_pallas_ct=True)

    def sums_fn(params, mb):
        preds, _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            mb["image"], train=True, mutable=["batch_stats"])
        matched = j_match_batch(mb["boxes"], mb["labels"], mb["weights"],
                                mb["valid"], jpriors)
        sums, n = j_loss_sums(preds.loc, preds.conf, preds.obj, matched)
        return sum(sums.values()), (n, sums, preds.obj)

    # JAX's ``accumulate``: the micro-batches in order, their gradients and
    # sums added, one division by the whole batch's N (in train mode a
    # micro-batch's forward does not read the running statistics that
    # JAX's scan carries)
    fn = jax.jit(jax.value_and_grad(sums_fn, has_aux=True))
    micro = [{k: jnp.asarray(v[i:i + 2]) for k, v in batch.items()}
             for i in (0, 2)]
    with pltpu.force_tpu_interpret_mode():
        compiled = fn.lower(variables["params"], micro[0]).compile(
            compiler_options=STRICT)
        outs = [compiled(variables["params"], mb) for mb in micro]
    n = max(sum(float(o[0][1][0]) for o in outs), 1.0)
    ref_losses = {k: sum(float(o[0][1][1][k]) for o in outs) / n
                  for k in LOSS_KEYS}
    ref16 = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda *g: sum(np.asarray(x, np.float64) for x in g).astype(
            np.float32) / n, *[o[1] for o in outs])})
    pbatch = batch_to(batch, "cpu")
    mined = [loss_mask(torch.tensor(np.asarray(o[0][1][2])), match_batch(
        pbatch["boxes"][i:i + 2], pbatch["labels"][i:i + 2],
        pbatch["weights"][i:i + 2], pbatch["valid"][i:i + 2],
        prior_boxes(TINY_64), 0.5))[0] for o, i in zip(outs, (0, 2))]
    mask = torch.cat(mined)

    def port(dtype):
        net = port_net(task, state, dtype=dtype)
        losses, _ = loss_and_grads(net, pbatch, prior_boxes(TINY_64),
                                   mask=mask, accum_steps=2)
        assert float(losses["num_pos"]) == n
        return ({k: float(losses[k]) for k in LOSS_KEYS},
                {m: p.grad.detach().clone()
                 for m, p in net.named_parameters()})

    losses16, grads16 = port(BF16)
    losses32, grads32 = port(torch.float32)
    for k in LOSS_KEYS:
        effect = abs(ref_losses[k] - losses32[k])
        assert effect > 0, k
        dist = abs(losses16[k] - ref_losses[k])
        record_property(f"{k}_over_effect", dist / effect)
        assert dist <= EFFECT_SHARE * effect, (k, losses16[k],
                                               ref_losses[k], effect)
    names = sorted(grads16)
    assert set(names) <= set(ref16)
    cat = lambda d: torch.cat([d[m].reshape(-1) for m in names])
    effect = (cat(ref16) - cat(grads32)).norm()
    to_bf16 = float((cat(grads16) - cat(ref16)).norm() / effect)
    record_property("grads_over_effect", to_bf16)
    assert to_bf16 <= EFFECT_SHARE
    assert float((cat(grads16) - cat(grads32)).norm() / effect) > \
        EFFECT_SHARE     # not the float32 model
    for m in names:
        assert grads16[m].dtype == torch.float32, m
    # each tensor, biases included, within its own bf16 effect or
    # TENSOR_FLOOR of the vector's, but obj.0.bias: XLA's CPU backend sums
    # that bias's bf16 cotangent in bf16 (torch in f32), so its "effect" in
    # JAX's result is that sum's rounding, not bf16's effect on the port
    # (JAX's bf16 gradient 0.29 from the f32 one, the port's 0.005; the
    # port's 0.298 from JAX's, 1.02 times the band). It is held to the f32
    # gradient on the same anchors within TENSOR_FLOOR of the vector's
    # effect instead, and the biases together within EFFECT_SHARE of their
    # joint effect besides.
    odd = "obj.0.bias"
    for m in names:
        if m == odd:
            continue
        band = max(TENSOR_SHARE * (ref16[m] - grads32[m]).norm(),
                   TENSOR_FLOOR * effect)
        assert (grads16[m] - ref16[m]).norm() <= band, m
    odd_to_f32 = float((grads16[odd] - grads32[odd]).norm())
    record_property("obj0_bias_to_f32", odd_to_f32)
    record_property("obj0_bias_to_jax_bf16",
                    float((grads16[odd] - ref16[odd]).norm()))
    assert odd_to_f32 <= TENSOR_FLOOR * effect
    assert float((ref16[odd] - grads32[odd]).norm()) > 10 * odd_to_f32
    biases = [m for m in names if m.endswith(".bias")]
    cat_b = lambda d: torch.cat([d[m].reshape(-1) for m in biases])
    to_bias = float((cat_b(grads16) - cat_b(ref16)).norm()
                    / (cat_b(ref16) - cat_b(grads32)).norm())
    record_property("biases_over_effect", to_bias)
    assert to_bias <= EFFECT_SHARE


# --- the fused optimizer ---------------------------------------------------

FUSED_CFG = dict(lr=2e-3, steps=(3,), warmup_iters=2)


def seeded_grads(net, seed):
    gen = torch.Generator().manual_seed(seed)
    return {name: torch.randn(p.shape, generator=gen) * 0.01
            for name, p in net.named_parameters()}


def port_updates(net, opt, sched, seeds):
    for seed in seeds:
        grads = seeded_grads(net, seed)
        for name, p in net.named_parameters():
            p.grad = grads[name]
        opt.step()
        sched.step()
        opt.zero_grad()
    return {n: p.detach().clone() for n, p in net.named_parameters()}


@pytest.mark.parametrize("phase,setting", [(1, "transfer"),
                                           (2, "transfer")])
def test_fused_optimizer_matches_jax_and_the_per_leaf_flavour(phase,
                                                              setting):
    task = resolve_task(phase, setting, "ours", "VOC")
    jtask = j_resolve_task(phase, setting, "ours", "VOC")
    state = seeded_state(task, 64, seed=phase)
    variables = torch_state_to_variables(state)

    tx = j_build_fused(variables["params"], jtask, JSolverConfig(**FUSED_CFG))
    params, opt_state = variables["params"], None
    opt_state = tx.init(params)
    probe = port_net(task, state)
    for seed in range(3):
        grads = seeded_grads(probe, seed)
        jgrads = torch_state_to_variables(
            {**{k: torch.zeros_like(v) for k, v in state.items()},
             **grads})["params"]
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(jnp.add, params, updates)
    jafter = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, params)})

    net = port_net(task, state)
    opt, sched = build_optimizer(net, task, SolverConfig(**FUSED_CFG),
                                 fused=True)
    assert all(g["fused"] for g in opt.param_groups)
    # the ours groups in phase 2, one group in phase 1
    assert [g["initial_lr"] / FUSED_CFG["lr"] for g in opt.param_groups] == \
        pytest.approx([0.1, 0.5, 1.0] if phase == 2 else [1.0])
    fused = port_updates(net, opt, sched, range(3))
    leaf_net = port_net(task, state)
    leaf = port_updates(leaf_net, *build_optimizer(
        leaf_net, task, SolverConfig(**FUSED_CFG)), range(3))
    for name, val in fused.items():
        assert not torch.equal(val, state[name]), name
        np.testing.assert_allclose(val.numpy(), jafter[name].numpy(),
                                   rtol=FUSED_RTOL, atol=FUSED_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(val.numpy(), leaf[name].numpy(),
                                   rtol=FUSED_RTOL, atol=FUSED_ATOL,
                                   err_msg=name)


def written_checkpoint(tmp_path, written_fused):
    """A phase-1 model and its optimizer after two updates of the
    ``written_fused`` flavour, checkpointed at iteration 1."""
    task = resolve_task(1, "transfer", "ours", "VOC")
    net = port_net(task, seeded_state(task, 64, seed=3))
    opt, sched = build_optimizer(net, task, SolverConfig(**FUSED_CFG),
                                 fused=written_fused)
    port_updates(net, opt, sched, (0, 1))
    Checkpointer(str(tmp_path)).save("model_0000001", net, opt, sched,
                                     iteration=1)
    return task, net, opt, sched


@pytest.mark.parametrize("written_fused", [False, True])
def test_resume_across_flavours(tmp_path, caplog, written_fused):
    """A checkpoint written by one flavour, resumed with the other flag:
    a warning, the writer's flavour, and the next update equal to the
    uninterrupted run's bit for bit."""
    task, net, opt, sched = written_checkpoint(tmp_path, written_fused)
    net2 = port_net(task, seeded_state(task, 64, seed=4))
    opt2, sched2 = build_optimizer(net2, task, SolverConfig(**FUSED_CFG),
                                   fused=not written_fused)
    with caplog.at_level(logging.WARNING):
        assert Checkpointer(str(tmp_path)).resume_or_load(
            None, net2, opt2, sched2, resume=True) == 1
    assert "does not match --fused-opt" in caplog.text
    assert all(bool(g["fused"]) == written_fused for g in opt2.param_groups)
    assert sched2.last_epoch == sched.last_epoch == 2
    ours = port_updates(net2, opt2, sched2, (2,))
    ref = port_updates(net, opt, sched, (2,))
    for name, val in ref.items():
        assert torch.equal(val, ours[name]), name


def test_resume_in_the_same_flavour_does_not_warn(tmp_path, caplog):
    task, net, opt, _ = written_checkpoint(tmp_path, True)
    net2 = port_net(task, seeded_state(task, 64, seed=4))
    opt2, sched2 = build_optimizer(net2, task, SolverConfig(**FUSED_CFG),
                                   fused=True)
    with caplog.at_level(logging.WARNING):
        Checkpointer(str(tmp_path)).resume_or_load(None, net2, opt2, sched2,
                                                   resume=True)
    assert "does not match" not in caplog.text
    for p, q in zip(opt.param_groups[0]["params"],
                    opt2.param_groups[0]["params"]):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])


# --- the CLI ---------------------------------------------------------------

def test_cli_accum_steps_and_fused_opt(tmp_path, monkeypatch):
    from fixtures import make_mini_voc_all

    monkeypatch.setenv("VOC_ROOT", make_mini_voc_all(str(tmp_path / "voc")))
    save = str(tmp_path / "w")
    row = cli.main([
        "-p", "1", "--setting", "transfer", "--basenet", "no_such.pth",
        "-d", "VOC", "--max-iter", "2", "-b", "4", "--accum-steps", "2",
        "--fused-opt", "on", "--num-workers", "2",
        "--save-folder", save, "--device", "cpu"])
    assert row["iteration"] == 1
    assert all(np.isfinite(v) for v in row.values())
    saved = torch.load(os.path.join(save, "model_final.pth"),
                       weights_only=True)["optimizer"]
    task = resolve_task(1, "transfer", "ours", "VOC")
    assert all(g["fused"] for g in saved["param_groups"])
    assert len(saved["state"]) == len(list(
        build_net(task, 300, device="cpu").parameters()))


def test_cli_batch_must_divide_by_accum_steps(tmp_path):
    with pytest.raises(SystemExit,
                       match="--batch-size must divide by --accum-steps"):
        cli.main(["-b", "4", "--accum-steps", "3", "--save-folder",
                  str(tmp_path), "--device", "cpu"])
