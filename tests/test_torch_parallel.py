"""Data parallelism of the port (``ct_tpu_torch/parallel``) vs the JAX
package's ``shard_map`` mesh, on the CPU.

The size-64 phase-2 ``transfer`` ``ours`` model starts in both packages
from the port's seeded init (``test_torch_train_accum.seeded_state``),
carried into JAX by its importer. The port's two ranks are two worker
processes (``tests/torch_dp_worker.py``) in one gloo group, started once
for every case below; each has a ``communicate`` timeout of its own, so a
hang fails the test instead of cutting the suite.

* (i) The two-rank step (``loss_and_grads(mesh=...)`` then SGD, schedule
  and renorm, ``make_train_step``'s body) against JAX's
  ``make_train_step(mesh=make_mesh(2))`` on the same state and batch, at
  ``accum_steps`` 1 and 2, on the anchors JAX mined (the port's
  ``loss_mask`` on the obj logits of JAX's forward of each rank's
  micro-batch, handed in as ``mask``): the N-normalised losses to rtol
  1e-5, each gradient (JAX: the micro-batches' gradients of the loss
  sums, added, divided once by the global N) to rtol 1e-4 / atol
  1e-4·max|g|, the parameters after the update to rtol 1e-5 / atol 1e-6
  (``test_train_step_matches_jax``'s bands); BatchNorm's running means to
  rtol 1e-5 and the variances by the n/(n-1) relation at the per-rank
  element count (``test_torch_train_accum.assert_running_stats``, with
  one more float32 rounding of the stored value for the mean over the
  ranks).
* (ii) Both ranks' parameters, buffers and gradients equal bit for bit.
* (iii) The two-rank eval step, detections gathered, against JAX's mesh
  eval: ``valid`` and ``classes`` equal, scores rtol 1e-4 / atol 1e-5,
  boxes rtol 1e-3 / atol 0.5 (``test_eval_step_dp8_tiny_exact_parity``'s
  bands).
* (iv) The loader's rank blocks, whose union in rank order is the single
  process's batches.
* (v) The device augmentation's rank slices against the single process's
  draws for the global batch, and mixup's per-rank streams.
* (vi) ``init_reweight`` over two ranks against one process over the
  union of the blocks (each block a batch), and BatchNorm's averaged
  running statistics against the mean of the two ranks' runs alone.
* (vii) ``shard_batch`` against the per-device shards of JAX's
  ``shard_batch(make_mesh(2), ·)``.
* The int8 serving model calibrated on other images on each rank holds
  rank 0's scales on both after the eval CLI's broadcast.
* ``make_mesh``, ``initialize``, ``make_host_local_batch`` and the
  launcher without a group, and ``--ndev`` above the visible cards
  raising; a CLI's entry under a launcher's variables (world size 1).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import TINY_64 as J_TINY_64
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu.ops.losses import multibox_loss_sums as j_loss_sums
from ct_tpu.ops.matching import match_batch as j_match_batch
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu.parallel import make_mesh as j_make_mesh
from ct_tpu.parallel import shard_batch as j_shard_batch
from ct_tpu.train.solver import SolverConfig as JSolverConfig
from ct_tpu.train.solver import build_optimizer as j_build_optimizer
from ct_tpu.train.step import TrainState as JTrainState
from ct_tpu.train.step import make_eval_step as j_make_eval_step
from ct_tpu.train.step import make_train_step as j_make_train_step
from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.data.augment_device import augment_batch
from ct_tpu_torch.data.loader import Loader
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.losses import loss_mask
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.parallel import distributed
from ct_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from ct_tpu_torch.train import cli
from ct_tpu_torch.train.reweight import init_reweight
from ct_tpu_torch.train.step import LOSS_KEYS, batch_to
from test_torch_train_accum import seeded_state
from test_torch_train_step import GRAD_ATOL, SOLVER, bn_counts, make_batch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TASK = (2, "transfer", "ours", "VOC")
WORKER_TIMEOUT = 300
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX's products at full float32 precision (as in
    tests/test_torch_train_step.py)."""
    with jax.default_matmul_precision("highest"):
        yield


def global_batch(n):
    """n seeded images with their padded targets (``make_batch`` pairs)."""
    parts = [make_batch(10 + i) for i in range(n // 2)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def setup():
    jtask = j_resolve_task(*TASK)
    task = resolve_task(*TASK)
    state = seeded_state(task, 64, seed=7)
    return jtask, task, state, torch_state_to_variables(state)


def jax_reference(jtask, variables, batch, accum):
    """What JAX's two-device step sees: each device's micro-batches'
    gradients of the loss sums and obj logits → (the anchors mined on
    them [B, P], the gradients summed and divided by the global N, N)."""
    jnet = j_build_net(jtask, 64)
    jpriors = j_prior_boxes(J_TINY_64)

    def sums_fn(params, mb):
        preds, _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            mb["image"], train=True, mutable=["batch_stats"])
        matched = j_match_batch(mb["boxes"], mb["labels"], mb["weights"],
                                mb["valid"], jpriors)
        sums, n = j_loss_sums(preds.loc, preds.conf, preds.obj, matched)
        return sum(sums.values()), (n, preds.obj)

    fn = jax.jit(jax.value_and_grad(sums_fn, has_aux=True))
    micro = batch["image"].shape[0] // (2 * accum)
    outs, masks = [], []
    for lo in range(0, batch["image"].shape[0], micro):
        mb = {k: v[lo:lo + micro] for k, v in batch.items()}
        out = fn(variables["params"], {k: jnp.asarray(v)
                                       for k, v in mb.items()})
        outs.append(out)
        pb = batch_to(mb, CPU)
        masks.append(loss_mask(torch.tensor(np.asarray(out[0][1][1])),
                               match_batch(pb["boxes"], pb["labels"],
                                           pb["weights"], pb["valid"],
                                           prior_boxes(TINY_64), 0.5))[0])
    n = max(sum(float(o[0][1][0]) for o in outs), 1.0)
    grads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda *g: sum(np.asarray(x, np.float64) for x in g).astype(
            np.float32) / n, *[o[1] for o in outs])})
    return torch.cat(masks), grads, n


def jax_mesh_step(jtask, variables, batch, accum):
    jnet = j_build_net(jtask, 64)
    tx = j_build_optimizer(variables["params"], jtask,
                           JSolverConfig(**SOLVER))
    jstate = JTrainState(variables["params"], variables["batch_stats"],
                         tx.init(variables["params"]),
                         jnp.asarray(0, jnp.int32))
    step = j_make_train_step(jnet, j_prior_boxes(J_TINY_64), jtask, tx, 0.5,
                             mesh=j_make_mesh(2), accum_steps=accum)
    jstate, metrics = step(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    after = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    return {k: float(v) for k, v in metrics.items()}, after


def eval_inputs():
    rng = np.random.RandomState(3)
    images = rng.randn(4, 3, 64, 64).astype(np.float32) * 50
    sizes = np.tile([480, 640], (4, 1)).astype(np.int32)
    return images, sizes


def reweight_batches():
    return [batch_to(global_batch(4), CPU), batch_to(global_batch(4), CPU)]


def start_workers(cases, tmp):
    """Two gloo ranks on ``cases``; returns their Popen handles."""
    path = os.path.join(tmp, "cases.pt")
    torch.save(cases, path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = str(distributed.free_port())
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"), path,
         tmp, str(r), "2", port], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(2)]


def finish_workers(procs, tmp):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The JAX references, and the two ranks' results on the same inputs:
    the workers run while this process runs JAX's mesh steps."""
    jtask, task, state, variables = setup
    tmp = str(tmp_path_factory.mktemp("dp"))
    batches = {1: global_batch(4), 2: global_batch(8)}
    refs = {a: jax_reference(jtask, variables, batches[a], a)
            for a in (1, 2)}
    images, sizes = eval_inputs()
    calib = torch.from_numpy(np.random.RandomState(5).randn(
        2, 2, 3, 64, 64).astype(np.float32) * 50)
    cases = {f"train{a}": dict(kind="train", task=TASK, state=state,
                               solver=SOLVER, batch=batches[a],
                               mask=refs[a][0], accum=a) for a in (1, 2)}
    cases["eval"] = dict(kind="eval", task=TASK, state=state,
                         images=torch.from_numpy(images),
                         sizes=torch.from_numpy(sizes))
    cases["reweight"] = dict(kind="reweight", task=TASK, state=state,
                             batches=reweight_batches())
    cases["int8"] = dict(kind="int8", task=TASK, state=state, images=calib)
    procs = start_workers(cases, tmp)
    try:
        steps = {a: jax_mesh_step(jtask, variables, batches[a], a)
                 for a in (1, 2)}
        jnet = j_build_net(jtask, 64)
        jdets = j_make_eval_step(jnet, j_prior_boxes(J_TINY_64),
                                 mesh=j_make_mesh(2))(
            variables["params"], variables["batch_stats"],
            jnp.asarray(images.transpose(0, 2, 3, 1)), jnp.asarray(sizes))
    finally:
        ranks = finish_workers(procs, tmp)
    return {"batches": batches, "refs": refs, "steps": steps,
            "jdets": [np.asarray(t) for t in jdets], "ranks": ranks}


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_step_matches_jax_mesh(setup, runs, accum):
    _, task, state, _ = setup
    mine = runs["ranks"][0][f"train{accum}"]
    _, ref_grads, n = runs["refs"][accum]
    metrics, jafter = runs["steps"][accum]
    for key in LOSS_KEYS + ("total_loss",):
        np.testing.assert_allclose(mine["losses"][key], metrics[key],
                                   rtol=1e-5, err_msg=key)
    assert mine["losses"]["num_pos"] == n
    assert set(mine["grads"]) <= set(ref_grads)
    for name, g in mine["grads"].items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=1e-4,
            atol=max(1e-6, GRAD_ATOL * np.abs(ref).max()), err_msg=name)
    after = mine["after"]
    net = build_net(task, 64, device="cpu")
    for name, _ in net.named_parameters():
        np.testing.assert_allclose(after[name].numpy(), jafter[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # BatchNorm's statistics: each rank's micro-batch of the block
    micro = runs["batches"][accum]["image"].shape[0] // (2 * accum)
    net.load_state_dict(state)
    counts = bn_counts(net.train(), batch_to(
        {"image": runs["batches"][accum]["image"][:micro]}, CPU)["image"])
    assert_averaged_running_stats(after, jafter, state, counts,
                                  updates=accum)


def assert_averaged_running_stats(ours, ref, start, counts, updates):
    """``test_torch_train_accum.assert_running_stats`` for statistics
    averaged over the ranks: the mean's sum rounds the stored value once
    more in each package (JAX's ``pmean``, the port's all-reduce), so the
    variances' identity holds to one float32 spacing of the stored value
    for each update and for the mean, in each package."""
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
            atol = 2 * (updates + 1) * np.spacing(np.abs(val.numpy()))
            assert np.all(np.abs(a - b) <= atol + 1e-4 * np.abs(b)), key


@pytest.mark.parametrize("case", ["train1", "train2", "reweight"])
def test_ranks_hold_the_same_state(runs, case):
    a, b = (r[case] for r in runs["ranks"])
    for key in a["after"]:
        assert torch.equal(a["after"][key], b["after"][key]), key
    for key in a.get("grads", {}):
        assert torch.equal(a["grads"][key], b["grads"][key]), key


def test_two_rank_eval_matches_jax_mesh(runs):
    ref = runs["jdets"]
    for rank in runs["ranks"]:
        boxes, scores, classes, valid = (
            t.numpy() for t in rank["eval"]["gathered"])
        np.testing.assert_array_equal(valid, ref[3])
        np.testing.assert_array_equal(classes, ref[2])
        np.testing.assert_allclose(scores, ref[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(boxes, ref[0], rtol=1e-3, atol=0.5)
    assert valid.any()
    # the gathered detections are the ranks' blocks in rank order
    for i, (a, b) in enumerate(zip(runs["ranks"][0]["eval"]["block"],
                                   runs["ranks"][1]["eval"]["block"])):
        assert torch.equal(runs["ranks"][0]["eval"]["gathered"][i],
                           torch.cat([a, b]))


def test_two_rank_reweight_is_one_process_over_the_blocks(setup, runs):
    _, task, state, _ = setup
    batches = reweight_batches()
    whole = build_net(task, 64, device="cpu")
    whole.load_state_dict(state)
    union = [blk for b in batches for blk in
             (shard_batch(Mesh(2, 0, CPU), b), shard_batch(Mesh(2, 1, CPU), b))]
    protos = init_reweight(whole, _Next(union), prior_boxes(TINY_64), task,
                           init_iter=len(union))
    alone = []
    for r in range(2):
        net = build_net(task, 64, device="cpu")
        net.load_state_dict(state)
        init_reweight(net, _Next([shard_batch(Mesh(2, r, CPU), b)
                                  for b in batches]),
                      prior_boxes(TINY_64), task, init_iter=len(batches))
        alone.append(net.state_dict())
    mine = runs["ranks"][0]["reweight"]
    np.testing.assert_allclose(mine["prototypes"].numpy(), protos.numpy(),
                               rtol=1e-5, atol=1e-6)
    for key, val in mine["after"].items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                val.numpy(), ((alone[0][key] + alone[1][key]) / 2).numpy(),
                rtol=1e-6, atol=1e-7, err_msg=key)
    assert torch.equal(mine["after"]["OBJ_Target.weight"], mine["prototypes"])


class _Next:
    def __init__(self, batches):
        self.batches = list(batches)

    def next(self):
        return self.batches.pop(0)


def test_int8_ranks_serve_rank0_scales(runs):
    (a, b) = (r["int8"] for r in runs["ranks"])
    assert len(a["after"]) == len(b["after"]) > 0
    # calibrated on other images, the ranks' activation scales differ ...
    assert any(not torch.equal(x, y) for x, y in zip(a["before"],
                                                     b["before"]))
    # ... until rank 0's are broadcast
    for x, y, r0 in zip(a["after"], b["after"], a["before"]):
        assert torch.equal(x, y) and torch.equal(x, r0)


class _Indexed:
    """Samples that name their index: image value i, one box."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return (np.full((4, 4, 3), i, np.uint8),
                np.asarray([[0.1, 0.1, 0.5, 0.5, 1 + i % 5, 1.0]]))


def test_loader_rank_blocks_are_the_single_process_batches():
    single = Loader(_Indexed(), 6, num_workers=2, max_objs=3, seed=2)
    ranks = [Loader(_Indexed(), 6, num_workers=2, max_objs=3, seed=2,
                    rank=r, world=2) for r in range(2)]
    try:
        for _ in range(5):
            whole = single.next()
            parts = [r.next() for r in ranks]
            assert all(p["image"].shape[0] == 3 for p in parts)
            for key in whole:
                np.testing.assert_array_equal(
                    np.concatenate([p[key] for p in parts]), whole[key],
                    err_msg=key)
    finally:
        for loader in [single] + ranks:
            loader.stop()
    with pytest.raises(ValueError, match="does not divide"):
        Loader(_Indexed(), 5, rank=0, world=2)


def test_device_augment_rank_slices_are_the_single_process_draws():
    rng = np.random.RandomState(0)
    b = 6
    images = torch.from_numpy(rng.randint(0, 255, (b, 3, 96, 96)).astype(
        np.uint8))
    batch = batch_to(global_batch(b), CPU)
    gen = torch.Generator()
    args = (images, batch["boxes"], batch["labels"], batch["valid"])
    whole = augment_batch(gen.manual_seed(9), *args, out_size=64)
    for r in range(2):
        mesh = Mesh(2, r, CPU)
        part = augment_batch(gen.manual_seed(9), *shard_batch(mesh, args),
                             out_size=64, rank=r, world=2)
        for key in whole:
            np.testing.assert_allclose(part[key].numpy(),
                                       shard_batch(mesh, whole[key]).numpy(),
                                       rtol=1e-6, atol=1e-4, err_msg=key)
    # the single process draws as before (rank 0 of 1)
    again = augment_batch(gen.manual_seed(9), *args, out_size=64, rank=0,
                          world=1)
    assert all(torch.equal(whole[k], again[k]) for k in whole)
    # mixup: the single process's stream on rank 0, another on rank 1
    one = cli.mixup_rng(4).random(3)
    assert np.array_equal(one, np.random.default_rng(
        cli.seed_of(cli.MIXUP_STREAM, 4)).random(3))
    r0, r1 = (cli.mixup_rng(4, Mesh(2, r, CPU)).random(3) for r in range(2))
    assert np.array_equal(r0, one) and not np.array_equal(r1, one)


def test_shard_batch_matches_jax_device_shards():
    batch = global_batch(4)
    jmesh = j_make_mesh(2)
    sharded = j_shard_batch(jmesh, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    devices = list(jmesh.devices.reshape(-1))
    for r in range(2):
        ours = shard_batch(Mesh(2, r, CPU), batch)
        for key, arr in sharded.items():
            shard = [s for s in arr.addressable_shards
                     if s.device == devices[r]][0]
            np.testing.assert_array_equal(ours[key], np.asarray(shard.data),
                                          err_msg=key)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(Mesh(2, 0, CPU), np.zeros((3, 2)))


def test_single_process_mesh_and_launcher_checks():
    mesh = make_mesh()
    assert (mesh.world_size, mesh.rank, mesh.distributed) == (1, 0, False)
    assert distributed.initialize() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2)
    local = distributed.make_host_local_batch(mesh, {"x": np.ones((2, 3))})
    assert torch.equal(local["x"], torch.ones(2, 3, dtype=torch.float64))
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda") == "nccl"
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {have + 1} CUDA devices, "
                                           f"but {have} are visible"):
        distributed.launch("ct_tpu_torch.parallel.distributed:initialize",
                           have + 1, device="cuda")


def test_cli_entry_joins_a_launchers_group(monkeypatch):
    """Under a launcher's variables the CLI joins its group (world size 1
    here, over gloo by ``env://``) and leaves it; ``--ndev`` must be 0 or
    ``WORLD_SIZE``, and ``-b`` must divide over the ranks."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(distributed.free_port()))
    with pytest.raises(SystemExit, match="WORLD_SIZE 1: pass 0 or 1"):
        distributed.cli_entry(2, "cpu", "x:y", [], 4)
    entry = distributed.cli_entry(0, "cpu", "x:y", [], 4)
    try:
        assert entry.joined and not entry.launched
        assert torch.distributed.is_initialized()
        mesh = make_mesh(1)
        assert (mesh.world_size, mesh.group is not None) == (1, True)
        assert torch.distributed.get_backend() == "gloo"
    finally:
        distributed.leave(entry)
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("RANK")
    with pytest.raises(SystemExit, match="must be divisible by --ndev 2"):
        distributed.cli_entry(2, "cpu", "x:y", [], 3)
