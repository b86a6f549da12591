"""Training CLI of the port: the flags of ``train.py``, plus ``--device``.

    python -m ct_tpu_torch.train -d VOC -p 2 --setting incre --split 1 \\
        --shot 5 --mixup --load-file weights/phase1.pth \\
        --save-folder weights/ [--device-augment --canvas 384] [--bf16] \\
        [--profile-dir trace/] [--device cuda|cpu]
    python -m ct_tpu_torch.train -s 512 -p 2 --setting incre ... \\
        --accum-steps 4 [--fused-opt on] [--device-augment --canvas 640]
    python -m ct_tpu_torch.train -d COCO -p 1 --setting transfer \\
        --save-folder weights/ [--worker-type process]

Data parallel, one process a card, in either of two launch forms:

    python -m ct_tpu_torch.train --ndev 4 -b 64 ...     # spawns 4 workers
    torchrun --nproc-per-node 4 -m ct_tpu_torch.train -b 64 ...

``--ndev N`` > 1 starts N workers on a free localhost port; ``--ndev 0``
(the default) takes every visible card, and one card (or the CPU) is the
single-process path with no group. Under a launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) the CLI joins that group, at world size 1 too, and
``--ndev`` must be 0 or ``WORLD_SIZE``. The backend is NCCL on the cards
(one rank a card: ``--ndev`` above the visible cards raises) and gloo on
the CPU. ``-b`` is the global batch, which must divide over the ranks
(and their ``--accum-steps``). Each rank decodes its block of each
global batch from the shared sampler, the train step sums the
unnormalised gradients, loss sums and N over the ranks and divides by the
global N, and rank 0 writes the checkpoints, metrics, logs to the console
and traces ``--profile-dir``; rank N > 0 logs to ``log.txt.rank{N}``.
The device augmentation draws the global batch's parameters and applies
each rank's rows, so it equals the single process's; batch-level mixup,
though, pairs only within a rank's block (JAX's pairs across the global
batch), from a stream seeded with the rank folded in.

``--orbax``: asynchronous checkpoints (``train/async_ckpt.py``): each
save is a host snapshot written in the background to
``<save-folder>/orbax/<iteration + 1>/checkpoint.pth``; ``--resume`` in
phase 1 resumes from the newest, and the eval CLI loads it with
``--load-file`` or ``--resume --save-folder <save-folder>/orbax``.

The same phase/setting/method state machine and loop as ``train.py``: the
training set of the few-shot protocol, weights loaded from ``--basenet``
(phase 1) or ``--load-file`` (phase 2, weights only) or resumed from the
newest checkpoint with ``--resume``, the ``OBJ_Target`` initialisation
over ``--init-iter`` batches before mixup is turned on (phase 2 ``ours``),
mixup off for the last ``--no-mixup-iter`` iterations, checkpoints every
``--checkpoint-period`` iterations and at the end (``.pth``, which the
port's eval CLI loads).

``--device-augment``: the loader only resizes each image to a
``--canvas``² uint8 canvas; the augmentation (and, with ``--mixup``, a
batch-level mixup in place of the dataset's) runs batched on the device
(``data/augment_device.py``), from generators seeded per iteration.
``init_reweight`` then sees augmented, never-mixed batches from a
generator of its own.

``--bf16``: the model computes in bfloat16 as ``train.py --bf16``'s does
(``build_net(..., dtype=torch.bfloat16)``: float32 parameters, gradients
and SGD; bf16 convolutions, BN outputs, CT projections and CT attention
kernels), and the device augmentation emits bf16 images (its init batches
too), which mixup blends in float32 and keeps in bf16.

``--accum-steps N`` takes each batch in N micro-batches of B / N images
and sums their gradients before one update (``train/step.py``): how the
512 model trains at batch 64 on one card. ``--fused-opt on`` takes
torch's fused SGD step (``train/solver.py``). A resume (``--resume``,
phase 1) whose checkpoint was written by the other ``--fused-opt`` flavour
warns and resumes with that flavour, momentum and schedule carried over,
as ``train.py`` does.

Metrics: the losses stay on the device and are fetched together at each
write point (after 5 iterations, every 20 and at the last), where the
smoothed scalars go to the log, ``metrics.json`` and TensorBoard
(``train/events.py``): the losses, ``lr``, ``time`` (the whole
iteration: loader, augmentation and step, ``StepTimer``) and
``data_time`` (the wait in ``loader.next()``). ``--profile-dir`` traces
iterations 10–14 after the start (``utils/profiler.py``).

``-d VOC`` reads the VOC root in ``VOC_ROOT`` (default
``data/VOCdevkit``); ``-d COCO`` (phase 1, ``--setting transfer``: the
COCO-60 source pretraining) reads ``split_nonvoc_train2014`` and
``split_nonvoc_valminusminival2014`` under ``COCO_ROOT`` (default
``data/COCO``). ``--worker-type process`` runs the loader's workers as
spawned processes, for the host augmentation. As in
the reference, ``CT_ATTENTION_FLASH=0`` trains the CT attention with its
blockwise backward instead of the flash one; it is read on every call of
``main``. ``--pallas-ct`` raises: the port always runs its own CT kernels.

Fresh weights (all of them in phase 1 without a basenet; the CT head's
θ/φ/g and ``fc_base`` in phase 2) get the JAX package's initialisers
(``models/init.py``, seed 0), as ``train.py`` starts from
``init_train_state`` before it loads a checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("ct_tpu_torch.train")

# flag → (is it set?, why the port does not run it)
UNPORTED = (
    ("--pallas-ct", lambda a: a.pallas_ct is not None,
     "none: the port always runs its CT kernels on the card"),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Context-Transformer training (PyTorch/CUDA port)")
    parser.add_argument("-s", "--size", default="300",
                        help="300 or 512 input size.")
    parser.add_argument("--basenet", default="./weights/vgg16_reducedfc.pth",
                        help="Pretrained base model (phase 1)")
    parser.add_argument("-d", "--dataset", default="VOC",
                        help="VOC or COCO dataset.")
    parser.add_argument("--split", type=int, default=1,
                        help="VOC base/novel split, for VOC only.")
    parser.add_argument("--setting", default="transfer",
                        help="Training setting: transfer or incre.")
    parser.add_argument("-p", "--phase", type=int, default=1,
                        help="1: source pretraining, 2: target finetuning.")
    parser.add_argument("-m", "--method", default="ours",
                        help="ft(baseline) or ours, for phase 2 only.")
    parser.add_argument("--shot", type=int, default=5,
                        help="Number of shots, for phase 2 only.")
    parser.add_argument("--init-iter", type=int, default=50,
                        help="Batches used for OBJ_Target initialization")
    parser.add_argument("-max", "--max-iter", type=int, default=180000)
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument("--lr", "--learning-rate", type=float, default=4e-3)
    parser.add_argument("--steps", type=int, nargs="+",
                        default=[120000, 150000])
    parser.add_argument("--warmup-iter", type=int, default=5000)
    parser.add_argument("--ndev", type=int, default=0,
                        help="Data-parallel ranks, one a card (0 = every "
                             "visible card)")
    parser.add_argument("--num-workers", type=int, default=4,
                        help="Host data-pipeline workers")
    parser.add_argument("--worker-type", default="thread",
                        choices=["thread", "process"],
                        help="Loader worker pool: threads (for "
                             "--device-augment) or spawned processes (for "
                             "the host augmentation, which holds the GIL)")
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=5e-4)
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--load-file", default=None,
                        help="Model checkpoint for loading.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the last checkpoint.")
    parser.add_argument("-is", "--instance-shot", action="store_true",
                        help="Use instance shots for the transfer setting.")
    parser.add_argument("--mixup", action="store_true")
    parser.add_argument("--no-mixup-iter", type=int, default=800,
                        help="Disable mixup for the last iterations.")
    parser.add_argument("--save-folder", default="./weights/")
    parser.add_argument("--checkpoint-period", type=int, default=10000)
    parser.add_argument("--max-objs", type=int, default=100,
                        help="Static per-image annotation padding")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--profile-dir", default=None,
                        help="Trace iterations 10-14 (torch.profiler)")
    parser.add_argument("--device-augment", action="store_true",
                        help="Run the SSD augmentation batched on the "
                             "device (the host only resizes to a canvas; "
                             "with --mixup, mixup is batch-level there)")
    parser.add_argument("--canvas", type=int, default=384,
                        help="Working-canvas size for --device-augment")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (float32 parameters)")
    parser.add_argument("--fused-opt", choices=["on", "off"], default="off",
                        help="torch's fused SGD step")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="Gradient accumulation: micro-batches per "
                             "step (BatchNorm statistics per micro-batch)")
    parser.add_argument("--orbax", action="store_true",
                        help="Asynchronous checkpoints under "
                             "<save-folder>/orbax")
    # a flag of train.py that the port does not run: it raises
    parser.add_argument("--pallas-ct", choices=["auto", "on", "off"],
                        default=None)
    return parser.parse_args(argv)


def check_ported(args, unported=UNPORTED) -> None:
    """Raise on the first flag of ``unported`` that ``args`` sets, naming
    why the port does not run it."""
    for flag, is_set, item in unported:
        if is_set(args):
            raise SystemExit(f"{flag} is not ported to ct_tpu_torch yet "
                             f"(ROADMAP: {item})")


def training_set(args, preproc):
    """The training set of ``args.dataset``: the VOC sets of the few-shot
    protocol, or COCO's ``split_nonvoc_train2014`` and
    ``split_nonvoc_valminusminival2014`` (the COCO-60 source domain)."""
    from ct_tpu_torch.data.coco import COCODetection
    from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection

    if args.dataset == "VOC":
        if args.phase == 2 and (args.setting == "incre"
                                or args.instance_shot):
            sets = [("2007", "trainval")]
        else:
            sets = [("2007", "trainval"), ("2012", "trainval")]
        return VOCDetection(
            os.environ.get("VOC_ROOT", "data/VOCdevkit"), sets, preproc,
            AnnotationTransform(0 if args.setting == "transfer"
                                else args.split),
            phase=args.phase, setting=args.setting, split=args.split,
            shot=args.shot, instance_shot=args.instance_shot)
    if args.dataset == "COCO":
        return COCODetection(os.environ.get("COCO_ROOT", "data/COCO"),
                             [("2014", "split_nonvoc_train"),
                              ("2014", "split_nonvoc_valminusminival")],
                             preproc)
    raise ValueError(f"Unknown dataset: {args.dataset}")


# the random streams of the device route, as train.py's PRNG keys 1, 2, 3
AUGMENT_STREAM, MIXUP_STREAM, REWEIGHT_STREAM = 1, 2, 3


def seed_of(stream: int, iteration: int) -> int:
    """The seed of one iteration's draws from one stream (train.py folds
    the iteration into the stream's key), so that a resumed run draws what
    an unbroken one would."""
    return (stream << 32) + iteration


def is_write_point(iteration: int, start_iter: int, max_iter: int) -> bool:
    """Where train.py fetches the losses and writes its metrics: after 5
    iterations, every 20 and at the last."""
    return iteration - start_iter > 5 and (iteration % 20 == 0
                                           or iteration == max_iter - 1)


def device_augmented(gen, seed: int, batch, out_size: int,
                     out_dtype=None, mesh=None) -> dict:
    """A batch on the device, augmented there from ``gen`` seeded with
    ``seed`` (images in ``out_dtype``, the model's compute type as
    train.py's ``out_dtype``; float32 by default), its weights carried
    over. Under ``mesh`` the batch is this rank's block, augmented by its
    rows of the global batch's draws."""
    from ct_tpu_torch.data.augment_device import augment_batch

    gen.manual_seed(seed)
    rank, world = (mesh.rank, mesh.world_size) if mesh else (0, 1)
    return dict(augment_batch(gen, batch["image"], batch["boxes"],
                              batch["labels"], batch["valid"],
                              out_size=out_size, out_dtype=out_dtype,
                              rank=rank, world=world),
                weights=batch["weights"])


def mixup_rng(iteration: int, mesh=None) -> np.random.Generator:
    """The generator of one iteration's batch-level mixup. Under a mesh of
    several ranks the rank is folded into the seed of ranks other than 0:
    a rank pairs only within its block, and ranks with one seed would pair
    their blocks alike."""
    seed = seed_of(MIXUP_STREAM, iteration)
    if mesh is not None and mesh.rank > 0:
        return np.random.default_rng([seed, mesh.rank])
    return np.random.default_rng(seed)


class AugmentedBatches:
    """``init_reweight``'s loader on the device-augment route: the
    loader's canvases augmented on the device at the model's size from a
    stream of their own, never mixed (the reference initialises before it
    turns mixup on)."""

    def __init__(self, loader, device, out_size: int, out_dtype=None,
                 mesh=None):
        import torch

        self.loader = loader
        self.device = device
        self.out_size = out_size
        self.out_dtype = out_dtype
        self.mesh = mesh
        self.gen = torch.Generator(device=device)
        self.i = 0

    def next(self):
        from ct_tpu_torch.train.step import batch_to

        self.i += 1
        return device_augmented(self.gen, seed_of(REWEIGHT_STREAM, self.i),
                                batch_to(self.loader.next(), self.device),
                                self.out_size, self.out_dtype, self.mesh)


def load_or_resume(args, ck, async_ck, model, optimizer, scheduler) -> int:
    """train.py's dispatch: with ``--orbax``, ``--resume`` and an
    asynchronous checkpoint, phase 1 resumes from the newest (model,
    optimizer, schedule); otherwise ``Checkpointer.resume_or_load`` of the
    basenet (phase 1) or ``--load-file`` (phase 2). Returns the iteration
    the state ended at, -1 for a fresh start."""
    if (async_ck is not None and args.resume and async_ck.has_checkpoint()
            and args.phase == 1):
        return async_ck.resume(model, optimizer, scheduler)
    return ck.resume_or_load(
        args.basenet if args.phase == 1 else args.load_file, model,
        optimizer, scheduler, resume=args.resume,
        load_optimizer=args.phase == 1)


def main(argv=None) -> dict:
    """Train; returns the last iteration's losses and lr (rank 0's where
    it spawned the data-parallel workers)."""
    from ct_tpu_torch.parallel import distributed
    from ct_tpu_torch.utils.logger import close_logger, setup_logger

    args = parse_args(argv)
    check_ported(args)
    if args.accum_steps > 1 and args.batch_size % args.accum_steps:
        raise SystemExit("--batch-size must divide by --accum-steps")
    entry = distributed.cli_entry(
        args.ndev, args.device, "ct_tpu_torch.train.cli:main",
        sys.argv[1:] if argv is None else argv, args.batch_size)
    if entry.launched:
        return entry.result
    os.makedirs(args.save_folder, exist_ok=True)
    setup_logger(args.save_folder)
    try:
        return train(args)
    finally:
        close_logger()
        distributed.leave(entry)


def train(args) -> dict:
    """The training run of ``main`` in this process (one rank of a group,
    where one is initialised)."""
    import torch

    from ct_tpu_torch import resolve_device
    from ct_tpu_torch.config import (
        EXPAND_PROB, OVERLAP_THRESHOLD, RGB_MEANS, get_config, resolve_task,
    )
    from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment
    from ct_tpu_torch.data.augment_device import mixup_batch
    from ct_tpu_torch.data.loader import Loader
    from ct_tpu_torch.models.init import init_like_jax
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.distributed import rank_device
    from ct_tpu_torch.parallel.mesh import make_mesh, replicate
    from ct_tpu_torch.train.async_ckpt import AsyncCheckpointer
    from ct_tpu_torch.train.checkpointer import (
        Checkpointer, PeriodicCheckpointer,
    )
    from ct_tpu_torch.train.events import (
        CommonMetricPrinter, EventStorage, JSONWriter, TensorboardWriter,
    )
    from ct_tpu_torch.train.reweight import init_reweight
    from ct_tpu_torch.train.solver import (
        SolverConfig, build_optimizer, warmup_multistep_schedule,
    )
    from ct_tpu_torch.train.step import (
        LOSS_KEYS, TrainState, batch_to, make_train_step,
    )
    from ct_tpu_torch.utils.profiler import StepTimer, annotate, trace

    device = resolve_device(args.device)
    if torch.distributed.is_initialized():
        device = rank_device(device)
    mesh = make_mesh(device=device)
    if args.batch_size // mesh.world_size % args.accum_steps:
        raise SystemExit(f"--batch-size {args.batch_size} must divide over "
                         f"{mesh.world_size} ranks of --accum-steps "
                         f"{args.accum_steps} micro-batches")
    logger.info("Mesh: %d rank(s) (%s), this one %d on %s", mesh.world_size,
                torch.distributed.get_backend() if mesh.group else "no group",
                mesh.rank, device)
    if device.type == "cuda":
        # float32 products in float32, and bf16 ones summed in float32
        # (preferred_element_type=float32 in the JAX package)
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    img_dim = 512 if args.size == "512" else 300
    task = resolve_task(args.phase, args.setting, args.method, args.dataset)
    priors = prior_boxes(get_config(args.dataset, img_dim), device)
    solver_cfg = SolverConfig(lr=args.lr, momentum=args.momentum,
                              weight_decay=args.weight_decay,
                              gamma=args.gamma, steps=tuple(args.steps),
                              warmup_iters=args.warmup_iter)
    schedule = warmup_multistep_schedule(solver_cfg)

    preproc = (RawCanvasTransform(args.canvas) if args.device_augment
               else TrainAugment(img_dim, RGB_MEANS, EXPAND_PROB))
    dataset = training_set(args, preproc)

    # the reference's switch between the CT attention's two backwards
    ct_flash = os.environ.get("CT_ATTENTION_FLASH", "1") != "0"
    logger.info("CT attention backward: %s",
                "flash" if ct_flash else "blockwise (CT_ATTENTION_FLASH=0)")
    # the JAX package's initialisers (train.py's init_train_state) for
    # whatever the basenet or --load-file does not overwrite
    model = init_like_jax(
        build_net(task, img_dim, device=device, ct_flash=ct_flash,
                  dtype=dtype), torch.Generator().manual_seed(0)).train()
    optimizer, scheduler = build_optimizer(model, task, solver_cfg,
                                           fused=args.fused_opt == "on")
    ck = Checkpointer(args.save_folder)
    async_ck = (AsyncCheckpointer(os.path.join(args.save_folder, "orbax"))
                if args.orbax else None)
    last = load_or_resume(args, ck, async_ck, model, optimizer, scheduler)
    replicate(mesh, model)
    start_iter = last + 1
    state = TrainState(model, optimizer, scheduler, start_iter)
    step_fn = make_train_step(priors, OVERLAP_THRESHOLD,
                              accum_steps=args.accum_steps, mesh=mesh)
    periodic = PeriodicCheckpointer(async_ck or ck, args.checkpoint_period,
                                    args.max_iter)

    loader = Loader(dataset, args.batch_size, num_workers=args.num_workers,
                    max_objs=args.max_objs, seed=0, workers=args.worker_type,
                    rank=mesh.rank, world=mesh.world_size)
    writers = [CommonMetricPrinter(args.max_iter),
               JSONWriter(os.path.join(args.save_folder, "metrics.json")),
               TensorboardWriter(args.save_folder)] if mesh.is_primary else []
    storage = EventStorage(start_iter)
    timer = StepTimer()
    aug_gen = torch.Generator(device=device)
    zero_ignored = args.setting == "incre" or args.instance_shot
    device_mixup = False
    profiler_ctx = None
    # The losses stay on the device, one stacked vector per iteration, and
    # are fetched together at the write points: the loop never waits for
    # the card to finish a step.
    metric_keys = LOSS_KEYS + ("total_loss",)
    pending = []          # [(iteration, metric_keys' values on the device)]
    result = {}

    def flush_metrics():
        if not pending:
            return
        host = torch.stack([m for _, m in pending]).cpu().tolist()
        for (it, _), vals in zip(pending, host):
            losses = dict(zip(metric_keys, vals))
            storage.put_scalars(iteration=it, **losses)
            storage.put_scalar("lr", schedule(it), smoothing_hint=False,
                               iteration=it)
            result.update(iteration=it, **losses, lr=schedule(it))
        pending.clear()

    try:
        if task.has_ct_head:
            rw_loader = (AugmentedBatches(loader, device, img_dim, dtype,
                                          mesh)
                         if args.device_augment else loader)
            init_reweight(model, rw_loader, priors, task, args.init_iter,
                          mesh=mesh)
            if args.mixup and args.device_augment:
                device_mixup = True   # batch-level, after the augmentation
            elif args.mixup:
                dataset.set_mixup(np.random.beta, 1.5, 1.5)
                loader.restart()
            logger.info("Fine tuning on %d-shot task", args.shot)
        logger.info("Starting training from iteration %d", start_iter)
        for iteration in range(start_iter, args.max_iter):
            storage.step()
            if args.profile_dir is not None and mesh.is_primary:
                if iteration == start_iter + 10:
                    profiler_ctx = trace(args.profile_dir)
                    profiler_ctx.__enter__()
                elif iteration == start_iter + 15 and profiler_ctx is not None:
                    profiler_ctx.__exit__(None, None, None)
                    profiler_ctx = None
                    logger.info("Profiler trace written to %s",
                                args.profile_dir)
            if (task.has_ct_head and args.mixup and iteration
                    == args.max_iter - args.no_mixup_iter):
                if device_mixup:
                    device_mixup = False
                else:
                    dataset.set_mixup(None)
                    loader.restart()
            with annotate("data"):
                t0 = time.perf_counter()
                batch = loader.next()
                storage.put_scalar("data_time", time.perf_counter() - t0)
                batch = batch_to(batch, device)
            if args.device_augment:
                with annotate("augment"):
                    batch = device_augmented(
                        aug_gen, seed_of(AUGMENT_STREAM, iteration), batch,
                        img_dim, dtype, mesh)
                    if device_mixup:
                        batch = mixup_batch(mixup_rng(iteration, mesh),
                                            batch, zero_ignored=zero_ignored)
            with annotate("step"):
                losses = step_fn(state, batch)
            pending.append((iteration,
                            torch.stack([losses[k] for k in metric_keys])))
            dt = timer.tick()
            if dt is not None:
                storage.put_scalar("time", dt)
            if is_write_point(iteration, start_iter, args.max_iter):
                flush_metrics()
                for w in writers:
                    w.write(storage)
            periodic.step(iteration, model=model, optimizer=optimizer,
                          scheduler=scheduler)
        flush_metrics()
    finally:
        if profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)
        if async_ck is not None:
            async_ck.wait()   # drain the save in flight before exiting
        loader.stop()
        for w in writers[1:]:
            w.close()
    return result
