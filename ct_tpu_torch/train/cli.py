"""Training CLI of the port: the flags of ``train.py``, plus ``--device``.

    python -m ct_tpu_torch.train -d VOC -p 2 --setting incre --split 1 \\
        --shot 5 --mixup --load-file weights/phase1.pth \\
        --save-folder weights/ [--device-augment --canvas 384] [--bf16] \\
        [--profile-dir trace/] [--device cuda|cpu]
    python -m ct_tpu_torch.train -d COCO -p 1 --setting transfer \\
        --save-folder weights/ [--worker-type process]

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
``main``. Flags of what the port does not run yet raise and name the
ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("ct_tpu_torch.train")

# flag → (is it set?, the ROADMAP item that will port it)
UNPORTED = (
    ("--orbax", lambda a: a.orbax, "Queue 1 item 8 (async checkpoints)"),
    ("--pallas-ct", lambda a: a.pallas_ct is not None,
     "none: the port always runs its CT kernels on the card"),
    ("--fused-opt on", lambda a: a.fused_opt == "on",
     "Queue 1 item 4 (fused optimizer)"),
    ("--accum-steps > 1", lambda a: a.accum_steps > 1,
     "Queue 1 item 4 (gradient accumulation)"),
    ("--ndev > 1", lambda a: a.ndev > 1,
     "Queue 1 item 8 (data-parallel training)"),
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
                        help="Devices (one card only in the port)")
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
    # flags of train.py that the port does not run yet: each raises
    parser.add_argument("--pallas-ct", choices=["auto", "on", "off"],
                        default=None)
    parser.add_argument("--orbax", action="store_true")
    parser.add_argument("--fused-opt", choices=["on", "off"], default="off")
    parser.add_argument("--accum-steps", type=int, default=1)
    return parser.parse_args(argv)


def check_ported(args, unported=UNPORTED) -> None:
    """Raise on the first flag of ``unported`` that ``args`` sets, naming
    the ROADMAP item that will port it."""
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
                     out_dtype=None) -> dict:
    """A batch on the device, augmented there from ``gen`` seeded with
    ``seed`` (images in ``out_dtype``, the model's compute type as
    train.py's ``out_dtype``; float32 by default), its weights carried
    over."""
    from ct_tpu_torch.data.augment_device import augment_batch

    gen.manual_seed(seed)
    return dict(augment_batch(gen, batch["image"], batch["boxes"],
                              batch["labels"], batch["valid"],
                              out_size=out_size, out_dtype=out_dtype),
                weights=batch["weights"])


class AugmentedBatches:
    """``init_reweight``'s loader on the device-augment route: the
    loader's canvases augmented on the device at the model's size from a
    stream of their own, never mixed (the reference initialises before it
    turns mixup on)."""

    def __init__(self, loader, device, out_size: int, out_dtype=None):
        import torch

        self.loader = loader
        self.device = device
        self.out_size = out_size
        self.out_dtype = out_dtype
        self.gen = torch.Generator(device=device)
        self.i = 0

    def next(self):
        from ct_tpu_torch.train.step import batch_to

        self.i += 1
        return device_augmented(self.gen, seed_of(REWEIGHT_STREAM, self.i),
                                batch_to(self.loader.next(), self.device),
                                self.out_size, self.out_dtype)


def main(argv=None) -> dict:
    """Train; returns the last iteration's losses and lr."""
    args = parse_args(argv)
    check_ported(args)

    import torch

    from ct_tpu_torch import resolve_device
    from ct_tpu_torch.config import (
        EXPAND_PROB, OVERLAP_THRESHOLD, RGB_MEANS, get_config, resolve_task,
    )
    from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment
    from ct_tpu_torch.data.augment_device import mixup_batch
    from ct_tpu_torch.data.loader import Loader
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
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

    os.makedirs(args.save_folder, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(args.save_folder,
                                                   "log.txt"))],
        force=True)

    device = resolve_device(args.device)
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
    torch.manual_seed(0)
    model = build_net(task, img_dim, device=device, ct_flash=ct_flash,
                      dtype=dtype).train()
    optimizer, scheduler = build_optimizer(model, task, solver_cfg)
    ck = Checkpointer(args.save_folder)
    last = ck.resume_or_load(
        args.basenet if args.phase == 1 else args.load_file, model,
        optimizer, scheduler, resume=args.resume,
        load_optimizer=args.phase == 1)
    start_iter = last + 1
    state = TrainState(model, optimizer, scheduler, start_iter)
    step_fn = make_train_step(priors, OVERLAP_THRESHOLD)
    periodic = PeriodicCheckpointer(ck, args.checkpoint_period, args.max_iter)

    loader = Loader(dataset, args.batch_size, num_workers=args.num_workers,
                    max_objs=args.max_objs, seed=0, workers=args.worker_type)
    writers = [CommonMetricPrinter(args.max_iter),
               JSONWriter(os.path.join(args.save_folder, "metrics.json")),
               TensorboardWriter(args.save_folder)]
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
            rw_loader = (AugmentedBatches(loader, device, img_dim, dtype)
                         if args.device_augment else loader)
            init_reweight(model, rw_loader, priors, task, args.init_iter)
            if args.mixup and args.device_augment:
                device_mixup = True   # batch-level, after the augmentation
            elif args.mixup:
                dataset.set_mixup(np.random.beta, 1.5, 1.5)
                loader.restart()
            logger.info("Fine tuning on %d-shot task", args.shot)
        logger.info("Starting training from iteration %d", start_iter)
        for iteration in range(start_iter, args.max_iter):
            storage.step()
            if args.profile_dir is not None:
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
                        img_dim, dtype)
                    if device_mixup:
                        batch = mixup_batch(
                            np.random.default_rng(
                                seed_of(MIXUP_STREAM, iteration)),
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
        loader.stop()
        for w in writers[1:]:
            w.close()
    return result
