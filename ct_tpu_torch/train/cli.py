"""Training CLI of the port: the flags of ``train.py``, plus ``--device``.

    python -m ct_tpu_torch.train -d VOC -p 2 --setting incre --split 1 \\
        --shot 5 --mixup --load-file weights/phase1.pth \\
        --save-folder weights/ [--device cuda|cpu]

The same phase/setting/method state machine as ``train.py``: the training
set of the few-shot protocol, weights loaded from ``--basenet`` (phase 1)
or ``--load-file`` (phase 2, weights only) or resumed from the newest
checkpoint with ``--resume``, the ``OBJ_Target`` initialisation over
``--init-iter`` batches before mixup is turned on (phase 2 ``ours``),
mixup off for the last ``--no-mixup-iter`` iterations, checkpoints every
``--checkpoint-period`` iterations and at the end (``.pth``, which the
port's eval CLI loads), one loss line per iteration on the log and the
same keys as one JSON line per iteration in ``metrics.json``.

The VOC root comes from ``VOC_ROOT`` (default ``data/VOCdevkit``). Flags of
what the port does not run yet raise and name the ROADMAP item that will
port it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

logger = logging.getLogger("ct_tpu_torch.train")

# flag → (is it set?, the ROADMAP item that will port it)
UNPORTED = (
    ("--bf16", lambda a: a.bf16, "Queue 1 item 4 (bf16 training)"),
    ("--device-augment", lambda a: a.device_augment,
     "Queue 1 item 6 (device augmentation)"),
    ("--canvas", lambda a: a.canvas is not None,
     "Queue 1 item 6 (device augmentation)"),
    ("--orbax", lambda a: a.orbax, "Queue 1 item 8 (async checkpoints)"),
    ("--pallas-ct", lambda a: a.pallas_ct is not None,
     "none: the port always runs its CT kernels on the card"),
    ("--profile-dir", lambda a: a.profile_dir is not None,
     "Queue 1 item 8 (torch.profiler)"),
    ("--fused-opt on", lambda a: a.fused_opt == "on",
     "Queue 1 item 4 (fused optimizer)"),
    ("--accum-steps > 1", lambda a: a.accum_steps > 1,
     "Queue 1 item 4 (gradient accumulation)"),
    ("--ndev > 1", lambda a: a.ndev > 1,
     "Queue 1 item 8 (data-parallel training)"),
    ("--worker-type process", lambda a: a.worker_type == "process",
     "Queue 1 item 5 (process workers)"),
    ("-d COCO", lambda a: a.dataset != "VOC", "Queue 1 item 5 (COCO data)"),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Context-Transformer training (PyTorch/CUDA port)")
    parser.add_argument("-s", "--size", default="300",
                        help="300 or 512 input size.")
    parser.add_argument("--basenet", default="./weights/vgg16_reducedfc.pth",
                        help="Pretrained base model (phase 1)")
    parser.add_argument("-d", "--dataset", default="VOC",
                        help="VOC (COCO is not ported).")
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
                        help="Host data-pipeline worker threads")
    parser.add_argument("--worker-type", default="thread",
                        choices=["thread", "process"],
                        help="Loader workers (threads only in the port)")
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
    # flags of train.py that the port does not run yet: each raises
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--pallas-ct", choices=["auto", "on", "off"],
                        default=None)
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--orbax", action="store_true")
    parser.add_argument("--device-augment", action="store_true")
    parser.add_argument("--canvas", type=int, default=None)
    parser.add_argument("--fused-opt", choices=["on", "off"], default="off")
    parser.add_argument("--accum-steps", type=int, default=1)
    return parser.parse_args(argv)


def check_ported(args) -> None:
    for flag, is_set, item in UNPORTED:
        if is_set(args):
            raise SystemExit(f"{flag} is not ported to ct_tpu_torch yet "
                             f"(ROADMAP: {item})")


def train_sets(args):
    if args.phase == 2 and (args.setting == "incre" or args.instance_shot):
        return [("2007", "trainval")]
    return [("2007", "trainval"), ("2012", "trainval")]


def main(argv=None) -> dict:
    """Train; returns the last iteration's losses."""
    args = parse_args(argv)
    check_ported(args)

    import torch

    from ct_tpu_torch import resolve_device
    from ct_tpu_torch.config import (
        EXPAND_PROB, OVERLAP_THRESHOLD, RGB_MEANS, get_config, resolve_task,
    )
    from ct_tpu_torch.data.augment import TrainAugment
    from ct_tpu_torch.data.loader import Loader
    from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.checkpointer import (
        Checkpointer, PeriodicCheckpointer,
    )
    from ct_tpu_torch.train.reweight import init_reweight
    from ct_tpu_torch.train.solver import (
        SolverConfig, build_optimizer, warmup_multistep_schedule,
    )
    from ct_tpu_torch.train.step import TrainState, batch_to, make_train_step

    os.makedirs(args.save_folder, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(args.save_folder,
                                                   "log.txt"))],
        force=True)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    img_dim = 512 if args.size == "512" else 300
    task = resolve_task(args.phase, args.setting, args.method, args.dataset)
    priors = prior_boxes(get_config(args.dataset, img_dim), device)
    solver_cfg = SolverConfig(lr=args.lr, momentum=args.momentum,
                              weight_decay=args.weight_decay,
                              gamma=args.gamma, steps=tuple(args.steps),
                              warmup_iters=args.warmup_iter)
    schedule = warmup_multistep_schedule(solver_cfg)

    dataset = VOCDetection(
        os.environ.get("VOC_ROOT", "data/VOCdevkit"), train_sets(args),
        TrainAugment(img_dim, RGB_MEANS, EXPAND_PROB),
        AnnotationTransform(0 if args.setting == "transfer" else args.split),
        phase=args.phase, setting=args.setting, split=args.split,
        shot=args.shot, instance_shot=args.instance_shot)

    torch.manual_seed(0)
    model = build_net(task, img_dim, device=device).train()
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
                    max_objs=args.max_objs, seed=0)
    metrics_path = os.path.join(args.save_folder, "metrics.json")
    row = {}
    try:
        if task.has_ct_head:
            init_reweight(model, loader, priors, task, args.init_iter)
            if args.mixup:
                dataset.set_mixup(np.random.beta, 1.5, 1.5)
                loader.restart()
            logger.info("Fine tuning on %d-shot task", args.shot)
        logger.info("Starting training from iteration %d", start_iter)
        with open(metrics_path, "a") as metrics:
            for iteration in range(start_iter, args.max_iter):
                if (task.has_ct_head and args.mixup and iteration
                        == args.max_iter - args.no_mixup_iter):
                    dataset.set_mixup(None)
                    loader.restart()
                batch = batch_to(loader.next(), device)
                t0 = time.perf_counter()
                losses = step_fn(state, batch)
                row = {"iteration": iteration,
                       **{k: float(v) for k, v in losses.items()
                          if k != "num_pos"},
                       "lr": schedule(iteration),
                       "time": time.perf_counter() - t0}
                logger.info("iter: %d/%d  %s", iteration, args.max_iter,
                            "  ".join(f"{k}: {v:.4g}" for k, v in row.items()
                                      if k != "iteration"))
                metrics.write(json.dumps(row) + "\n")
                metrics.flush()
                periodic.step(iteration, model=model, optimizer=optimizer,
                              scheduler=scheduler)
    finally:
        loader.stop()
    return row
