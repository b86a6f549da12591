"""Input-pipeline rates: loader → device augmentation → train step.

The port of ``scripts/bench_pipeline.py``:

    python -m ct_tpu_torch.scripts.bench_pipeline [--device cuda|cpu]
        [--batch-size 64] [--iters 20] [--workers N] [--mixup]

On the VOC images under ``VOC_ROOT`` (default ``.parity_p2/voc/VOCdevkit``,
JPEG decode and XML parse included; VOC2007 ``trainval_split1``, the
phase-1 list), in images/s:

  1. ``host_augment``: the loader with the host augmentation
     (``TrainAugment``, the reference's DataLoader-worker path);
  2. ``raw_canvas``: the loader of the device route (``RawCanvasTransform``:
     decode and a resize to a 384² canvas only);
  3. ``end_to_end``: the device route's loader → copy to the device →
     ``augment_batch`` (``--mixup``: and ``mixup_batch``) → a phase-2
     transfer ``ours`` train step from seeded weights, at 300 on the card
     (64 on the CPU), f32 with TF32 off as the train CLI runs it, steady
     state after 3 iterations.

Also ``augment_ms``: the device augmentation (and mixup) of one batch
alone. Prints one JSON line with the device's name; on the CPU the
numbers are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ct_tpu_torch import resolve_device
from ct_tpu_torch.scripts import device_name
from ct_tpu_torch.utils.timing import fetch_sync, time_calls

DEFAULT_ROOT = os.path.join(".parity_p2", "voc", "VOCdevkit")
CANVAS = 384
WARMUP = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--workers", type=int, default=max(1, os.cpu_count()))
    ap.add_argument("--mixup", action="store_true")
    return ap.parse_args(argv)


def loader_rate(loader, batch_size: int, iters: int) -> float:
    for _ in range(WARMUP):
        loader.next()
    t0 = time.perf_counter()
    for _ in range(iters):
        loader.next()
    return batch_size * iters / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    """Run the bench; returns the rates (images/s) and ``augment_ms``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":     # the train CLI's f32: TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from ct_tpu_torch.config import (
        EXPAND_PROB, RGB_MEANS, TINY_64, VOC_300, resolve_task,
    )
    from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment
    from ct_tpu_torch.data.augment_device import mixup_batch
    from ct_tpu_torch.data.loader import Loader
    from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.cli import device_augmented
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, batch_to, make_train_step

    root = os.environ.get("VOC_ROOT", DEFAULT_ROOT)

    def make_loader(preproc):
        ds = VOCDetection(root, [("2007", "trainval")], preproc,
                          AnnotationTransform(0), phase=1,
                          setting="transfer", split=1)
        return Loader(ds, args.batch_size, num_workers=args.workers,
                      max_objs=16, seed=0)

    res = {"device": device_name(device), "batch": args.batch_size,
           "workers": args.workers, "iters": args.iters,
           "mixup": args.mixup}
    loader = make_loader(TrainAugment(300, RGB_MEANS, EXPAND_PROB))
    try:
        res["host_augment"] = loader_rate(loader, args.batch_size,
                                          args.iters)
    finally:
        loader.stop()

    loader = make_loader(RawCanvasTransform(CANVAS))
    try:
        res["raw_canvas"] = loader_rate(loader, args.batch_size, args.iters)

        size = 300 if device.type == "cuda" else 64
        task = resolve_task(2, "transfer", "ours", "VOC")
        torch.manual_seed(0)
        model = build_net(task, size, device=device).train()
        optimizer, scheduler = build_optimizer(
            model, task, SolverConfig(lr=1e-3, steps=(10**6,),
                                      warmup_iters=0))
        state = TrainState(model, optimizer, scheduler)
        step = make_train_step(prior_boxes(VOC_300 if size == 300
                                           else TINY_64, device))
        gen = torch.Generator(device=device)

        def augment(i, batch):
            out = device_augmented(gen, i, batch, size)
            if args.mixup:
                out = mixup_batch(np.random.default_rng(i), out)
            return out

        def run_iter(i):
            return step(state, augment(i, batch_to(loader.next(), device)))

        for i in range(WARMUP):
            fetch_sync(run_iter(i))
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = run_iter(WARMUP + i)
        fetch_sync(out)
        res["end_to_end"] = (args.batch_size * args.iters
                             / (time.perf_counter() - t0))
        batch = batch_to(loader.next(), device)
        res["augment_ms"] = 1e3 * time_calls(augment, (0, batch), iters=5)
    finally:
        loader.stop()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
