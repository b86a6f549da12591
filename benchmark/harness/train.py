"""A training cell: the program's train step, fed from the card.

Set-up builds the system under test as the train CLI does
(``ct_tpu_torch.train``): the detector in train mode from the
configuration's weights, in bf16 where the cell says so, SGD with its
per-group learning rates (``build_optimizer``, per-leaf as the CLI's
default), and ``ct_tpu_torch.train.step.make_train_step`` with the cell's
gradient accumulation. The trainval images live on the card as uint8,
resized to the input size, with their boxes padded; each step gathers its
batch there at indices drawn from the seed (no augmentation; every box
labelled) and subtracts the mean.

Traffic (``kind: train``): steps dispatched back to back; the host reads
the loss every 20 steps, as the train CLI does at its write points; the
window ends in a synchronize. The first three steps run in set-up on
batches of distinct images and are the ones the reference follows; a few
more warm the card before the window.

With ``--trace 1`` a profiler session covers a few steps from 60% of the
window on, and the window ends with them.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import arith, judge, program
from benchmark.harness.data import BGR_MEANS, padded_targets
from benchmark.harness.record import Phases, Run
from benchmark.harness.trace import Profiler, Spans
from benchmark.reference import post
from benchmark.reference.model import Numerics
from benchmark.reference.train import Trainer

CHECKED_STEPS = 3
READ_EVERY = 20
WEIGHT_DECAY = 5e-4


class Feed:
    """The resident fixture and the seed's batch order."""

    def __init__(self, images, batch: int, max_objs: int, seed: int,
                 device):
        t = padded_targets(images, max_objs)
        self.data = {
            "image": torch.from_numpy(images.pixels).permute(0, 3, 1, 2)
            .contiguous().to(device),
            **{k: torch.from_numpy(v).to(device) for k, v in t.items()}}
        n = len(images.sizes)
        rng = np.random.default_rng([seed, 5])
        epochs = -(-batch * 4096 // n)
        order = np.concatenate([rng.permutation(n) for _ in range(epochs)])
        self.table = torch.from_numpy(order[:batch * 4096].reshape(
            4096, batch)).to(device)
        self.means = torch.tensor(BGR_MEANS, device=device)[None, :, None,
                                                             None]

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        idx = self.table[i % len(self.table)]
        out = {k: v.index_select(0, idx) for k, v in self.data.items()}
        out["image"] = out["image"].float() - self.means
        out["weights"] = out["valid"].float()
        return out


def drive(cell, seed: int, seconds: float, trace: bool, device, inputs,
          t_start: float) -> Run:
    """One run of a training cell (module docstring)."""
    cfg, traffic, opt = cell.config, cell.traffic, cell.workload["program"]
    batch = traffic["batch"]
    phases = Phases(t_start)
    phases("start")
    state = inputs.state(cell, seed, device)
    phases("weights")
    images = inputs.trainval(cell)
    phases("images")
    feed = Feed(images, batch, traffic["max_objs"], seed, device)
    phases("resident")
    ts, step = program.training(cell, state, device)
    phases("program")
    names = [n for n, _ in ts.model.named_parameters()]
    p0 = {n: state[n].to(device, torch.float32) for n in names}

    losses, grad = [], {}
    for i in range(CHECKED_STEPS):
        out = step(ts, feed(i))
        losses.append(float(out["total_loss"]))
        if i == 0:
            # SGD's buffer after its first step is g + decay·p; an
            # optimizer that kept none took no gradient
            grad = {n: ts.optimizer.state[p].get(
                        "momentum_buffer", WEIGHT_DECAY * p0[n])
                    - WEIGHT_DECAY * p0[n]
                    for n, p in ts.model.named_parameters()}
    change = {n: p.detach().float() - p0[n]
              for n, p in ts.model.named_parameters()}
    n_setup = CHECKED_STEPS + traffic["warmup_steps"]
    for i in range(CHECKED_STEPS, n_setup):
        step(ts, feed(i))
    float(out["total_loss"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases("first steps")
    setup_s = time.perf_counter() - t_start

    prof, traced, mark_at, untraced_step_s = None, None, -1, None
    span = Spans()
    failed, done = 0, 0
    t0 = time.perf_counter()
    while True:
        with span("bench.feed"):
            b = feed(n_setup + done)
        with span("bench.step"):
            out = step(ts, b)
        done += 1
        if done % READ_EVERY == 0:
            with span("bench.read"):
                failed += not math.isfinite(float(out["total_loss"]))
        elapsed = time.perf_counter() - t0
        if not trace:
            if elapsed >= seconds:
                break
            continue
        # the traced run: the steps before 60% of the window set the wall
        # time of a step without the profiler; then a session over
        # traffic["traced_steps"] steps, and the window ends with them
        if prof is None and elapsed >= seconds * 0.6:
            if device.type == "cuda":
                torch.cuda.synchronize()
            untraced_step_s = (time.perf_counter() - t0) / done
            prof = Profiler(span)
            prof.start()
            mark_at = done + 2
        if prof is not None and done == mark_at:
            prof.mark()
        if prof is not None and done == mark_at + traffic["traced_steps"]:
            prof.mark()
            break
    failed += not math.isfinite(float(out["total_loss"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None:
        traced = prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del ts, step, out, b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    task = inputs.task(cell)
    t_check = time.perf_counter()
    checks = judge_training(cell, state, feed, losses, grad, change, device,
                            task)
    flops = arith.forward_flops(state, task, cfg["size"])
    micro = batch // opt["accum_steps"]
    shapes = dict(size=cfg["size"], batch=batch, micro=micro,
                  accum=opt["accum_steps"], priors=flops["priors"],
                  keys=flops["keys"], classes=task.src_classes,
                  novel=task.num_novel, bf16=opt["bf16"],
                  traced_steps=traffic["traced_steps"],
                  untraced_step_s=untraced_step_s)
    return Run(kind="train", setup_s=setup_s, window_s=window_s,
               attempted=done, failed=failed, latencies_s=[], service_s=[],
               images=done * batch, shapes=shapes, flops=flops,
               event_ms={}, trace=traced, memory_peak=peak, checks=checks,
               checks_s=time.perf_counter() - t_check)


def reference_steps(cell, state, feed, device, task, control: bool = False):
    """The plain reference's first three steps on the same batches →
    (losses, first gradient, change over the three), by parameter.
    ``control``: its convs and dense layers on operands rounded to float8
    e4m3, one precision below the cell's bf16."""
    cfg, opt = cell.config, cell.workload["program"]
    trainer = Trainer({k: v.to(device) for k, v in state.items()},
                      dict(task=task, size=cfg["size"]), lr=opt["lr"],
                      weight_decay=WEIGHT_DECAY, accum=opt["accum_steps"])
    p0 = {k: v.detach().clone() for k, v in trainer.params.items()}
    pri = post.priors(cfg["size"]).to(device)
    numerics = Numerics("fp8") if control else None
    losses, grad = [], {}
    for i in range(CHECKED_STEPS):
        loss, g = trainer.loss_and_grads(feed(i), pri, numerics)
        losses.append(loss)
        if i == 0:
            grad = g
        trainer.update()
    change = {k: trainer.params[k].detach() - p0[k] for k in p0}
    return losses, grad, change


def judge_training(cell, state, feed, losses, grad, change, device,
                   task) -> Dict[str, float]:
    ref = reference_steps(cell, state, feed, device, task)
    return judge.train_numbers(losses, ref[0], grad, ref[1], change, ref[2])


def control(cell, seed: int, inputs, device) -> Dict[str, float]:
    """The control's numbers on ``seed``'s inputs: the reference's steps
    with float8 operands judged against its own steps, as the program's
    are."""
    task = inputs.task(cell)
    state = inputs.state(cell, seed, device)
    feed = Feed(inputs.trainval(cell), cell.traffic["batch"],
                cell.traffic["max_objs"], seed, device)
    low = reference_steps(cell, state, feed, device, task, True)
    ref = reference_steps(cell, state, feed, device, task)
    return judge.train_numbers(low[0], ref[0], low[1], ref[1], low[2],
                               ref[2])
