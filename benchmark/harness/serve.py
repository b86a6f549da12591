"""A serving cell: the program's eval step served at a fixed rate.

Set-up builds the system under test as the eval CLI does
(``ct_tpu_torch.test``): the detector from the configuration's weights,
in bf16 where the cell says so, and with ``int8`` the serving model
(BatchNorm folded, int8 calibrated on trainval images drawn by the seed,
quantized, int8 chained across the trunk's pools); then
``ct_tpu_torch.eval.make_eval_step`` with the cell's NMS options. Request
payloads are batches of test images (resized, mean subtracted, float32,
in pinned host memory), a fixed number of distinct batches drawn by the
seed and sent in turn.

Traffic (``kind: serve``): an open loop with one request in flight.
Request i is due at the sum of the gaps before it; the gaps are the same
set in every run (``1/rate`` times an even spread of ``1 ± spread``),
shuffled by the seed, so every seed offers the same load in another
order. A request's latency runs from when it was due to when its
detections are on the host: the wait behind the request before it, the
copy to the card, the step, the copy back. Below the knee every request
due in the window is served and judged. Above it (``close_at_window``)
the backlog grows all through the window: a request not started when
the window closes is not sent, and the window ends with the last answer.

With ``--trace 1`` CUDA events mark the start and end of the model's
forward (hooks on the module ``make_eval_step`` calls) and the step's
return: forward, then scores and post-processing. A profiler session
covers a stretch of requests: the window's last ones at a fixed rate,
with a backlog the first after 60% of the window (the window then ends
with them).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import arith, judge, program
from benchmark.harness.data import normalized
from benchmark.harness.record import Phases, Run
from benchmark.harness.trace import Profiler, Spans
from benchmark.reference import post
from benchmark.reference.model import Model, Numerics, calibrate, fold_bn

CHUNK = 16      # images a reference forward takes at once


def schedule(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of the window's requests."""
    n = max(1, int(round(seconds * traffic["rate_per_s"])))
    spread = traffic["gap_spread"]
    gaps = np.linspace(1 - spread, 1 + spread, n) / traffic["rate_per_s"]
    gaps = np.random.default_rng([seed, 1]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Payloads:
    """The distinct request batches: float32 NCHW images (pinned on a
    card) and their original (h, w)."""

    def __init__(self, images, traffic: dict, seed: int, device):
        b, n = traffic["batch"], traffic["distinct_batches"]
        order = np.random.default_rng([seed, 2]).permutation(
            len(images.sizes))
        self.index = [order[(j * b + np.arange(b)) % len(order)]
                      for j in range(n)]
        pin = device.type == "cuda"
        self.x = [torch.from_numpy(normalized(images.pixels[i])) for i in
                  self.index]
        self.hw = [torch.from_numpy(images.sizes[i]) for i in self.index]
        if pin:
            self.x = [t.pin_memory() for t in self.x]
            self.hw = [t.pin_memory() for t in self.hw]
        self.turn = np.random.default_rng([seed, 3]).permutation(n)

    def of(self, i: int) -> int:
        """The batch request i carries."""
        return int(self.turn[i % len(self.turn)])


def timed(step, net, events):
    """``step`` with CUDA events at the start and end of ``net``'s forward
    and once the step has returned, appended to ``events`` a request."""
    marks = []

    def mark(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    net.register_forward_pre_hook(mark)
    net.register_forward_hook(mark)

    def run(images, sizes):
        dets = step(images, sizes)
        mark()
        events.append(tuple(marks[-3:]))
        marks.clear()
        return dets

    return run


def drive(cell, seed: int, seconds: float, trace: bool, device,
          inputs, t_start: float) -> Run:
    """One run of a serving cell (module docstring)."""
    cfg, traffic, opt = cell.config, cell.traffic, cell.workload["program"]
    size = cfg["size"]
    phases = Phases(t_start)
    phases("start")
    state = inputs.state(cell, seed, device)
    phases("weights")
    calib_x = inputs.calibration(cell, seed) if opt["int8"] else None
    test = inputs.test(cell)
    phases("images")
    payloads = Payloads(test, traffic, seed, device)
    phases("payloads")
    net, priors, step = program.serving(cell, state, calib_x, device)
    phases("program")
    events = []
    if trace and device.type == "cuda":
        step = timed(step, net, events)
    spans = Spans()
    for i in range(traffic["warmup_requests"]):
        _request(step, payloads, i, device, spans)
    events.clear()
    due = schedule(traffic, seed, seconds)
    phases("warm-up")
    setup_s = time.perf_counter() - t_start

    if trace and len(due) < 3:
        raise ValueError("a traced run needs three requests or more")
    prof = Profiler(spans) if trace else None
    backlog = traffic.get("close_at_window", False)
    n_traced = traffic["traced_requests"]
    # the profiler opens two requests before the traced stretch
    open_at = None if backlog else max(0, len(due) - n_traced - 2)
    answers, latency, service = [], [], []
    failed, untraced_rate = 0, None
    t0 = time.perf_counter()
    for i, d in enumerate(due):
        now = time.perf_counter() - t0
        if prof is not None:
            if open_at is None and now >= 0.6 * seconds:
                open_at = i
            if i == open_at:
                # images a second before the profiler opened: the traced
                # run's rate without the profiler's start and its work
                untraced_rate = (traffic["batch"] * i
                                 / (time.perf_counter() - t0)) if i else None
                prof.start()
            if open_at is not None and i == open_at + 2:
                prof.mark()
            if backlog and open_at is not None and (
                    i == open_at + 2 + n_traced):
                break
        elif backlog and now >= seconds:
            break
        with spans("bench.wait"):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        start = time.perf_counter()
        try:
            dets = _request(step, payloads, i, device, spans)
        except RuntimeError as err:        # a request the program refused
            print(f"request {i} failed: {err}", file=sys.stderr)
            dets = None
        done = time.perf_counter()
        ok = dets is not None and all(np.isfinite(t).all() for t in dets[:2])
        failed += not ok
        latency.append(done - (t0 + d) if ok else math.inf)
        service.append(done - start)
        answers.append((payloads.of(i), dets))
    window_s = time.perf_counter() - t0
    traced = None
    if prof is not None:
        prof.mark()
        traced = prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    event_ms = {"forward": [], "postprocess": []}
    for e0, e1, e2 in events:
        event_ms["forward"].append(e0.elapsed_time(e1))
        event_ms["postprocess"].append(e1.elapsed_time(e2))
    del net, step, events
    if device.type == "cuda":
        torch.cuda.empty_cache()

    task = inputs.task(cell)
    flops = arith.forward_flops(state, task, size)
    t_check = time.perf_counter()
    checks = judge_serving(cell, state, calib_x, payloads, answers, device,
                           task)
    shapes = dict(size=size, batch=traffic["batch"], priors=flops["priors"],
                  keys=flops["keys"], classes=task.src_classes,
                  novel=task.num_novel, int8=opt["int8"], bf16=opt["bf16"],
                  untraced_images_per_s=untraced_rate)
    return Run(kind="serve", setup_s=setup_s, window_s=window_s,
               attempted=len(answers), failed=failed, latencies_s=latency,
               service_s=service,
               images=traffic["batch"] * (len(answers) - failed),
               shapes=shapes, flops=flops,
               event_ms=event_ms, trace=traced,
               memory_peak=peak, checks=checks,
               checks_s=time.perf_counter() - t_check)


def _request(step, payloads, i, device, span):
    """Copy request i's batch to the card, run the step, fetch the
    detections: (boxes, scores, classes, valid) as numpy."""
    j = payloads.of(i)
    with span("bench.copy"):
        x = payloads.x[j].to(device, non_blocking=True)
        hw = payloads.hw[j].to(device, non_blocking=True)
    with span("bench.step"):
        dets = step(x, hw)
    with span("bench.fetch"):
        return tuple(t.cpu().numpy() for t in dets)


def reference_batches(cell, state, calib_x, payloads, used, device, task,
                      control: bool = False):
    """The plain reference's dense output and detections of each request
    batch in ``used``. ``control``: one precision below the cell's, int4
    for an int8 model and float8 e4m3 for a bf16 one."""
    cfg, opt = cell.config, cell.workload["program"]
    size = cfg["size"]
    state = {k: v.to(device) for k, v in state.items()}
    if opt["int8"]:
        folded = fold_bn(state)
        absmax = calibrate(folded, task, size, [calib_x.to(device)])
        model = Model(folded, task, size, folded=True, numerics=Numerics(
            "int", 4 if control else 8, absmax,
            quantize_heads=opt["int8_heads"]))
    else:
        model = Model(state, task, size,
                      numerics=Numerics("fp8" if control else "float"))
    pri = post.priors(size).to(device)
    out = {}
    with torch.no_grad():
        for j in used:
            x = payloads.x[j].to(device)
            hw = payloads.hw[j].to(device)
            boxes, fused = [], []
            for c in range(0, x.shape[0], CHUNK):
                preds = model.forward(x[c:c + CHUNK])
                boxes.append(post.pixel_boxes(preds.loc, pri,
                                              hw[c:c + CHUNK]))
                fused.append(post.fuse(*_softmax(preds)))
            boxes, fused = torch.cat(boxes), torch.cat(fused)
            dets = post.detect(boxes, fused, opt["top_k"], opt["approx_topk"],
                               opt["pool_size"])
            out[j] = {"dense": (boxes, fused), "ref": tuple(dets)}
    return out


def _softmax(preds):
    return torch.softmax(preds.conf, -1), torch.softmax(preds.obj, -1)


def judge_serving(cell, state, calib_x, payloads, answers, device, task,
                  control: bool = False) -> Dict[str, float]:
    """The serving numbers over every answered request (identical answers
    judged once)."""
    unique: Dict[tuple, tuple] = {}
    for j, dets in answers:
        if dets is None:
            continue
        key = (j,) + tuple(hash(t.tobytes()) for t in dets)
        unique.setdefault(key, (j, dets))
    ref = reference_batches(cell, state, calib_x, payloads,
                            sorted({j for j, _ in unique.values()}), device,
                            task, control)
    items = []
    for j, dets in unique.values():
        prog = tuple(torch.from_numpy(t).to(device) for t in dets)
        items.append({"prog": prog, **ref[j]})
    return judge.serve_numbers(items)


def control(cell, seed: int, inputs, device) -> Dict[str, float]:
    """The control's numbers on ``seed``'s inputs: the reference one
    precision below the cell's, on every distinct request batch, judged
    against the reference as the program's answers are."""
    task = inputs.task(cell)
    state = inputs.state(cell, seed, device)
    calib_x = (inputs.calibration(cell, seed)
               if cell.workload["program"]["int8"] else None)
    payloads = Payloads(inputs.test(cell), cell.traffic, seed, device)
    used = range(len(payloads.x))
    low = reference_batches(cell, state, calib_x, payloads, used, device,
                            task, control=True)
    ref = reference_batches(cell, state, calib_x, payloads, used, device,
                            task)
    return judge.serve_numbers([{"prog": low[j]["ref"], **ref[j]}
                                for j in used])
