#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``ct_tpu_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Runs in phases, each printing one JSON line with its wall-clock seconds:

1. env     the card's name and power limit (nvidia-smi), CUDA and nvcc.
2. build   every CUDA source of the port, built with nvcc from csrc/,
           one nvcc each, all started together.
3. kernel  each kernel on the card against its plain PyTorch version, f32
           with TF32 off: ``ct_attention_cm`` (eval forward) at the eval
           path's shapes (B=8, C=15), at the transfer width (C=60) and at
           ragged P and K; ``ct_attention_cm_stats`` (training forward)
           and ``ct_attention_cm_bwd_flash`` (flash backward, also against
           torch autograd of the plain forward) at B=8 with C=15 and 60
           and at ragged shapes; ``pool2x2_relu`` forward and backward bit
           for bit against torch autograd on tie-heavy inputs. Each is
           timed at its path's batch (8 for eval, 64 for training): kernel,
           plain, bound and the one PyTorch call that computes the same
           function (``scaled_dot_product_attention`` forward or backward,
           ``relu(max_pool2d)`` and its autograd backward).
4. model   the phase-2 incre split-1 RFBNet300 with ``ref_model.pth`` on
           the card: 1 warm-up and 3 timed eval steps on 8 seeded images
           (images/s from the median step), the kernels' launch counts
           over those steps, one profiled step, and the same model on the
           CPU on one image, whose detections must match.
5. train   the same model in train mode on the card: ``init_reweight``
           over 2 batches, then 1 warm-up and 3 timed steps of
           ``make_train_step`` at batch 64 with the CLI's solver defaults
           on seeded images and targets (images/s from the median step,
           finite losses, peak memory), the launch counts of the four
           training kernels over those steps, one profiled step, and one
           loss-and-gradients call at batch 2 on the card and on the CPU
           from the same state, whose losses and gradients must agree.
6. kernels one line listing every kernel of the two paths with its
           launches on its path's phase, error and times.

Any failure raises and exits non-zero with no "ok" line. The last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REF_MODEL = os.path.join(".parity_p2", "ref_model.pth")
# the profiler's tables of one eval step and one train step
PROFILE_DIR = os.path.join("build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_TOL = 1e-4      # max |kernel - plain|, f32, K up to 1858 terms
# flash backward: max |kernel - plain| over max |plain|, per output; each
# entry sums up to 11,620 anchors (dk, dv) or 1,858 keys (dq)
BWD_TOL = 1e-4
MATCH_IOU = 0.999      # card vs CPU detections, per box
MATCH_SCORE = 1e-4
# card vs CPU, one train loss-and-gradients call at batch 2: the losses to
# rtol 1e-4; each gradient tensor, over the anchors the CPU mined, taken as
# the vector the optimizer applies, to ‖Δ‖₂ ≤ 1e-2 · ‖CPU gradient‖₂. At
# batch 2 in train mode a discrete choice made on near-equal f32 values
# (the max-pool of the CT keys, a ReLU, BatchNorm over as few as 2·10·10
# values per channel) can go the other way on the card: in the RFB blocks
# such runs measured up to 2.4e-3 norm-relative error (extras.1, with cuDNN
# on or off, from one run to the next) where the rest stayed below 5e-4,
# and 1.4e-2 of a tensor's largest entry, which is why the norm and not the
# largest entry is held. A gradient that vanishes in exact arithmetic (φ's
# bias, the bias of a BN that feeds another train-mode BN) is rounding
# noise on both sides, so the norm is floored at 1e-2.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
TRAIN_GRAD_FLOOR = 1e-2
TRAIN_BATCH, TRAIN_STEPS = 64, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> dict:
    import torch

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    from ct_tpu_torch.kernels import nvcc
    nvcc_ver = run([nvcc(), "--version"]).splitlines()[-1]
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvcc": nvcc_ver,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from ct_tpu_torch import kernels

    out = {}
    for name, res in kernels.build_all().items():
        ptxas = [ln.strip() for ln in res["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        out[name] = {"seconds": res["seconds"], "built": res["built"],
                     "ptxas": ptxas}
    return out


def attention_case(rng, b, c, p, kk, time_it: bool) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_reference_cm,
    )

    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((b, c, p), np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((b, kk, c), np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((b, kk, c), np.float32)).to(dev)
    base = torch.from_numpy(
        rng.standard_normal((b, c, p), np.float32)).to(dev)
    wz = torch.from_numpy(
        rng.standard_normal((c,), np.float32) * 0.1).to(dev)

    with torch.inference_mode():
        out = ct_attention_cm(q, k, v, base, wz)
        ref = ct_attention_reference_cm(q, k, v, base, wz)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        res = {"B": b, "C": c, "P": p, "K": kk, "max_abs_err": err,
               "tol": KERNEL_TOL}
        if not err <= KERNEL_TOL:
            raise AssertionError(f"ct_attention_cm disagrees with its plain "
                                 f"version: {res}")
        if not time_it:
            return res
        flops = 4 * b * p * kk * c
        nbytes = 4 * (3 * b * c * p + 2 * b * kk * c + c)
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        # yardstick: one library call of the same attention on the
        # row-major layout ([B, 1, P, C] queries), scores unscaled
        q_rm = q.transpose(1, 2).contiguous()[:, None]
        k4, v4 = k[:, None], v[:, None]
        lib = F.scaled_dot_product_attention(q_rm, k4, v4, scale=1.0)
        lib_out = base + lib[:, 0].transpose(1, 2) * wz[None, :, None]
        res.update(
            ms=cuda_ms(lambda: ct_attention_cm(q, k, v, base, wz), 20),
            plain_ms=cuda_ms(
                lambda: ct_attention_reference_cm(q, k, v, base, wz), 5),
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k4, v4, scale=1.0), 20),
            library_max_abs_err=(lib_out - ref).abs().max().item(),
        )
    return res


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory rate."""
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def training_attention_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """``ct_attention_cm_stats`` and ``ct_attention_cm_bwd_flash`` against
    their plain versions (and the flash backward against torch autograd
    of the plain forward) on the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm_bwd_flash, ct_attention_cm_bwd_flash_reference,
        ct_attention_cm_stats, ct_attention_cm_stats_reference,
        ct_attention_reference_cm,
    )

    dev = torch.device("cuda")
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * scale).to(dev)
    q, base, g = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = t(c, scale=0.1)

    # plain versions one at a time: at batch 64 each [B, K, P] tensor of
    # them is 5.5 GB
    with torch.no_grad():
        out, delta, m, z = ct_attention_cm_stats(q, k, v, base, wz)
        ref = ct_attention_cm_stats_reference(q, k, v, base, wz)
        fwd_err = {name: (a - r).abs().max().item() for name, a, r in
                   zip(("out", "delta", "m"), (out, delta, m), ref)}
        fwd_err["z_rel"] = ((z - ref[3]).abs() / ref[3]).max().item()
        del ref
        gd = g * delta
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        grads = ct_attention_cm_bwd_flash(q, k, v, wz, g, m, z, colsum)
        plain = ct_attention_cm_bwd_flash_reference(q, k, v, wz, g, m, z,
                                                    colsum)
        scales = [r.abs().max().item() for r in plain]
        errs = [(a - r).abs().max().item() for a, r in zip(grads, plain)]
        del plain
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(ct_attention_reference_cm(*args, base, wz),
                               args, g)
    bwd_rel = {}
    for name, a, r, scale, err in zip(("dq", "dk", "dv"), grads, auto,
                                      scales, errs):
        bwd_rel[name] = err / scale
        bwd_rel[name + "_vs_autograd"] = (a - r).abs().max().item() / scale
    del args, auto
    torch.cuda.synchronize()
    res = {"B": b, "C": c, "P": p, "K": kk,
           "stats_max_abs_err": max(fwd_err.values()), "stats_err": fwd_err,
           "stats_tol": KERNEL_TOL, "bwd_max_abs_err": max(errs),
           "bwd_rel_err": bwd_rel, "bwd_tol": BWD_TOL}
    if not (max(fwd_err.values()) <= KERNEL_TOL
            and max(bwd_rel.values()) <= BWD_TOL):
        raise AssertionError(f"training attention kernels disagree with "
                             f"their plain versions: {res}")
    if not time_it:
        return res

    torch.cuda.empty_cache()
    # yardsticks: one library call of the same attention on the row-major
    # layout ([B, 1, P, C] queries, unscaled scores), forward and backward
    q_rm = q.transpose(1, 2).contiguous()[:, None].requires_grad_()
    k4 = k[:, None].clone().requires_grad_()
    v4 = v[:, None].clone().requires_grad_()
    lib_out = F.scaled_dot_product_attention(q_rm, k4, v4, scale=1.0)
    lib_g = (g * wz[None, :, None]).transpose(1, 2).contiguous()[:, None]
    with torch.no_grad():
        res["stats"] = dict(
            ms=cuda_ms(lambda: ct_attention_cm_stats(q, k, v, base, wz), 10),
            plain_ms=cuda_ms(lambda: ct_attention_cm_stats_reference(
                q, k, v, base, wz), 3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k4, v4, scale=1.0), 10),
            **bound(4 * b * p * kk * c,
                    4 * (4 * b * c * p + 2 * b * kk * c + c + 2 * b * p)))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: ct_attention_cm_bwd_flash(
                q, k, v, wz, g, m, z, colsum), 5),
            plain_ms=cuda_ms(lambda: ct_attention_cm_bwd_flash_reference(
                q, k, v, wz, g, m, z, colsum), 3, warmup=1),
            **bound(10 * b * p * kk * c,
                    4 * (3 * b * c * p + 4 * b * kk * c + c + 3 * b * p)))
    res["bwd"]["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (q_rm, k4, v4), lib_g, retain_graph=True), 5)
    return res


def pool_case(rng, shape, time_it: bool) -> dict:
    """``pool2x2_relu`` forward and backward against torch autograd of
    ``F.relu`` then ``F.max_pool2d``, bit for bit, on tie-heavy inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.pool_relu import (
        pool2x2_relu_bwd, pool2x2_relu_bwd_reference, pool2x2_relu_fwd,
        pool2x2_relu_reference,
    )

    dev = torch.device("cuda")
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(dev)
    y = pool2x2_relu_fwd(x)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32)).to(dev)
    dx = pool2x2_relu_bwd(x, y, g)
    xr = x.clone().requires_grad_()
    yr = F.max_pool2d(F.relu(xr), 2, 2)
    yr.backward(g)
    torch.cuda.synchronize()
    res = {"shape": list(shape),
           "fwd_bitexact": bool(torch.equal(y, yr.detach())),
           "bwd_bitexact": bool(torch.equal(dx, xr.grad)),
           "fwd_max_abs_err": (y - yr.detach()).abs().max().item(),
           "bwd_max_abs_err": (dx - xr.grad).abs().max().item(),
           "bwd_routed": int((dx != 0).sum().item())}
    if not (res["fwd_bitexact"] and res["bwd_bitexact"]):
        raise AssertionError(f"pool2x2_relu disagrees with torch autograd: "
                             f"{res}")
    if not time_it:
        return res
    del xr, yr
    n = x.numel()
    xl = x.clone().requires_grad_()
    yl = torch.relu(F.max_pool2d(xl, 2, 2))
    res["fwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_fwd(x), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_reference(x), 10),
        library_ms=cuda_ms(lambda: torch.relu(F.max_pool2d(x, 2, 2)), 10),
        **bound(n, 4 * (n + n // 4)))
    res["bwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_bwd(x, y, g), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_bwd_reference(x, y, g), 5),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            yl, xl, g, retain_graph=True), 10),
        **bound(2 * n, 4 * (2 * n + 2 * (n // 4))))
    return res


def phase_kernel(seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    res = {
        # the eval path's shapes: batch 8, incre (C=15), P=11620, K=1858
        "incre": attention_case(rng, 8, 15, 11620, 1858, True),
        "transfer": attention_case(rng, 8, 60, 11620, 1858, True),
        # P not a multiple of the 128-anchor tile, K not of the 64-key tile
        "ragged": attention_case(rng, 3, 60, 1001, 97, False),
        "ragged_narrow": attention_case(rng, 2, 7, 130, 65, False),
        # the training kernels: checked at batch 8, timed at batch 64
        "train_incre": training_attention_case(rng, 8, 15, 11620, 1858,
                                               False),
        "train_transfer": training_attention_case(rng, 8, 60, 11620, 1858,
                                                  False),
        "train_ragged": training_attention_case(rng, 3, 60, 1001, 97, False),
        "train_ragged_narrow": training_attention_case(rng, 2, 7, 130, 65,
                                                       False),
        "train_timed": training_attention_case(rng, TRAIN_BATCH, 15, 11620,
                                               1858, True),
        # conv1's pool at 300: [B, 64, 300, 300] → [B, 64, 150, 150]
        "pool": pool_case(rng, (8, 64, 300, 300), False),
        "pool_ragged": pool_case(rng, (3, 5, 6, 10), False),
        "pool_timed": pool_case(rng, (TRAIN_BATCH, 64, 300, 300), True),
    }
    torch.cuda.empty_cache()
    return res


def seeded_images(seed: int, n: int, size: int):
    """n smooth random BGR images, mean-subtracted, NCHW float32: uniform
    noise on a 12x12 grid, bilinearly upsampled, so that the detector sees
    blobs rather than pixel noise."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.config import RGB_MEANS

    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (n, 3, 12, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)
    return img - torch.tensor(RGB_MEANS)[None, :, None, None]


def phase_model(seed: int, out_dir: str) -> dict:
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.eval import compare_detections, make_eval_step
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.priors import prior_boxes

    batch, steps = 8, 3
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    images = seeded_images(seed, batch, 300)
    sizes = torch.tensor([[375, 500]] * batch)      # a typical VOC image

    torch.cuda.reset_peak_memory_stats()   # the kernel phase's is not ours
    net = build_net(task, 300, device="cuda")
    net.load_state_dict(state)
    step = make_eval_step(net, prior_boxes(VOC_300, "cuda"))
    x, hw = images.cuda(), sizes.cuda()

    counts = {"ct_attention_cm": ct_attention_cm}
    for fn in counts.values():
        fn.launches = 0
    times = []
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = step(x, hw)
        dets = type(dets)(*(t.cpu() for t in dets))
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counts.items()}
    for name, n in launches.items():
        if n != 1 + steps:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{1 + steps} eval steps")
    median_s = sorted(times[1:])[steps // 2]
    res = {"batch": batch, "warmup_s": times[0], "step_s": times[1:],
           "images_per_s": batch / median_s, "launches": launches,
           "detections_per_image": dets.valid.sum(1).tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["profile"] = profile_step(lambda: step(x, hw), out_dir,
                                  "profile_model.txt")

    cpu_net = build_net(task, 300, device="cpu")
    cpu_net.load_state_dict(state)
    cpu_step = make_eval_step(cpu_net, prior_boxes(VOC_300, "cpu"))
    cpu_dets = cpu_step(images[:1], sizes[:1])
    gpu_dets = step(x[:1], hw[:1])
    agree = compare_detections(type(gpu_dets)(*(t.cpu() for t in gpu_dets)),
                               cpu_dets, iou_tol=MATCH_IOU,
                               score_tol=MATCH_SCORE)
    res["card_vs_cpu"] = agree
    if not agree["ok"]:
        raise AssertionError(f"card and CPU detections differ: {agree}")
    return res


def seeded_targets(seed: int, n: int, max_objs: int = 4) -> dict:
    """Padded targets of n images as the incre training set gives them:
    1-4 boxes per image in percent coordinates, labels 1..20, every object
    after the first ignored (-1), weight 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    boxes = np.tile(np.asarray([0, 0, 1, 1], np.float32), (n, max_objs, 1))
    labels = np.zeros((n, max_objs), np.int32)
    valid = np.zeros((n, max_objs), bool)
    for i in range(n):
        k = int(rng.integers(1, 5))
        mins = rng.uniform(0.0, 0.6, (k, 2))
        sizes = rng.uniform(0.1, 0.4, (k, 2))
        boxes[i, :k] = np.concatenate([mins, np.minimum(mins + sizes, 1.0)],
                                      1)
        labels[i, 0] = rng.integers(1, 21)
        labels[i, 1:k] = -1
        valid[i, :k] = True
    return {"boxes": torch.from_numpy(boxes),
            "labels": torch.from_numpy(labels),
            "weights": torch.from_numpy(valid.astype(np.float32)),
            "valid": torch.from_numpy(valid)}


def phase_train(seed: int, out_dir: str) -> dict:
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bwd_flash, ct_attention_cm_stats,
    )
    from ct_tpu_torch.ops.pool_relu import pool2x2_relu_bwd, pool2x2_relu_fwd
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.reweight import init_reweight
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import (
        TrainState, make_train_step,
    )

    batch, steps = TRAIN_BATCH, TRAIN_STEPS
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    dev = torch.device("cuda")
    batches = [dict(seeded_targets(seed + i, batch),
                    image=seeded_images(seed + i, batch, 300))
               for i in range(3)]
    on_card = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    priors = prior_boxes(VOC_300, dev)

    net = build_net(task, 300, device=dev)
    net.load_state_dict(state)

    class Batches:   # init_reweight's loader: the first two batches
        def __init__(self):
            self.left = list(on_card[:2])

        def next(self):
            return self.left.pop(0)

    t0 = time.perf_counter()
    init_reweight(net, Batches(), priors, task, init_iter=2)
    torch.cuda.synchronize()
    res = {"batch": batch, "init_reweight_s": time.perf_counter() - t0}

    # the CLI's solver defaults
    optimizer, scheduler = build_optimizer(net, task, SolverConfig())
    train_state = TrainState(net, optimizer, scheduler)
    step = make_train_step(priors)
    counts = {"ct_attention_cm": ct_attention_cm,
              "ct_attention_cm_stats": ct_attention_cm_stats,
              "ct_attention_cm_bwd_flash": ct_attention_cm_bwd_flash,
              "pool2x2_relu_fwd": pool2x2_relu_fwd,
              "pool2x2_relu_bwd": pool2x2_relu_bwd}
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    times, losses = [], []
    for i in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(train_state, on_card[2])
        losses.append({k: float(v) for k, v in out.items()})
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counts.items()}
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_cm"] = 0       # the eval kernel: no gradient path
    if launches != expected:
        raise AssertionError(f"launches over {1 + steps} train steps: "
                             f"{launches}, expected {expected}")
    if not all(math.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"non-finite train losses: {losses}")
    median_s = sorted(times[1:])[steps // 2]
    res.update(warmup_s=times[0], step_s=times[1:],
               images_per_s=batch / median_s, launches=launches,
               losses=losses,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res["profile"] = profile_step(lambda: step(train_state, on_card[2]),
                                  out_dir, "profile_train.txt")

    res["card_vs_cpu"] = card_vs_cpu(task, net, batches[2], priors)
    return res


def card_vs_cpu(task, net, batch, priors) -> dict:
    """One loss-and-gradients call at batch 2 from the same state on the
    card and on the CPU. The card's gradients are taken over the anchors
    the CPU mined, so that near-tied negatives ranked the other way round
    cannot move them; the card's own mining is compared apart."""
    from ct_tpu_torch.config import VOC_300
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.step import LOSS_KEYS, loss_and_grads

    cpu_net = build_net(task, 300, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             net.state_dict().items()})
    mini = {k: v[:2].cpu() for k, v in batch.items()}
    mini_card = {k: v.to(priors.device) for k, v in mini.items()}
    cpu_losses, cpu_mask = loss_and_grads(cpu_net, mini,
                                          prior_boxes(VOC_300, "cpu"))
    _, own_mask = loss_and_grads(net, mini_card, priors)
    losses, _ = loss_and_grads(net, mini_card, priors,
                               mask=cpu_mask.to(priors.device))
    rows = []
    for (name, p), q in zip(net.named_parameters(), cpu_net.parameters()):
        d = p.grad.cpu() - q.grad
        norm = q.grad.norm().item()
        rows.append((d.norm().item() / max(norm, TRAIN_GRAD_FLOOR), name,
                     norm, d.norm().item(), q.grad.abs().max().item(),
                     d.abs().max().item()))
    rows.sort(reverse=True)
    loss_rel = {k: abs(losses[k].item() - cpu_losses[k].item())
                / abs(cpu_losses[k].item()) for k in LOSS_KEYS}
    res = {"batch": 2, "num_pos": cpu_losses["num_pos"].item(),
           "anchors_counted": int(cpu_mask.sum().item()),
           "mined_differently": int((own_mask.cpu() != cpu_mask).sum().item()),
           "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "worst_grad_rel_err": rows[0][0], "worst_grad": rows[0][1],
           "grad_tol": TRAIN_GRAD_TOL,
           # (‖Δ‖/‖g‖, name, ‖g‖, ‖Δ‖, max|g|, max|Δ|) of the worst tensors
           "worst_grads": rows[:8]}
    res["ok"] = bool(max(loss_rel.values()) <= TRAIN_LOSS_RTOL
                     and rows[0][0] <= TRAIN_GRAD_TOL)
    return res


def profile_step(fn, out_dir: str, table: str) -> dict:
    """One step ``fn()`` under torch.profiler: device time by kernel. The
    table goes to ``out_dir/table``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=80))
    top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3,
            "calls": e.count} for e in events[:12]]
    return {"wall_ms": wall * 1e3, "device_kernel_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if wall else None,
            "top": top}


def kernels_line(results: dict) -> list:
    """Every kernel of the eval and train paths: its launches on its path's
    phase, its error against its plain version, and its times at that
    path's batch (8 for eval, 64 for training)."""
    kern = results["kernel"]
    incre, timed, pool = kern["incre"], kern["train_timed"], kern["pool_timed"]
    attn_err = max(max(v for n, v in kern[c]["stats_err"].items()
                       if n != "z_rel")
                   for c in ("train_incre", "train_transfer", "train_ragged",
                             "train_ragged_narrow", "train_timed"))
    bwd_err = max(kern[c]["bwd_max_abs_err"]
                  for c in ("train_incre", "train_transfer", "train_ragged",
                            "train_ragged_narrow", "train_timed"))
    pool_err = {d: max(kern[c][d + "_max_abs_err"]
                       for c in ("pool", "pool_ragged", "pool_timed"))
                for d in ("fwd", "bwd")}
    rows = [
        ("ct_attention_cm", "ct_attention_cm.cu",
         "ct_tpu/ops/ct_attention.py:146", results["model"]["launches"],
         incre["max_abs_err"], incre),
        ("ct_attention_cm_stats", "ct_attention_cm.cu",
         "ct_tpu/ops/ct_attention.py:209", results["train"]["launches"],
         attn_err, timed["stats"]),
        ("ct_attention_cm_bwd_flash", "ct_attention_cm_bwd.cu",
         "ct_tpu/ops/ct_attention.py:520", results["train"]["launches"],
         bwd_err, timed["bwd"]),
        ("pool2x2_relu_fwd", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:56", results["train"]["launches"],
         pool_err["fwd"], pool["fwd"]),
        ("pool2x2_relu_bwd", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:66", results["train"]["launches"],
         pool_err["bwd"], pool["bwd"]),
    ]
    return [{"name": name, "route": "cuda",
             "source": "ct_tpu_torch/csrc/" + src, "replaces": replaces,
             "launches": launches[name], "max_abs_err": err,
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"]}
            for name, src, replaces, launches, err, t in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import ct_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ct_tpu_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    if not os.path.exists(REF_MODEL):
        print(f"chip_smoke: {REF_MODEL} is missing", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    results = {}
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("kernel", lambda: phase_kernel(args.seed)),
                     ("model", lambda: phase_model(args.seed, PROFILE_DIR)),
                     ("train", lambda: phase_train(args.seed, PROFILE_DIR))):
        t0 = time.perf_counter()
        results[name] = fn()
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              **results[name]})
    if not results["train"]["card_vs_cpu"]["ok"]:
        raise AssertionError("card and CPU train losses or gradients "
                             "differ beyond their bands (train phase line)")
    emit({"kernels": kernels_line(results)})
    print(results["env"]["nvidia_smi"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
