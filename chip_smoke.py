#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``ct_tpu_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Runs in phases, each printing one JSON line with its wall-clock seconds:

1. env     the card's name and power limit (nvidia-smi), CUDA and nvcc.
2. build   every CUDA kernel of the port, built with nvcc from csrc/.
3. kernel  ``ct_attention_cm`` on the card against its plain PyTorch
           version, f32 with TF32 off, at the eval path's shapes (C=15),
           at the transfer width (C=60) and at ragged P and K; kernel,
           plain, bound and ``scaled_dot_product_attention`` times.
4. model   the phase-2 incre split-1 RFBNet300 with ``ref_model.pth`` on
           the card: 1 warm-up and 3 timed eval steps on 8 seeded images
           (images/s from the median step), the kernels' launch counts
           over those steps, one profiled step, and the same model on the
           CPU on one image, whose detections must match.
5. kernels one line listing every kernel of the path with its launches
           on the model phase, error and times.

Any failure raises and exits non-zero with no "ok" line. The last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REF_MODEL = os.path.join(".parity_p2", "ref_model.pth")
# the profiler's table of one eval step
PROFILE_DIR = os.path.join("build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_TOL = 1e-4      # max |kernel - plain|, f32, K up to 1858 terms
MATCH_IOU = 0.999      # card vs CPU detections, per box
MATCH_SCORE = 1e-4


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


def phase_kernel(seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        # the eval path's shapes: batch 8, incre (C=15), P=11620, K=1858
        "incre": attention_case(rng, 8, 15, 11620, 1858, True),
        "transfer": attention_case(rng, 8, 60, 11620, 1858, True),
        # P not a multiple of the 128-anchor tile, K not of the 64-key tile
        "ragged": attention_case(rng, 3, 60, 1001, 97, False),
        "ragged_narrow": attention_case(rng, 2, 7, 130, 65, False),
    }


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
    try:  # a measurement aside: the check does not rest on it
        res["profile"] = profile_step(step, x, hw, out_dir)
    except Exception as e:  # noqa: BLE001
        res["profile"] = {"error": repr(e)}

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


def profile_step(step, x, hw, out_dir: str) -> dict:
    """One eval step under torch.profiler: device time by kernel. The
    table goes to ``out_dir/profile_model.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, hw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_model.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))
    top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3,
            "calls": e.count} for e in events[:12]]
    return {"wall_ms": wall * 1e3, "device_kernel_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if wall else None,
            "top": top}


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
                     ("model", lambda: phase_model(args.seed, PROFILE_DIR))):
        t0 = time.perf_counter()
        results[name] = fn()
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              **results[name]})

    incre = results["kernel"]["incre"]
    emit({"kernels": [{
        "name": "ct_attention_cm", "route": "cuda",
        "source": "ct_tpu_torch/csrc/ct_attention_cm.cu",
        "replaces": "ct_tpu/ops/ct_attention.py:146",
        "launches": results["model"]["launches"]["ct_attention_cm"],
        "max_abs_err": incre["max_abs_err"], "ms": incre["ms"],
        "plain_ms": incre["plain_ms"], "bound_ms": incre["bound_ms"],
        "bound_by": incre["bound_by"], "library_ms": incre["library_ms"],
    }]})
    print(results["env"]["nvidia_smi"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
