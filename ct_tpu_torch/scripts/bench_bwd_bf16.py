"""The bfloat16 CT attention backwards, timed and split by kernel.

    python -m ct_tpu_torch.scripts.bench_bwd_bf16 [--device cuda|cpu]
        [--batch B] [--anchors P] [--keys K] [--widths 15 60]
        [--iters N] [--json PATH]

Rows 3, 4 and 5's backward of PERF.md §6 on bfloat16 inputs (seeded
normal; × 0.3 for row 5 as the JAX bwd bench feeds it), each at both
widths: ``ct_attention_cm_bwd_flash_bf16`` (from the bf16 training
forward's m, z and delta), ``ct_attention_cm_bwd_bf16`` and
``ct_attention_bwd_bf16``. For each: the mean time of ``--iters`` calls
(CUDA events), the device time of each kernel of one call (torch.profiler,
by the kernel's function name), and each output's largest and mean |Δ|
against its plain version on the same inputs, over its largest and mean
|entry|. Defaults: the train step's and the bench's B=64, P=11,620,
K=1,858. It calls only the wrappers of ``ops/ct_attention``, so it times
whichever ``ct_tpu_torch`` comes first on ``sys.path``: two trees in turns
on one card compare their kernels on the same inputs. ``--device cpu``
runs the plain versions (host clock, no split) at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ct_tpu_torch import resolve_device
from ct_tpu_torch.ops import ct_attention as T
from ct_tpu_torch.scripts import device_name

BF16 = torch.bfloat16
# a profiler window opened soon after another loses its first kernel
# records unless the host pauses and short markers lead the calls
# (chip_smoke.py, profiled_events)
PAUSE_S, MARKERS, MARKER_CYCLES = 1.0, 32, 12_500_000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--anchors", type=int, default=11620)
    ap.add_argument("--keys", type=int, default=1858)
    ap.add_argument("--widths", type=int, nargs="+", default=[15, 60])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="also write the result here")
    return ap.parse_args(argv)


def cases(device, b, c, p, kk, seed):
    """(row, wrapper, arguments, plain version, output names) of the three
    backwards on seeded inputs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=device)
                               * scale).to(BF16)
    q, g, base = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = torch.randn(c, generator=gen, device=device) * 0.1
    _, delta, m, z = T.ct_attention_cm_stats_bf16(q, k, v, base, wz)
    colsum = (g.float() * delta.float() * wz[None, :, None]).sum(
        dim=1, keepdim=True)
    rm = lambda x: x.mul(0.3).transpose(1, 2).contiguous()
    grads = ("dq", "dk", "dv", "dwz")
    return [
        ("3", T.ct_attention_cm_bwd_flash_bf16,
         (q, k, v, wz, g, m, z, colsum),
         T.ct_attention_cm_bwd_flash_reference_bf16, grads[:3]),
        ("4", T.ct_attention_cm_bwd_bf16, (q, k, v, wz, g),
         T.ct_attention_cm_bwd_reference_bf16, grads),
        ("5 bwd", T.ct_attention_bwd_bf16,
         (rm(q), k.mul(0.3), v.mul(0.3), wz, rm(g)),
         T.ct_attention_bwd_reference_bf16, grads),
    ]


def mean_ms(fn, iters: int, device) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(key: str) -> str:
    """A profiler key's kernel function name, without its namespace,
    template arguments and parameters."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split("::")[-1].split()[-1]


def split_ms(fn) -> dict:
    """Device ms of each kernel of one call of ``fn()``, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    time.sleep(PAUSE_S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key):
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


def errors(outs, plains, names) -> dict:
    res = {}
    for n, a, r in zip(names, outs, plains):
        a, r = a.float(), r.float()
        d = (a - r).abs()
        res[n] = {"max_rel": d.max().item() / r.abs().max().item(),
                  "mean_rel": d.mean().item() / r.abs().mean().item()}
    return res


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    res = {"device": device_name(device), "batch": args.batch,
           "anchors": args.anchors, "keys": args.keys,
           "package": T.__file__, "rows": []}
    for c in args.widths:
        with torch.no_grad():
            for row, fn, fargs, plain, names in cases(
                    device, args.batch, c, args.anchors, args.keys,
                    args.seed):
                call = lambda: fn(*fargs)
                rec = {"row": row, "C": c,
                       "ms": mean_ms(call, args.iters, device),
                       "errors": errors(call(), plain(*fargs), names)}
                if device.type == "cuda":
                    rec["kernels_ms"] = split_ms(call)
                    torch.cuda.empty_cache()
                print(json.dumps(rec), flush=True)
                res["rows"].append(rec)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
