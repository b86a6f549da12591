"""CT attention backward bench: row-major, class-major, blockwise, flash.

The port of ``scripts/bench_ct_bwd.py`` and, with ``--size 512``, of
``scripts/bench_ct_bwd_512.py``:

    python -m ct_tpu_torch.scripts.bench_ct_bwd [--size 300|512]
        [--device cuda|cpu] [--iters N] [--batch B] [--anchors P]
        [--keys K] [--classes C]

At 300: B=64, P=11,620, K=1,858, C=60; at 512: B=16, P=32,756, K=4,964,
C=60. In order, each in ms and TFLOP/s (10·B·P·K·C flops, the JAX
bench's count) and with the cross-errors the JAX bench prints (max |Δ|
and its ratio to the largest entry):

1. the row-major blockwise backward (``ct_attention_bwd``) against the
   class-major one (``ct_attention_cm_bwd``, on the transposed q and g);
2. the class-major forward (``ct_attention_cm``, no gradient) and the
   stats forward (``ct_attention_cm_stats``);
3. the class-major blockwise backward against the flash backward
   (``ct_attention_cm_bwd_flash``, from the stats forward's m, z, delta).

Then each backward against its plain version at a batch whose [B, K, P]
plain tensors fit beside the bench's (``--plain-batch``, default 2); the
line names the batch. Inputs are seeded normal × 0.3, q, k, v and g in
bfloat16 and wz in float32, as the JAX bench feeds them
(``scripts/bench_ct_bwd.py:77-78``): the port's bf16 kernels run
(``ct_attention_bwd_bf16``, ``ct_attention_cm_bwd_bf16``,
``ct_attention_cm_stats_bf16``, ``ct_attention_cm_bwd_flash_bf16``;
the plain check against their plain bf16 versions). In bf16 the two
blockwise layouts differ in their weights' last bit (row-major divides by
the sum, class-major multiplies by its inverse, as the JAX kernels do) and
the flash backward rounds at other points than the blockwise one, so those
two cross-errors are readings of that. ``--dtype float32`` runs the
float32 kernels on the same values in float32. Run it with nothing else on
the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ct_tpu_torch import resolve_device
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_bwd, ct_attention_bwd_reference,
    ct_attention_bwd_reference_bf16, ct_attention_cm, ct_attention_cm_bwd,
    ct_attention_cm_bwd_flash, ct_attention_cm_bwd_flash_reference,
    ct_attention_cm_bwd_flash_reference_bf16, ct_attention_cm_bwd_reference,
    ct_attention_cm_bwd_reference_bf16, ct_attention_cm_stats,
)
from ct_tpu_torch.scripts import device_name
from ct_tpu_torch.utils.timing import time_calls

SIZES = {"300": (64, 11620, 1858, 60), "512": (16, 32756, 4964, 60)}
GRADS = ("dq", "dk", "dv", "dwz")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the plain versions of (row-major, class-major, flash) by input type
PLAIN = {torch.float32: (ct_attention_bwd_reference,
                         ct_attention_cm_bwd_reference,
                         ct_attention_cm_bwd_flash_reference),
         torch.bfloat16: (ct_attention_bwd_reference_bf16,
                          ct_attention_cm_bwd_reference_bf16,
                          ct_attention_cm_bwd_flash_reference_bf16)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="300", choices=sorted(SIZES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--anchors", type=int, default=None)
    ap.add_argument("--keys", type=int, default=None)
    ap.add_argument("--classes", type=int, default=None)
    ap.add_argument("--plain-batch", type=int, default=2,
                    help="batch of the check against the plain versions")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="type of q, k, v and g (wz is float32)")
    return ap.parse_args(argv)


def flash_bwd(q_cm, k, v, wz, g_cm, delta, m, z):
    """The flash backward as the autograd Function runs it: dwz and colsum
    from the saved delta in float32, then the kernel → (dq, dk, dv,
    dwz)."""
    gd = g_cm.float() * delta.float()
    colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
    return (*ct_attention_cm_bwd_flash(q_cm, k, v, wz, g_cm, m, z, colsum),
            gd.sum(dim=(0, 2)))


def cross_errors(label, a, b) -> dict:
    """max |a - b| per gradient, its ratio to max |a| and max |a| itself,
    printed."""
    out = {}
    for name, x, y in zip(GRADS, a, b):
        err = (x.float() - y.float()).abs().max().item()
        ref = x.abs().max().item() or 1.0
        print(f"  {label}max|d{name[1:]}| = {err:.3e}  (rel {err/ref:.2e})",
              flush=True)
        out[name] = {"max_abs_err": err, "rel": err / ref, "max_abs": ref}
    return out


def main(argv=None) -> dict:
    """Run the bench; returns its numbers."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    print("device", device_name(device), flush=True)
    b, p, kk, c = SIZES[args.size]
    b = args.batch or b
    p = args.anchors or p
    kk = args.keys or kk
    c = args.classes or c
    dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(0)

    def mk(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * 0.3).to(device, dtype)

    q, k, v, g = mk(b, p, c), mk(b, kk, c), mk(b, kk, c), mk(b, p, c)
    wz = torch.from_numpy(rng.standard_normal(c, np.float32)).to(device)
    q_cm = q.transpose(1, 2).contiguous()
    g_cm = g.transpose(1, 2).contiguous()
    base_cm = torch.zeros_like(q_cm)
    flops = 10 * b * p * kk * c
    res = {"size": args.size, "batch": b, "anchors": p, "keys": kk,
           "classes": c, "dtype": args.dtype, "device": device_name(device)}
    rm_plain, cm_plain, flash_plain = PLAIN[dtype]

    def line(key, label, t, tflops=True):
        rate = f" ({flops/t/1e12:.1f} TF/s)" if tflops else ""
        print(f"{label} {t*1e3:.2f} ms{rate}", flush=True)
        res[key] = t * 1e3

    with torch.no_grad():
        rm = (q, k, v, wz, g)
        cm = (q_cm, k, v, wz, g_cm)
        line("rowmajor_bwd_ms", "row-major bwd:  ",
             time_calls(ct_attention_bwd, rm, args.iters, 3))
        line("classmajor_bwd_ms", "class-major bwd:",
             time_calls(ct_attention_cm_bwd, cm, args.iters, 3))
        a = ct_attention_bwd(*rm)
        a = (a[0].transpose(1, 2), *a[1:])
        blockwise = ct_attention_cm_bwd(*cm)
        res["rowmajor_vs_classmajor"] = cross_errors("", a, blockwise)
        del a

        fwd = (q_cm, k, v, base_cm, wz)
        line("cm_fwd_ms", "cm fwd (plain): ",
             time_calls(ct_attention_cm, fwd, args.iters, 3), False)
        line("cm_fwd_stats_ms", "cm fwd (stats): ",
             time_calls(ct_attention_cm_stats, fwd, args.iters, 3), False)
        _, delta, m, z = ct_attention_cm_stats(*fwd)
        flash = (q_cm, k, v, wz, g_cm, delta, m, z)
        line("cm_bwd_ms", "cm bwd (blockwise):",
             time_calls(ct_attention_cm_bwd, cm, args.iters, 3))
        line("cm_bwd_flash_ms", "cm bwd (flash):    ",
             time_calls(flash_bwd, flash, args.iters, 3))
        res["blockwise_vs_flash"] = cross_errors(
            "flash ", blockwise, flash_bwd(*flash))
        del blockwise, flash, delta, m, z

        # each backward against its plain version, at a batch that fits
        n = min(b, args.plain_batch)
        print(f"plain check at batch {n}:", flush=True)
        res["plain_batch"] = n
        rm, cm = ([x[:n] if x.dim() == 3 else x for x in xs]
                  for xs in (rm, cm))
        res["rowmajor_vs_plain"] = cross_errors(
            "row-major vs plain ", rm_plain(*rm), ct_attention_bwd(*rm))
        res["classmajor_vs_plain"] = cross_errors(
            "class-major vs plain ", cm_plain(*cm), ct_attention_cm_bwd(*cm))
        _, delta, m, z = ct_attention_cm_stats(*cm[:3], base_cm[:n], wz)
        gd = cm[4].float() * delta.float()
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        plain = flash_plain(*cm, m, z, colsum)
        res["flash_vs_plain"] = cross_errors(
            "flash vs plain ", (*plain, gd.sum(dim=(0, 2))),
            flash_bwd(*cm, delta, m, z))
    return res


if __name__ == "__main__":
    main()
