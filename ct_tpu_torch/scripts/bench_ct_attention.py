"""CT attention forward bench: the row-major kernel and its variants.

The port of ``scripts/bench_ct_attention.py``:

    python -m ct_tpu_torch.scripts.bench_ct_attention [--device cuda|cpu]
        [--iters N] [--batch B] [--anchors P] [--keys K] [--classes C]
        [--dtype bfloat16|float32]

At B=128, P=11,620, K=1,858, C=60 (the defaults) it times the plain
version, the production row-major forward (``ct_attention``) and the
variants of ``make_variant``, each in ms and TFLOP/s (4·B·P·K·C flops)
with its max |Δ| against the production kernel. Inputs are seeded normal
× 0.3 in bfloat16, with wz in float32, as the JAX bench feeds them; then
the port's bf16 kernels run. Of the JAX bench's 12 variants (exponential
in float32 or bfloat16, the denominator fused or not, block_q 512, 1024,
2048) three bodies differ on bf16 inputs, and the bench times each:

* exp=float32, fused: the denominator from the ones column of v, the
  sum of the weights rounded to bf16, as JAX's production ``_kernel``:
  ``ct_attention_bf16``;
* exp=float32, unfused: v multiplied by the rounded weights, the sum
  taken over the float32 weights before their rounding
  (``e.astype(f32)`` of an f32 e): ``ct_attention_variant_unfused_bf16``;
* exp=bfloat16: ``ct_attention_variant_bf16``, fused and unfused alike
  (e is already bf16, so both sums are of the rounded weights).

``--dtype float32`` runs the float32 kernels on the same values in
float32, where ``fuse_denom`` changes nothing (``e.astype(v.dtype)`` and
``e.astype(f32)`` are both no-ops): two bodies, ``ct_attention`` and
``ct_attention_variant``. block_q has no counterpart in the CUDA kernels,
whose block is its 128 threads. Each line names the variants it stands
for. Run it with nothing else on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ct_tpu_torch import resolve_device
from ct_tpu_torch.ops.ct_attention import (
    ct_attention, ct_attention_reference, ct_attention_reference_bf16,
    ct_attention_variant, ct_attention_variant_unfused_bf16,
)
from ct_tpu_torch.scripts import device_name
from ct_tpu_torch.utils.timing import time_calls


FUSE_DENOM = (False, True)
BLOCK_Q = (512, 1024, 2048)


def make_variant(exp_dtype, block_q, fuse_denom=False):
    """The row-major forward with its exponential in ``exp_dtype``:
    ``ct_attention`` for torch.float32, ``ct_attention_variant`` (the same
    kernel with its bfloat16 flag) for torch.bfloat16; on bf16 inputs, the
    float32 exponential with ``fuse_denom=False`` runs
    ``ct_attention_variant_unfused_bf16`` (see the module docstring).

    ``block_q`` (the TPU kernel's query block) has no counterpart in the
    CUDA kernel, whose block is its 128 threads: it is kept on the
    returned function and changes nothing."""
    if exp_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"make_variant: exp_dtype {exp_dtype}")

    def fwd(q, k, v, base, wz):
        if exp_dtype == torch.bfloat16:
            return ct_attention_variant(q, k, v, base, wz)
        if q.dtype == torch.bfloat16 and not fuse_denom:
            return ct_attention_variant_unfused_bf16(q, k, v, base, wz)
        return ct_attention(q, k, v, base, wz)

    fwd.exp_dtype, fwd.block_q = exp_dtype, block_q
    fwd.fuse_denom = fuse_denom
    return fwd


def bodies(dtype):
    """(exp_dtype, fuse_denom values that share a body) of each variant
    body the bench times on ``dtype`` inputs."""
    if dtype == torch.bfloat16:
        return ((torch.float32, (True,)), (torch.float32, (False,)),
                (torch.bfloat16, FUSE_DENOM))
    return ((torch.float32, FUSE_DENOM), (torch.bfloat16, FUSE_DENOM))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--anchors", type=int, default=11620)
    ap.add_argument("--keys", type=int, default=1858)
    ap.add_argument("--classes", type=int, default=60)
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16",
                    help="q, k, v and base (wz is float32 either way)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; returns its numbers (ms, TFLOP/s, max |Δ|)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    print("device", device_name(device), flush=True)
    rng = np.random.default_rng(0)
    b, p, kk, c = args.batch, args.anchors, args.keys, args.classes

    dtype = getattr(torch, args.dtype)

    def mk(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * 0.3).to(device, dtype)

    q, k, v, base = mk(b, p, c), mk(b, kk, c), mk(b, kk, c), mk(b, p, c)
    wz = torch.from_numpy(rng.standard_normal(c, np.float32)).to(device)
    inputs = (q, k, v, base, wz)
    plain = (ct_attention_reference_bf16 if dtype == torch.bfloat16
             else ct_attention_reference)
    flops = 4 * b * p * kk * c
    res = {"batch": b, "anchors": p, "keys": kk, "classes": c,
           "dtype": args.dtype, "device": device_name(device),
           "variants": []}

    with torch.no_grad():
        t = time_calls(plain, inputs, max(1, args.iters // 3))
        print(f"plain version: {t*1e3:.2f} ms  ({flops/t/1e12:.1f} TFLOP/s)",
              flush=True)
        res["plain_ms"] = t * 1e3
        t = time_calls(ct_attention, inputs, args.iters)
        print(f"production kernel: {t*1e3:.2f} ms  ({flops/t/1e12:.1f} TF/s)",
              flush=True)
        res["production_ms"] = t * 1e3
        prod = ct_attention(*inputs)
        print("block_q has no counterpart in the CUDA kernels: one timing "
              f"stands for bq={list(BLOCK_Q)}", flush=True)
        for exp_dtype, fuses in bodies(dtype):
            fn = make_variant(exp_dtype, BLOCK_Q[0], fuse_denom=fuses[0])
            t = time_calls(fn, inputs, args.iters)
            err = (fn(*inputs).float() - prod.float()).abs().max().item()
            name = str(exp_dtype).split(".")[-1]
            print(f"exp={name:9s} fuse={list(map(int, fuses))}: "
                  f"{t*1e3:.2f} ms ({flops/t/1e12:.1f} TF/s)"
                  f"  max|Δ|={err:.2e}", flush=True)
            res["variants"].append(
                {"exp_dtype": name, "fuse_denom": list(fuses),
                 "block_q": list(BLOCK_Q), "ms": t * 1e3,
                 "max_abs_err": err})
    return res


if __name__ == "__main__":
    main()
