"""Bias + ReLU backward bench: the one-pass kernel against library calls.

The port of ``scripts/bench_bias_relu_bwd.py``:

    python -m ct_tpu_torch.scripts.bench_bias_relu_bwd [--device cuda|cpu]
        [--iters N] [--batch B] [--shape N C H W ...]
        [--dtype bfloat16|float32]

On the four conv activations of RFBNet300's trunk in training, NCHW
[64, 64, 300, 300], [64, 128, 150, 150], [64, 256, 75, 75] and
[64, 512, 38, 38] (``--batch`` changes N, ``--shape`` replaces the list;
the JAX bench's are NHWC), g and y in bfloat16 as the JAX bench feeds them
(``--dtype float32`` for the float32 kernel), dbias float32: the kernel
(``bias_relu_bwd``) is held to the plain version (mask bit for bit, dbias
at rtol 1e-5 and atol 1e-2, the JAX bench's check) and timed beside
PyTorch's own calls for the same function, ``threshold_backward`` and the
channel sum in float32. Best of 3 windows. Run it with nothing else on the
card.
"""

from __future__ import annotations

import argparse

import torch

from ct_tpu_torch import resolve_device
from ct_tpu_torch.ops.bias_relu import bias_relu_bwd, bias_relu_bwd_reference
from ct_tpu_torch.scripts import device_name
from ct_tpu_torch.utils.timing import time_calls

SHAPES = ((64, 64, 300, 300), (64, 128, 150, 150), (64, 256, 75, 75),
          (64, 512, 38, 38))


def library(g, y):
    """PyTorch's calls for the same function: ReLU's backward and the
    channel sum."""
    masked = torch.ops.aten.threshold_backward(g, y, 0.0)
    return masked, masked.sum(dim=(0, 2, 3), dtype=torch.float32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--shape", type=int, nargs=4, action="append",
                    default=None, metavar=("N", "C", "H", "W"))
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default="bfloat16", help="g and y (dbias is float32)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the bench; returns {shape: numbers}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    print("device", device_name(device), args.dtype, flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    res = {}
    for shape in args.shape or SHAPES:
        shape = (args.batch or shape[0], *shape[1:])
        # seeded on the device: the largest shape is 368 million values
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        y = torch.relu(torch.randn(shape, generator=gen,
                                   device=device)).to(dtype)
        mk, dk = bias_relu_bwd(g, y)
        mp, dp = bias_relu_bwd_reference(g, y)
        if not torch.equal(mk, mp):
            raise AssertionError(f"{shape}: the mask differs from the plain "
                                 "version's")
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-2)
        del mk, mp
        t_lib = time_calls(library, (g, y), args.iters, 3)
        t_kernel = time_calls(bias_relu_bwd, (g, y), args.iters, 3)
        print(f"{str(shape):22s} library {t_lib*1e3:7.2f} ms   "
              f"kernel {t_kernel*1e3:7.2f} ms   "
              f"max|Δdbias| {(dk - dp).abs().max().item():.2e}", flush=True)
        res[str(shape)] = {"library_ms": t_lib * 1e3,
                           "kernel_ms": t_kernel * 1e3,
                           "dbias_max_abs_err": (dk - dp).abs().max().item()}
        del g, y
    return res


if __name__ == "__main__":
    main()
