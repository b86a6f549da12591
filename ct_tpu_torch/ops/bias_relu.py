"""Backward of a convolution's bias + ReLU in one pass.

The port of ``bias_relu_bwd_pallas`` (``scripts/bench_bias_relu_bwd.py``)
in the port's NCHW layout: for y = relu(x + bias) and the upstream
gradient g, both [N, C, H, W] float32,

    masked = where(y > 0, g, 0)          the gradient of x
    dbias  = Σ_{n,h,w} masked            the gradient of bias, [C]

``bias_relu_bwd`` launches the hand-written CUDA kernel
(``csrc/bias_relu_bwd.cu``) for CUDA tensors, counting launches in
``.launches``, and takes the plain version for CPU tensors. The JAX bench
runs it in bfloat16; the port keeps float32 until it has a bfloat16 path.
"""

from __future__ import annotations

import torch

from ct_tpu_torch import kernels

CHUNK = 8192   # elements of an (n, c) plane per block (csrc kChunk)


def bias_relu_bwd_reference(g: torch.Tensor, y: torch.Tensor):
    """The plain version → (masked, dbias)."""
    masked = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
    return masked, masked.sum(dim=(0, 2, 3))


def bias_relu_bwd(g: torch.Tensor, y: torch.Tensor):
    """→ (masked [N, C, H, W], dbias [C]) float32, in one pass over g and
    y on the card."""
    for name, t in (("g", g), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"bias_relu_bwd: {name} is {t.dtype}, the kernel "
                            "takes float32")
    if g.dim() != 4 or g.shape != y.shape or g.device != y.device:
        raise ValueError(f"bias_relu_bwd: g and y must be NCHW of one shape "
                         f"on one device, got {tuple(g.shape)} on "
                         f"{g.device} and {tuple(y.shape)} on {y.device}")
    n, c, h, w = g.shape
    if min(n, c, h, w) < 1 or n * c > 65535:
        raise ValueError(f"bias_relu_bwd: {tuple(g.shape)}: the kernel "
                         "takes 1 to 65535 planes N·C, none empty")
    if g.device.type == "cpu":
        return bias_relu_bwd_reference(g, y)
    if g.device.type != "cuda":
        raise ValueError(f"bias_relu_bwd: no kernel for {g.device}")
    masked = torch.empty_like(g)
    dbias = g.new_empty((c,))
    part = g.new_empty((n * c * -(-(h * w) // CHUNK),))
    kernels.launch(bias_relu_bwd, "bias_relu_bwd", (g, y, masked, dbias, part),
                   (n, c, h * w))
    return masked, dbias


bias_relu_bwd.launches = 0
