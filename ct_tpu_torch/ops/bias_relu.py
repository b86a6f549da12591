"""Backward of a convolution's bias + ReLU in one pass.

The port of ``bias_relu_bwd_pallas`` (``scripts/bench_bias_relu_bwd.py``)
in the port's NCHW layout: for y = relu(x + bias) and the upstream
gradient g, both [N, C, H, W] of one type, float32 or bfloat16,

    masked = where(y > 0, g, 0)          the gradient of x, in g's type
    dbias  = Σ_{n,h,w} masked            the gradient of bias, [C] float32

In bfloat16, the type the JAX bench feeds its kernel, masked holds g's bits
or +0.0 (a -0.0 of g where y > 0 passes through) and dbias is the float32
sum of the masked values widened to float32, as the JAX kernel sums them: a
bf16 sum (``masked.sum()`` on a bf16 tensor) would round it to 8 bits.

``bias_relu_bwd`` launches the hand-written CUDA kernel
(``csrc/bias_relu_bwd.cu``) of its inputs' type for CUDA tensors, counting
launches in ``bias_relu_bwd.launches`` (float32) and
``bias_relu_bwd_bf16.launches`` (bfloat16), and takes the plain version for
CPU tensors.
"""

from __future__ import annotations

import torch

from ct_tpu_torch import kernels

CHUNK = 8192   # elements of an (n, c) plane per block (csrc kChunk)


def bias_relu_bwd_reference(g: torch.Tensor, y: torch.Tensor):
    """The plain version → (masked in g's type, dbias float32)."""
    masked = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
    return masked, masked.sum(dim=(0, 2, 3), dtype=torch.float32)


def _check(fn: str, g: torch.Tensor, y: torch.Tensor) -> None:
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: g is {g.dtype}, the kernels take float32 "
                        "or bfloat16")
    if y.dtype != g.dtype:
        raise TypeError(f"{fn}: y is {y.dtype} and g {g.dtype}; the kernels "
                        "take one type")
    if g.dim() != 4 or g.shape != y.shape or g.device != y.device:
        raise ValueError(f"{fn}: g and y must be NCHW of one shape on one "
                         f"device, got {tuple(g.shape)} on {g.device} and "
                         f"{tuple(y.shape)} on {y.device}")
    n, c, h, w = g.shape
    if min(n, c, h, w) < 1 or n * c > 65535:
        raise ValueError(f"{fn}: {tuple(g.shape)}: the kernel takes 1 to "
                         "65535 planes N·C, none empty")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {g.device}")


def _launch(wrapper, g: torch.Tensor, y: torch.Tensor):
    n, c, h, w = g.shape
    masked = torch.empty_like(g)
    dbias = g.new_empty((c,), dtype=torch.float32)
    part = g.new_empty((n * c * -(-(h * w) // CHUNK),), dtype=torch.float32)
    kernels.launch(wrapper, wrapper.__name__, (g, y, masked, dbias, part),
                   (n, c, h * w))
    return masked, dbias


def bias_relu_bwd(g: torch.Tensor, y: torch.Tensor):
    """→ (masked [N, C, H, W] in g's type, dbias [C] float32), in one pass
    over g and y on the card; bf16 goes to ``bias_relu_bwd_bf16``."""
    _check("bias_relu_bwd", g, y)
    if g.dtype == torch.bfloat16:
        return bias_relu_bwd_bf16(g, y)
    if g.device.type == "cpu":
        return bias_relu_bwd_reference(g, y)
    return _launch(bias_relu_bwd, g, y)


def bias_relu_bwd_bf16(g: torch.Tensor, y: torch.Tensor):
    """``bias_relu_bwd`` on bf16 g and y → (masked bf16, dbias float32):
    the bf16 kernel on CUDA tensors, counted on
    ``bias_relu_bwd_bf16.launches``."""
    _check("bias_relu_bwd_bf16", g, y)
    if g.dtype != torch.bfloat16:
        raise TypeError(f"bias_relu_bwd_bf16: g is {g.dtype}; this is the "
                        "bfloat16 kernel")
    if g.device.type == "cpu":
        return bias_relu_bwd_reference(g, y)
    return _launch(bias_relu_bwd_bf16, g, y)


bias_relu_bwd.launches = 0
bias_relu_bwd_bf16.launches = 0
