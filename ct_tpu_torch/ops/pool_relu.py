"""Fused 2×2/s2 max pool + ReLU that closes the conv1 stage in training.

The port of ``pool2x2_packed_relu`` (``ct_tpu/ops/pool_packed_pallas.py``)
in the port's NCHW layout: ``relu(max_pool2d(x, 2, 2))`` for x [N, C, H, W]
with H and W even, and its gradient, which routes g to the first maximum
of each window in row-major order — (0,0), (0,1), (1,0), (1,1) — found by
comparing x with the saved rectified output y, and to nothing where
y ≤ 0. That equals torch's autograd of ``F.relu`` then ``F.max_pool2d``
bit for bit (max_pool2d keeps the first maximum of a window).

``pool2x2_relu_fwd`` and ``pool2x2_relu_bwd`` launch the hand-written CUDA
kernels (``csrc/pool2x2_relu.cu``) for CUDA tensors, counting launches in
``.launches``, and take their plain versions for CPU tensors.
``pool2x2_relu`` is the differentiable entry. bfloat16 tensors (the
``--bf16`` training model) go to the bf16 instantiation of the same
kernels, counted on ``pool2x2_relu_fwd_bf16.launches`` and
``pool2x2_relu_bwd_bf16.launches``: the max, the ReLU and the tie routing
are exact in any type, so the result is bit for bit the plain version's,
as the JAX kernel's bf16 pass is its XLA composition's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ct_tpu_torch import kernels


def pool2x2_relu_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain forward."""
    return torch.relu(F.max_pool2d(x, 2, 2))


def pool2x2_relu_bwd_reference(x: torch.Tensor, y: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """The plain backward: the first-max priority chain in torch ops."""
    n, c, h2, w2 = y.shape
    xw = x.reshape(n, c, h2, 2, w2, 2)
    geff = torch.where(y > 0, g, torch.zeros_like(g))
    e = [xw[:, :, :, r, :, s] == y for r in (0, 1) for s in (0, 1)]
    w00 = e[0]
    w01 = e[1] & ~w00
    w10 = e[2] & ~(w00 | w01)
    w11 = e[3] & ~(w00 | w01 | w10)
    zero = torch.zeros_like(geff)
    d = [torch.where(w, geff, zero) for w in (w00, w01, w10, w11)]
    # [N, C, H2, 2, W2, 2] with window row r and column s
    row0 = torch.stack([d[0], d[1]], dim=-1)
    row1 = torch.stack([d[2], d[3]], dim=-1)
    return torch.stack([row0, row1], dim=3).reshape(x.shape)


def _check(x: torch.Tensor, name: str = "pool2x2_relu") -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x is {x.dtype}, the kernel takes float32 "
                        "or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NCHW, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    if h % 2 or w % 2 or min(n, c, h, w) < 1:
        raise ValueError(f"{name}: H and W must be even and nothing empty, "
                         f"got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")


def _launch_fwd(wrapper, x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    y = x.new_empty((n, c, h // 2, w // 2))
    kernels.launch(wrapper, wrapper.__name__, (x, y), (n * c, h, w))
    return y


def _launch_bwd(wrapper, x: torch.Tensor, y: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    for name, t in (("y", y), ("g", g)):
        if (tuple(t.shape) != (n, c, h // 2, w // 2)
                or t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{wrapper.__name__}: {name} must be {x.dtype} "
                             f"[{n}, {c}, {h // 2}, {w // 2}] on {x.device}")
    if x.device.type == "cpu":
        return pool2x2_relu_bwd_reference(x, y, g)
    dx = torch.empty_like(x)
    kernels.launch(wrapper, wrapper.__name__, (x, y, g, dx), (n * c, h, w))
    return dx


def pool2x2_relu_fwd(x: torch.Tensor) -> torch.Tensor:
    """relu(2×2/s2 max pool): [N, C, H, W] → [N, C, H/2, W/2] in x's type;
    bf16 x goes to ``pool2x2_relu_fwd_bf16``."""
    _check(x, "pool2x2_relu_fwd")
    if x.dtype == torch.bfloat16:
        return pool2x2_relu_fwd_bf16(x)
    if x.device.type == "cpu":
        return pool2x2_relu_reference(x)
    return _launch_fwd(pool2x2_relu_fwd, x)


def pool2x2_relu_bwd(x: torch.Tensor, y: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """Gradient of ``pool2x2_relu_fwd`` at x, from its output y and the
    upstream gradient g, both in x's type → [N, C, H, W] in x's type; bf16
    goes to ``pool2x2_relu_bwd_bf16``."""
    _check(x, "pool2x2_relu_bwd")
    if x.dtype == torch.bfloat16:
        return pool2x2_relu_bwd_bf16(x, y, g)
    return _launch_bwd(pool2x2_relu_bwd, x, y, g)


def pool2x2_relu_fwd_bf16(x: torch.Tensor) -> torch.Tensor:
    """``pool2x2_relu_fwd`` on bf16 x: the bf16 kernel on CUDA tensors,
    counted on ``pool2x2_relu_fwd_bf16.launches``."""
    _check(x, "pool2x2_relu_fwd_bf16")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pool2x2_relu_fwd_bf16: x is {x.dtype}")
    if x.device.type == "cpu":
        return pool2x2_relu_reference(x)
    return _launch_fwd(pool2x2_relu_fwd_bf16, x)


def pool2x2_relu_bwd_bf16(x: torch.Tensor, y: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """``pool2x2_relu_bwd`` on bf16 x, y and g: the bf16 kernel on CUDA
    tensors, counted on ``pool2x2_relu_bwd_bf16.launches``."""
    _check(x, "pool2x2_relu_bwd_bf16")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pool2x2_relu_bwd_bf16: x is {x.dtype}")
    return _launch_bwd(pool2x2_relu_bwd_bf16, x, y, g)


for _fn in (pool2x2_relu_fwd, pool2x2_relu_bwd, pool2x2_relu_fwd_bf16,
            pool2x2_relu_bwd_bf16):
    _fn.launches = 0


class _Pool2x2ReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = pool2x2_relu_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return pool2x2_relu_bwd(x, y, g.contiguous())


def pool2x2_relu(x: torch.Tensor) -> torch.Tensor:
    """relu(max_pool2d(x, 2, 2)) on NCHW float32 or bfloat16,
    differentiable: the forward and backward kernels on the card, their
    plain versions on the CPU."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pool2x2ReLU.apply(x)
    return pool2x2_relu_fwd(x)
