"""NCHW building blocks: conv + BN + ReLU and the RFB blocks.

The port of ``ct_tpu/models/layers.py``. Module and parameter names follow
the reference key space (``branch0.1.conv.weight``, ``bn.running_var``
...), so a state_dict loads with no renaming. BN keeps eps 1e-5 and torch
momentum 0.01. Max pooling is torch's own, whose ``ceil_mode`` is the
semantics the JAX package reproduces.

The serving path's pieces live here too: ``BasicConv(fold_bn=True)`` (a
biased conv and no BN, for weights folded by ``models/fold_bn.py``) and
the int8 side of the JAX package's ``Conv2d`` and ``max_pool2d``.

A compute dtype (``Conv2d.compute_dtype``, set by ``RFBNet(dtype=...)``)
runs the JAX package's ``dtype=bfloat16`` model: parameters stay float32;
a conv casts its input and kernel to bfloat16 and emits bfloat16, then adds
its bias in bfloat16 (``promote_dtype``, then ``y + bias``); BN takes the
bf16 map with its float32 statistics and emits bf16 (``nn.BatchNorm2d``
computes in float32 and rounds once, as flax's ``dtype=bf16`` BN does; in
train mode it takes the batch statistics in float32 too, as flax's
``force_float32_reductions`` does; torch sums the variance about the
mean where flax takes E[x²] − E[x]², which differ in float32 rounding
alone; and its backward
returns the bf16 cotangent of the bf16 input); the ReLU, the pools and the
RFB blocks' ``out·scale + shortcut`` follow the type of their inputs, the
ReLU's gradient that of its cotangent (``relu_save_out``). An int8 conv
rescales in float32 and emits the compute dtype.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Ints = Union[int, Tuple[int, int]]

# torch._int_mm on the card takes M > 16 rows and K, N multiples of 8
_MM_MIN_ROWS, _MM_MULTIPLE = 17, 8


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor int8 quantization: clip(round(x / scale), -127, 127),
    rounding half to even, by a division as the JAX package divides."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times wᵀ for w [N, K] int8 → exact int32 [M, N].

    ``torch._int_mm``, with M padded to at least 17 rows and K and N to
    multiples of 8 by zeros, which add nothing to the sums."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_ = _round_up(k, _MM_MULTIPLE), _round_up(n, _MM_MULTIPLE)
    a = F.pad(a, (0, kp - k, 0, max(0, _MM_MIN_ROWS - m)))
    w = F.pad(w, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, w.t())[:m, :n]


def conv2d_int8(x8: torch.Tensor, w8: torch.Tensor, stride: Tuple[int, int],
                padding: Tuple[int, int],
                dilation: Tuple[int, int]) -> torch.Tensor:
    """Convolution of int8 x [B, C, H, W] with int8 w [O, C, kh, kw],
    zero padding → exact int32 [B, O, Ho, Wo].

    An im2col built from strided views of the padded input in NHWC order
    (``F.unfold`` takes no int8), then one ``int8_matmul``: every product
    and sum is an integer, so the result does not depend on the order of
    the sums, as the JAX package's int32-accumulating conv does not."""
    b, c, h, w = x8.shape
    o, _, kh, kw = w8.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xn = F.pad(x8, (pw, pw, ph, ph)).permute(0, 2, 3, 1).contiguous()
    taps = [xn[:, i * dh:i * dh + sh * (ho - 1) + 1:sh,
               j * dw:j * dw + sw * (wo - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    cols = torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c)
    wmat = w8.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    acc = int8_matmul(cols, wmat)
    return acc.view(b, ho, wo, o).permute(0, 3, 1, 2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and keys) with the int8 serving path
    of the JAX package's ``Conv2d`` (``ct_tpu/models/layers.py``).

    The float path is ``nn.Conv2d``'s. ``set_quant`` attaches the scales
    that ``models/quantize.py`` computes, as buffers, and turns the int8
    path on: activations per tensor (``act_scale``), weights per output
    channel (``kernel_int8``, ``kernel_scale``), an exact int32 sum, then
    ``y = acc · (act_scale · kernel_scale) + bias`` in float32. With
    ``out_scale`` the conv emits int8 at that scale, its consumer's
    ``act_scale`` (a chain across max pools, ``vgg_pool_chains``); an int8
    input is taken as already quantized at this conv's ``act_scale``.
    """

    # None: float32 throughout; torch.bfloat16: the JAX package's
    # dtype=bfloat16 conv (see the module docstring)
    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for name in ("act_scale", "kernel_int8", "kernel_scale",
                     "out_scale"):
            self.register_buffer(name, None)

    def set_quant(self, act_scale: torch.Tensor, kernel_int8: torch.Tensor,
                  kernel_scale: torch.Tensor,
                  out_scale: Optional[torch.Tensor] = None) -> None:
        dev = self.weight.device
        if tuple(kernel_int8.shape) != tuple(self.weight.shape):
            raise ValueError(f"kernel_int8 {tuple(kernel_int8.shape)} does "
                             f"not fit weight {tuple(self.weight.shape)}")
        self.act_scale = act_scale.to(dev, torch.float32).reshape(())
        self.kernel_int8 = kernel_int8.to(dev, torch.int8)
        self.kernel_scale = kernel_scale.to(dev, torch.float32).reshape(-1)
        self.out_scale = (None if out_scale is None else
                          out_scale.to(dev, torch.float32).reshape(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_int8 is None:
            if x.dtype == torch.int8:
                raise TypeError("an int8 activation reached a float conv: "
                                "its producer's out_scale chains it to a "
                                "conv that was not quantized")
            dt = self.compute_dtype
            if dt is None:
                return super().forward(x)
            y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
            if self.bias is not None:
                y = y + self.bias.to(dt)[None, :, None, None]
            return y
        x8 = x if x.dtype == torch.int8 else quantize_act(x, self.act_scale)
        acc = conv2d_int8(x8, self.kernel_int8, self.stride, self.padding,
                          self.dilation)
        y = acc.float() * (self.act_scale * self.kernel_scale)[
            None, :, None, None]
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        if self.out_scale is not None:
            return quantize_act(y, self.out_scale)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` that also pools the chained int8 activations of the
    serving path. They are pooled in float16, which holds every int8 value
    exactly: the implicit -inf padding never wins against values clipped
    to [-127, 127], as the JAX package's -128 padding never does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.int8:
            return super().forward(x.half()).to(torch.int8)
        return super().forward(x)


class BasicConv(nn.Module):
    """Conv (no bias) → BN → (ReLU); with ``fold_bn`` a biased conv and no
    BN, for weights whose BN is folded in (``models/fold_bn.py``)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: Ints,
                 stride: Ints = 1, padding: Ints = 0, dilation: Ints = 1,
                 relu: bool = True, fold_bn: bool = False):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel_size,
                           stride=stride, padding=padding,
                           dilation=dilation, bias=fold_bn)
        self.bn = (nn.Identity() if fold_bn else
                   nn.BatchNorm2d(out_planes, eps=1e-5, momentum=0.01))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class BasicRFB(nn.Module):
    """Receptive-field block: 3 dilated branches + linear fuse + shortcut."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 scale: float = 0.1, visual: int = 1, fold_bn: bool = False):
        super().__init__()
        self.scale = scale
        inter = in_planes // 8
        v = visual
        conv = functools.partial(BasicConv, fold_bn=fold_bn)
        self.branch0 = nn.Sequential(
            conv(in_planes, 2 * inter, 1, stride=stride),
            conv(2 * inter, 2 * inter, 3, padding=v, dilation=v,
                 relu=False),
        )
        self.branch1 = nn.Sequential(
            conv(in_planes, inter, 1),
            conv(inter, 2 * inter, 3, stride=stride, padding=1),
            conv(2 * inter, 2 * inter, 3, padding=v + 1,
                 dilation=v + 1, relu=False),
        )
        self.branch2 = nn.Sequential(
            conv(in_planes, inter, 1),
            conv(inter, (inter // 2) * 3, 3, padding=1),
            conv((inter // 2) * 3, 2 * inter, 3, stride=stride,
                 padding=1),
            conv(2 * inter, 2 * inter, 3, padding=2 * v + 1,
                 dilation=2 * v + 1, relu=False),
        )
        self.ConvLinear = conv(6 * inter, out_planes, 1, relu=False)
        self.shortcut = conv(in_planes, out_planes, 1, stride=stride,
                             relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                        dim=1)
        out = self.ConvLinear(out)
        return torch.relu(out * self.scale + self.shortcut(x))


class BasicRFBa(nn.Module):
    """RFB-s variant (the 'Norm' block on the conv4_3 map): 4 thin branches."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 scale: float = 0.1, fold_bn: bool = False):
        super().__init__()
        self.scale = scale
        inter = in_planes // 4
        conv = functools.partial(BasicConv, fold_bn=fold_bn)
        self.branch0 = nn.Sequential(
            conv(in_planes, inter, 1),
            conv(inter, inter, 3, padding=1, relu=False),
        )
        self.branch1 = nn.Sequential(
            conv(in_planes, inter, 1),
            conv(inter, inter, (3, 1), padding=(1, 0)),
            conv(inter, inter, 3, padding=3, dilation=3, relu=False),
        )
        self.branch2 = nn.Sequential(
            conv(in_planes, inter, 1),
            conv(inter, inter, (1, 3), stride=stride, padding=(0, 1)),
            conv(inter, inter, 3, padding=3, dilation=3, relu=False),
        )
        self.branch3 = nn.Sequential(
            conv(in_planes, inter // 2, 1),
            conv(inter // 2, (inter // 4) * 3, (1, 3), padding=(0, 1)),
            conv((inter // 4) * 3, inter, (3, 1), stride=stride,
                 padding=(1, 0)),
            conv(inter, inter, 3, padding=5, dilation=5, relu=False),
        )
        self.ConvLinear = conv(4 * inter, out_planes, 1, relu=False)
        self.shortcut = conv(in_planes, out_planes, 1, stride=stride,
                             relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                         self.branch3(x)], dim=1)
        out = self.ConvLinear(out)
        return torch.relu(out * self.scale + self.shortcut(x))
