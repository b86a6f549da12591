"""NCHW building blocks: conv + BN + ReLU and the RFB blocks.

The float path of ``ct_tpu/models/layers.py``. Module and parameter names
follow the reference key space (``branch0.1.conv.weight``, ``bn.running_var``
...), so a state_dict loads with no renaming. BN keeps eps 1e-5 and torch
momentum 0.01. Max pooling is torch's own ``nn.MaxPool2d``, whose
``ceil_mode`` is the semantics the JAX package reproduces.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

Ints = Union[int, Tuple[int, int]]


class BasicConv(nn.Module):
    """Conv (no bias) → BN → (ReLU)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: Ints,
                 stride: Ints = 1, padding: Ints = 0, dilation: Ints = 1,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, out_planes, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, bias=False)
        self.bn = nn.BatchNorm2d(out_planes, eps=1e-5, momentum=0.01)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class BasicRFB(nn.Module):
    """Receptive-field block: 3 dilated branches + linear fuse + shortcut."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 scale: float = 0.1, visual: int = 1):
        super().__init__()
        self.scale = scale
        inter = in_planes // 8
        v = visual
        self.branch0 = nn.Sequential(
            BasicConv(in_planes, 2 * inter, 1, stride=stride),
            BasicConv(2 * inter, 2 * inter, 3, padding=v, dilation=v,
                      relu=False),
        )
        self.branch1 = nn.Sequential(
            BasicConv(in_planes, inter, 1),
            BasicConv(inter, 2 * inter, 3, stride=stride, padding=1),
            BasicConv(2 * inter, 2 * inter, 3, padding=v + 1,
                      dilation=v + 1, relu=False),
        )
        self.branch2 = nn.Sequential(
            BasicConv(in_planes, inter, 1),
            BasicConv(inter, (inter // 2) * 3, 3, padding=1),
            BasicConv((inter // 2) * 3, 2 * inter, 3, stride=stride,
                      padding=1),
            BasicConv(2 * inter, 2 * inter, 3, padding=2 * v + 1,
                      dilation=2 * v + 1, relu=False),
        )
        self.ConvLinear = BasicConv(6 * inter, out_planes, 1, relu=False)
        self.shortcut = BasicConv(in_planes, out_planes, 1, stride=stride,
                                  relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                        dim=1)
        out = self.ConvLinear(out)
        return torch.relu(out * self.scale + self.shortcut(x))


class BasicRFBa(nn.Module):
    """RFB-s variant (the 'Norm' block on the conv4_3 map): 4 thin branches."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 scale: float = 0.1):
        super().__init__()
        self.scale = scale
        inter = in_planes // 4
        self.branch0 = nn.Sequential(
            BasicConv(in_planes, inter, 1),
            BasicConv(inter, inter, 3, padding=1, relu=False),
        )
        self.branch1 = nn.Sequential(
            BasicConv(in_planes, inter, 1),
            BasicConv(inter, inter, (3, 1), padding=(1, 0)),
            BasicConv(inter, inter, 3, padding=3, dilation=3, relu=False),
        )
        self.branch2 = nn.Sequential(
            BasicConv(in_planes, inter, 1),
            BasicConv(inter, inter, (1, 3), stride=stride, padding=(0, 1)),
            BasicConv(inter, inter, 3, padding=3, dilation=3, relu=False),
        )
        self.branch3 = nn.Sequential(
            BasicConv(in_planes, inter // 2, 1),
            BasicConv(inter // 2, (inter // 4) * 3, (1, 3), padding=(0, 1)),
            BasicConv((inter // 4) * 3, inter, (3, 1), stride=stride,
                      padding=(1, 0)),
            BasicConv(inter, inter, 3, padding=5, dilation=5, relu=False),
        )
        self.ConvLinear = BasicConv(4 * inter, out_planes, 1, relu=False)
        self.shortcut = BasicConv(in_planes, out_planes, 1, stride=stride,
                                  relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                         self.branch3(x)], dim=1)
        out = self.ConvLinear(out)
        return torch.relu(out * self.scale + self.shortcut(x))
