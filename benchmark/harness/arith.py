"""The yardstick's arithmetic: the card's peaks, the least time of the CT
head's kernels from their shapes, and the detector's FLOPs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3; exponentials
on the special-function units, 16 a clock on each of the 132 SMs at the
1,980 MHz boost clock (CUDA programming guide, compute capability 9.0).

The CT head's bounds are those of the port's kernel table (``PERF.md``,
kernel rows 1, 2, 3 and 6 in bf16): the products over the bf16 peak, the
B·P·K exponentials over the SFUs and the bytes each kernel must move,
the largest of the three.

FLOPs are counted by running the plain reference model on the ``meta``
device with a counting ``Numerics``: 2·MACs of every convolution and
dense layer from its output's shape, plus the CT attention's two products
(4·P·K·C an image) and its classifier (2·P·C·N).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import (
    CT_POOL, Model, Numerics, Task, anchors_per_cell,
)
from benchmark.reference.post import PRIORS

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
SFU_RATE = 16 * 132 * 1.98e9


def bound_s(flops: float, exps: float, nbytes: float) -> float:
    """The least seconds of a bf16 kernel: the larger of its products on
    the tensor cores and its exponentials on the SFUs, or its bytes."""
    return max(flops / PEAK_BF16, exps / SFU_RATE, nbytes / PEAK_BYTES)


def ct_eval_bound_s(b, c, p, k) -> float:
    """Row 1 in bf16: the eval forward ``ct_attention_cm_bf16``."""
    return bound_s(4 * b * p * k * c, b * p * k,
                   2 * (3 * b * c * p + 2 * b * k * c) + 4 * c)


def ct_stats_bound_s(b, c, p, k) -> float:
    """Row 2 in bf16: the training forward ``ct_attention_cm_stats_bf16``."""
    return bound_s(4 * b * p * k * c, b * p * k,
                   2 * (4 * b * c * p + 2 * b * k * c) + 4 * (2 * b * p + c))


def ct_flash_bwd_bound_s(b, c, p, k) -> float:
    """Row 3 in bf16: the flash backward ``ct_attention_cm_bwd_flash_bf16``."""
    return bound_s(10 * b * p * k * c, b * p * k,
                   2 * (3 * b * c * p + 2 * b * k * c)
                   + 4 * (2 * b * k * c + 3 * b * p + c))


def ct_serving_bound_s(b, c, p, k, n) -> float:
    """Row 6 in bf16: the fused serving head ``ct_attention_serving_bf16``."""
    return bound_s(2 * b * p * c * (2 * k + c + n), b * p * k,
                   2 * (b * c * p + b * n * p + 2 * b * k * c + c * c + n * c)
                   + 8 * c)


class _Count(Numerics):
    """Counts 2·MACs per image instead of checking values."""

    def __init__(self):
        super().__init__("float")
        self.flops: Dict[str, float] = {}

    def conv(self, name, x, w, b, stride, padding, dilation):
        y = torch.nn.functional.conv2d(x, w, b, stride, padding, dilation)
        self.flops[name] = 2.0 * y[0].numel() * w[0].numel()
        return y

    def dense(self, x, w, b):
        y = torch.nn.functional.linear(x, w, b)
        self.flops["dense." + str(len(self.flops))] = (
            2.0 * y[0].numel() * w.shape[1])
        return y


def forward_flops(state: Dict[str, torch.Tensor], task: Task,
                  size: int) -> Dict[str, float]:
    """FLOPs of one image's forward: ``conv`` (every convolution, heads
    included), ``ct`` (the CT head's dense layers, attention and
    classifier), and their sum ``total``."""
    meta = {k: torch.empty(v.shape, device="meta") for k, v in state.items()}
    count = _Count()
    model = Model(meta, task, size, numerics=count)
    with torch.no_grad():
        preds = model.forward(torch.empty(1, 3, size, size, device="meta"))
    p, k = preds.loc.shape[1], num_keys(size)
    c, n = task.src_classes, task.num_novel
    conv = sum(v for key, v in count.flops.items() if not key.startswith(
        "dense."))
    ct = (sum(v for key, v in count.flops.items() if key.startswith("dense."))
          + 4.0 * p * k * c + 2.0 * p * c * n)
    return {"conv": conv, "ct": ct, "total": conv + ct, "priors": p,
            "keys": k}


def num_keys(size: int) -> int:
    """K: the max-pooled context anchors (1,858 at 300, 4,964 at 512)."""
    return sum((-(-f // pool)) ** 2 * a for f, pool, a in zip(
        PRIORS[size][0], CT_POOL[size], anchors_per_cell(size)))
