"""Static architecture configs and the phase/setting/method task table.

The port's own copy of ``ct_tpu/config.py``: the anchor geometry of each
detector resolution and the few-shot protocol state machine that fixes
the class counts. Plain Python, no tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Anchor/feature-pyramid geometry for one detector resolution."""

    name: str
    min_dim: int
    feature_maps: Tuple[int, ...]
    steps: Tuple[int, ...]
    min_sizes: Tuple[float, ...]
    max_sizes: Tuple[float, ...]
    aspect_ratios: Tuple[Tuple[int, ...], ...]
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = True

    @property
    def anchors_per_cell(self) -> Tuple[int, ...]:
        # one min-size box + one geometric-mean box + 2 per extra aspect ratio
        return tuple(2 + 2 * len(ars) for ars in self.aspect_ratios)

    @property
    def num_priors(self) -> int:
        return sum(
            f * f * a for f, a in zip(self.feature_maps, self.anchors_per_cell)
        )

    def __post_init__(self):
        n = len(self.feature_maps)
        if not (len(self.steps) == len(self.min_sizes) == len(self.max_sizes)
                == len(self.aspect_ratios) == n):
            raise ValueError(f"{self.name}: per-level tuples differ in length")
        for v in self.variance:
            if v <= 0:
                raise ValueError("Variances must be greater than 0")


VOC_300 = SSDConfig(
    name="VOC_300",
    min_dim=300,
    feature_maps=(38, 19, 10, 5, 3, 1),
    steps=(8, 16, 32, 64, 100, 300),
    min_sizes=(30, 60, 111, 162, 213, 264),
    max_sizes=(60, 111, 162, 213, 264, 315),
    aspect_ratios=((2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

VOC_512 = SSDConfig(
    name="VOC_512",
    min_dim=512,
    feature_maps=(64, 32, 16, 8, 4, 2, 1),
    steps=(8, 16, 32, 64, 128, 256, 512),
    min_sizes=(35.84, 76.8, 153.6, 230.4, 307.2, 384.0, 460.8),
    max_sizes=(76.8, 153.6, 230.4, 307.2, 384.0, 460.8, 537.6),
    aspect_ratios=((2, 3), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

# Reduced-geometry config of the size-64 test model (sources: Norm at
# 16x16, RFB at 8x8); never a parity target on its own.
TINY_64 = SSDConfig(
    name="TINY_64",
    min_dim=64,
    feature_maps=(16, 8),
    steps=(4, 8),
    min_sizes=(16, 28),
    max_sizes=(28, 44),
    aspect_ratios=((2,), (2,)),
)

CONFIGS = {
    ("VOC", 300): VOC_300,
    ("VOC", 512): VOC_512,
}


def get_config(dataset: str, size: int) -> SSDConfig:
    try:
        return CONFIGS[(dataset, int(size))]
    except KeyError:
        raise ValueError(f"No SSD config for dataset={dataset} size={size}")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Resolved few-shot protocol state.

    ``src_cls_dim`` is the width of the conf head (source classes, no
    background: background is carried by the 2-way obj head), and
    ``num_classes`` the evaluation class count including background.
    """

    phase: int              # 1 = source pretraining, 2 = target fine-tuning
    setting: str            # 'transfer' | 'incre'
    method: str             # 'ours' | 'ft'
    dataset: str            # 'VOC' | 'COCO'
    src_cls_dim: int
    num_classes: int

    @property
    def has_ct_head(self) -> bool:
        return self.phase == 2 and self.method == "ours"

    @property
    def num_novel(self) -> int:
        """Rows of the cosine ``OBJ_Target`` classifier."""
        if self.setting == "transfer":
            return self.num_classes - 1
        return self.num_classes - 1 - self.src_cls_dim


def resolve_task(phase: int, setting: str, method: str, dataset: str) -> TaskSpec:
    if phase == 1:
        if dataset == "VOC":
            dims = (15, 16)
        elif dataset == "COCO":
            dims = (60, 61)
        else:
            raise ValueError(f"Unknown dataset: {dataset}")
    elif phase == 2:
        if setting == "transfer":
            if method == "ours":
                dims = (60, 21)
            elif method == "ft":
                dims = (20, 21)
            else:
                raise ValueError(f"Unknown method: {method}")
        elif setting == "incre":
            if method != "ours":
                raise ValueError(
                    "We only support our method for incremental setting."
                )
            dims = (15, 21)
        else:
            raise ValueError(f"Unknown setting: {setting}")
    else:
        raise ValueError(f"Unknown phase: {phase}")
    return TaskSpec(phase, setting, method, dataset, *dims)


# Mean BGR pixel values subtracted during preprocessing.
RGB_MEANS = (104.0, 117.0, 123.0)

# Training: probability of the zoom-out expand, and the IoU at which a
# prior matches a ground-truth box.
EXPAND_PROB = 0.6
OVERLAP_THRESHOLD = 0.5
