"""Ragged annotations → fixed-shape padded arrays.

The port of ``ct_tpu/data/targets.py`` (``pad_targets``). Annotation rows
are ``[x1, y1, x2, y2, label, weight]`` in percent coordinates (weight is
the mixup weight, 1.0 without mixup; label -1 = ignore).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class PaddedTargets(NamedTuple):
    boxes: np.ndarray    # [B, M, 4] float32
    labels: np.ndarray   # [B, M] int32
    weights: np.ndarray  # [B, M] float32
    valid: np.ndarray    # [B, M] bool


MAX_OBJS = 100


def pad_targets(annos: Sequence[np.ndarray],
                max_objs: int = MAX_OBJS) -> PaddedTargets:
    """Pad a batch of ragged [N_i, 6] annotation arrays to [B, max_objs, …].

    Rows beyond ``max_objs`` are dropped; padded rows are valid=False with
    unit boxes (a zero-size box would give log(0) in the encode of
    unmatched priors, and inf·0 = nan in the loss).
    """
    b = len(annos)
    boxes = np.tile(np.asarray([0, 0, 1, 1], dtype=np.float32),
                    (b, max_objs, 1))
    labels = np.zeros((b, max_objs), dtype=np.int32)
    weights = np.zeros((b, max_objs), dtype=np.float32)
    valid = np.zeros((b, max_objs), dtype=bool)
    for i, a in enumerate(annos):
        a = np.asarray(a, dtype=np.float32).reshape(-1, 6)
        n = min(a.shape[0], max_objs)
        boxes[i, :n] = a[:n, :4]
        labels[i, :n] = a[:n, 4].astype(np.int32)
        weights[i, :n] = a[:n, 5]
        valid[i, :n] = True
    return PaddedTargets(boxes, labels, weights, valid)
