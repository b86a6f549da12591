"""Infinite shuffled index stream for iteration-based training.

The port of ``TrainingSampler`` (``ct_tpu/train/sampler.py``, always
shuffling): an endless stream of dataset indices, reshuffled every epoch
from a seeded numpy generator.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class TrainingSampler:
    def __init__(self, size: int, seed: Optional[int] = None):
        if size <= 0:
            raise ValueError(f"TrainingSampler: size must be positive, got "
                             f"{size}")
        self._size = size
        self._rng = np.random.default_rng(
            seed if seed is not None else np.random.SeedSequence().entropy)

    def __iter__(self) -> Iterator[int]:
        while True:
            yield from self._rng.permutation(self._size).tolist()
