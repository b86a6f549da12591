"""The inputs of a cell, read once a process: the fixture's images and
the configuration's weights, checked against the digests the
configuration names."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from benchmark.harness import data, weights
from benchmark.reference.model import Task


class Inputs:
    """Decoded images and weights, keyed by what they depend on."""

    def __init__(self):
        self._cache: Dict[tuple, object] = {}

    def _once(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @staticmethod
    def task(cell) -> Task:
        c = cell.config
        return Task(c["setting"], c["src_classes"], c["num_classes"])

    def fixture(self, cell) -> data.Fixture:
        c = cell.config
        return data.Fixture(os.path.join(cell.root, c["fixture"]),
                            c["class_split"])

    def _ids(self, cell, sets, digest_key):
        """The image ids of ``sets``, their files checked once."""
        c = cell.config
        fx = self.fixture(cell)
        ids = [i for year, name in sets for i in fx.ids(year, name)]

        def check():
            if digest_key in c:
                data.check_digest(f"{c['fixture']} {digest_key}",
                                  fx.digest(ids), c[digest_key])
            return ids
        return self._once(("ids", str(cell.root), c["fixture"],
                           tuple(map(tuple, sets))), check)

    def _images(self, cell, sets, digest_key):
        c = cell.config
        ids = self._ids(cell, sets, digest_key)
        return self._once((str(cell.root), c["fixture"], tuple(map(tuple,
                           sets)), c["size"], c["class_split"]),
                          lambda: self.fixture(cell).load(ids, c["size"]))

    def test(self, cell) -> data.Images:
        return self._images(cell, cell.config["test_sets"], "test_sha256")

    def trainval(self, cell) -> data.Images:
        return self._images(cell, cell.config["trainval_sets"],
                            "trainval_sha256")

    def calibration(self, cell, seed: int) -> torch.Tensor:
        """The int8 calibration batch: trainval images drawn by ``seed``,
        float32 NCHW, the mean subtracted."""
        c = cell.config
        ids = self._ids(cell, c["trainval_sets"], "trainval_sha256")
        pick = np.random.default_rng([seed, 4]).choice(
            len(ids), cell.workload["program"]["calib_images"],
            replace=False)
        images = self.fixture(cell).load([ids[i] for i in pick], c["size"])
        return torch.from_numpy(data.normalized(images.pixels))

    def state(self, cell, seed: int, device) -> Dict[str, torch.Tensor]:
        """The weights the cell starts from: the configuration's trained
        checkpoint (on the CPU, as read), or drawn from ``seed`` on
        ``device``."""
        c = cell.config
        if c["weights"] == "seeded":
            return weights.draw(self.task(cell), c["size"], seed, device)
        path = os.path.join(cell.root, c["weights"])

        def make():
            if "weights_sha256" in c:
                data.check_digest(c["weights"], data.sha256_file(path),
                                  c["weights_sha256"])
            return weights.load_checkpoint(path)
        return self._once(("weights", path), make)
