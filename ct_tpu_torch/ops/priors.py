"""SSD anchor (prior box) generation, the port of ``ct_tpu/ops/priors.py``.

Ordering: row-major over (row i, col j) cells per pyramid level, anchors
innermost in the order [min-size, geometric-mean, (√ar, 1/√ar) and
(1/√ar, √ar) per extra aspect ratio]. Priors are in center-size form,
normalized to [0, 1] image coordinates, optionally clipped. 11,620 priors
at 300, 32,756 at 512.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ct_tpu_torch.config import SSDConfig


def prior_boxes_np(cfg: SSDConfig) -> np.ndarray:
    """Priors as a float32 numpy array of shape [num_priors, 4]."""
    levels = []
    for k, f in enumerate(cfg.feature_maps):
        f_k = cfg.min_dim / cfg.steps[k]
        s_k = cfg.min_sizes[k] / cfg.min_dim
        s_k_prime = math.sqrt(s_k * (cfg.max_sizes[k] / cfg.min_dim))

        whs = [(s_k, s_k), (s_k_prime, s_k_prime)]
        for ar in cfg.aspect_ratios[k]:
            r = math.sqrt(ar)
            whs.append((s_k * r, s_k / r))
            whs.append((s_k / r, s_k * r))
        whs = np.asarray(whs, dtype=np.float64)          # [A, 2]

        # cell centers: i is the row (cy), j the column (cx)
        idx = (np.arange(f, dtype=np.float64) + 0.5) / f_k
        cy, cx = np.meshgrid(idx, idx, indexing="ij")     # [f, f]
        centers = np.stack([cx, cy], axis=-1)             # [f, f, 2]

        a = whs.shape[0]
        level = np.concatenate(
            [
                np.broadcast_to(centers[:, :, None, :], (f, f, a, 2)),
                np.broadcast_to(whs[None, None, :, :], (f, f, a, 2)),
            ],
            axis=-1,
        ).reshape(-1, 4)
        levels.append(level)

    out = np.concatenate(levels, axis=0).astype(np.float32)
    if cfg.clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def prior_boxes(cfg: SSDConfig, device="cpu") -> torch.Tensor:
    """Priors as a float32 tensor [num_priors, 4] (center-size form)."""
    return torch.from_numpy(prior_boxes_np(cfg)).to(device)
