"""Benches of the port, the counterparts of the JAX package's
``scripts/bench_ct_attention.py``, ``scripts/bench_ct_bwd.py`` (with
``bench_ct_bwd_512.py`` as ``--size 512``) and
``scripts/bench_bias_relu_bwd.py`` (kernels: ``python -m
ct_tpu_torch.scripts.<name> [--device cuda|cpu] [--iters N] [--batch B]``),
and ``scripts/bench_pipeline.py`` (loader → device augmentation → train
step: ``python -m ct_tpu_torch.scripts.bench_pipeline``).
"""

from __future__ import annotations

import torch


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu": the device a bench's numbers are of."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
