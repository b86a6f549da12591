"""PyTorch/CUDA port of ct_tpu for one NVIDIA H100.

The package mirrors ``ct_tpu``'s module names, keeps its public layouts
([B, C, P] class-major for the Context-Transformer attention, [B, P, 4] /
[B, P, C] for predictions) and imports nothing of it. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations


def resolve_device(device="cuda") -> "torch.device":
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A CUDA request on a host without a card raises."""
    # torch is imported where it is used: the loader's worker processes
    # import the package for their dataset and need no torch
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
