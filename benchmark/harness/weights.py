"""The weights a cell starts from: a trained checkpoint read by the
benchmark, or weights drawn from the seed on the device.

Drawn weights follow the JAX package's initialisers, which the port's
training starts from (``init_train_state``; its rules, copied here):
``he_normal`` for the convs inside conv+BN blocks and for θ/φ/g,
``lecun_normal`` for the other convs (the VGG trunk and the heads), zeros
for every bias, ``Wz`` and ``fc_base``, ``normal(0.02)`` for
``OBJ_Target``, and BN scale 1 and shift 0 with running mean 0 and
variance 1. ``he_normal`` and ``lecun_normal`` are flax's
``variance_scaling(2 or 1, "fan_in", "truncated_normal")``: a unit normal
cut at ±2 times √(scale / fan_in) / 0.8796256610342398. All draws come
from one ``torch.Generator`` on the device in two calls (one truncated
normal for every such kernel, one normal for ``OBJ_Target``), in the
types the program keeps its parameters in (float32).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

from benchmark.reference.model import Task, param_shapes

TRUNC_STD = 0.87962566103423978
HE = re.compile(r"(\.conv\.weight|^(theta|phi|g)\.weight)$")
LECUN = re.compile(r"^(base|loc|conf|obj)\.\d+\.weight$")


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (``{"model": state_dict}`` or a bare one) →
    its state dict on the CPU, without a ``module.`` prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    out = {}
    for key, val in obj.items():
        key = key[len("module."):] if key.startswith("module.") else key
        out[key] = val.reshape(()) if key.endswith(
            "num_batches_tracked") else val
    return out


def draw(task: Task, size: int, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """The JAX package's initialisation of the detector from ``seed``."""
    shapes = param_shapes(task, size)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = [(k, s) for k, s in shapes.items()
               if HE.search(k) or LECUN.match(k)]
    flat = torch.empty(sum(math.prod(s) for _, s in kernels), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        scale = 2.0 if HE.search(key) else 1.0
        std = math.sqrt(scale / math.prod(shape[1:])) / TRUNC_STD
        out[key] = flat[at:at + n].view(shape) * std
        at += n
    obj = shapes["OBJ_Target.weight"]
    out["OBJ_Target.weight"] = torch.randn(obj, generator=gen,
                                           device=device) * 0.02
    for key, shape in shapes.items():
        if key in out:
            continue
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
        elif key == "scale":
            out[key] = torch.full(shape, 5.0, device=device)
        elif key.endswith(("bn.weight", "running_var")):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out
