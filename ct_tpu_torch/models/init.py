"""The JAX package's initialisers for weights a run does not load.

``build_net`` leaves torch's defaults in place (``kaiming_uniform(a=√5)``
kernels, random biases): evaluation loads every weight, and tests that
build seeded port models rely on those defaults. A training run starts
from the JAX package's ``init_train_state`` instead, whose flax modules
draw (``ct_tpu/models/layers.py``, ``ct_tpu/models/rfbnet.py``):

* ``BasicConv``'s conv kernel and the θ/φ/g kernels: ``he_normal``;
* every other conv kernel (the VGG trunk, the loc/conf/obj heads):
  ``lecun_normal``;
* every bias, ``Wz`` and the ``fc_base`` kernel: zeros;
* ``OBJ_Target``: ``normal(0.02)``, not truncated;
* BatchNorm: scale 1, bias 0.

Flax's ``variance_scaling(scale, "fan_in", "truncated_normal")`` draws a
normal truncated to ±2 and multiplies it by ``sqrt(scale / fan_in) /
0.87962566103423978`` (the truncated unit normal's standard deviation),
``fan_in`` being kh·kw·in_channels for a conv kernel and in_features for
a dense one; ``he_normal`` is scale 2, ``lecun_normal`` scale 1.

``init_like_jax`` draws every value from one CPU ``torch.Generator``, in
the order of ``model.named_parameters()``, and copies it to the
parameter's device: the same seed gives the same weights on the CPU and
on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch import nn

from ct_tpu_torch.models.layers import BasicConv

TRUNC_STD = 0.87962566103423978   # std of the unit normal cut at ±2
OBJ_TARGET_STD = 0.02


def variance_scaling_std(scale: float, fan_in: int) -> float:
    """The standard deviation of the normal that flax truncates to ±2."""
    return math.sqrt(scale / fan_in) / TRUNC_STD


def fan_in(weight: torch.Tensor) -> int:
    """kh·kw·in_channels of a conv kernel [O, I, kh, kw], in_features of a
    dense one [O, I]."""
    return math.prod(weight.shape[1:])


def _truncated(scale: float) -> Callable:
    def draw(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        std = variance_scaling_std(scale, fan_in(p))
        out = torch.empty(p.shape, dtype=torch.float32)
        return nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                     generator=gen)
    return draw


def _normal(std: float) -> Callable:
    def draw(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return torch.randn(p.shape, generator=gen) * std
    return draw


def _const(value: float) -> Callable:
    return lambda p, gen: torch.full(p.shape, value, dtype=torch.float32)


he_normal, lecun_normal = _truncated(2.0), _truncated(1.0)
zeros, ones = _const(0.0), _const(1.0)


def initializers(model: nn.Module) -> Dict[str, Callable]:
    """Parameter name → the JAX package's initialiser for it. Raises on a
    parameter it has no rule for."""
    rules: Dict[str, Callable] = {}
    basic_convs = {id(m.conv) for m in model.modules()
                   if isinstance(m, BasicConv)}
    for prefix, m in model.named_modules():
        own = dict(m.named_parameters(prefix=prefix, recurse=False))
        if not own:
            continue
        if isinstance(m, nn.Conv2d):
            kernel = he_normal if id(m) in basic_convs else lecun_normal
            rules.update({n: kernel if n.endswith(".weight") else zeros
                          for n in own})
        elif isinstance(m, nn.BatchNorm2d):
            rules.update({n: ones if n.endswith(".weight") else zeros
                          for n in own})
        elif isinstance(m, nn.Linear) and prefix in ("theta", "phi", "g"):
            rules.update({n: he_normal if n.endswith(".weight") else zeros
                          for n in own})
        elif isinstance(m, nn.Linear) and prefix == "fc_base":
            rules.update(dict.fromkeys(own, zeros))
        elif isinstance(m, nn.Linear) and prefix == "OBJ_Target":
            rules.update(dict.fromkeys(own, _normal(OBJ_TARGET_STD)))
        elif prefix == "":
            rules.update({n: zeros for n in own if n == "Wz"})
    missing = [n for n, _ in model.named_parameters() if n not in rules]
    if missing:
        raise ValueError(f"init_like_jax: no initialiser for {missing}")
    return rules


@torch.no_grad()
def init_like_jax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Give every parameter of ``model`` the JAX package's initialiser
    (module docstring), drawn from ``generator`` (a CPU generator, seeded
    from the run's seed); buffers such as BatchNorm's running statistics
    keep their values. Returns ``model``."""
    rules = initializers(model)
    for name, p in model.named_parameters():
        p.copy_(rules[name](p, generator))
    return model
