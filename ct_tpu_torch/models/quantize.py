"""Post-training int8 quantization for the serving path: the port of
``ct_tpu/models/quantize.py``.

    net      ── fold_bn.fold_bn ──►  folded model (biased convs)
    folded   ── calibrate(...)  ──►  per-conv activation |max|
    both     ── quantize(...)   ──►  scales attached to the convs

A quantized ``Conv2d`` (``models/layers.py``) quantizes its input per
tensor, holds its weights per output channel, sums in int32 and rescales
in float32. The detection heads (loc/conf/obj) stay float by default
(``SKIP_DEFAULT``): their outputs feed box decode and score fusion.

Names are the port's module names (``base.21``, ``loc.0``,
``Norm.branch0.0.conv``); a skip pattern is matched against a conv's name
and each of its dotted prefixes, as the JAX package matches its patterns
against every key on a module's path.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ct_tpu_torch.models.layers import Conv2d

# head convs + CT projections stay float
SKIP_DEFAULT = (r"^(loc|conf|obj)\.\d+$", r"^(theta|phi|g|fc_base)$")
# the conf heads int8 too; loc (box decode) and obj (the score gate) float
SKIP_LOC_OBJ = (r"^(loc|obj)\.\d+$", r"^(theta|phi|g|fc_base)$")
# every head conv int8; the CT projections stay float
SKIP_CT_ONLY = (r"^(theta|phi|g|fc_base)$",)


def convs(net: nn.Module) -> Iterable[Tuple[str, Conv2d]]:
    """(name, module) of every conv that can take the int8 path."""
    return ((n, m) for n, m in net.named_modules() if isinstance(m, Conv2d))


@torch.no_grad()
def calibrate(net: nn.Module,
              batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Run calibration batches through ``net`` (eval mode, float) → each
    conv's input absmax, float32, maxima merged across batches, on the
    CPU."""
    merged: Dict[str, torch.Tensor] = {}

    def record(name):
        def hook(_module, args):
            m = args[0].detach().abs().amax().float().cpu()
            merged[name] = (m if name not in merged
                            else torch.maximum(merged[name], m))
        return hook

    hooks = [m.register_forward_pre_hook(record(n)) for n, m in convs(net)]
    try:
        seen = 0
        for images in batches:
            net(images)
            seen += 1
    finally:
        for h in hooks:
            h.remove()
    if not seen:
        raise ValueError("calibrate: need at least one calibration batch")
    return merged


def _skipped(name: str, skip_re) -> bool:
    parts = name.split(".")
    prefixes = [".".join(parts[:i]) for i in range(1, len(parts) + 1)]
    return any(r.match(p) for r in skip_re for p in prefixes)


def quantize_variables(
    net: nn.Module,
    calib: Dict[str, torch.Tensor],
    skip: Sequence[str] = SKIP_DEFAULT,
    chains: Sequence[Tuple[str, str]] = (),
) -> Dict[str, Dict[str, np.ndarray]]:
    """The scales of every calibrated conv whose name is not skipped →
    {name: {act_scale, kernel_int8 [O, I, kh, kw], kernel_scale [O]
    (, out_scale)}} as numpy, computed as the JAX package computes them:
    ``kernel_scale = max(max|W_o|/127, 1e-12)``, ``kernel_int8 =
    clip(rint(W / kernel_scale))``, ``act_scale = max(absmax/127, 1e-12)``.

    ``chains``: (producer, consumer) pairs separated only by ReLU and max
    pooling (``rfbnet.vgg_pool_chains``); the producer gets ``out_scale :=
    consumer act_scale`` and emits int8."""
    skip_re = [re.compile(s) for s in skip]
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, conv in convs(net):
        absmax: Optional[torch.Tensor] = calib.get(name)
        if absmax is None or _skipped(name, skip_re):
            continue
        w = conv.weight.detach().cpu().numpy().astype(np.float32)
        w_s = np.abs(w).reshape(w.shape[0], -1).max(1) / 127.0
        w_s = np.maximum(w_s, 1e-12).astype(np.float32)
        w8 = np.clip(np.rint(w / w_s[:, None, None, None]), -127, 127)
        out[name] = {
            "act_scale": np.float32(max(float(absmax) / 127.0, 1e-12)),
            "kernel_int8": w8.astype(np.int8),
            "kernel_scale": w_s,
        }
    for prod, cons in chains:
        if prod in out and cons in out:
            out[prod]["out_scale"] = out[cons]["act_scale"]
    return out


def attach(net: nn.Module, quant: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Put ``quant``'s scales on the named convs of ``net`` as buffers,
    which turns on their int8 path."""
    for name, q in quant.items():
        conv = net.get_submodule(name)
        if not isinstance(conv, Conv2d):
            raise TypeError(f"{name} is not a Conv2d")
        conv.set_quant(**{k: torch.as_tensor(np.asarray(v))
                          for k, v in q.items()})


def quantize(net: nn.Module, calib: Dict[str, torch.Tensor],
             skip: Sequence[str] = SKIP_DEFAULT,
             chains: Sequence[Tuple[str, str]] = ()
             ) -> Dict[str, Dict[str, np.ndarray]]:
    """``quantize_variables`` then ``attach``, on ``net`` in place; returns
    the scales."""
    quant = quantize_variables(net, calib, skip, chains)
    attach(net, quant)
    return quant
