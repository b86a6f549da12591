"""Weights into the port: JAX variables or a reference ``.pth``.

The port's modules use the reference key space, so a reference state_dict
loads as it is. ``from_jax_variables`` maps the JAX package's flax
``{'params', 'batch_stats'}`` (as numpy arrays) into that key space; it is
the port's own copy of ``variables_to_torch_state``
(``ct_tpu/models/torch_export.py``):

  vgg_{i}/{kernel,bias}                 → base.{i}.{weight,bias}
  Norm|extras_{k}/branchA_B/conv/kernel → Norm|extras.{k}.branchA.B.conv.weight
  …/bn/{scale,bias}                     → …bn.{weight,bias}
  batch_stats …/bn/{mean,var}           → …bn.running_{mean,var}
  loc_{i}|conf_{i}|obj_{i}/…            → loc|conf|obj.{i}.…
  theta|phi|g|fc_base (Dense)           → Linear weight (transposed) / bias
  Wz → Wz;  OBJ_Target → OBJ_Target.weight;  scale → tensor([5.])

Layouts: conv [kh,kw,I,O] → [O,I,kh,kw]; linear [I,O] → [O,I].

``quant_from_jax`` maps the JAX package's int8 ``quant`` collection
(``ct_tpu/models/quantize.py``) into the port's conv names, and
``serving_from_jax`` builds the port's serving model from JAX's folded
variables and that collection, so that both packages run the serving
model on the same scales.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

CT_SCALE = 5.0


def _np(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _conv_w(w) -> np.ndarray:
    return np.transpose(_np(w), (3, 2, 0, 1))


def _linear_w(w) -> np.ndarray:
    return np.transpose(_np(w), (1, 0))


def _emit_basicconv(out: Dict[str, np.ndarray], prefix: str,
                    p: Dict[str, Any], s: Optional[Dict[str, Any]]):
    """One BasicConv: {conv: {kernel[, bias]}, bn: {scale, bias}} (+ stats)."""
    conv = p["conv"]
    out[prefix + ".conv.weight"] = _conv_w(conv["kernel"])
    if "bias" in conv:
        out[prefix + ".conv.bias"] = _np(conv["bias"])
    if "bn" in p:
        out[prefix + ".bn.weight"] = _np(p["bn"]["scale"])
        out[prefix + ".bn.bias"] = _np(p["bn"]["bias"])
        if s is not None and "bn" in s:
            out[prefix + ".bn.running_mean"] = _np(s["bn"]["mean"])
            out[prefix + ".bn.running_var"] = _np(s["bn"]["var"])
            out[prefix + ".bn.num_batches_tracked"] = np.asarray(0, np.int64)


def _emit_rfb(out: Dict[str, np.ndarray], prefix: str,
              p: Dict[str, Any], s: Optional[Dict[str, Any]]):
    """A BasicRFB / BasicRFBa / plain BasicConv extras module."""
    if "conv" in p:  # plain BasicConv ('conv' extras entries)
        _emit_basicconv(out, prefix, p, s)
        return
    for name, sub in p.items():
        if name.startswith("branch"):
            stem, idx = name.rsplit("_", 1)
            torch_name = f"{prefix}.{stem}.{idx}"
        else:  # ConvLinear / shortcut
            torch_name = f"{prefix}.{name}"
        _emit_basicconv(out, torch_name, sub,
                        None if s is None else s.get(name))


def from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` (numpy leaves) → the port's
    state_dict (reference key space, CPU tensors)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    has_ct = False
    for key, val in params.items():
        if key.startswith("vgg_"):
            i = key[len("vgg_"):]
            out[f"base.{i}.weight"] = _conv_w(val["kernel"])
            out[f"base.{i}.bias"] = _np(val["bias"])
        elif key == "Norm":
            _emit_rfb(out, "Norm", val, stats.get("Norm"))
        elif key.startswith("extras_"):
            k = key[len("extras_"):]
            _emit_rfb(out, f"extras.{k}", val, stats.get(key))
        elif key.startswith(("loc_", "conf_", "obj_")):
            head, i = key.rsplit("_", 1)
            out[f"{head}.{i}.weight"] = _conv_w(val["kernel"])
            out[f"{head}.{i}.bias"] = _np(val["bias"])
        elif key in ("theta", "phi", "g", "fc_base"):
            has_ct = True
            out[f"{key}.weight"] = _linear_w(val["kernel"])
            out[f"{key}.bias"] = _np(val["bias"])
        elif key == "Wz":
            has_ct = True
            out["Wz"] = _np(val)
        elif key == "OBJ_Target":
            has_ct = True
            out["OBJ_Target.weight"] = _np(val)
        else:
            raise KeyError(f"unmapped flax param {key!r}")

    if has_ct:
        out["scale"] = np.asarray([CT_SCALE], np.float32)
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def torch_module_name(path) -> str:
    """A flax module path (``('Norm', 'branch0_1', 'conv')``) → the port's
    module name (``Norm.branch0.1.conv``)."""
    parts = []
    for key in path:
        if key.startswith("vgg_"):
            parts += ["base", key[len("vgg_"):]]
        elif key.startswith(("extras_", "loc_", "conf_", "obj_", "branch")):
            parts += key.rsplit("_", 1)
        else:
            parts.append(key)
    return ".".join(parts)


def quant_from_jax(quant: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX package's ``quant`` collection (numpy leaves) → {the port's
    conv name: {act_scale, kernel_int8 [O,I,kh,kw], kernel_scale
    (, out_scale)}}, which ``models/quantize.attach`` puts on a folded
    model."""
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def walk(node, path):
        if "kernel_int8" in node:
            q = {k: np.asarray(v) for k, v in node.items()}
            q["kernel_int8"] = np.transpose(q["kernel_int8"], (3, 2, 0, 1))
            out[torch_module_name(path)] = q
            return
        for key, child in node.items():
            walk(child, path + (key,))

    walk(quant, ())
    return out


def serving_from_jax(task, size: int, folded: Dict[str, Any],
                     quant: Dict[str, Any], device="cuda"):
    """The JAX package's folded variables (``fold_variables``) and its
    ``quant`` collection → the port's folded, quantized model on
    ``device``, on the same scales."""
    from ct_tpu_torch.models.quantize import attach
    from ct_tpu_torch.models.rfbnet import build_net

    net = build_net(task, size, device=device, fold_bn=True)
    net.load_state_dict(from_jax_variables(folded))
    attach(net, quant_from_jax(quant))
    return net


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (``{"model": state_dict, "iteration"}`` or a
    bare state_dict) → the port's state_dict, on the CPU.

    Read with ``weights_only=True``. A ``module.`` prefix (DataParallel)
    is dropped, and ``num_batches_tracked`` stored as shape [1] becomes the
    scalar ``nn.BatchNorm2d`` holds.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    out = {}
    for key, val in obj.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            val = val.reshape(())
        out[key] = val
    return out
