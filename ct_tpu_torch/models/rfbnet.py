"""RFBNet-SSD detector with the Context-Transformer few-shot head, NCHW.

The port of ``ct_tpu/models/rfbnet.py`` (float path, phase 1 and phase 2).
Module names follow the reference key space: ``base.{i}`` is the VGG trunk
indexed like the reference's ``nn.ModuleList`` (ReLUs and pools hold their
own indices), then ``Norm``, ``extras.{k}``, ``loc|conf|obj.{i}``,
``theta|phi|g|fc_base``, ``Wz``, ``OBJ_Target`` and ``scale``.

In train mode (``net.train()``) BatchNorm uses batch statistics and
updates its running statistics, and the ReLU and 2×2 max pool that close
the conv1 stage run as one fused ``pool2x2_relu`` (kernel on the card), as
the JAX package fuses them in training only; eval mode runs ``base``
layer by layer.

The forward returns raw logits for every head (softmax lives in
``eval_scores``); predictions are [B, P, 4] / [B, P, C] with anchors
ordered row-major over (row, col, anchor) per source map, as in the JAX
package. The CT head runs class-major ([B, C, P]) around
``ct_attention_cm``, whose public layout that is.

With ``fold_bn`` (the serving path, ``models/fold_bn.py``) every
``BasicConv`` is a biased conv without BN, and a model with a CT head runs
the fused serving head ``ct_attention_serving`` in its place. Its convs
take the int8 path once ``models/quantize.py`` attaches their scales.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ct_tpu_torch import resolve_device
from ct_tpu_torch.config import TaskSpec
from ct_tpu_torch.models.layers import (
    BasicConv, BasicRFB, BasicRFBa, Conv2d, MaxPool2d,
)
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_serving,
)
from ct_tpu_torch.ops.pool_relu import pool2x2_relu

VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "C",
           512, 512, 512, "M", 512, 512, 512)

# Reduced-depth plan of the size-64 test model: the same structure (conv
# stages → Norm RFB-a source → pool → dilated fc6/fc7 → RFB extras →
# heads) at a fraction of the work.
VGG_CFG_TINY = (16, "M", 32, "C", 64, "M")


def vgg_plan(size: int = 300) -> List[Tuple[str, int, Any]]:
    """VGG16-reducedfc layer plan as (kind, torch_index, spec) tuples;
    torch_index is the layer's position in ``base``."""
    tiny = size == 64
    cfg = VGG_CFG_TINY if tiny else VGG_CFG
    fc_out, fc_dil = (128, 2) if tiny else (1024, 6)
    plan: List[Tuple[str, int, Any]] = []
    idx = 0
    for v in cfg:
        if v == "M":
            plan.append(("pool", idx, dict(kernel=2, stride=2, ceil=False)))
            idx += 1
        elif v == "C":
            plan.append(("pool", idx, dict(kernel=2, stride=2, ceil=True)))
            idx += 1
        else:
            plan.append(("conv", idx, dict(out=v, kernel=3, pad=1, dil=1)))
            idx += 2  # conv + relu
    plan.append(("pool", idx, dict(kernel=3, stride=1, pad=1, ceil=False)))
    idx += 1
    plan.append(("conv", idx,
                 dict(out=fc_out, kernel=3, pad=fc_dil, dil=fc_dil)))  # fc6
    idx += 2
    plan.append(("conv", idx, dict(out=fc_out, kernel=1, pad=0, dil=1)))  # fc7
    return plan


def fused_pool_relu(size: int):
    """``base`` index of the ReLU that the training forward fuses with the
    2×2/s2 max pool right after it (the pool closing the conv1 stage), or
    None: the first pool of the plan, when it is 2×2/s2 without ceil mode,
    follows a conv, and no Norm source taps off between them."""
    plan = vgg_plan(size)
    norm_idx = norm_spec(size)[0]
    for i, (kind, idx, spec) in enumerate(plan):
        if kind != "pool":
            continue
        ok = (i > 0 and plan[i - 1][0] == "conv" and spec["kernel"] == 2
              and spec["stride"] == 2 and not spec["ceil"]
              and norm_idx not in (idx - 1, idx))
        return idx - 1 if ok else None
    return None


def vgg_pool_chains(size: int = 300) -> List[Tuple[str, str]]:
    """(producer, consumer) ``base`` convs separated only by ReLU and max
    pooling: the int8 serving path chains quantization across them (the
    producer emits int8 at the consumer's activation scale; round and clip
    commute with ReLU and max, so that is exact). At 300 the (base.21,
    base.24) chain also feeds the Norm source, which taps the int8 conv4_3
    map: its calibrated absmax equals base.24's, since the 2×2 pool keeps
    the maximum."""
    pairs: List[Tuple[str, str]] = []
    prev_conv: Optional[str] = None
    pooled = False
    for kind, idx, _spec in vgg_plan(size):
        if kind == "conv":
            name = f"base.{idx}"
            if prev_conv is not None and pooled:
                pairs.append((prev_conv, name))
            prev_conv, pooled = name, False
        else:
            pooled = True
    return pairs


def norm_spec(size: int) -> Tuple[int, int]:
    """(``base`` index where the Norm RFB-a source taps off, channels)."""
    return (8, 64) if size == 64 else (23, 512)


def extras_plan(size: int) -> List[Tuple[str, Dict[str, int]]]:
    """Extra feature layers: ('rfb'|'conv', spec)."""
    if size == 64:
        return [("rfb", dict(out=128, stride=1, visual=2))]
    if size == 300:
        return [
            ("rfb", dict(out=1024, stride=1, visual=2)),
            ("rfb", dict(out=512, stride=2, visual=2)),
            ("rfb", dict(out=256, stride=2, visual=2)),
            ("conv", dict(out=128, kernel=1, stride=1, pad=0)),
            ("conv", dict(out=256, kernel=3, stride=1, pad=0)),
            ("conv", dict(out=128, kernel=1, stride=1, pad=0)),
            ("conv", dict(out=256, kernel=3, stride=1, pad=0)),
        ]
    if size == 512:
        return [
            ("rfb", dict(out=1024, stride=1, visual=2)),
            ("rfb", dict(out=512, stride=2, visual=2)),
            ("rfb", dict(out=256, stride=2, visual=2)),
            ("rfb", dict(out=256, stride=2, visual=1)),
            ("rfb", dict(out=256, stride=2, visual=1)),
            ("conv", dict(out=128, kernel=1, stride=1, pad=0)),
            ("conv", dict(out=256, kernel=4, stride=1, pad=1)),
        ]
    raise ValueError("Only RFBNet300 and RFBNet512 are supported.")


def source_indices(size: int) -> List[int]:
    """Which extras outputs feed detection heads (k < indicator or even)."""
    if size == 64:
        return [0]
    indicator = 3 if size == 300 else 5
    return [
        k for k in range(len(extras_plan(size)))
        if k < indicator or k % 2 == 0
    ]


def mbox(size: int) -> List[int]:
    if size == 64:
        return [4, 4]
    return [6, 6, 6, 6, 4, 4] if size == 300 else [6, 6, 6, 6, 6, 4, 4]


# Context-Transformer key pooling (kernel == stride, ceil mode), one entry
# per source map. 300 is the reference schedule; 512 adds one mid-level 2x
# entry; 64 is the test model's.
CT_POOL = {300: (3, 2, 2, 2, 1, 1), 512: (3, 2, 2, 2, 2, 1, 1),
           64: (2, 1)}
CT_SCALE = 5.0   # the fixed scale of the cosine classifier


class Predictions(NamedTuple):
    loc: torch.Tensor        # [B, P, 4]  raw box regressions
    conf: torch.Tensor       # [B, P, C_out]  class logits (post-CT if any)
    obj: torch.Tensor        # [B, P, 2]  objectness logits
    conf_feat: torch.Tensor  # [B, P, C_src]  pre-CT source-class logits


def _anchors_last(x: torch.Tensor, a: int, c: int) -> torch.Tensor:
    """Head output [B, a·c, H, W] → [B, H·W·a, c] (anchors innermost)."""
    b, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w * a, c)


def _class_major(x: torch.Tensor, a: int, c: int) -> torch.Tensor:
    """Head output [B, a·c, H, W] → [B, c, H·W·a], the same anchor order."""
    b, _, h, w = x.shape
    return x.view(b, a, c, h, w).permute(0, 2, 3, 4, 1).reshape(b, c, -1)


class RFBNet(nn.Module):
    """The detector. Input NCHW float images (BGR, mean-subtracted)."""

    def __init__(self, task: TaskSpec, size: int = 300,
                 fold_bn: bool = False):
        super().__init__()
        self.task = task
        self.size = size
        self.fold_bn = fold_bn
        src_c = task.src_cls_dim

        layers: List[nn.Module] = []
        in_ch = 3
        for kind, idx, spec in vgg_plan(size):
            assert idx == len(layers)
            if kind == "conv":
                layers += [Conv2d(in_ch, spec["out"], spec["kernel"],
                                  padding=spec["pad"], dilation=spec["dil"]),
                           nn.ReLU()]
                in_ch = spec["out"]
            else:
                layers.append(MaxPool2d(spec["kernel"], spec["stride"],
                                        padding=spec.get("pad", 0),
                                        ceil_mode=spec["ceil"]))
        self.base = nn.ModuleList(layers)
        self.fused_relu_idx = fused_pool_relu(size)
        self.norm_idx, norm_ch = norm_spec(size)
        self.Norm = BasicRFBa(norm_ch, norm_ch, stride=1, scale=1.0,
                              fold_bn=fold_bn)

        extras: List[nn.Module] = []
        src_ch = [norm_ch]
        self.src_idx = set(source_indices(size))
        for k, (kind, spec) in enumerate(extras_plan(size)):
            if kind == "rfb":
                extras.append(BasicRFB(in_ch, spec["out"],
                                       stride=spec["stride"], scale=1.0,
                                       visual=spec["visual"],
                                       fold_bn=fold_bn))
            else:
                extras.append(BasicConv(in_ch, spec["out"], spec["kernel"],
                                        stride=spec["stride"],
                                        padding=spec["pad"],
                                        fold_bn=fold_bn))
            in_ch = spec["out"]
            if k in self.src_idx:
                src_ch.append(in_ch)
        self.extras = nn.ModuleList(extras)

        self.anchors = mbox(size)
        head = lambda ch, a, c: Conv2d(ch, a * c, 3, padding=1)
        self.loc = nn.ModuleList(
            head(ch, a, 4) for ch, a in zip(src_ch, self.anchors))
        self.conf = nn.ModuleList(
            head(ch, a, src_c) for ch, a in zip(src_ch, self.anchors))
        self.obj = nn.ModuleList(
            head(ch, a, 2) for ch, a in zip(src_ch, self.anchors))

        if task.has_ct_head:
            self.ct_pool = CT_POOL[size]
            self.theta = nn.Linear(src_c, src_c)
            self.phi = nn.Linear(src_c, src_c)
            self.g = nn.Linear(src_c, src_c)
            self.Wz = nn.Parameter(torch.zeros(src_c))
            self.OBJ_Target = nn.Linear(src_c, task.num_novel, bias=False)
            # fixed cosine-classifier scale, kept in the key space
            self.register_buffer("scale", torch.tensor([CT_SCALE]))
            if task.setting == "incre":
                self.fc_base = nn.Linear(src_c, src_c)

    def forward(self, x: torch.Tensor) -> Predictions:
        task = self.task
        src_c = task.src_cls_dim
        b = x.shape[0]

        sources = []
        fused = self.fused_relu_idx if self.training else None
        for i, layer in enumerate(self.base):
            if i == self.norm_idx:
                sources.append(self.Norm(x))
            if fused is not None and i == fused:
                continue                      # runs inside the fused pool
            if fused is not None and i == fused + 1:
                x = pool2x2_relu(x)
                continue
            x = layer(x)
        for k, layer in enumerate(self.extras):
            x = layer(x)
            if k in self.src_idx:
                sources.append(x)

        loc, conf, obj, keys = [], [], [], []
        for i, s in enumerate(sources):
            a = self.anchors[i]
            loc.append(_anchors_last(self.loc[i](s), a, 4))
            obj.append(_anchors_last(self.obj[i](s), a, 2))
            cmap = self.conf[i](s)
            if task.has_ct_head:
                conf.append(_class_major(cmap, a, src_c))
                pool = self.ct_pool[i]
                pooled = nn.functional.max_pool2d(cmap, pool, pool,
                                                  ceil_mode=True)
                keys.append(_anchors_last(pooled, a, src_c))
            else:
                conf.append(_anchors_last(cmap, a, src_c))
        loc = torch.cat(loc, dim=1)
        obj = torch.cat(obj, dim=1)

        if task.has_ct_head:
            conf_cm = torch.cat(conf, dim=2)               # [B, C, P]
            conf_feat = conf_cm.transpose(1, 2)
            ct_head = (self._context_transformer_serving if self.fold_bn
                       else self._context_transformer)
            conf_out = ct_head(conf_cm, torch.cat(keys, dim=1))
        else:
            conf_feat = torch.cat(conf, dim=1)
            conf_out = conf_feat
        return Predictions(loc.float(), conf_out.float(), obj.float(),
                           conf_feat.float())

    def _context_transformer(self, conf_cm: torch.Tensor,
                             keys: torch.Tensor) -> torch.Tensor:
        """Non-local attention over the per-anchor source-class logits.

        Queries are all P anchors, keys/values the K pooled context
        anchors. Residual θ/φ/g projections, softmax affinity, Wz-gated
        delta, then a cosine classifier against OBJ_Target at the fixed
        scale. ``conf_cm`` is [B, C, P]; returns [B, P, num_out].
        """
        k = (self.phi(keys) + keys).contiguous()           # [B, K, C]
        v = (self.g(keys) + keys).contiguous()             # [B, K, C]
        q_cm = (torch.einsum("oc,bcp->bop", self.theta.weight, conf_cm)
                + self.theta.bias[None, :, None] + conf_cm).contiguous()
        novel = ct_attention_cm(q_cm, k, v, conf_cm.contiguous(), self.Wz)
        novel = novel / torch.sqrt(
            torch.sum(novel * novel, dim=1, keepdim=True))
        novel = torch.einsum("nc,bcp->bnp", self.OBJ_Target.weight,
                             novel) * self.scale               # [B, N, P]
        return self._with_base(conf_cm, novel)

    def _with_base(self, conf_cm: torch.Tensor,
                   novel: torch.Tensor) -> torch.Tensor:
        """[B, N, P] novel scores → [B, P, num_out], after the residual
        ``fc_base`` projection of the source classes for ``incre``."""
        if self.task.setting == "incre":
            base = (torch.einsum("oc,bcp->bop", self.fc_base.weight, conf_cm)
                    + self.fc_base.bias[None, :, None] + conf_cm)
            return torch.cat([base, novel], dim=1).transpose(1, 2)
        return novel.transpose(1, 2)

    def _context_transformer_serving(self, conf_cm: torch.Tensor,
                                     keys: torch.Tensor) -> torch.Tensor:
        """The serving CT head (``_context_transformer_serving`` of the JAX
        package): θ projection, attention, residual, ℓ2 normalisation and
        the cosine classifier in one ``ct_attention_serving`` call that
        reads the class-major conf once. Returns [B, P, num_out]."""
        k = (self.phi(keys) + keys).contiguous()           # [B, K, C]
        v = (self.g(keys) + keys).contiguous()             # [B, K, C]
        novel = ct_attention_serving(
            conf_cm.contiguous(), k, v, self.theta.weight.t().contiguous(),
            self.theta.bias, self.Wz, self.OBJ_Target.weight,
            CT_SCALE)                                      # [B, N, P]
        return self._with_base(conf_cm, novel)


def build_net(task: TaskSpec, size: int = 300, device="cuda",
              fold_bn: bool = False) -> RFBNet:
    """The detector for ``task`` at ``size`` (300, 512, or the size-64
    test model), in eval mode on ``device`` (``.train()`` for training);
    ``fold_bn`` builds the serving model, whose weights come folded."""
    if size not in (64, 300, 512):
        raise ValueError("Only RFBNet300 and RFBNet512 are supported "
                         "(plus the size-64 test variant).")
    return RFBNet(task, size, fold_bn).to(resolve_device(device)).eval()


def eval_scores(preds: Predictions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmaxed (conf, obj), computed in float32."""
    return (torch.softmax(preds.conf.float(), dim=-1),
            torch.softmax(preds.obj.float(), dim=-1))
