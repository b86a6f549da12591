"""Plain RFBNet-SSD with the Context-Transformer head, as functions of a
state dict.

The benchmark's reference for the detector (RFBNet, arXiv:1711.07767;
Context-Transformer, arXiv:2003.07304): the VGG16-reducedfc trunk, the Norm
RFB-a source on conv4_3, the RFB extras, the loc/conf/obj heads and, in
phase 2 with method ``ours``, the CT head (θ/φ/g residual projections over
the conf maps and their max-pooled keys, softmax attention, the ``Wz``
gate, ℓ2 normalisation, the cosine ``OBJ_Target`` classifier at scale 5,
and ``fc_base`` for ``incre``). Parameters are named in the reference
implementation's key space (``base.{i}``, ``Norm.branch0.1.conv.weight``,
``extras.{k}``, ``loc.{i}`` ...), so one state dict drives this module and
the program under test.

Plain PyTorch only: float32 by default (float64 where ``Numerics`` sums
integer products exactly), no kernel, no cache. Nothing here imports the
program. The layer plans are a frozen copy of the published configs
(``data/config.py`` VOC_300 / VOC_512 of the reference implementation).

``Numerics`` says how each convolution computes: in float32; recording its
input's |max| (calibration); on integers of ``bits`` bits (per-tensor
activation scale from the calibration, per-output-channel weight scale,
products summed exactly in float64, rescaled in float32), the int8 serving
path and, at 4 bits, its control; or on operands rounded to float8 e4m3
(per-tensor activation and per-channel weight scales), the control of a
bfloat16 model.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "C",
           512, 512, 512, "M", 512, 512, 512)
# the size-64 model of the CPU tests: the same structure at a fraction of
# the work
VGG_CFG_TINY = (16, "M", 32, "C", 64, "M")
CT_POOL = {300: (3, 2, 2, 2, 1, 1), 512: (3, 2, 2, 2, 2, 1, 1), 64: (2, 1)}
CT_SCALE = 5.0
BN_EPS = 1e-5
BN_MOMENTUM = 0.01
FP8_MAX = 448.0      # the largest float8 e4m3fn value
HEADS = re.compile(r"^(loc|conf|obj)\.\d+$")


def vgg_plan(size: int) -> List[Tuple[str, int, dict]]:
    """(kind, index in ``base``, spec) of the VGG16-reducedfc trunk."""
    cfg = VGG_CFG_TINY if size == 64 else VGG_CFG
    fc_out, fc_dil = (128, 2) if size == 64 else (1024, 6)
    plan, idx = [], 0
    for v in cfg:
        if v in ("M", "C"):
            plan.append(("pool", idx, dict(kernel=2, stride=2, pad=0,
                                           ceil=v == "C")))
            idx += 1
        else:
            plan.append(("conv", idx, dict(out=v, kernel=3, pad=1, dil=1)))
            idx += 2
    plan.append(("pool", idx, dict(kernel=3, stride=1, pad=1, ceil=False)))
    idx += 1
    plan.append(("conv", idx, dict(out=fc_out, kernel=3, pad=fc_dil,
                                   dil=fc_dil)))
    idx += 2
    plan.append(("conv", idx, dict(out=fc_out, kernel=1, pad=0, dil=1)))
    return plan


def norm_index(size: int) -> int:
    """``base`` index before which the Norm source taps the trunk."""
    return 8 if size == 64 else 23


def extras_plan(size: int) -> List[Tuple[str, dict]]:
    """The extra layers: ("rfb", out, stride, visual) or ("conv", out,
    kernel, pad)."""
    if size == 64:
        return [("rfb", dict(out=128, stride=1, visual=2))]
    rfb = lambda o, s, v: ("rfb", dict(out=o, stride=s, visual=v))
    conv = lambda o, k, p: ("conv", dict(out=o, kernel=k, pad=p))
    if size == 300:
        return [rfb(1024, 1, 2), rfb(512, 2, 2), rfb(256, 2, 2),
                conv(128, 1, 0), conv(256, 3, 0), conv(128, 1, 0),
                conv(256, 3, 0)]
    if size == 512:
        return [rfb(1024, 1, 2), rfb(512, 2, 2), rfb(256, 2, 2),
                rfb(256, 2, 1), rfb(256, 2, 1), conv(128, 1, 0),
                conv(256, 4, 1)]
    raise ValueError(f"no RFBNet at size {size}")


def source_indices(size: int) -> List[int]:
    if size == 64:
        return [0]
    indicator = 3 if size == 300 else 5
    return [k for k in range(len(extras_plan(size)))
            if k < indicator or k % 2 == 0]


def anchors_per_cell(size: int) -> List[int]:
    if size == 64:
        return [4, 4]
    return [6, 6, 6, 6, 4, 4] if size == 300 else [6, 6, 6, 6, 6, 4, 4]


def _basic(out: dict, prefix: str, cin: int, cout: int, kh: int,
           kw: int) -> None:
    out[prefix + ".conv.weight"] = (cout, cin, kh, kw)
    for n in ("weight", "bias", "running_mean", "running_var"):
        out[f"{prefix}.bn.{n}"] = (cout,)
    out[prefix + ".bn.num_batches_tracked"] = ()


def _rfb_shapes(out, prefix, cin, cout):
    i = cin // 8
    for name, a, b, kh, kw in (
            ("branch0.0", cin, 2 * i, 1, 1), ("branch0.1", 2 * i, 2 * i, 3, 3),
            ("branch1.0", cin, i, 1, 1), ("branch1.1", i, 2 * i, 3, 3),
            ("branch1.2", 2 * i, 2 * i, 3, 3),
            ("branch2.0", cin, i, 1, 1), ("branch2.1", i, i // 2 * 3, 3, 3),
            ("branch2.2", i // 2 * 3, 2 * i, 3, 3),
            ("branch2.3", 2 * i, 2 * i, 3, 3),
            ("ConvLinear", 6 * i, cout, 1, 1), ("shortcut", cin, cout, 1, 1)):
        _basic(out, f"{prefix}.{name}", a, b, kh, kw)


def _rfb_a_shapes(out, prefix, c):
    i = c // 4
    for name, a, b, kh, kw in (
            ("branch0.0", c, i, 1, 1), ("branch0.1", i, i, 3, 3),
            ("branch1.0", c, i, 1, 1), ("branch1.1", i, i, 3, 1),
            ("branch1.2", i, i, 3, 3),
            ("branch2.0", c, i, 1, 1), ("branch2.1", i, i, 1, 3),
            ("branch2.2", i, i, 3, 3),
            ("branch3.0", c, i // 2, 1, 1),
            ("branch3.1", i // 2, i // 4 * 3, 1, 3),
            ("branch3.2", i // 4 * 3, i, 3, 1), ("branch3.3", i, i, 3, 3),
            ("ConvLinear", 4 * i, c, 1, 1), ("shortcut", c, c, 1, 1)):
        _basic(out, f"{prefix}.{name}", a, b, kh, kw)


def param_shapes(task: "Task", size: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the detector, by key, with its shape
    from the published plan."""
    out: Dict[str, Tuple[int, ...]] = {}
    cin = 3
    for kind, idx, spec in vgg_plan(size):
        if kind == "conv":
            k = spec["kernel"]
            out[f"base.{idx}.weight"] = (spec["out"], cin, k, k)
            out[f"base.{idx}.bias"] = (spec["out"],)
            cin = spec["out"]
    norm_c = 64 if size == 64 else 512
    _rfb_a_shapes(out, "Norm", norm_c)
    src = [norm_c]
    for k, (kind, spec) in enumerate(extras_plan(size)):
        if kind == "rfb":
            _rfb_shapes(out, f"extras.{k}", cin, spec["out"])
        else:
            _basic(out, f"extras.{k}", cin, spec["out"], spec["kernel"],
                   spec["kernel"])
        cin = spec["out"]
        if k in source_indices(size):
            src.append(cin)
    c = task.src_classes
    for i, (ch, a) in enumerate(zip(src, anchors_per_cell(size))):
        for head, n in (("loc", 4), ("conf", c), ("obj", 2)):
            out[f"{head}.{i}.weight"] = (a * n, ch, 3, 3)
            out[f"{head}.{i}.bias"] = (a * n,)
    for name in ("theta", "phi", "g") + (("fc_base",) if task.setting
                                          == "incre" else ()):
        out[name + ".weight"] = (c, c)
        out[name + ".bias"] = (c,)
    out["Wz"] = (c,)
    out["OBJ_Target.weight"] = (task.num_novel, c)
    out["scale"] = (1,)
    return out


class Task(NamedTuple):
    """The few-shot protocol's class counts (phase 2, method ``ours``)."""
    setting: str        # "incre" or "transfer"
    src_classes: int    # conf head width C (no background)
    num_classes: int    # evaluated classes, background included

    @property
    def num_novel(self) -> int:
        return (self.num_classes - 1 if self.setting == "transfer"
                else self.num_classes - 1 - self.src_classes)


class Predictions(NamedTuple):
    loc: torch.Tensor        # [B, P, 4]
    conf: torch.Tensor       # [B, P, num_classes - 1]
    obj: torch.Tensor        # [B, P, 2]


class Numerics:
    """How a convolution computes (module docstring). ``mode`` is
    "float", "record", "int" or "fp8"; ``absmax`` holds the calibration,
    ``quantize_heads`` whether the loc/conf/obj heads take the integer
    path too."""

    def __init__(self, mode: str = "float", bits: int = 8,
                 absmax: Optional[Dict[str, float]] = None,
                 quantize_heads: bool = True):
        if mode not in ("float", "record", "int", "fp8"):
            raise ValueError(f"unknown numerics {mode}")
        self.mode = mode
        self.bits = bits
        self.absmax: Dict[str, float] = dict(absmax or {})
        self.quantize_heads = quantize_heads

    def conv(self, name: str, x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor], stride, padding,
             dilation) -> torch.Tensor:
        x = x.float()
        if self.mode == "record":
            m = float(x.detach().abs().amax())
            self.absmax[name] = max(self.absmax.get(name, 0.0), m)
        elif self.mode == "int" and (self.quantize_heads
                                     or not HEADS.match(name)):
            return self._int_conv(name, x, w, b, stride, padding, dilation)
        elif self.mode == "fp8":
            x, w = fp8_round(x), fp8_round(w, per_channel=True)
        return F.conv2d(x, w, b, stride, padding, dilation)

    def dense(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.mode == "fp8":
            x, w = fp8_round(x), fp8_round(w, per_channel=True)
        return F.linear(x, w, b)

    def _int_conv(self, name, x, w, b, stride, padding, dilation):
        qmax = 2 ** (self.bits - 1) - 1
        act_scale = torch.tensor(max(self.absmax[name] / qmax, 1e-12),
                                 dtype=torch.float32, device=x.device)
        w_scale = torch.clamp(w.abs().reshape(w.shape[0], -1).amax(1) / qmax,
                              min=1e-12)
        wq = torch.clamp(torch.round(w / w_scale[:, None, None, None]),
                         -qmax, qmax)
        xq = torch.clamp(torch.round(x / act_scale), -qmax, qmax)
        # every product and partial sum of integers is exact in float64
        acc = F.conv2d(xq.double(), wq.double(), None, stride, padding,
                       dilation)
        y = acc.float() * (act_scale * w_scale)[None, :, None, None]
        return y if b is None else y + b[None, :, None, None]


def fp8_round(t: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale that maps its |max| (per
    tensor, or per leading index) to the format's largest value."""
    if per_channel:
        m = t.detach().abs().reshape(t.shape[0], -1).amax(1)
        m = m.reshape(-1, *([1] * (t.dim() - 1)))
    else:
        m = t.detach().abs().amax()
    s = torch.clamp(m, min=1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Model:
    """The detector over state dict ``params`` (tensors keyed in the
    reference key space). ``folded``: BatchNorm already folded into biased
    convs (``fold_bn``); otherwise BN runs on its running statistics, or,
    with ``train=True`` in ``forward``, on the batch's, updating them in
    place at momentum 0.01."""

    def __init__(self, params: Dict[str, torch.Tensor], task: Task,
                 size: int, folded: bool = False,
                 numerics: Optional[Numerics] = None):
        self.p = params
        self.task = task
        self.size = size
        self.folded = folded
        self.numerics = numerics or Numerics()
        self.train = False

    # -- layers ----------------------------------------------------------
    def conv(self, name, x, stride=1, padding=0, dilation=1):
        pair = lambda v: v if isinstance(v, tuple) else (v, v)
        return self.numerics.conv(name, x, self.p[name + ".weight"],
                                  self.p.get(name + ".bias"), pair(stride),
                                  pair(padding), pair(dilation))

    def basic(self, prefix, x, kernel, stride=1, padding=0, dilation=1,
              relu=True):
        y = self.conv(prefix + ".conv", x, stride, padding, dilation)
        if not self.folded:
            p = prefix + ".bn."
            y = F.batch_norm(y, self.p[p + "running_mean"],
                             self.p[p + "running_var"], self.p[p + "weight"],
                             self.p[p + "bias"], training=self.train,
                             momentum=BN_MOMENTUM, eps=BN_EPS)
        return torch.relu(y) if relu else y

    def rfb(self, prefix, x, stride, visual, scale=1.0):
        """``BasicRFB``: three dilated branches, a linear fuse and a
        shortcut."""
        c = lambda n, y, *a, **k: self.basic(f"{prefix}.{n}", y, *a, **k)
        v = visual
        b0 = c("branch0.0", x, 1, stride=stride)
        b0 = c("branch0.1", b0, 3, padding=v, dilation=v, relu=False)
        b1 = c("branch1.0", x, 1)
        b1 = c("branch1.1", b1, 3, stride=stride, padding=1)
        b1 = c("branch1.2", b1, 3, padding=v + 1, dilation=v + 1, relu=False)
        b2 = c("branch2.0", x, 1)
        b2 = c("branch2.1", b2, 3, padding=1)
        b2 = c("branch2.2", b2, 3, stride=stride, padding=1)
        b2 = c("branch2.3", b2, 3, padding=2 * v + 1, dilation=2 * v + 1,
               relu=False)
        out = c("ConvLinear", torch.cat([b0, b1, b2], 1), 1, relu=False)
        return torch.relu(out * scale + c("shortcut", x, 1, stride=stride,
                                          relu=False))

    def rfb_a(self, prefix, x, scale=1.0):
        """``BasicRFB_a`` (the Norm source): four thin branches."""
        c = lambda n, y, *a, **k: self.basic(f"{prefix}.{n}", y, *a, **k)
        b0 = c("branch0.1", c("branch0.0", x, 1), 3, padding=1, relu=False)
        b1 = c("branch1.0", x, 1)
        b1 = c("branch1.1", b1, 3, padding=(1, 0))
        b1 = c("branch1.2", b1, 3, padding=3, dilation=3, relu=False)
        b2 = c("branch2.0", x, 1)
        b2 = c("branch2.1", b2, 3, padding=(0, 1))
        b2 = c("branch2.2", b2, 3, padding=3, dilation=3, relu=False)
        b3 = c("branch3.0", x, 1)
        b3 = c("branch3.1", b3, 3, padding=(0, 1))
        b3 = c("branch3.2", b3, 3, padding=(1, 0))
        b3 = c("branch3.3", b3, 3, padding=5, dilation=5, relu=False)
        out = c("ConvLinear", torch.cat([b0, b1, b2, b3], 1), 1, relu=False)
        return torch.relu(out * scale + c("shortcut", x, 1, relu=False))

    def dense(self, name, x):
        return self.numerics.dense(x, self.p[name + ".weight"],
                                   self.p.get(name + ".bias"))

    # -- the detector ----------------------------------------------------
    def forward(self, x: torch.Tensor, train: bool = False) -> Predictions:
        self.train = train
        size, task = self.size, self.task
        sources = []
        norm_at = norm_index(size)
        for kind, idx, spec in vgg_plan(size):
            if idx == norm_at:
                sources.append(self.rfb_a("Norm", x))
            if kind == "conv":
                x = torch.relu(self.conv(f"base.{idx}", x, 1, spec["pad"],
                                         spec["dil"]))
            else:
                x = F.max_pool2d(x, spec["kernel"], spec["stride"],
                                 spec["pad"], ceil_mode=spec["ceil"])
        for k, (kind, spec) in enumerate(extras_plan(size)):
            if kind == "rfb":
                x = self.rfb(f"extras.{k}", x, spec["stride"], spec["visual"])
            else:
                x = self.basic(f"extras.{k}", x, spec["kernel"],
                               padding=spec["pad"])
            if k in source_indices(size):
                sources.append(x)

        c = task.src_classes
        loc, obj, conf, keys = [], [], [], []
        for i, (s, a) in enumerate(zip(sources, anchors_per_cell(size))):
            b, _, h, w = s.shape
            last = lambda t, n: t.permute(0, 2, 3, 1).reshape(b, h * w * a, n)
            loc.append(last(self.conv(f"loc.{i}", s, 1, 1), 4))
            obj.append(last(self.conv(f"obj.{i}", s, 1, 1), 2))
            cmap = self.conv(f"conf.{i}", s, 1, 1)
            conf.append(cmap.view(b, a, c, h, w).permute(0, 2, 3, 4, 1)
                        .reshape(b, c, -1))
            pool = CT_POOL[size][i]
            pooled = F.max_pool2d(cmap, pool, pool, ceil_mode=True)
            keys.append(pooled.permute(0, 2, 3, 1).reshape(b, -1, c))
        conf_cm = torch.cat(conf, 2)                         # [B, C, P]
        return Predictions(torch.cat(loc, 1),
                           self.ct_head(conf_cm, torch.cat(keys, 1)),
                           torch.cat(obj, 1))

    def ct_head(self, conf_cm: torch.Tensor,
                keys: torch.Tensor) -> torch.Tensor:
        """[B, C, P] conf logits, [B, K, C] pooled keys → [B, P, N_out]."""
        k = self.dense("phi", keys) + keys
        v = self.dense("g", keys) + keys
        q = self.dense("theta", conf_cm.transpose(1, 2)).transpose(1, 2)
        q = q + conf_cm
        wz = self.p["Wz"]
        delta = attention(q, k, v, grad=torch.is_grad_enabled())
        novel = conf_cm + delta * wz[None, :, None]
        novel = novel / torch.sqrt((novel * novel).sum(1, keepdim=True))
        novel = torch.einsum("nc,bcp->bnp", self.p["OBJ_Target.weight"],
                             novel) * CT_SCALE
        if self.task.setting == "incre":
            base = self.dense("fc_base", conf_cm.transpose(1, 2))
            return torch.cat([base + conf_cm.transpose(1, 2),
                              novel.transpose(1, 2)], 2)
        return novel.transpose(1, 2)


def _attend(q, k, v):
    s = torch.einsum("bkc,bcp->bkp", k, q)
    return torch.einsum("bkp,bkc->bcp", torch.softmax(s, 1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              grad: bool, chunk_bytes: float = 2e9) -> torch.Tensor:
    """softmax_K(kᵀq)·v per image, class-major [B, C, P], a few images at
    a time so that the [b, K, P] affinity stays under ``chunk_bytes``;
    under autograd each chunk is recomputed in the backward instead of
    kept."""
    b, _, p = q.shape
    per = max(1, int(chunk_bytes // (k.shape[1] * p * 4)))
    out = []
    for i in range(0, b, per):
        args = (q[i:i + per], k[i:i + per], v[i:i + per])
        out.append(checkpoint(_attend, *args, use_reentrant=False)
                   if grad else _attend(*args))
    return torch.cat(out, 0)


@torch.no_grad()
def fold_bn(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """BatchNorm folded into the convs before it, in float32:
    W' = W·γ/√(σ²+ε), b' = β − μ·γ/√(σ²+ε) (+ b·γ/√(σ²+ε))."""
    out = {k: v.float() for k, v in state.items() if ".bn." not in k}
    for key in state:
        if not key.endswith(".bn.running_var"):
            continue
        pre = key[:-len(".bn.running_var")]
        bn = lambda n: state[f"{pre}.bn.{n}"].float()
        std = torch.sqrt((bn("running_var") + BN_EPS).double()).float()
        factor = bn("weight") / std
        bias = bn("bias") - bn("running_mean") * factor
        if f"{pre}.conv.bias" in state:
            bias = bias + state[f"{pre}.conv.bias"].float() * factor
        out[f"{pre}.conv.weight"] = (state[f"{pre}.conv.weight"].float()
                                     * factor[:, None, None, None])
        out[f"{pre}.conv.bias"] = bias
    return out


def scores(preds: Predictions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmaxed (conf, obj)."""
    return torch.softmax(preds.conf, -1), torch.softmax(preds.obj, -1)


def calibrate(folded: Dict[str, torch.Tensor], task: Task, size: int,
              images: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Each conv's input |max| over calibration batches, the folded model
    in float32."""
    num = Numerics("record")
    model = Model(folded, task, size, folded=True, numerics=num)
    with torch.no_grad():
        for x in images:
            model.forward(x)
    return num.absmax
