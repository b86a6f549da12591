"""Plain training step of the detector: matching, the multibox loss with
the objectness head, backward, SGD with per-group learning rates, and the
``OBJ_Target`` renormalisation.

A frozen copy of the reference implementation's semantics
(``layers/modules/multibox_loss.py``, ``utils/box_utils.py`` ``match``,
the phase-2 solver): every prior takes its best ground truth, each ground
truth's best prior is forced to it (the later one wins a prior claimed
twice), priors under IoU 0.5 are background; smooth-L1 on the positives,
2-class objectness cross entropy over positives and 3:1 hard negatives
(ranked by their cross entropy, ties by anchor index), source-class cross
entropy on ``[obj_bg + logsumexp(conf), obj_fg + conf_k]`` over the same
anchors; every sum divided by N, the floored count of positives. The
batch runs in ``accum`` equal micro-batches (BatchNorm over each), their
gradients summed before the one division by the whole batch's N. SGD:
weight decay 5e-4 added to the gradient, momentum 0.9 (the buffer starts
at the first step's gradient), the trunk at 0.1× the learning rate and
the Norm and extras blocks at 0.5×; after the update the ``OBJ_Target``
rows are scaled to unit length.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from benchmark.reference.model import Model

MATCH_THRESHOLD = 0.5
NEG_POS = 3
VARIANCES = (0.1, 0.2)


def point_form(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2], 1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, 4] × [P, 4] point-form boxes → [B, M, P]."""
    lo = torch.maximum(a[..., :, None, :2], b[None, None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[None, None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area(a)[..., None] + area(b)[None, None] - inter)


@torch.no_grad()
def match(boxes, labels, valid, pri):
    """Padded targets [B, M, ...] against [P, 4] center-size priors →
    (regression targets [B, P, 4], class [B, P], 0 = background)."""
    b, m = labels.shape
    ov = torch.where(valid[..., None], iou(boxes, point_form(pri)), -1.0)
    best_ov, best_gt = ov.max(1)
    best_prior = ov.argmax(2)                                   # [B, M]
    for i in range(b):
        for j in range(m):          # in order: a later gt wins the prior
            if valid[i, j]:
                best_gt[i, best_prior[i, j]] = j
                best_ov[i, best_prior[i, j]] = 2.0
    matched = torch.gather(boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    cls = torch.gather(labels.long(), 1, best_gt)
    cls = torch.where(best_ov < MATCH_THRESHOLD, 0, cls)
    g_c = ((matched[..., :2] + matched[..., 2:]) / 2 - pri[:, :2]) / (
        VARIANCES[0] * pri[:, 2:])
    g_wh = torch.log(((matched[..., 2:] - matched[..., :2]) / pri[:, 2:])
                     .double()).float() / VARIANCES[1]
    return torch.cat([g_c, g_wh], -1), cls


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None]).squeeze(-1))


def loss_sums(loc, conf, obj, loc_t, cls_t) -> Tuple[Dict, torch.Tensor]:
    """The three unnormalised loss sums and the positive count."""
    pos = cls_t > 0
    num_pos = pos.float().sum(1).floor()
    with torch.no_grad():
        ce = _ce(obj, pos.long())
        rank_loss = torch.where(pos, torch.zeros_like(ce), ce)
        order = torch.argsort(-rank_loss, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)
        num_neg = torch.clamp(NEG_POS * num_pos, max=obj.shape[1] - 1)
        mask = (pos | (rank < num_neg[:, None])).float()
    d = (loc - loc_t).abs()
    l1 = torch.where(d < 1, 0.5 * d * d, d - 0.5).sum(-1)
    loss_l = (l1 * pos.float()).sum()
    loss_o = (_ce(obj, pos.long()) * mask).sum()
    bg = obj[..., 0] + torch.logsumexp(conf, -1)
    logits = torch.cat([bg[..., None], obj[..., 1:2] + conf], -1)
    loss_c = (_ce(logits, cls_t) * mask).sum()
    return {"loc": loss_l, "cls": loss_c, "obj": loss_o}, num_pos.sum()


def lr_multiplier(name: str) -> float:
    top = name.split(".", 1)[0]
    return 0.1 if top == "base" else 0.5 if top in ("extras", "Norm") else 1.0


class Trainer:
    """The reference's training state: float32 parameters (leaves that
    take gradients), BatchNorm's running statistics and the momentum
    buffers."""

    def __init__(self, state: Dict[str, torch.Tensor], model_args: dict,
                 lr: float, momentum: float = 0.9, weight_decay: float = 5e-4,
                 accum: int = 1):
        self.params = {k: v.detach().clone().float() for k, v in
                       state.items() if not k.endswith(("running_mean",
                                                        "running_var",
                                                        "num_batches_tracked",
                                                        "scale"))}
        for p in self.params.values():
            p.requires_grad_(True)
        self.buffers = {k: v.detach().clone().float() for k, v in
                        state.items() if k.endswith(("running_mean",
                                                     "running_var"))}
        self.model_args = model_args
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.accum = accum
        self.momentum_buf: Dict[str, torch.Tensor] = {}

    def model(self, numerics=None) -> Model:
        return Model({**self.params, **self.buffers}, numerics=numerics,
                     **self.model_args)

    def loss_and_grads(self, batch: Mapping[str, torch.Tensor], pri,
                       numerics=None) -> Tuple[float, Dict]:
        """The N-normalised total loss of ``batch``; leaves each
        parameter's gradient in ``.grad``."""
        for p in self.params.values():
            p.grad = None
        b = batch["image"].shape[0]
        micro = b // self.accum
        totals, n = 0.0, 0.0
        model = self.model(numerics)
        for i in range(self.accum):
            part = slice(i * micro, (i + 1) * micro)
            loc_t, cls_t = match(batch["boxes"][part], batch["labels"][part],
                                 batch["valid"][part], pri)
            preds = model.forward(batch["image"][part], train=True)
            sums, num_pos = loss_sums(preds.loc, preds.conf, preds.obj,
                                      loc_t, cls_t)
            total = sum(sums.values())
            total.backward()
            totals += float(total.detach())
            n += float(num_pos)
        n = max(n, 1.0)
        for p in self.params.values():
            if p.grad is not None:
                p.grad.div_(n)
        return totals / n, {k: p.grad.detach().clone()
                            for k, p in self.params.items()
                            if p.grad is not None}

    @torch.no_grad()
    def update(self) -> None:
        for name, p in self.params.items():
            if p.grad is None:
                continue
            d = p.grad + self.wd * p
            buf = self.momentum_buf.get(name)
            buf = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
            self.momentum_buf[name] = buf
            p.sub_(self.lr * lr_multiplier(name) * buf)
        w = self.params["OBJ_Target.weight"]
        w.div_(torch.linalg.vector_norm(w, dim=1, keepdim=True))
