"""Multibox loss with the separate objectness head, batched.

The port of ``ct_tpu/ops/losses.py`` (``multibox_loss_sums``), the
reference's combined loss:

  * smooth-L1 box loss on positive anchors, weighted by the (mixup)
    weights;
  * 2-class objectness cross entropy with 3:1 hard-negative mining; the
    negatives are ranked by their unweighted cross entropy with positive
    and ignored anchors zeroed, ties broken by anchor index;
  * source-class cross entropy on the combined logit
    ``[obj_bg + logsumexp(conf), obj_fg + conf_k]`` over positives and
    mined negatives;
  * the normaliser N = Σ_image floor(Σ weighted positives).

Ignored anchors (label -1) are neither positives nor mined negatives.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ct_tpu_torch.ops.matching import MatchResult


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Huber loss with beta 1 (torch's smooth_l1_loss default)."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _ce_from_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy: logsumexp(logits) - logits[label]."""
    picked = torch.gather(logits, -1, labels[..., None]).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def loss_mask(obj_p: torch.Tensor, targets: MatchResult,
              neg_pos_ratio: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchors the objectness and class losses count: positives and
    the 3:1 mined hard negatives → (mask [B, P] bool, floored weighted
    positive count [B])."""
    _, cls_t, w_t, obj_t = targets
    num_priors = obj_p.shape[1]
    with torch.no_grad():
        pos = cls_t > 0
        # the reference floors the weighted positive count per image
        num_pos = torch.floor(torch.sum(w_t * pos.to(w_t.dtype), dim=1))
        ce_obj = _ce_from_logits(obj_p, obj_t.long())
        rank_loss = torch.where(obj_t, torch.zeros_like(ce_obj), ce_obj)
        order = torch.argsort(-rank_loss, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(
            num_priors, device=order.device).expand_as(order))
        num_neg = torch.clamp(neg_pos_ratio * num_pos, max=num_priors - 1)
        return pos | (rank < num_neg[:, None]), num_pos


def masked_loss_sums(loc_p: torch.Tensor, conf_p: torch.Tensor,
                     obj_p: torch.Tensor, targets: MatchResult,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The three unnormalised loss sums over the anchors of ``mask``."""
    loc_t, cls_t, w_t, obj_t = targets
    posf = (cls_t > 0).to(loc_p.dtype)
    maskf = mask.to(loc_p.dtype)
    loss_l = torch.sum(smooth_l1(loc_p - loc_t).sum(dim=-1) * w_t * posf)
    ce_obj = _ce_from_logits(obj_p, obj_t.long())
    loss_obj = torch.sum(ce_obj * w_t * maskf)
    logit_bg = obj_p[..., 0] + torch.logsumexp(conf_p, dim=-1)
    logits = torch.cat([logit_bg[..., None], obj_p[..., 1:2] + conf_p],
                       dim=-1)
    ce_cls = _ce_from_logits(logits, cls_t.clamp(min=0))
    loss_c = torch.sum(ce_cls * w_t * maskf)
    return {"loss_box_reg": loss_l, "loss_cls": loss_c, "loss_obj": loss_obj}


def multibox_loss_sums(
    loc_p: torch.Tensor,     # [B, P, 4]
    conf_p: torch.Tensor,    # [B, P, C] source-class logits (no background)
    obj_p: torch.Tensor,     # [B, P, 2] objectness logits
    targets: MatchResult,
    neg_pos_ratio: int = 3,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Unnormalised loss sums and the positive count N (not yet floored
    at 1)."""
    mask, num_pos = loss_mask(obj_p, targets, neg_pos_ratio)
    return (masked_loss_sums(loc_p, conf_p, obj_p, targets, mask),
            torch.sum(num_pos))
