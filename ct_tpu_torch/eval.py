"""Batched inference: forward → softmax → decode → NMS → per-image cap.

The port of ``make_eval_step`` (``ct_tpu/train/step.py``) and of
``run_inference`` (``test.py``), on one device.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ct_tpu_torch.config import RGB_MEANS, TaskSpec
from ct_tpu_torch.data.voc import eval_transform
from ct_tpu_torch.models.rfbnet import RFBNet, eval_scores
from ct_tpu_torch.ops.detection import postprocess
from ct_tpu_torch.ops.nms import Detections

logger = logging.getLogger(__name__)


def make_eval_step(
    net: RFBNet, priors_cs: torch.Tensor, top_k: int = 200,
    approx_top_k: bool = False, pool_size: int = 0,
) -> Callable[[torch.Tensor, Optional[torch.Tensor]], Detections]:
    """A step (images [B,3,S,S] NCHW, image_sizes [B,2] (h, w) or None) →
    ``Detections``, on the device of ``net`` and ``priors_cs``, with the
    reference eval's thresholds (score 0.01, IoU 0.45, 200 detections per
    image) and ``top_k`` candidates per class; ``approx_top_k`` and
    ``pool_size`` are the serving options of ``batched_nms``. A quantized
    serving model carries its own scales, so the step needs nothing more
    for it."""

    @torch.inference_mode()
    def step(images: torch.Tensor,
             image_sizes: Optional[torch.Tensor] = None) -> Detections:
        preds = net(images)
        conf, obj = eval_scores(preds)
        return postprocess(preds.loc, conf, obj, priors_cs,
                           image_sizes=image_sizes, top_k=top_k,
                           approx_top_k=approx_top_k, pool_size=pool_size)

    return step


def run_inference(net: RFBNet, dataset, task: TaskSpec,
                  priors_cs: torch.Tensor, img_dim: int,
                  batch_size: int = 32, **step_options) -> List[list]:
    """Batched inference over ``dataset`` → the reference's ``all_boxes``:
    all_boxes[class][image] = float32 [n, 5] (x1, y1, x2, y2, score) in
    pixels. The final batch is padded to ``batch_size`` by repeating its
    last image, so every step has the same shape. ``step_options`` go to
    ``make_eval_step``."""
    device = priors_cs.device
    eval_step = make_eval_step(net, priors_cs, **step_options)
    num_images = len(dataset)
    num_classes = task.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(num_classes)]

    for lo in range(0, num_images, batch_size):
        hi = min(lo + batch_size, num_images)
        images, sizes = [], []
        for i in range(lo, hi):
            img = dataset.pull_image(i)
            sizes.append([img.shape[0], img.shape[1]])
            images.append(eval_transform(img, img_dim, RGB_MEANS))
        pad = batch_size - (hi - lo)
        images.extend([images[-1]] * pad)
        sizes.extend([sizes[-1]] * pad)

        t0 = time.perf_counter()
        x = torch.from_numpy(np.stack(images)).permute(0, 3, 1, 2)
        dets = eval_step(x.to(device).contiguous(),
                         torch.tensor(sizes, device=device))
        dets = Detections(*(t.cpu().numpy() for t in dets))
        detect_time = time.perf_counter() - t0

        for bi, i in enumerate(range(lo, hi)):
            valid = dets.valid[bi]
            classes = dets.classes[bi][valid]
            boxes = dets.boxes[bi][valid]
            scores = dets.scores[bi][valid]
            for j in range(1, num_classes):
                m = classes == j
                all_boxes[j][i] = np.hstack(
                    [boxes[m], scores[m, None]]).astype(np.float32)
        if (lo // batch_size) % 5 == 0:
            logger.info("im_detect: %d/%d batch=%d %.3fs", hi, num_images,
                        hi - lo, detect_time)
    return all_boxes


def compare_detections(a: Detections, b: Detections, image: int = 0,
                       iou_tol: float = 0.999,
                       score_tol: float = 1e-4) -> dict:
    """How far two runs' detections of one image agree (CPU tensors or
    numpy arrays). Each box of ``a``, best score first, is matched to the
    unused box of ``b`` of its class within ``score_tol`` with the highest
    IoU. ``ok``: the same count, and every match has IoU ≥ ``iou_tol``."""
    def rows(d):
        v = np.asarray(d.valid[image]).astype(bool)
        return (np.asarray(d.boxes[image])[v], np.asarray(d.scores[image])[v],
                np.asarray(d.classes[image])[v])

    ab, as_, ac = rows(a)
    bb, bs, bc = rows(b)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    used = np.zeros(len(bb), bool)
    min_iou, max_ds = 1.0, 0.0
    for i in np.argsort(-as_, kind="stable"):
        cand = np.where((bc == ac[i]) & ~used
                        & (np.abs(bs - as_[i]) <= score_tol))[0]
        if len(cand) == 0:
            min_iou = 0.0
            continue
        c = bb[cand]
        iw = np.clip(np.minimum(ab[i, 2], c[:, 2])
                     - np.maximum(ab[i, 0], c[:, 0]), 0, None)
        ih = np.clip(np.minimum(ab[i, 3], c[:, 3])
                     - np.maximum(ab[i, 1], c[:, 1]), 0, None)
        inter = iw * ih
        iou = inter / (area(ab[i]) + area(c) - inter)
        j = int(np.argmax(iou))
        min_iou = min(min_iou, float(iou[j]))
        max_ds = max(max_ds, float(abs(bs[cand[j]] - as_[i])))
        used[cand[j]] = True
    return {"count_a": int(len(as_)), "count_b": int(len(bs)),
            "min_iou": min_iou, "max_abs_dscore": max_ds,
            "iou_tol": iou_tol, "score_tol": score_tol,
            "ok": len(as_) == len(bs) and min_iou >= iou_tol}
