"""Batched inference: forward → softmax → decode → NMS → per-image cap.

The port of ``make_eval_step`` (``ct_tpu/train/step.py``) and of
``run_inference`` and ``run_inference_host_nms`` (``test.py``); the latter
runs NMS on the host, in one process.

``run_inference`` with a ``mesh`` of several ranks is ``test.py --ndev``'s
sharded eval step: each rank decodes and runs its block of each padded
batch, and the fixed-shape detections (boxes, scores, classes, valid) are
gathered in rank order, from which rank 0 fills ``all_boxes``.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ct_tpu_torch.config import RGB_MEANS, TaskSpec
from ct_tpu_torch.data.voc import eval_transform
from ct_tpu_torch.models.rfbnet import RFBNet, eval_scores
from ct_tpu_torch.ops.detection import decode_and_fuse, postprocess
from ct_tpu_torch.ops.nms import Detections
from ct_tpu_torch.parallel.mesh import Mesh, gather_blocks
from ct_tpu_torch.utils.profiler import annotate
from ct_tpu_torch.utils.timer import Timer

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
    serving model carries its own scales, and a bf16 model (``RFBNet``'s
    ``dtype``) its compute type: the images go in float32, as the JAX
    package feeds them, its first conv casts them, and the scores reach
    NMS in the type the model emits them (bf16 on the serving path); the
    detections come out float32 either way. Its spans (``utils/profiler``):
    ``eval.step`` on the host, ``eval.forward`` and ``eval.postprocess``
    (scores, decode, NMS, the cap) on the device."""

    @torch.inference_mode()
    def step(images: torch.Tensor,
             image_sizes: Optional[torch.Tensor] = None) -> Detections:
        with annotate("eval.step"):
            with annotate("eval.forward", device=True):
                preds = net(images)
            with annotate("eval.postprocess", device=True):
                conf, obj = eval_scores(preds)
                return postprocess(preds.loc, conf, obj, priors_cs,
                                   image_sizes=image_sizes, top_k=top_k,
                                   approx_top_k=approx_top_k,
                                   pool_size=pool_size)

    return step


def make_decode_step(
    net: RFBNet, priors_cs: torch.Tensor, score_threshold: float = 0.01,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
    """The eval step stopped before NMS, for the host's NMS: images [B,3,
    S,S] → (boxes [B,P,4] percent coordinates, scores [B,P,C+1], above
    [B,P,C+1]), boxes and scores float32 and ``above`` the candidates
    (score > ``score_threshold``). The threshold compares in the scores'
    own type (bf16 on a bf16 model), as numpy compares the JAX package's
    bf16 scores."""

    @torch.inference_mode()
    def step(images: torch.Tensor):
        preds = net(images)
        conf, obj = eval_scores(preds)
        boxes, scores = decode_and_fuse(preds.loc, conf, obj, priors_cs)
        return boxes.float(), scores.float(), scores > score_threshold

    return step


def _batches(dataset, img_dim: int, batch_size: int,
             rows: slice = slice(None)):
    """(lo, hi, images [n,S,S,3] float32, sizes [(h, w)] × n) over
    ``dataset``: the ``rows`` of each batch of ``batch_size``, the final
    batch padded by repeating its last image, so every step has the same
    shape."""
    for lo in range(0, len(dataset), batch_size):
        hi = min(lo + batch_size, len(dataset))
        index = list(range(lo, hi)) + [hi - 1] * (batch_size - (hi - lo))
        pulled = {}
        for i in index[rows]:
            if i not in pulled:
                img = dataset.pull_image(i)
                pulled[i] = ((img.shape[0], img.shape[1]),
                             eval_transform(img, img_dim, RGB_MEANS))
        sizes = [pulled[i][0] for i in index[rows]]
        images = np.stack([pulled[i][1] for i in index[rows]])
        yield lo, hi, images, sizes


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(images).permute(0, 3, 1, 2).to(
        device).contiguous()


def run_inference(net: RFBNet, dataset, task: TaskSpec,
                  priors_cs: torch.Tensor, img_dim: int,
                  batch_size: int = 32, mesh: Optional[Mesh] = None,
                  **step_options) -> Optional[List[list]]:
    """Batched inference over ``dataset`` → the reference's ``all_boxes``:
    all_boxes[class][image] = float32 [n, 5] (x1, y1, x2, y2, score) in
    pixels. ``step_options`` go to ``make_eval_step``. Under a ``mesh`` of
    several ranks each runs its block of every batch (``batch_size`` must
    divide over them), and only rank 0 returns ``all_boxes`` (the others
    None)."""
    device = priors_cs.device
    sharded = mesh is not None and mesh.distributed
    rows = mesh.block(batch_size) if sharded else slice(None)
    primary = not sharded or mesh.is_primary
    eval_step = make_eval_step(net, priors_cs, **step_options)
    num_images = len(dataset)
    num_classes = task.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(num_classes)]
    timer = Timer()

    for lo, hi, images, sizes in _batches(dataset, img_dim, batch_size,
                                          rows):
        timer.tic()
        dets = eval_step(_nchw(images, device),
                         torch.tensor(sizes, device=device))
        if sharded:
            dets = Detections(*(gather_blocks(mesh, t) for t in dets))
        dets = Detections(*(t.cpu().numpy() for t in dets))
        detect_time = timer.toc(average=False)
        if not primary:
            continue

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
    return all_boxes if primary else None


def run_inference_host_nms(net: RFBNet, dataset, task: TaskSpec,
                           priors_cs: torch.Tensor, img_dim: int,
                           batch_size: int = 32, max_per_image: int = 200,
                           thresh: float = 0.01) -> List[list]:
    """``run_inference`` with the reference's CPU-NMS eval: decode and
    obj×conf fusion on the device (``make_decode_step``), then on the host
    per class the native greedy NMS at IoU 0.45 over every score above
    ``thresh``, and the per-image cap (scores ≥ the ``max_per_image``-th).
    The port of ``run_inference_host_nms`` (``test.py``)."""
    from ct_tpu_torch import native

    device = priors_cs.device
    decode_step = make_decode_step(net, priors_cs, thresh)
    num_images = len(dataset)
    num_classes = task.num_classes
    all_boxes = [[[] for _ in range(num_images)] for _ in range(num_classes)]

    for lo, hi, images, sizes in _batches(dataset, img_dim, batch_size):
        boxes, scores, above = (t.cpu().numpy() for t in
                                decode_step(_nchw(images, device)))
        for bi, i in enumerate(range(lo, hi)):
            h, w = sizes[bi]
            bx = boxes[bi] * np.asarray([w, h, w, h], np.float32)
            sc = scores[bi]
            for j in range(1, num_classes):
                inds = np.where(above[bi, :, j])[0]
                if len(inds) == 0:
                    all_boxes[j][i] = np.empty((0, 5), np.float32)
                    continue
                c_dets = np.hstack([bx[inds], sc[inds, j, None]])
                keep = native.cpu_nms(c_dets, 0.45)
                all_boxes[j][i] = c_dets[keep]
            image_scores = np.hstack(
                [all_boxes[j][i][:, -1] for j in range(1, num_classes)])
            if len(image_scores) > max_per_image:
                image_thresh = np.sort(image_scores)[-max_per_image]
                for j in range(1, num_classes):
                    keep = all_boxes[j][i][:, -1] >= image_thresh
                    all_boxes[j][i] = all_boxes[j][i][keep]
        if (lo // batch_size) % 5 == 0:
            logger.info("im_detect (host NMS): %d/%d", hi, num_images)
    return all_boxes


def compare_detections(a: Detections, b: Detections, image: int = 0,
                       iou_tol: float = 0.999,
                       score_tol: float = 1e-4) -> dict:
    """How far two runs' detections of one image agree (CPU tensors or
    numpy arrays). Each box of ``a``, best score first, is matched to the
    unused box of ``b`` of its class within ``score_tol`` with the highest
    IoU. ``ok``: the same count, and every match has IoU ≥ ``iou_tol``;
    ``matched``: the boxes of ``a`` so matched at IoU ≥ ``iou_tol``."""
    def rows(d):
        v = np.asarray(d.valid[image]).astype(bool)
        return (np.asarray(d.boxes[image])[v], np.asarray(d.scores[image])[v],
                np.asarray(d.classes[image])[v])

    ab, as_, ac = rows(a)
    bb, bs, bc = rows(b)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    used = np.zeros(len(bb), bool)
    min_iou, max_ds, matched = 1.0, 0.0, 0
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
        matched += int(iou[j] >= iou_tol)
        max_ds = max(max_ds, float(abs(bs[cand[j]] - as_[i])))
        used[cand[j]] = True
    return {"count_a": int(len(as_)), "count_b": int(len(bs)),
            "min_iou": min_iou, "max_abs_dscore": max_ds,
            "matched": matched,
            "iou_tol": iou_tol, "score_tol": score_tol,
            "ok": len(as_) == len(bs) and min_iou >= iou_tol}
