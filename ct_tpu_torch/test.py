"""Evaluation CLI of the port: the flags of ``test.py``, plus ``--device``.

    python -m ct_tpu_torch.test -p 2 --setting incre --split 1 \\
        --load-file .parity_p2/ref_model.pth --save-folder out/ \\
        [--device cuda|cpu] [--retest] [--resume] [--top-k 200] \\
        [--int8 [--int8-heads] [--calib-images 8]] [--bf16] \\
        [--approx-topk on] [--pool-size 512] [--host-nms]
    python -m ct_tpu_torch.test -d COCO -p 1 --setting transfer \\
        --load-file weights/model_final.pth --save-folder out/

``--int8`` runs the serving path: BN folded into the convs, activation
ranges calibrated on ``--calib-images`` train-split images (never the test
set), convs in int8 (the heads too with ``--int8-heads``), the fused
serving CT head. ``--bf16`` computes in bfloat16 as the JAX package's
``--bf16`` does (float32 parameters, bf16 convs, BN and CT head, the bf16
CT kernels), with or without ``--int8``; the JAX bench's full serving
config is ``--int8 --int8-heads --bf16 --approx-topk on --top-k 128
--pool-size 512``. ``--host-nms`` decodes and fuses the scores on the
device and runs the per-class NMS on the host, in the port's native C++
library (the reference's CPU-NMS eval).

``-d VOC`` scores the 2007 test set under ``VOC_ROOT`` (default
``data/VOCdevkit``) by VOC mAP; ``-d COCO`` scores
``split_nonvoc_minival2014`` under ``COCO_ROOT`` (default ``data/COCO``)
by the 12 COCO numbers and the AP of each class, and calibrates int8 on
``split_nonvoc_train2014``. Writes
``<save-folder>/inference/detections.pkl``, the scores as ``eval.json``
and the inference rate through the dataset layer as ``speed.json``;
``--retest`` re-scores the cached detections. Flags of what the port does
not run yet raise and name the ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import sys
import time

import numpy as np

logger = logging.getLogger("ct_tpu_torch.test")

# flag → (is it set?, the ROADMAP item that will port it)
UNPORTED = (
    ("--ndev > 1", lambda a: a.ndev > 1,
     "Queue 1 item 8 (data-parallel eval)"),
    ("--pallas-ct", lambda a: a.pallas_ct is not None,
     "none: the port always runs its CT kernels on the card"),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Context-Transformer eval (PyTorch/CUDA port)")
    parser.add_argument("-s", "--size", default="300",
                        help="300 or 512 input size.")
    parser.add_argument("--load-file", "--load_file", dest="load_file",
                        default=None, help="Model checkpoint (.pth).")
    parser.add_argument("-d", "--dataset", default="VOC",
                        help="VOC or COCO dataset.")
    parser.add_argument("--split", type=int, default=1,
                        help="VOC base/novel split, for VOC only.")
    parser.add_argument("--setting", default="transfer",
                        help="Testing setting: transfer or incre.")
    parser.add_argument("-p", "--phase", type=int, default=1,
                        help="1: source pretraining, 2: target finetuning.")
    parser.add_argument("--method", default="ours",
                        help="ft(baseline) or ours, for phase 2 only.")
    parser.add_argument("--retest", action="store_true",
                        help="Re-evaluate cached detections.")
    parser.add_argument("--resume", action="store_true",
                        help="Test the last checkpoint of --save-folder.")
    parser.add_argument("--save-folder", "--save_folder", dest="save_folder",
                        default="weights/", type=str)
    parser.add_argument("-b", "--batch-size", type=int, default=32,
                        help="Inference batch size.")
    parser.add_argument("--approx-topk", choices=["auto", "on", "off"],
                        default="off",
                        help="grouped_topk NMS candidate selection (auto = "
                             "off in the port)")
    parser.add_argument("--pool-size", type=int, default=0,
                        help="Per-image candidate pool of the serving NMS "
                             "(0 = exact per-class path)")
    parser.add_argument("--top-k", type=int, default=200,
                        help="Per-class NMS candidate cap")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving path: fold BN, calibrate on "
                             "train-split images, int8 convs")
    parser.add_argument("--calib-images", type=int, default=8,
                        help="Train-split images for int8 calibration")
    parser.add_argument("--int8-heads", action="store_true",
                        help="With --int8: the loc/conf/obj heads int8 too")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (float32 parameters)")
    parser.add_argument("--host-nms", action="store_true",
                        help="Run NMS on the host in the native C++ library "
                             "(the reference's CPU-NMS eval)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    # flags of test.py that the port does not run: each raises
    parser.add_argument("--pallas-ct", choices=["auto", "on", "off"],
                        default=None)
    parser.add_argument("--ndev", type=int, default=1)
    return parser.parse_args(argv)


def calibration_images(args, img_dim: int, n: int) -> np.ndarray:
    """→ [n, 3, S, S] float32 train-split images for int8 calibration.

    Ranges come from the training distribution, never the test set. When
    the train split is not on disk, seeded mean-centred noise takes its
    place, as in the JAX package."""
    from ct_tpu_torch.config import RGB_MEANS
    from ct_tpu_torch.data.coco import COCODetection
    from ct_tpu_torch.data.voc import (
        AnnotationTransform, VOCDetection, eval_transform, read_image,
    )

    try:
        if args.dataset == "COCO":
            ds = COCODetection(os.environ.get("COCO_ROOT", "data/COCO"),
                               [("2014", "split_nonvoc_train")])
            paths = ds.ids
        else:
            if args.phase == 2 and args.setting == "incre":
                sets = [("2007", "trainval")]
            else:
                sets = [("2007", "trainval"), ("2012", "trainval")]
            ds = VOCDetection(
                os.environ.get("VOC_ROOT", "data/VOCdevkit"), sets, None,
                AnnotationTransform(0 if args.setting == "transfer"
                                    else args.split),
                phase=1, setting=args.setting, split=args.split)
            paths = [os.path.join(rootpath, "JPEGImages", img_id + ".jpg")
                     for rootpath, img_id in ds.ids]
        n = min(n, len(paths))
        imgs = [eval_transform(read_image(path), img_dim, RGB_MEANS)
                for path in paths[:n]]
        logger.info("int8 calibration: %d train-split images", n)
        return np.stack(imgs).transpose(0, 3, 1, 2).copy()
    except Exception as e:  # the train split is missing
        logger.warning(
            "train split unavailable for calibration (%r); using "
            "synthetic mean-centered noise (test set is never used)", e)
        rng = np.random.RandomState(0)
        noise = rng.randn(n, img_dim, img_dim, 3).astype(np.float32) * 50
        return noise.transpose(0, 3, 1, 2).copy()


def serving_model(net, images, int8_heads: bool = False):
    """The int8 serving model of ``net``: a folded copy, calibrated on
    ``images`` (a tensor [n, 3, S, S], one batch) and quantized, with int8
    chained across the trunk's pools. Returns (model, scales)."""
    from ct_tpu_torch.models.fold_bn import fold_bn
    from ct_tpu_torch.models.quantize import (
        SKIP_CT_ONLY, SKIP_DEFAULT, calibrate, quantize,
    )
    from ct_tpu_torch.models.rfbnet import vgg_pool_chains

    folded = fold_bn(net)
    device = next(folded.parameters()).device
    calib = calibrate(folded, [images.to(device)])
    quant = quantize(folded, calib,
                     skip=SKIP_CT_ONLY if int8_heads else SKIP_DEFAULT,
                     chains=vgg_pool_chains(net.size))
    logger.info("int8 serving path: %d convs quantized (calibrated on %d "
                "train-split images)", len(quant), len(images))
    return folded, quant


def eval_set(args):
    """The test set of ``args.dataset``: VOC 2007 test, or COCO's
    ``split_nonvoc_minival2014``."""
    from ct_tpu_torch.data.coco import COCODetection
    from ct_tpu_torch.data.voc import VOCTestSet

    if args.dataset == "VOC":
        return VOCTestSet(os.environ.get("VOC_ROOT", "data/VOCdevkit"),
                          "2007", "test", phase=args.phase,
                          setting=args.setting, split=args.split)
    if args.dataset == "COCO":
        return COCODetection(os.environ.get("COCO_ROOT", "data/COCO"),
                             [("2014", "split_nonvoc_minival")])
    raise ValueError(f"Unknown dataset: {args.dataset}")


def main(argv=None) -> dict:
    from ct_tpu_torch.train.cli import check_ported

    args = parse_args(argv)
    check_ported(args, UNPORTED)

    import torch

    from ct_tpu_torch import resolve_device
    from ct_tpu_torch.config import get_config, resolve_task
    from ct_tpu_torch.eval import run_inference, run_inference_host_nms
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.checkpointer import Checkpointer

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s: %(message)s")

    path = None
    if not args.retest:
        ck = Checkpointer(args.save_folder)
        path = (ck.get_checkpoint_file() if args.resume
                and ck.has_checkpoint() else args.load_file)
        if path is None:
            raise SystemExit("--load-file is required unless --retest, or "
                             "--resume with a checkpoint in --save-folder")
    save_folder = os.path.join(args.save_folder, "inference")
    os.makedirs(save_folder, exist_ok=True)
    img_dim = 512 if args.size == "512" else 300
    task = resolve_task(args.phase, args.setting, args.method, args.dataset)
    dataset = eval_set(args)

    det_file = os.path.join(save_folder, "detections.pkl")
    if args.retest:
        with open(det_file, "rb") as f:
            all_boxes = pickle.load(f)
        logger.info("Evaluating cached detections")
    else:
        logger.info("Loading weights from %s", path)
        device = resolve_device(args.device)
        if device.type == "cuda":
            # float32 products in float32, and bf16 ones summed in float32
            # (preferred_element_type=float32 in the JAX package), as the
            # train CLI sets them
            matmul = torch.backends.cuda.matmul
            matmul.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
            torch.backends.cudnn.allow_tf32 = False
        net = build_net(task, img_dim, device=device,
                        dtype=torch.bfloat16 if args.bf16 else torch.float32)
        net.load_state_dict(load_reference_pth(path))
        if args.int8:
            images = calibration_images(args, img_dim, args.calib_images)
            net, _ = serving_model(net, torch.from_numpy(images),
                                   int8_heads=args.int8_heads)
        priors = prior_boxes(get_config(args.dataset, img_dim), device)
        t0 = time.perf_counter()
        if args.host_nms:
            all_boxes = run_inference_host_nms(net, dataset, task, priors,
                                               img_dim, args.batch_size)
        else:
            all_boxes = run_inference(net, dataset, task, priors, img_dim,
                                      batch_size=args.batch_size,
                                      top_k=args.top_k,
                                      approx_top_k=args.approx_topk == "on",
                                      pool_size=args.pool_size)
        seconds = time.perf_counter() - t0
        speed = {"images": len(dataset), "seconds": seconds,
                 "images_per_s": len(dataset) / seconds,
                 "batch_size": args.batch_size, "device": str(device),
                 "int8": args.int8, "bf16": args.bf16,
                 "host_nms": args.host_nms}
        if device.type == "cuda":
            speed["device_name"] = torch.cuda.get_device_name(device)
        logger.info("inference: %(images)d images in %(seconds).1f s, "
                    "%(images_per_s).1f images/s", speed)
        with open(os.path.join(save_folder, "speed.json"), "w") as f:
            json.dump(speed, f, indent=1)
        with open(det_file, "wb") as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    logger.info("Evaluating detections")
    result = dataset.evaluate_detections(all_boxes, save_folder)
    with open(os.path.join(save_folder, "eval.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
