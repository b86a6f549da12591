"""Evaluation CLI of the port: the flags of ``test.py`` for the VOC eval
path, plus ``--device``.

    python -m ct_tpu_torch.test -p 2 --setting incre --split 1 \\
        --load-file .parity_p2/ref_model.pth --save-folder out/ \\
        [--device cuda|cpu] [--retest]

The VOC root comes from ``VOC_ROOT`` (default ``data/VOCdevkit``).
Writes ``<save-folder>/inference/detections.pkl`` and the VOC mAP as
``<save-folder>/inference/eval.json``; ``--retest`` re-scores the cached
detections.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import sys

logger = logging.getLogger("ct_tpu_torch.test")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Context-Transformer eval (PyTorch/CUDA port)")
    parser.add_argument("-s", "--size", default="300",
                        help="300 or 512 input size.")
    parser.add_argument("--load-file", "--load_file", dest="load_file",
                        default=None, help="Model checkpoint (.pth).")
    parser.add_argument("-d", "--dataset", default="VOC", choices=["VOC"],
                        help="Dataset (VOC only in the port so far).")
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
    parser.add_argument("--save-folder", "--save_folder", dest="save_folder",
                        default="weights/", type=str)
    parser.add_argument("-b", "--batch-size", type=int, default=32,
                        help="Inference batch size.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ct_tpu_torch import resolve_device
    from ct_tpu_torch.config import get_config, resolve_task
    from ct_tpu_torch.data.voc import VOCTestSet
    from ct_tpu_torch.eval import run_inference
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes

    save_folder = os.path.join(args.save_folder, "inference")
    os.makedirs(save_folder, exist_ok=True)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s: %(message)s")

    img_dim = 512 if args.size == "512" else 300
    task = resolve_task(args.phase, args.setting, args.method, args.dataset)
    dataset = VOCTestSet(os.environ.get("VOC_ROOT", "data/VOCdevkit"),
                         "2007", "test", phase=args.phase,
                         setting=args.setting, split=args.split)

    det_file = os.path.join(save_folder, "detections.pkl")
    if args.retest:
        with open(det_file, "rb") as f:
            all_boxes = pickle.load(f)
        logger.info("Evaluating cached detections")
    else:
        if args.load_file is None:
            raise SystemExit("--load-file is required unless --retest")
        device = resolve_device(args.device)
        net = build_net(task, img_dim, device=device)
        net.load_state_dict(load_reference_pth(args.load_file))
        priors = prior_boxes(get_config(args.dataset, img_dim), device)
        all_boxes = run_inference(net, dataset, task, priors, img_dim,
                                  batch_size=args.batch_size)
        with open(det_file, "wb") as f:
            pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    logger.info("Evaluating detections")
    result = dataset.evaluate_detections(all_boxes, save_folder)
    with open(os.path.join(save_folder, "eval.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
