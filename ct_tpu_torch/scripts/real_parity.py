"""Trained parity on synthetic fixtures: build them, train the port's model
on the card, export a ``.pth``, score it and diff it against the records.

The port of the JAX package's ``scripts/real_parity.py``, with its
sub-commands, flags, defaults and output file names, on the port's
modules, plus ``--device`` (the card unless ``cpu`` is passed) and
``--eval-batch`` (32, the JAX script's ``-b``):

  python -m ct_tpu_torch.scripts.real_parity build  [--images 400]
  python -m ct_tpu_torch.scripts.real_parity train  [--iters 3000 --batch 64]
  python -m ct_tpu_torch.scripts.real_parity eval-ours [--int8 | --bf16 ...]
  python -m ct_tpu_torch.scripts.real_parity diff

The incremental chain (phase-1 base-15 pretrain, then the 5-shot
fine-tune of the CT head):

  ... build2 --out .parity_p2 [--images 600]
  ... train  --out .parity_p2 --export-name phase1.pth
  ... train2 --out .parity_p2 [--iters 400 --shot 5]
  ... eval-ours --out .parity_p2 --phase 2
  ... diff --out .parity_p2 --phase 2

The transfer chain (the paper's protocol: COCO-60 pretrain, then a 5-shot
fine-tune on the 20 VOC classes):

  ... build3 --out .parity_tr --images 1800 --test-images 128
  ... train  --out .parity_tr --dataset COCO --iters 9000 --batch 64 \\
        --export-name phase1.pth
  ... eval-ours --out .parity_tr --dataset COCO --phase 1 \\
        --setting transfer --load-name phase1.pth
  ... train2 --out .parity_tr --setting transfer --shot 5 --iters 600
  ... eval-ours --out .parity_tr --phase 2 --setting transfer

Under ``--out``: ``voc/VOCdevkit`` and ``coco/`` (the fixtures of
``tools/voc_fixture.py`` and ``tools/coco_fixture.py``), ``phase1.pth``,
``ref_model.pth`` (the phase-2 export), ``ours_eval*.json`` (the scores
of an ``eval-ours`` config, its detections under ``ours_eval*/``), and
the reference stack's ``ref_eval*.json`` and ``detections_ref*.pkl``
that ``diff`` compares against.

Training decodes the whole fixture once (``DeviceDataset``), keeps it on
the device as uint8 canvases and gathers each batch there, the indices
drawn from ``np.random.RandomState(0)`` as the JAX script draws them; the
augmentation (and, in phase 2, mixup) runs on the device
(``data/augment_device.py``) from the train CLI's seeded streams. The
model trains in bf16 on the card and in float32 on the CPU, as the JAX
script trained in bf16 on its accelerator; evaluation is float32 unless
``--bf16``. Fresh weights get the JAX package's initialisers
(``models/init.py``) before phase 2 loads ``phase1.pth`` over them
(tensors of another shape skipped). The exports are ``{"model":
state_dict, "iteration": it}`` in the reference key space, as the JAX
package's ``save_pth`` writes them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a) -> None:
    print(*a, flush=True)


def cmd_build(args) -> dict:
    """The 15-base-class fixture: both years, each class in its colour."""
    from ct_tpu_torch.tools.voc_fixture import (
        ALL20, YEAR_SEEDS, make_mini_voc,
    )

    for year, seed in YEAR_SEEDS:
        make_mini_voc(os.path.join(args.out, "voc"), year=year,
                      num_images=args.images, classes=ALL20[:15], seed=seed,
                      class_colors=True, max_test_ids=args.test_images)
    log(f"fixture: 2x{args.images} images, 15 base classes, "
        f"test set {args.test_images}")
    return {"images": args.images, "test_images": args.test_images}


def cmd_build2(args) -> dict:
    """The all-20-class fixture with few-shot lists regenerated by
    ``data/make_shots.py`` (``tools/voc_fixture.build_fewshot_voc``)."""
    from ct_tpu_torch.tools.voc_fixture import build_fewshot_voc

    res = build_fewshot_voc(os.path.join(args.out, "voc"), args.images,
                            args.test_images)
    log(f"fixture: 2x{args.images} images, 20 split-1 classes, "
        f"{len(res['lists'])} list files, split1(2007)="
        f"{res['split1_2007']} base images, test set {args.test_images}")
    return {"images": args.images, "test_images": args.test_images,
            "lists": len(res["lists"]), "split1_2007": res["split1_2007"]}


def cmd_build3(args) -> dict:
    """The transfer pair: ``coco/``, the COCO-60 source fixture for the
    phase-1 pretrain and the COCO evaluator, and ``voc/``, the few-shot
    VOC fixture of ``build2`` at no more than 600 images a year."""
    import copy

    from ct_tpu_torch.tools.coco_fixture import make_coco60

    make_coco60(os.path.join(args.out, "coco"), n_train=args.images,
                n_val=args.test_images)
    voc_args = copy.copy(args)
    voc_args.images = min(args.images, 600)
    res = cmd_build2(voc_args)
    log(f"coco60 fixture: {args.images} train / {args.test_images} minival")
    return {"coco_images": args.images, "voc": res}


class DeviceDataset:
    """A small fixture decoded once and held on the device: uint8 NCHW
    canvases and targets padded to ``max_objs``; ``next()`` gathers a
    batch there at indices drawn from ``np.random.RandomState(seed)``,
    the JAX script's stream."""

    def __init__(self, dataset, batch_size: int, device, max_objs: int = 8,
                 seed: int = 0):
        import torch

        from ct_tpu_torch.data.loader import to_device
        from ct_tpu_torch.data.targets import pad_targets

        imgs, annos = [], []
        for i in range(len(dataset)):
            img, t = dataset[i]
            imgs.append(img.astype(np.uint8))
            annos.append(t)
        pt = pad_targets(annos, max_objs=max_objs)
        images = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2)
        self.data = {
            "image": to_device(images.contiguous(), device),
            "boxes": to_device(pt.boxes, device),
            "labels": to_device(pt.labels, device),
            "weights": to_device(pt.weights, device),
            "valid": to_device(pt.valid, device),
        }
        self.device = device
        self.size = len(dataset)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        log(f"dataset resident on {device}: "
            f"{tuple(self.data['image'].shape)} uint8")

    def next(self) -> dict:
        from ct_tpu_torch.data.loader import to_device

        idx = to_device(self.rng.randint(0, self.size,
                                         size=(self.batch_size,)),
                        self.device)
        return {k: v.index_select(0, idx) for k, v in self.data.items()}


def phase1_solver(lr: float, iters: int):
    """Phase 1's schedule: decays at 70% and 90% of the run, warm-up over
    a sixth of it, 500 iterations at the most."""
    from ct_tpu_torch.train.solver import SolverConfig

    return SolverConfig(lr=lr, steps=(int(iters * 0.7), int(iters * 0.9)),
                        warmup_iters=min(500, iters // 6))


def phase2_solver(lr: float, iters: int):
    """Phase 2's schedule: no warm-up, one decay at 87.5% of the run."""
    from ct_tpu_torch.train.solver import SolverConfig

    return SolverConfig(lr=lr, steps=(int(iters * 0.875),), warmup_iters=0)


def mixup_on(it: int, iters: int, no_mixup_iter: int) -> bool:
    """Whether iteration ``it`` mixes its batch: all but the last
    ``no_mixup_iter``."""
    return it < iters - no_mixup_iter


def canvas_of(size: int) -> int:
    return 384 if size == 300 else (size * 5 + 3) // 4


class Run:
    """What ``train`` and ``train2`` share: the device (TF32 off on the
    card, as the CLIs set it), the compute type, and the model built for
    ``task`` with the JAX package's initialisers (seed 0)."""

    def __init__(self, args, task):
        import torch

        from ct_tpu_torch import resolve_device
        from ct_tpu_torch.config import get_config
        from ct_tpu_torch.models.init import init_like_jax
        from ct_tpu_torch.models.rfbnet import build_net
        from ct_tpu_torch.ops.priors import prior_boxes
        from ct_tpu_torch.scripts import device_name

        self.device = resolve_device(args.device)
        self.device_name = device_name(self.device)
        if self.device.type == "cuda":
            matmul = torch.backends.cuda.matmul
            matmul.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        self.task = task
        self.size = args.size
        self.model = init_like_jax(
            build_net(task, args.size, device=self.device, dtype=self.dtype),
            torch.Generator().manual_seed(0)).train()
        self.priors = prior_boxes(get_config(task.dataset, args.size),
                                  self.device)
        self.gen = torch.Generator(device=self.device)

    def state(self, cfg, accum: int):
        """The train state over ``cfg``'s schedule with the fused SGD step
        (JAX's ``build_fused_optimizer``), and the step."""
        from ct_tpu_torch.config import OVERLAP_THRESHOLD
        from ct_tpu_torch.train.solver import build_optimizer
        from ct_tpu_torch.train.step import TrainState, make_train_step

        optimizer, scheduler = build_optimizer(self.model, self.task, cfg,
                                               fused=True)
        return (TrainState(self.model, optimizer, scheduler),
                make_train_step(self.priors, OVERLAP_THRESHOLD,
                                accum_steps=accum))

    def augmented(self, batch: dict, it: int) -> dict:
        from ct_tpu_torch.train.cli import (
            AUGMENT_STREAM, device_augmented, seed_of,
        )

        return device_augmented(self.gen, seed_of(AUGMENT_STREAM, it), batch,
                                self.size, self.dtype)

    def export(self, path: str, iteration: int) -> str:
        import torch

        torch.save({"model": {k: v.detach().cpu() for k, v in
                              self.model.state_dict().items()},
                    "iteration": int(iteration)}, path)
        log("exported", path, f"@iter {iteration}")
        return path


def _losses(metrics: dict) -> dict:
    return {k: float(metrics[k]) for k in ("total_loss", "loss_box_reg",
                                           "loss_cls", "loss_obj")}


def _loss_line(it: int, m: dict) -> str:
    return (f"iter {it}: total={m['total_loss']:.4f} "
            f"box={m['loss_box_reg']:.4f} cls={m['loss_cls']:.4f} "
            f"obj={m['loss_obj']:.4f}")


def cmd_train(args) -> dict:
    """Phase 1 from the JAX initialisers (no basenet): VOC incre split 1
    on 07+12 trainval, or ``--dataset COCO``, the COCO-60 transfer
    pretrain on ``split_nonvoc_train2014``; exports every 500 iterations
    and at the end."""
    from ct_tpu_torch.config import resolve_task
    from ct_tpu_torch.data.augment import RawCanvasTransform

    canvas = canvas_of(args.size)
    if args.dataset == "COCO":
        from ct_tpu_torch.data.coco import COCODetection

        task = resolve_task(1, "transfer", "ours", "COCO")
        what = "phase-1 COCO-60 transfer"
        dataset = COCODetection(os.path.join(args.out, "coco"),
                                [("2014", "split_nonvoc_train")],
                                RawCanvasTransform(canvas))
    else:
        from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection

        task = resolve_task(1, "incre", "ours", "VOC")
        what = "phase-1 incre split-1"
        dataset = VOCDetection(
            os.path.join(args.out, "voc", "VOCdevkit"),
            [("2007", "trainval"), ("2012", "trainval")],
            RawCanvasTransform(canvas), AnnotationTransform(1),
            phase=1, setting="incre", split=1)
    run = Run(args, task)
    log(f"device: {run.device_name}  ({what}, size {args.size}, "
        f"{str(run.dtype).replace('torch.', '')})")
    log(f"train dataset: {len(dataset)} images")
    loader = DeviceDataset(dataset, args.batch, run.device)
    state, step = run.state(phase1_solver(args.lr, args.iters), args.accum)
    path = os.path.join(args.out, args.export_name)

    t0 = time.time()
    t_load = t_aug = t_step = 0.0
    m = {}
    for it in range(args.iters):
        ta = time.time()
        b = loader.next()
        tb = time.time()
        aug = run.augmented(b, it)
        tc = time.time()
        metrics = step(state, aug)
        td = time.time()
        t_load += tb - ta
        t_aug += tc - tb
        t_step += td - tc
        if it % 100 == 0 or it == args.iters - 1:
            m = _losses(metrics)
            rate = args.batch * (it + 1) / (time.time() - t0)
            log(f"{_loss_line(it, m)}  ({rate:.0f} img/s  load "
                f"{t_load:.0f}s aug {t_aug:.0f}s step {t_step:.0f}s)")
        if it and it % 500 == 0:
            run.export(path, it)   # insurance against a cut run
    seconds = time.time() - t0
    run.export(path, args.iters - 1)
    return {"iterations": args.iters, "batch": args.batch,
            "seconds": seconds, "images_per_s": args.batch * args.iters
            / seconds, "load_s": t_load, "aug_s": t_aug, "step_s": t_step,
            "last": m, "export": path, "device": run.device_name,
            "dtype": str(run.dtype).replace("torch.", "")}


def cmd_train2(args) -> dict:
    """Phase 2 of the ``ours`` method: ``phase1.pth`` loaded over the JAX
    initialisers, ``OBJ_Target`` from ``--init-iter`` augmented, never
    mixed batches, then the CT head's fine-tune with mixup off for the
    last ``--no-mixup-iter`` iterations; exports ``--export-name``.
    ``incre`` trains on the 2007 instance shots (every object after an
    image's first an ignore label), ``transfer`` on the
    ``trainval_{shot}shot`` image shots of 07+12."""
    from ct_tpu_torch.config import resolve_task
    from ct_tpu_torch.data.augment import RawCanvasTransform
    from ct_tpu_torch.data.augment_device import mixup_batch
    from ct_tpu_torch.data.voc import AnnotationTransform, VOCDetection
    from ct_tpu_torch.train.checkpointer import Checkpointer
    from ct_tpu_torch.train.cli import AugmentedBatches, mixup_rng
    from ct_tpu_torch.train.reweight import init_reweight

    task = resolve_task(2, args.setting, "ours", "VOC")
    train_sets = ([("2007", "trainval")] if args.setting == "incre"
                  else [("2007", "trainval"), ("2012", "trainval")])
    dataset = VOCDetection(
        os.path.join(args.out, "voc", "VOCdevkit"), train_sets,
        RawCanvasTransform(canvas_of(args.size)),
        AnnotationTransform(0 if args.setting == "transfer" else 1),
        phase=2, setting=args.setting, split=1, shot=args.shot)
    run = Run(args, task)
    log(f"device: {run.device_name}  (phase-2 {args.setting} split-1, "
        f"{args.shot}-shot, size {args.size}, "
        f"{str(run.dtype).replace('torch.', '')})")
    log(f"train dataset: {len(dataset)} shot images")
    loader = DeviceDataset(dataset, args.batch, run.device)
    Checkpointer(os.path.join(args.out, "p2_weights")).resume_or_load(
        os.path.join(args.out, args.phase1_name), run.model, resume=False,
        load_optimizer=False)
    state, step = run.state(phase2_solver(args.lr, args.iters), args.accum)

    t0 = time.time()
    init_reweight(run.model, AugmentedBatches(loader, run.device, args.size,
                                              run.dtype),
                  run.priors, task, args.init_iter)
    init_s = time.time() - t0
    log(f"OBJ_Target initialized from {args.init_iter} batches")

    t0 = time.time()
    m = {}
    for it in range(args.iters):
        batch = run.augmented(loader.next(), it)
        if mixup_on(it, args.iters, args.no_mixup_iter):
            # ignore rows drop out of the loss (incre; transfer has none)
            batch = mixup_batch(mixup_rng(it), batch, zero_ignored=True)
        metrics = step(state, batch)
        if it % 50 == 0 or it == args.iters - 1:
            m = _losses(metrics)
            rate = args.batch * (it + 1) / (time.time() - t0)
            log(f"{_loss_line(it, m)}  ({rate:.0f} img/s)")
    seconds = time.time() - t0
    path = run.export(os.path.join(args.out, args.export_name),
                      args.iters - 1)
    return {"iterations": args.iters, "batch": args.batch,
            "init_iter": args.init_iter, "init_s": init_s,
            "seconds": seconds,
            "images_per_s": args.batch * args.iters / seconds, "last": m,
            "export": path, "device": run.device_name,
            "dtype": str(run.dtype).replace("torch.", "")}


def ours_name(args) -> str:
    """The result-file stem of an ``eval-ours`` config, which ``diff``
    resolves the same way."""
    name = getattr(args, "name", None)
    if name:
        return name
    name = "ours_eval"
    if args.dataset == "COCO":
        name += "_coco"
    if args.int8:
        name += "_int8"
        if args.calib_images != 8:
            name += f"_c{args.calib_images}"
    if args.int8_heads:
        name += "h"
    if args.bf16:
        name += "_bf16"
    if args.approx:
        name += "_approx"
    if args.pool:
        name += "_pool"
    if args.size != 300:
        name += f"_{args.size}"
    return name


def cmd_eval_ours(args) -> dict:
    """The port's eval CLI at batch ``--eval-batch`` (32, the JAX
    script's) on ``--load-name`` with the variant flags; writes
    ``<stem>.json`` in the JAX script's form (VOC: ``mAP``, ``APs``,
    ``base_mAP``/``novel_mAP``; COCO: the evaluator's numbers)."""
    from ct_tpu_torch import test as test_cli

    os.environ["VOC_ROOT"] = os.path.join(args.out, "voc", "VOCdevkit")
    os.environ["COCO_ROOT"] = os.path.join(args.out, "coco")
    name = ours_name(args)
    extra = []
    if args.int8:
        extra += ["--int8"]
        if args.calib_images != 8:
            extra += ["--calib-images", str(args.calib_images)]
    if args.int8_heads:
        extra += ["--int8-heads"]
    if args.bf16:
        extra += ["--bf16"]
    if args.approx:
        extra += ["--approx-topk", "on", "--top-k", "128"]
    if args.pool:
        extra += ["--pool-size", "512"]
    if args.size != 300:
        extra += ["-s", str(args.size)]
    res = test_cli.main([
        "-d", args.dataset, "-p", str(args.phase),
        "--setting", args.setting, "--split", "1",
        "--load-file", os.path.join(args.out, args.load_name),
        "--save-folder", os.path.join(args.out, name), "-b",
        str(args.eval_batch), "--device", args.device, *extra])
    if args.dataset == "COCO":
        out = {k: float(v) for k, v in res.items()}
    else:
        out = {"mAP": float(res["mAP"]),
               "APs": {k: float(v) for k, v in res.get("APs", {}).items()}}
        for k in ("base_mAP", "novel_mAP"):
            if k in res:
                out[k] = float(res[k])
    with open(os.path.join(args.out, name + ".json"), "w") as f:
        json.dump(out, f, indent=1)
    log(name, "mAP:", out.get("mAP", out.get("AP50")))
    return out


def cmd_diff(args) -> dict:
    """Our scores against the reference stack's (``ref_eval.json``) and,
    where both are there, our detections against its: PASS is |Δ mAP| <
    0.003 at a reference mAP ≥ 0.3 (incre phase 2: the novel mAP too)."""
    from ct_tpu_torch.tools.diff_detections import diff

    name = ours_name(args)
    if args.dataset == "COCO":
        return _diff_coco(args, name)
    with open(os.path.join(args.out, "ref_eval.json")) as f:
        ref = json.load(f)
    with open(os.path.join(args.out, name + ".json")) as f:
        ours = json.load(f)
    delta = abs(ref["mAP"] - ours["mAP"])
    log(f"reference mAP {ref['mAP']:.4f}  ours {ours['mAP']:.4f}  "
        f"|delta| {delta:.5f}")
    res = {"ref_mAP": ref["mAP"], "mAP": ours["mAP"], "delta": delta}
    for k in ("base_mAP", "novel_mAP"):
        if k in ref and k in ours:
            d = abs(ref[k] - ours[k])
            log(f"  {k}: reference {ref[k]:.4f}  ours {ours[k]:.4f}  "
                f"|delta| {d:.5f}")
            res[k] = {"ref": ref[k], "ours": ours[k], "delta": d}
    det_ours = os.path.join(args.out, name, "inference", "detections.pkl")
    det_ref = os.path.join(args.out, "detections_ref.pkl")
    if os.path.exists(det_ours) and os.path.exists(det_ref):
        res["detections"] = diff(det_ours, det_ref)
        log(json.dumps(res["detections"], indent=1, default=float))
    ok = delta < 0.003 and ref["mAP"] >= 0.3
    check_novel = args.phase == 2 and args.setting == "incre"
    if check_novel:
        # the CT head's decisive number is the novel-class mAP (transfer:
        # every class is novel, so the mAP is that number)
        ok = (ok and "novel_mAP" in ref and "novel_mAP" in ours
              and ref["novel_mAP"] >= 0.3
              and abs(ref["novel_mAP"] - ours["novel_mAP"]) < 0.003)
    log("PASS" if ok else "FAIL",
        "(target: |delta| < 0.003 at mAP >= 0.3"
        + (", novel_mAP >= 0.3" if check_novel else "") + ")")
    res["ok"] = ok
    return res


def _diff_coco(args, name: str) -> dict:
    """The COCO evaluator's numbers against the reference stack's
    (``ref_eval_coco.json``): PASS is |Δ AP50| < 0.003 at AP50 ≥ 0.3."""
    from ct_tpu_torch.tools.diff_detections import diff

    with open(os.path.join(args.out, "ref_eval_coco.json")) as f:
        ref = json.load(f)
    with open(os.path.join(args.out, name + ".json")) as f:
        ours = json.load(f)
    d50 = abs(ref["AP50"] - ours["AP50"])
    dap = abs(ref["AP"] - ours["AP"])
    log(f"reference AP50 {ref['AP50']:.4f}  ours {ours['AP50']:.4f}  "
        f"|delta| {d50:.5f}")
    log(f"reference AP   {ref['AP']:.4f}  ours {ours['AP']:.4f}  "
        f"|delta| {dap:.5f}")
    res = {"ref_AP50": ref["AP50"], "AP50": ours["AP50"], "delta_AP50": d50,
           "delta_AP": dap}
    cat_deltas = []
    for k in ref:
        if k.startswith("AP-") and k in ours:
            a, b = ref[k], ours[k]
            if a == a and b == b:  # NaN: the class is absent on both sides
                cat_deltas.append((abs(a - b), k))
    if cat_deltas:
        cat_deltas.sort(reverse=True)
        log(f"per-category AP deltas: max {cat_deltas[0][0]:.4f} "
            f"({cat_deltas[0][1]}), mean "
            f"{sum(d for d, _ in cat_deltas) / len(cat_deltas):.5f} "
            f"over {len(cat_deltas)} categories")
    det_ours = os.path.join(args.out, name, "inference", "detections.pkl")
    det_ref = os.path.join(args.out, "detections_ref_coco.pkl")
    if os.path.exists(det_ours) and os.path.exists(det_ref):
        res["detections"] = diff(det_ours, det_ref)
        log(json.dumps(res["detections"], indent=1, default=float))
    ok = d50 < 0.003 and ref["AP50"] >= 0.3
    log("PASS" if ok else "FAIL",
        "(target: |delta AP50| < 0.003 at AP50 >= 0.3)")
    res["ok"] = ok
    return res


COMMANDS = {"build": cmd_build, "build2": cmd_build2, "build3": cmd_build3,
            "train": cmd_train, "train2": cmd_train2,
            "eval-ours": cmd_eval_ours, "diff": cmd_diff}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=list(COMMANDS))
    ap.add_argument("--out", default=os.path.join(REPO, ".parity_real"))
    ap.add_argument("--images", type=int, default=400)
    ap.add_argument("--test-images", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=300, choices=[300, 512],
                    help="input resolution")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation micro-steps (512@64: 4)")
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--export-name", default="ref_model.pth")
    ap.add_argument("--name", default=None,
                    help="the eval/diff result-file stem (default: from "
                         "the variant flags)")
    ap.add_argument("--dataset", default="VOC", choices=["VOC", "COCO"],
                    help="train/eval-ours/diff dataset (COCO: the "
                         "transfer pretrain and the COCO evaluator)")
    ap.add_argument("--load-name", default="ref_model.pth",
                    help="checkpoint that eval-ours scores")
    ap.add_argument("--phase", type=int, default=1)
    ap.add_argument("--setting", default="incre",
                    choices=["incre", "transfer"],
                    help="phase-2 protocol (train2/eval-ours/diff)")
    ap.add_argument("--phase1-name", default="phase1.pth",
                    help="phase-1 checkpoint that train2 loads")
    ap.add_argument("--shot", type=int, default=5)
    ap.add_argument("--init-iter", type=int, default=50)
    ap.add_argument("--no-mixup-iter", type=int, default=100)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--calib-images", type=int, default=8,
                    help="int8 calibration set size")
    ap.add_argument("--int8-heads", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--approx", action="store_true")
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--eval-batch", type=int, default=32,
                    help="eval-ours batch (the eval CLI pads the last)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run one sub-command; returns its result (``diff``: with ``ok``)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(0 if main().get("ok", True) else 1)
