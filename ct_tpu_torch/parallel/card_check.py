"""The ranks' half of ``chip_smoke.py``'s ``dp`` phase.

``chip_smoke.py`` starts two ranks of one gloo group on the one card
(``distributed.launch(..., share_device=True)``) on ``rank_check``, a
target in the package, so that a rank never imports ``chip_smoke.py``.
Each rank, on its block of the spec's global batch:

1. one train step of the phase-2 RFBNet300 (``loss_and_grads`` over the
   group, the anchors handed in, then SGD, the schedule and the renorm),
   in each type of ``spec["dtypes"]``, with the kernels' launches counted
   from 0 around it; the gradients, the parameters after the update and
   BatchNorm's running statistics flattened, and both ranks' copies held
   against each other bit for bit; then ``spec["timed_steps"]`` more steps
   and as many all-reduces of the step's buffer, timed;
2. the eval of the spec's first images through ``run_inference`` over the
   group (each rank its block of each batch, the detections gathered),
   with the eval kernels' launches.

Rank 0 returns what both saw, on the host; ``chip_smoke.py`` holds it to
one process's run of the same step and eval on the card.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch


def kernel_counts() -> Dict[str, object]:
    """The wrappers of the train and eval steps' kernels, by name."""
    from ct_tpu_torch.ops import ct_attention as ct
    from ct_tpu_torch.ops import nms, pool_relu

    fns = (ct.ct_attention_cm, ct.ct_attention_cm_stats,
           ct.ct_attention_cm_bwd_flash, ct.ct_attention_cm_bwd,
           ct.ct_attention_cm_bf16, ct.ct_attention_cm_stats_bf16,
           ct.ct_attention_cm_bwd_flash_bf16, ct.ct_attention_cm_bwd_bf16,
           pool_relu.pool2x2_relu_fwd, pool_relu.pool2x2_relu_bwd,
           pool_relu.pool2x2_relu_fwd_bf16, pool_relu.pool2x2_relu_bwd_bf16,
           nms.nms_mask)
    return {fn.__name__: fn for fn in fns}


def zero_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in kernel_counts().items()
            if fn.launches}


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


class Subset:
    """The first ``n`` images of an eval set."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, min(n, len(dataset))

    def __len__(self):
        return self.n

    def pull_image(self, i):
        return self.dataset.pull_image(i)


def _train(spec, mesh, dtype) -> dict:
    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.mesh import (
        all_reduce_flat, bn_running_stats, gather_blocks, shard_batch,
    )
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import loss_and_grads, normalize_obj_target

    dev = mesh.device
    task = resolve_task(2, "incre", "ours", "VOC")
    net = build_net(task, 300, device=dev, dtype=dtype)
    net.load_state_dict(load_reference_pth(spec["ref_model"]))
    opt, sched = build_optimizer(net, task, SolverConfig(**spec["solver"]))
    priors = prior_boxes(VOC_300, dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in shard_batch(mesh, spec["batch"]).items()}
    name = str(dtype).replace("torch.", "")
    mask = torch.from_numpy(shard_batch(mesh, spec["masks"][name])).to(dev)

    def step():
        losses, _ = loss_and_grads(net, batch, priors, 0.5, mask=mask,
                                   mesh=mesh)
        grads = [p.grad.detach().clone() for p in net.parameters()
                 if p.grad is not None]
        opt.step()
        sched.step()
        normalize_obj_target(net)
        return losses, grads

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, grads = step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "grads": flat(grads),
           "params": flat(net.parameters()),
           "stats": flat(bn_running_stats(net)),
           "launches": launches, "first_step_s": first_s}
    # both ranks' state, bit for bit
    same = {}
    for key in ("grads", "params", "stats"):
        both = gather_blocks(mesh, out[key][None])
        same[key] = bool(torch.equal(both[0], both[1]))
    out["ranks_equal"] = same

    step_s, reduce_s = [], []
    buffers = grads + [t.clone() for t in bn_running_stats(net)]
    for _ in range(spec["timed_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        calls = all_reduce_flat(mesh, buffers)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
    out.update(step_s=step_s, all_reduce_s=reduce_s,
               all_reduce_calls=calls,
               all_reduce_mb=sum(t.numel() * 4 for t in buffers) / 1e6)
    for key in ("grads", "params", "stats"):
        out[key] = out[key].cpu().numpy()
    return out


def _eval(spec, mesh) -> dict:
    import os

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.data.voc import VOCTestSet
    from ct_tpu_torch.eval import run_inference
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes

    dev = mesh.device
    task = resolve_task(2, "incre", "ours", "VOC")
    net = build_net(task, 300, device=dev)
    net.load_state_dict(load_reference_pth(spec["ref_model"]))
    net.eval()
    dataset = Subset(VOCTestSet(os.path.abspath(spec["voc_root"]), "2007",
                                "test", phase=2, setting="incre", split=1),
                     spec["eval_images"])
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_boxes = run_inference(net, dataset, task, prior_boxes(VOC_300, dev),
                              300, batch_size=spec["eval_batch"], mesh=mesh)
    torch.cuda.synchronize()
    return {"all_boxes": all_boxes, "seconds": time.perf_counter() - t0,
            "launches": read_counts()}


def rank_check(spec: dict) -> dict:
    """This rank's half of the ``dp`` phase (module docstring); rank 0
    returns both halves' findings, the other ranks None."""
    from ct_tpu_torch.parallel.distributed import rank_device
    from ct_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mesh = make_mesh(device=rank_device("cuda"))
    res = {"world_size": mesh.world_size,
           "backend": torch.distributed.get_backend()}
    for dtype in spec["dtypes"]:
        res[str(dtype).replace("torch.", "")] = _train(spec, mesh, dtype)
    res["eval"] = _eval(spec, mesh)
    return res if mesh.is_primary else None


def flat_state(net) -> Dict[str, np.ndarray]:
    """One process's gradients, parameters and BatchNorm running
    statistics, flattened as ``rank_check`` flattens them."""
    from ct_tpu_torch.parallel.mesh import bn_running_stats

    return {"grads": flat(p.grad for p in net.parameters()
                          if p.grad is not None).cpu().numpy(),
            "params": flat(net.parameters()).cpu().numpy(),
            "stats": flat(bn_running_stats(net)).cpu().numpy()}
