"""One rank of the port's two-rank checks in ``test_torch_parallel.py``.

    python tests/torch_dp_worker.py CASES OUT RANK WORLD PORT

Joins a gloo group on the CPU at ``localhost:PORT``, runs the cases that
``CASES`` (a ``torch.save``d dict) holds on this rank's blocks and saves
what it saw to ``OUT/rank{RANK}.pt``. It imports the port only.
"""

import sys

import torch


def train_case(case, mesh):
    """One step of ``make_train_step``'s body on this rank's block, with
    the anchors handed in: the reduced gradients, the losses, and the
    state after the update."""
    from ct_tpu_torch.config import TINY_64, resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.mesh import shard_batch
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import (
        batch_to, loss_and_grads, normalize_obj_target,
    )

    task = resolve_task(*case["task"])
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(case["state"])
    net.train()
    opt, sched = build_optimizer(net, task, SolverConfig(**case["solver"]))
    batch = shard_batch(mesh, batch_to(case["batch"], "cpu"))
    mask = shard_batch(mesh, case["mask"])
    losses, _ = loss_and_grads(net, batch, prior_boxes(TINY_64), 0.5,
                               mask=mask, accum_steps=case["accum"],
                               mesh=mesh)
    grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()
             if p.grad is not None}
    opt.step()
    sched.step()
    normalize_obj_target(net)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": grads,
            "after": {k: v.detach().clone()
                      for k, v in net.state_dict().items()}}


def eval_case(case, mesh):
    """The eval step on this rank's block, the detections gathered."""
    from ct_tpu_torch.config import TINY_64, resolve_task
    from ct_tpu_torch.eval import make_eval_step
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.mesh import gather_blocks, shard_batch

    net = build_net(resolve_task(*case["task"]), 64, device="cpu")
    net.load_state_dict(case["state"])
    net.eval()
    images, sizes = shard_batch(mesh, (case["images"], case["sizes"]))
    dets = make_eval_step(net, prior_boxes(TINY_64))(images, sizes)
    return {"block": [t.clone() for t in dets],
            "gathered": [gather_blocks(mesh, t) for t in dets]}


class _Blocks:
    def __init__(self, batches):
        self.batches = list(batches)

    def next(self):
        return self.batches.pop(0)


def reweight_case(case, mesh):
    """``init_reweight`` over this rank's blocks of the batches."""
    from ct_tpu_torch.config import TINY_64, resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.mesh import shard_batch
    from ct_tpu_torch.train.reweight import init_reweight

    task = resolve_task(*case["task"])
    net = build_net(task, 64, device="cpu")
    net.load_state_dict(case["state"])
    blocks = [shard_batch(mesh, b) for b in case["batches"]]
    protos = init_reweight(net, _Blocks(blocks), prior_boxes(TINY_64), task,
                           init_iter=len(blocks), mesh=mesh)
    return {"prototypes": protos.clone(),
            "after": {k: v.detach().clone()
                      for k, v in net.state_dict().items()}}


def int8_case(case, mesh):
    """The int8 serving model as the eval CLI builds it under a group,
    calibrated on ``images[rank]``, then rank 0's broadcast. Returns the
    scales and int8 kernels before and after the broadcast."""
    from ct_tpu_torch.config import resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.parallel.mesh import replicate
    from ct_tpu_torch.test import quant_tensors, serving_model

    net = build_net(resolve_task(*case["task"]), 64, device="cpu")
    net.load_state_dict(case["state"])
    net.eval()
    served, _ = serving_model(net, case["images"][mesh.rank])
    before = [t.clone() for t in quant_tensors(served)]
    replicate(mesh, served, quant_tensors(served))
    return {"before": before,
            "after": [t.clone() for t in quant_tensors(served)]}


CASES = {"train": train_case, "eval": eval_case, "reweight": reweight_case,
         "int8": int8_case}


def main():
    cases_path, out, rank, world, port = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from ct_tpu_torch.parallel.distributed import initialize
    from ct_tpu_torch.parallel.mesh import make_mesh

    initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(world)
    cases = torch.load(cases_path, weights_only=False)
    results = {name: CASES[case["kind"]](case, mesh)
               for name, case in cases.items()}
    torch.save(results, f"{out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
