"""The system under test, built from ``ct_tpu_torch`` as its CLIs build
it. The only module of the benchmark that imports the program."""

from __future__ import annotations

import torch


def _task_and_priors(cfg, device):
    """The task and anchors the configuration names: its ``phase``,
    ``setting``, ``method`` and ``dataset``, and its anchor layout
    ``ssd`` (a name in ``ct_tpu_torch.config``)."""
    from ct_tpu_torch import config
    from ct_tpu_torch.ops.priors import prior_boxes

    task = config.resolve_task(cfg["phase"], cfg["setting"], cfg["method"],
                               cfg["dataset"])
    return task, prior_boxes(getattr(config, cfg["ssd"]), device)


def _net(cfg, opt, task, state, device):
    from ct_tpu_torch.models.rfbnet import build_net

    net = build_net(task, cfg["size"], device=device,
                    dtype=torch.bfloat16 if opt["bf16"] else torch.float32)
    net.load_state_dict(state)
    return net


def serving(cell, state, calib_x, device):
    """(model, priors, eval step) as ``ct_tpu_torch.test`` serves: with
    ``int8`` the folded, calibrated and quantized serving model."""
    from ct_tpu_torch.eval import make_eval_step

    cfg, opt = cell.config, cell.workload["program"]
    task, priors = _task_and_priors(cfg, device)
    net = _net(cfg, opt, task, state, device)
    if opt["int8"]:
        from ct_tpu_torch.test import serving_model
        net, _ = serving_model(net, calib_x, int8_heads=opt["int8_heads"])
    step = make_eval_step(net, priors, top_k=opt["top_k"],
                          approx_top_k=opt["approx_topk"],
                          pool_size=opt["pool_size"])
    return net, priors, step


def training(cell, state, device):
    """(train state, step) as ``ct_tpu_torch.train`` trains: the model in
    train mode, per-leaf SGD with its groups' learning rates and no
    warm-up, and ``make_train_step`` with the cell's accumulation."""
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, make_train_step

    cfg, opt = cell.config, cell.workload["program"]
    task, priors = _task_and_priors(cfg, device)
    net = _net(cfg, opt, task, state, device)
    net.train()
    solver = SolverConfig(lr=opt["lr"], warmup_iters=0, steps=(10 ** 9,))
    optimizer, schedule = build_optimizer(net, task, solver)
    step = make_train_step(priors, accum_steps=opt["accum_steps"])
    return TrainState(net, optimizer, schedule), step
