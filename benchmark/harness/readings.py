"""The readings the limits of ``correct`` are set from, in one process.

    python3 benchmark/harness/readings.py --workload <cell> \
        --seeds <n>... [--seconds S] [--control-seeds <n>...] \
        [--faults <name>...] [--rates <r>...] [--out FILE]

For each of ``--seeds``: one run of the cell as ``run.py`` makes it (the
window shortened to ``--seconds``) and the numbers that decide
``correct``: the program's sound readings. For each of
``--control-seeds``: the control, the plain reference one precision below
the cell's (int4 for int8, float8 e4m3 for bf16) put in the program's
place and judged as the program is. For each of ``--faults`` and
``--control-seeds``: a run with that fault planted in the program
(``FAULTS``). ``--rates``: a sweep of the serving rate (the knee), one run
of the first seed at each. Each reading is one JSON line on standard
output and in ``--out``.

The benchmark's own runs never run this: it is run on a card to set and
check the limits (``PERF.md``), and the CPU tests run its faults.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def fault(name: str):
    """Plant fault ``name`` in the program for the enclosed block.

    Training (``ct_tpu_torch.train.step.loss_and_grads``): ``half``, the
    step's loss and gradients from the first half of the batch alone, the
    mean over it; ``altered``, the step's loss sums (and so its loss and
    gradients) scaled by 1.25 where they are produced
    (``masked_loss_sums``); ``unchanged``, an optimizer step
    that leaves the parameters as they were; ``ct.zero`` and
    ``ct.scaled``, the gradients of the CT head's leaves alone
    (``judge.CT_HEAD``) left out or scaled by 1.25, as a head whose
    backward gave nothing or too much. Serving
    (``ct_tpu_torch.eval.make_eval_step``): ``stale``, each request
    answered with the previous request's detections; ``half``, the step
    run on the first half of the batch and its answers given to both
    halves; ``altered``, the best detection of the batch's first image
    given another class."""
    import torch

    import ct_tpu_torch.eval as ev
    import ct_tpu_torch.train.step as st
    from benchmark.harness.judge import CT_HEAD

    saved = (st.loss_and_grads, st.masked_loss_sums, ev.make_eval_step,
             torch.optim.SGD.step)
    lag, sums = st.loss_and_grads, st.masked_loss_sums

    def half_train(model, batch, *a, **k):
        n = batch["image"].shape[0] // 2
        return lag(model, {key: v[:n] for key, v in batch.items()}, *a, **k)

    def altered_train(*a, **k):
        return {key: v * 1.25 for key, v in sums(*a, **k).items()}

    def head_train(scale):
        def run(model, *a, **k):
            out = lag(model, *a, **k)
            for n, p in model.named_parameters():
                if n.split(".")[0] in CT_HEAD and p.grad is not None:
                    p.grad.mul_(scale)
            return out
        return run

    def serving(kind):
        def make(*a, **k):
            step = saved[2](*a, **k)
            last = []

            def faulty(images, sizes=None):
                if kind == "half":
                    n = images.shape[0] // 2
                    d = step(images[:n], None if sizes is None else sizes[:n])
                    return type(d)(*(torch.cat([t, t])[:images.shape[0]]
                                     for t in d))
                d = step(images, sizes)
                if kind == "stale":
                    last.append(d)
                    return last[-2] if len(last) > 1 else d
                classes = d.classes.clone()
                n_cls = int(classes.max())
                classes[0, 0] = classes[0, 0] % max(n_cls, 2) + 1
                return type(d)(d.boxes, d.scores, classes, d.valid)
            return faulty
        return make

    if name == "unchanged":
        torch.optim.SGD.step = lambda self, closure=None: None
    elif name == "half":
        st.loss_and_grads = half_train
    elif name == "altered":
        st.masked_loss_sums = altered_train
    elif name in ("ct.zero", "ct.scaled"):
        st.loss_and_grads = head_train(0.0 if name == "ct.zero" else 1.25)
    if name.startswith("serve."):
        ev.make_eval_step = serving(name.split(".", 1)[1])
    try:
        yield
    finally:
        (st.loss_and_grads, st.masked_loss_sums, ev.make_eval_step,
         torch.optim.SGD.step) = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark.run import prepare_environment
    prepare_environment(ROOT)
    import torch

    from benchmark.harness.inputs import Inputs
    from benchmark.harness.spec import driver, load_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cell = load_cell(args.workload)
    inputs = Inputs()
    kind = driver(cell)
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps({"cell": cell.name, **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def one(c, seed, **rec):
        t = time.perf_counter()
        run = kind.drive(c, seed, args.seconds, False, device, inputs, t)
        torch.cuda.reset_peak_memory_stats()
        lat = sorted(run.latencies_s)
        emit(seed=seed, checks=run.checks, setup_s=run.setup_s,
             window_s=run.window_s, attempted=run.attempted,
             failed=run.failed, images_per_s=run.images / run.window_s,
             p95_ms=1e3 * lat[int(0.95 * len(lat) + 0.999) - 1] if lat
             else None,
             service_ms=1e3 * sum(run.service_s) / len(run.service_s)
             if run.service_s else None, **rec)

    for seed in args.seeds:
        one(cell, seed, kind="sound")
    for rate in args.rates:
        c = cell._replace(traffic={**cell.traffic, "rate_per_s": rate})
        one(c, args.seeds[0] if args.seeds else 1, kind="rate", rate=rate)
    for seed in args.control_seeds:
        emit(seed=seed, kind="control",
             checks=kind.control(cell, seed, inputs, device))
    for name in args.faults:
        for seed in args.control_seeds:
            with fault(name):
                one(cell, seed, kind="fault", fault=name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
