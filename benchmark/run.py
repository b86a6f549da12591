#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ct_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for: sets the run up (inputs and weights from the seed, the program
built, every shape warmed), measures the window, checks what the timed
path produced against the plain reference, and prints one JSON line last
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each number that decided ``correct`` beside its limit (also the last
lines on standard error). Exits non-zero, printing no result, without
enough CUDA cards, or when JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules whose presence means the run is not the port's alone, compared
# by the top-level name (the part before the first dot), whole
FORBIDDEN = ("jax", "jaxlib", "flax", "ct_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout, few host threads, and no
    JAX behind a library's back."""
    build = root / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def loaded_forbidden() -> list:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None, require_cuda: bool = True, root=None,
         t_start: float = None) -> int:
    args = parse_args(argv)
    root = Path(root or ROOT)
    prepare_environment(root)
    import torch

    from benchmark.harness.inputs import Inputs
    from benchmark.harness.spec import driver, load_cell, read_metrics
    from benchmark.harness.trace import breakdown

    cell = load_cell(args.workload, root)
    kind = driver(cell)
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    device = torch.device("cuda" if require_cuda else "cpu")
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    if device.type == "cuda":
        # float32 products in float32 and bf16 ones summed in float32, as
        # the CLIs set them; the reference runs under the same settings
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
        torch.backends.cudnn.allow_tf32 = False

    run = kind.drive(cell, args.seed, args.seconds, bool(args.trace), device,
                Inputs(), T_START if t_start is None else t_start)

    bad = loaded_forbidden()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    limits = cell.workload["limits"]
    checks = {k: {"value": run.checks[k], "limit": v}
              for k, v in limits.items()}
    correct = run.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed,
              "metrics": read_metrics(cell.per_layer if args.trace
                                      else cell.end_to_end, run),
              "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    print(f"reference and comparison: {run.checks_s:.1f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
