"""The training step's share of the card's bf16 peak: the model FLOPs of
forward and backward (3× the forward's, counted from the published
architecture's shapes, ``harness/arith.py``) at the rate of the traced
run's steps before its profiler opened (host clock; the profiler's start
and its host work are left out), over 989 TFLOP/s."""

from benchmark.harness.arith import PEAK_BF16


def read(run):
    step_s = run.shapes.get("untraced_step_s") if run.kind == "train" else None
    if not step_s:
        return None
    rate = run.shapes["batch"] / step_s
    return 100.0 * rate * 3.0 * run.flops["total"] / PEAK_BF16
