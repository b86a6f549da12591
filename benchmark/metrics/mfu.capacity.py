"""The serving step's share of the card's peak at capacity: the least
time of an image's forward, each op at the peak of the type it computes
in (int8 convolutions at 1,979 TOP/s, the rest at 989 TFLOP/s), times the
images answered a second before the traced run's profiler opened (host
clock; the profiler's start and its host work are left out)."""

from benchmark.harness.arith import PEAK_BF16, PEAK_INT8


def read(run):
    rate = run.shapes.get("untraced_images_per_s")
    if run.kind != "serve" or not rate:
        return None
    f = run.flops
    conv_peak = PEAK_INT8 if run.shapes["int8"] else PEAK_BF16
    return 100.0 * (f["conv"] / conv_peak + f["ct"] / PEAK_BF16) * rate
