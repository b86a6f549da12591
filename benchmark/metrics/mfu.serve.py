"""The serving step's share of the card's peak: the least time of a
request's forward, each op at the peak of the type it computes in (int8
convolutions at 1,979 TOP/s, the rest at 989 TFLOP/s), over the mean
measured time of a request (copy to the card → detections on the host,
host clock) in the traced run."""

from benchmark.harness.arith import PEAK_BF16, PEAK_INT8


def read(run):
    if run.kind != "serve" or not run.service_s:
        return None
    f = run.flops
    conv_peak = PEAK_INT8 if run.shapes["int8"] else PEAK_BF16
    least = run.shapes["batch"] * (f["conv"] / conv_peak
                                   + f["ct"] / PEAK_BF16)
    return 100.0 * least / (sum(run.service_s) / len(run.service_s))
