"""The share of the traced stretch's device time (kernels, copies and
memsets) spent in cuDNN's NCHW↔NHWC layout conversions, by the kernel
names in ``layout_convert_pct.train.json``."""

from benchmark.harness.spec import metric_data
from benchmark.harness.trace import kernel_seconds

DATA = metric_data(__file__)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    total = sum(k.dur_s for k in run.trace.kernels)
    if total <= 0:
        return None
    k = kernel_seconds(run.trace, DATA["kernels"])
    return 100.0 * sum(k["seconds"].values()) / total
