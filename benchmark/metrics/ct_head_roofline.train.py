"""The CT head's training kernels' share of their roofline: the least time
of the bf16 training forward and flash backward (kernel rows 2 and 3,
``harness/arith.py``) of each micro-batch the trace holds, over the device
time of the kernels named in ``ct_head_roofline.train.json``. Micro-batches
are counted by the launches of the backward's dk/dv kernel."""

from benchmark.harness import arith
from benchmark.harness.spec import metric_data
from benchmark.harness.trace import kernel_seconds

DATA = metric_data(__file__)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    k = kernel_seconds(run.trace, DATA["kernels"])
    seconds = sum(k["seconds"].values())
    micro = k["launches"][DATA["per_micro_batch"]]
    if seconds <= 0 or micro == 0:
        return None
    s = run.shapes
    args = (s["micro"], s["classes"], s["priors"], s["keys"])
    least = micro * (arith.ct_stats_bound_s(*args)
                     + arith.ct_flash_bwd_bound_s(*args))
    return 100.0 * least / seconds
