"""The CT head's serving kernel's share of its roofline: the least time of
the bf16 fused serving head (kernel row 6) on a folded model, or of the
bf16 eval forward (row 1) on an unfolded one, for each request the trace
holds, over the device time of the kernels named in
``ct_head_roofline.serve.json``. Requests are counted by the launches of
the head's main kernel."""

from benchmark.harness import arith
from benchmark.harness.spec import metric_data
from benchmark.harness.trace import kernel_seconds

DATA = metric_data(__file__)


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    s = run.shapes
    names = DATA["folded" if s["int8"] else "unfolded"]
    k = kernel_seconds(run.trace, names)
    seconds = sum(k["seconds"].values())
    calls = k["launches"][names[0]]
    if seconds <= 0 or calls == 0:
        return None
    b, c, p, kk = s["batch"], s["classes"], s["priors"], s["keys"]
    least = (arith.ct_serving_bound_s(b, c, p, kk, s["novel"]) if s["int8"]
             else arith.ct_eval_bound_s(b, c, p, kk))
    return 100.0 * calls * least / seconds
