"""The share of a training step's wall time in which the device runs
nothing: 1 − (the device's busy time a step, the union of its kernel,
copy and memset intervals over the traced steps) / (the wall time a step
of the same run's untraced steps, host clock). The untraced wall time is
taken because the profiler's own host work (1.25× a step of the 512 cell)
would otherwise count as the device's idle time."""


def read(run):
    t, s = run.trace, run.shapes
    if run.kind != "train" or t is None or t.busy_s <= 0:
        return None
    busy_per_step = t.busy_s / s["traced_steps"]
    return 100.0 * (1.0 - busy_per_step / s["untraced_step_s"])
