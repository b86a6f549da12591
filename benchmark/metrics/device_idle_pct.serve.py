"""The share of a serving cell's traced stretch (between two marker
kernels) in which the device ran no kernel, copy or memset while a
request was in service: the idle time that the trace puts down to the
benchmark's wait for a request's due time (``bench.wait``, the planned
gaps between arrivals) is left out of both the idle time and the
stretch, so a faster step does not read as more idle."""


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or t.busy_s <= 0:
        return None
    waiting = t.idle_by_span.get("bench.wait", 0.0)
    return 100.0 * (1.0 - t.busy_s / (t.window_s - waiting))
