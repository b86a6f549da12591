"""Mean device time of a request's post-processing (``postprocess``:
decode, obj×conf fusion, candidate pool and top-k, NMS, the per-image cap)
in the traced run, by CUDA events around the call."""


def read(run):
    ms = run.event_ms.get("postprocess") if run.kind == "serve" else None
    return sum(ms) / len(ms) if ms else None
