"""Mean device time of the model's forward (``net(images)``) of a request
in the traced run, by CUDA events around the call."""


def read(run):
    ms = run.event_ms.get("forward") if run.kind == "serve" else None
    return sum(ms) / len(ms) if ms else None
