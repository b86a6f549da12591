"""Images whose detections reached the host over the whole window (host
clock): at a serving cell above its knee, the window runs from its start
to the last answer, and the rate is the capacity of the eval step with
one request in flight."""


def read(run):
    if run.kind != "serve" or run.window_s <= 0 or run.images <= 0:
        return None
    return run.images / run.window_s
