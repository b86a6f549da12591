"""Images taken by the train step over the whole window (host clock; the
window ends in a synchronize)."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.images / run.window_s
