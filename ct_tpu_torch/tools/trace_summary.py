"""The device's busy and idle share in a trace of ``utils/profiler.trace``.

    python -m ct_tpu_torch.tools.trace_summary DIR_OR_TRACE_JSON

Reads the Chrome trace that ``--profile-dir`` writes (``trace.json``) and
prints one JSON line: the trace's window (first to last event, host or
device), the time the card ran at least one kernel, copy or memset (the
union of their intervals, so overlapping kernels count once), the busy and
idle shares of the window, and the device time and count of each category.
A trace without device events (a CPU run) has busy share 0.
"""

from __future__ import annotations

import argparse
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES)
    busy, reach = 0.0, float("-inf")
    for t0, t1 in device:             # the union of the intervals
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    window = end - start
    by_cat = {c: {"ms": sum(e["dur"] for e in events
                            if e.get("cat") == c) / 1e3,
                  "count": sum(e.get("cat") == c for e in events)}
              for c in DEVICE_CATEGORIES}
    return {"trace": path, "window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window if window else 0.0,
            "device_idle_share": 1 - busy / window if window else 1.0,
            "by_category": by_cat}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="a --profile-dir or its trace.json")
    res = summarize(ap.parse_args(argv).path)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
