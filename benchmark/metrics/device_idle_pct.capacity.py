"""The device's idle share while a request is in service, in a serving
cell above its knee: read as ``device_idle_pct.serve`` reads it (that reader
and its data, found by name), for the cells that report
``serve_images_per_s``."""

from pathlib import Path

from benchmark.harness.spec import reader

read = reader(Path(__file__).resolve().parents[2], "device_idle_pct.serve")
