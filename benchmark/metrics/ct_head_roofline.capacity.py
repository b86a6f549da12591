"""The CT head's serving kernels' share of their roofline in a serving
cell above its knee: read as ``ct_head_roofline.serve`` reads it (that reader
and its data, found by name), for the cells that report
``serve_images_per_s``."""

from pathlib import Path

from benchmark.harness.spec import reader

read = reader(Path(__file__).resolve().parents[2], "ct_head_roofline.serve")
