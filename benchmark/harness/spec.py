"""What a cell is, found by name from ``BENCHMARK.json`` and the files
beside it.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own, found by name:

* ``BENCHMARK.json``'s ``configs`` entry names the configuration's file
  (``benchmark/configs/<config>.json``): the model, its published sizes,
  the inputs it reads with their digests, and what was cut;
* ``benchmark/traffic/<traffic>.json``: the mix (its ``kind``; batch,
  rate, spread of arrivals, schedule);
* ``benchmark/harness/<kind>.py``: the driver of a kind of traffic
  (``serve``, ``train``), with ``drive`` (one run) and ``control`` (the
  control's numbers); a kind with no driver is refused;
* ``benchmark/workloads/<cell>.json``: the program's options for the cell
  (precision, serving options, accumulation) and the limits that decide
  ``correct``;
* ``benchmark/metrics/<metric>.py``: one reader per metric, a function
  ``read(run) -> float | None`` (None: nothing to read in this run), with
  any data of its own in ``<metric>.json`` beside it.

The cell's metrics are the ``end_to_end`` entries that list it under
``workloads`` or have no such list, with ``--trace 0``, and with
``--trace 1`` the ``per_layer`` entries that list it, or, without a list,
that move an end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[2]


class Metric(NamedTuple):
    name: str
    unit: str
    read: Callable


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(root: Path, name: str) -> Callable:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_data(reader_file: str) -> dict:
    """The JSON beside a reader's file (``<metric>.json``)."""
    return _json(Path(reader_file).with_suffix(".json"))


def driver(cell: Cell) -> ModuleType:
    """The driver of the cell's kind of traffic (module docstring)."""
    kind = cell.traffic["kind"]
    module = None
    if re.fullmatch(r"[a-z][a-z0-9_]*", str(kind)):
        try:
            module = importlib.import_module(f"benchmark.harness.{kind}")
        except ModuleNotFoundError:
            pass
    if not (hasattr(module, "drive") and hasattr(module, "control")):
        raise SystemExit(f"{cell.name}: no driver for traffic kind "
                         f"{kind!r} (benchmark/harness/<kind>.py)")
    return module


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    root = Path(root or ROOT)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    workload = _json(root / "benchmark" / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    load = lambda ms: [Metric(m["name"], m["unit"], reader(root, m["name"]))
                       for m in ms]
    return Cell(name, int(w["chips"]), config, traffic, workload, load(e2e),
                load(layer), root)


def read_metrics(metrics: List[Metric], run) -> Dict[str, dict]:
    """{name: {value, unit}} of the metrics whose reader found something."""
    out = {}
    for m in metrics:
        value = m.read(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
