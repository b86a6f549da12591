"""The readers of the program's spans (``harness/program_spans.py``).

A traced run of a tiny cell reports the host span metrics and, on the
CPU, no device one; an untraced run reports none; and a reader of
records taken through ``logging`` alone gives a mean a request or step
over the traced stretch of its own run, and None where a run has nothing
to read.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import program_spans  # noqa: E402
from benchmark.harness.spec import reader  # noqa: E402
from benchmark.tests.tiny import SERVE, TRAIN, make_root, run_cell  # noqa: E402

SERVE_DEVICE = ("eval_forward_ms.serve", "eval_postprocess_ms.serve",
                "int8_conv_ms.serve", "ct_head_ms.serve")
TRAIN_HOST = ("step_host_ms.train", "forward_ms.train", "loss_ms.train",
              "backward_ms.train", "optimizer_ms.train")
SPAN_METRICS = ("eval_host_ms.serve",) + SERVE_DEVICE + TRAIN_HOST


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny checkout; ``make_root`` adds the tiny cells to every entry's
    ``workloads`` (the serve cell where a serving cell is listed)."""
    root = make_root(tmp_path_factory.mktemp("spans"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            cell = SERVE if m["name"].endswith(".serve") else TRAIN
            assert cell in m["workloads"], m["name"]
    return root


def test_the_entries_read_program_spans():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (m["source"], m["unit"], m["better"]) == (
            "program_span", "ms", "lower"), name
        serve = name.endswith(".serve")
        assert m["moves"] == ("serve_p95_ms" if serve
                              else "train_images_per_s"), name


@pytest.mark.parametrize("cell,host,device", [
    (SERVE, ("eval_host_ms.serve",), SERVE_DEVICE),
    (TRAIN, TRAIN_HOST, ())])
def test_a_traced_run_reads_the_host_spans(root, capsys, cell, host, device):
    res = run_cell(root, cell, trace=1, capsys=capsys)
    assert res["correct"] is True
    for name in host:
        assert res["metrics"][name]["value"] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    assert not set(device) & set(res["metrics"])     # no card, no events
    if cell == TRAIN:
        parts = sum(res["metrics"][n]["value"] for n in TRAIN_HOST[1:])
        assert parts <= res["metrics"]["step_host_ms.train"]["value"]


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_an_untraced_run_reads_no_span(root, capsys, cell):
    res = run_cell(root, cell, trace=0, capsys=capsys)
    assert not set(SPAN_METRICS) & set(res["metrics"])


def emit(span, t0_ns, t1_ns, device_ms=None, depth=0):
    log = logging.getLogger(program_spans.CHANNEL)
    log.handle(log.makeRecord(
        log.name, logging.DEBUG, __file__, 0, span, (), None,
        extra={"span": span, "depth": depth, "t0_ns": t0_ns, "t1_ns": t1_ns,
               "device_ms": lambda: device_ms}))


def session(units, ms, device_ms=None, t=0):
    """A profiler session's records: ``units`` train steps from ``t`` ms
    on, each ``ms`` long on the host with updates of 0.1 and 0.4 ms
    inside."""
    for i in range(units):
        t0 = (t + i * ms) * 1_000_000
        emit("train.update", t0 + 1, t0 + 100_001, device_ms=device_ms,
             depth=1)
        emit("train.update", t0 + 200_000, t0 + 600_000,
             device_ms=device_ms, depth=1)
        emit("train.step", t0, t0 + ms * 1_000_000)


def test_readers_take_a_mean_a_unit_or_nothing():
    host = reader(REPO, "step_host_ms.train")
    update = reader(REPO, "optimizer_ms.train")
    traced = SimpleNamespace(kind="train", trace=object())
    assert host(traced) is None and update(traced) is None    # no records
    # the session's first two steps (here 100 ms) are left out
    session(2, 100)
    session(3, 4, t=200)
    next_run = SimpleNamespace(kind="train", trace=object())
    assert host(next_run) == pytest.approx(4.0)
    assert update(next_run) == pytest.approx(0.5)
    reader(REPO, "loss_ms.train")           # loading forgets nothing
    assert host(next_run) == pytest.approx(4.0)
    assert host(SimpleNamespace(kind="train", trace=None)) is None
    # a run reads only what came after the run read before it
    session(4, 7, t=300)
    third = SimpleNamespace(kind="train", trace=object())
    assert host(third) == pytest.approx(7.0)
    assert host(next_run) is None and host(third) is None
    # a session of two steps has no stretch
    session(2, 9, t=400)
    assert host(SimpleNamespace(kind="train", trace=object())) is None


def test_device_readers_take_the_events_or_nothing():
    device = reader(REPO, "eval_postprocess_ms.serve")
    run = SimpleNamespace(kind="serve", trace=object())
    for i in range(5):
        t0 = i * 10_000_000
        emit("eval.postprocess", t0 + 1, t0 + 2, device_ms=0.5 * i, depth=1)
        emit("eval.step", t0, t0 + 9_000_000)
    assert device(run) == pytest.approx((1.0 + 1.5 + 2.0) / 3)
    assert device(SimpleNamespace(kind="train", trace=object())) is None
    for i in range(3):
        emit("eval.postprocess", i, i + 1, depth=1)       # no events
        emit("eval.step", i, i + 2)
    assert device(SimpleNamespace(kind="serve", trace=object())) is None
