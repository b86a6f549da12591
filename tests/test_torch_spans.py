"""The port's spans (``ct_tpu_torch/utils/profiler.py``'s ``annotate``).

Off outside a ``torch.profiler`` session; inside one a label in the trace
and, for a listener on the logger ``ct_tpu_torch.spans``, one record a
span on the trace's clock; nested as the eval and train steps run them;
and without effect on what the steps compute. All on the size-64 test
model, on the CPU (no CUDA events: a record's ``device_ms()`` is None).
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.data.targets import pad_targets
from ct_tpu_torch.eval import make_eval_step
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.test import serving_model
from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
from ct_tpu_torch.train.step import TrainState, batch_to, make_train_step
from ct_tpu_torch.utils.profiler import SPANS, annotate

TRAIN_CHILDREN = ["train.forward", "train.loss", "train.backward"] * 2 + [
    "train.update"] * 2


class Listener(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def listener():
    handler, level = Listener(), SPANS.level
    SPANS.addHandler(handler)
    SPANS.setLevel(logging.DEBUG)
    yield handler
    SPANS.removeHandler(handler)
    SPANS.setLevel(level)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def session():
    return profile(activities=[ProfilerActivity.CPU])


def boom(*_, **__):
    raise AssertionError("the span did work while off")


def children(records, parent):
    """Names of the records one level inside ``parent``, in start order."""
    inside = [r for r in records if r.depth == parent.depth + 1
              and parent.t0_ns <= r.t0_ns and r.t1_ns <= parent.t1_ns]
    return [r.span for r in sorted(inside, key=lambda r: r.t0_ns)]


def only(records, name):
    found = [r for r in records if r.span == name]
    assert len(found) == 1, [r.span for r in records]
    return found[0]


# --- models ------------------------------------------------------------------

def incre_task():
    return resolve_task(2, "incre", "ours", "VOC")


def train_setup(seed=5):
    """A seeded size-64 model in train mode, its optimizer and a batch of
    four images (two micro-batches of two)."""
    task = incre_task()
    torch.manual_seed(seed)
    net = build_net(task, 64, device="cpu").train()
    opt, sched = build_optimizer(net, task, SolverConfig(
        lr=4e-3, warmup_iters=0, steps=(100,)))
    rng = np.random.RandomState(seed)
    annos = []
    for _ in range(4):
        n = rng.randint(1, 4)
        mins = rng.uniform(0, 0.6, (n, 2))
        boxes = np.concatenate([mins, mins + rng.uniform(0.2, 0.4, (n, 2))],
                               1).clip(0, 1)
        labels = rng.randint(1, 21, (n, 1)).astype(np.float32)
        annos.append(np.hstack([boxes, labels, np.ones((n, 1))]).astype(
            np.float32))
    padded = pad_targets(annos, 8)
    batch = batch_to({"image": rng.standard_normal((4, 64, 64, 3)).astype(
                          np.float32),
                      "boxes": padded.boxes, "labels": padded.labels,
                      "weights": padded.weights, "valid": padded.valid},
                     "cpu")
    return TrainState(net, opt, sched), batch


def train_run(spans: bool):
    """One accumulated step (accum 2) from the seeded state → (losses,
    parameters after)."""
    state, batch = train_setup()
    step = make_train_step(prior_boxes(TINY_64), accum_steps=2)
    if spans:
        with session():
            losses = step(state, batch)
    else:
        losses = step(state, batch)
    return losses, [p.detach().clone() for p in state.model.parameters()]


@pytest.fixture(scope="module")
def serving():
    """The size-64 int8 serving model (heads quantized too), its eval step
    with the serving options and a request of two images."""
    torch.manual_seed(3)
    net = build_net(incre_task(), 64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    calib = torch.randn(2, 3, 64, 64, generator=gen)
    model, quant = serving_model(net, calib, int8_heads=True)
    step = make_eval_step(model, prior_boxes(TINY_64), top_k=16,
                          approx_top_k=True, pool_size=64)
    images = torch.randn(2, 3, 64, 64, generator=gen) * 50
    sizes = torch.tensor([[64, 64], [48, 80]])
    return step, len(quant), images, sizes


# --- the span API ------------------------------------------------------------

def test_off_stamps_records_and_emits_nothing(listener, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    with monkeypatch.context() as m:
        m.setattr(time, "time_ns", boom)
        m.setattr(torch.autograd.profiler, "record_function", boom)
        m.setattr(torch.cuda, "Event", boom)
        with annotate("off.outer", device=True):
            with annotate("off.inner"):
                torch.ones(4).sum()
    assert listener.records == []
    assert annotate("a") is annotate("b", device=True)


def test_a_session_without_a_listener_only_labels(monkeypatch):
    assert not SPANS.isEnabledFor(logging.DEBUG)
    with session() as prof:
        with monkeypatch.context() as m:
            m.setattr(time, "time_ns", boom)
            with annotate("labelled.only", device=True):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "labelled.only" in names


def test_on_records_names_depth_and_ordered_stamps(listener):
    with session():
        with annotate("on.outer"):
            with annotate("on.inner", device=True):
                torch.ones(8).sum()
            with annotate("on.next"):
                pass
    inner, nxt, outer = listener.records
    assert [r.span for r in listener.records] == ["on.inner", "on.next",
                                                  "on.outer"]
    assert (outer.depth, inner.depth, nxt.depth) == (0, 1, 1)
    assert (outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= nxt.t0_ns
            <= nxt.t1_ns <= outer.t1_ns)
    assert all(r.device_ms() is None for r in listener.records)
    assert outer.levelno == logging.DEBUG and outer.name == SPANS.name
    assert outer.getMessage().startswith("on.outer depth 0 host ")
    # nothing reaches the root logger: the channel does not propagate
    assert SPANS.propagate is False


def test_stamps_sit_on_the_traces_clock(listener, tmp_path):
    with session():
        with annotate("clock.warm"):   # the first label's set-up
            pass
    listener.records.clear()
    with session() as prof:
        for i in range(3):
            with annotate(f"clock.{i}"):
                torch.ones(1000).sum()
                time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    base_ns = raw["baseTimeNanoseconds"]
    events = {e["name"]: e for e in raw["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert len(listener.records) == 3
    for r in listener.records:
        e = events[r.span]
        start_ns = base_ns + e["ts"] * 1e3
        end_ns = start_ns + e["dur"] * 1e3
        assert abs(r.t0_ns - start_ns) < 1e6, (r.span, r.t0_ns - start_ns)
        assert abs(r.t1_ns - end_ns) < 1e6, (r.span, r.t1_ns - end_ns)


# --- the spans in the steps --------------------------------------------------

def test_train_step_spans_nest(listener):
    state, batch = train_setup()
    step = make_train_step(prior_boxes(TINY_64), accum_steps=2)
    with session():
        step(state, batch)
    records = listener.records
    top = only(records, "train.step")
    assert top.depth == 0
    assert children(records, top) == TRAIN_CHILDREN
    forwards = [r for r in records if r.span == "train.forward"]
    assert len(forwards) == 2
    for f in forwards:
        assert children(records, f) == ["model.ct_head"]
    assert {r.span for r in records} == set(TRAIN_CHILDREN) | {
        "train.step", "model.ct_head"}


def test_eval_step_spans_nest(listener, serving):
    step, n_quantized, images, sizes = serving
    assert n_quantized > 0
    with session():
        step(images, sizes)
    records = listener.records
    top = only(records, "eval.step")
    assert top.depth == 0
    assert children(records, top) == ["eval.forward", "eval.postprocess"]
    forward = only(records, "eval.forward")
    assert children(records, forward) == (["model.int8_conv"] * n_quantized
                                          + ["model.ct_head"])
    assert children(records, only(records, "eval.postprocess")) == []
    assert len(records) == n_quantized + 4


class FakeEvent:
    """A CUDA timing event on the CPU: a span's ``device_ms()`` reads 1.0
    from a pair of them."""

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_device_time_only_where_a_metric_reads_it(listener, serving,
                                                  monkeypatch):
    """Events on the serving path (the eval step's forward and
    post-processing, each int8 conv, the CT head); none in the host-paced
    train step, whose spans time the host."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    step, n_quantized, images, sizes = serving
    with session():
        step(images, sizes)
    timed = [r.span for r in listener.records if r.device_ms() is not None]
    assert sorted(timed) == sorted(
        ["eval.forward", "eval.postprocess", "model.ct_head"]
        + ["model.int8_conv"] * n_quantized)
    assert only(listener.records, "eval.step").device_ms() is None
    listener.records.clear()
    state, batch = train_setup()
    train_step = make_train_step(prior_boxes(TINY_64), accum_steps=2)
    with session():
        train_step(state, batch)
    assert len(listener.records) == 11
    assert all(r.device_ms() is None for r in listener.records)


def test_spans_change_no_result(listener, serving):
    off_losses, off_params = train_run(spans=False)
    on_losses, on_params = train_run(spans=True)
    assert listener.records
    for key in off_losses:
        assert torch.equal(off_losses[key], on_losses[key]), key
    for a, b in zip(off_params, on_params):
        assert torch.equal(a, b)

    step, _, images, sizes = serving
    off = step(images, sizes)
    with session():
        on = step(images, sizes)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
