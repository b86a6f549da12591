"""The harness on the CPU: the yardstick's arithmetic, what a run may
load, and a cell, a configuration and a per-layer metric added as files
alone."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness import arith  # noqa: E402
from benchmark.harness.trace import reduce  # noqa: E402
from benchmark.reference.model import Task  # noqa: E402
from benchmark.tests.tiny import SERVE, TRAIN, make_root, run_cell  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("bound, args, ms", [
    # PERF.md's kernel table: row 2 bf16 at C=15, row 3 bf16 at C=60 (B=64),
    # row 6 bf16 at the eval batch B=8 (C=15, N=5)
    (arith.ct_stats_bound_s, (64, 15, 11620, 1858), 0.330),
    (arith.ct_flash_bwd_bound_s, (64, 60, 11620, 1858), 0.838),
    (arith.ct_serving_bound_s, (8, 15, 11620, 1858, 5), 0.0413),
])
def test_ct_bounds_are_the_kernel_tables(bound, args, ms):
    assert round(bound(*args) * 1e3, 4 if ms < 0.1 else 3) == ms


def test_keys_and_flops():
    assert (arith.num_keys(300), arith.num_keys(512)) == (1858, 4964)
    from benchmark.reference.model import param_shapes
    import torch
    task = Task("incre", 15, 21)
    state = {k: torch.empty(s) for k, s in param_shapes(task, 300).items()}
    f = arith.forward_flops(state, task, 300)
    # VGG16-reducedfc's convolutions alone at 300: conv1_1 …  fc7
    vgg = 0
    hw, cin = 300, 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512,
              "M", 512, 512, 512):
        if v in ("M", "C"):
            hw = -(-hw // 2) if v == "C" else hw // 2
            continue
        vgg += 2 * hw * hw * v * cin * 9
        cin = v
    vgg += 2 * 19 * 19 * 1024 * (512 * 9 + 1024)        # fc6, fc7
    assert f["priors"] == 11620 and f["keys"] == 1858
    assert vgg < f["conv"] < 1.3 * vgg
    assert f["ct"] > 4 * 11620 * 1858 * 15


def test_trace_reduction():
    """Busy time is the union of device intervals between the marker
    kernels; idle time goes to the host span over its middle."""
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,
                                     "ts": ts, "dur": dur}
    t = reduce([ev("spin_kernel", "kernel", 95, 5),
                ev("k1", "kernel", 90, 20), ev("k2", "kernel", 105, 10),
                ev("copy", "gpu_memcpy", 150, 60),
                ev("spin_kernel", "kernel", 200, 5)],
               [("bench.wait", 110, 140)], [])
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 65e-6) < 1e-12                  # 100-115, 150-200
    assert abs(t.idle_by_span["bench.wait"] - 35e-6) < 1e-12  # 115-150
    assert [k.name for k in t.kernels] == ["k2", "copy"]
    assert t.spans == {"bench.wait": 1}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"ct_tpu_torch", "ct_tpu", "jax", "jaxlib", "flax"}, \
            path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.model, benchmark.reference.post, "
            "benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"ct_tpu_torch", "ct_tpu", "jax", "jaxlib", "flax"}


def test_only_the_program_module_imports_the_program():
    for path in (REPO / "benchmark").rglob("*.py"):
        if "tests" in path.parts or path.name in ("program.py",
                                                  "readings.py"):
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "ct_tpu_torch" not in tops, path
        assert not tops & {"ct_tpu", "jax", "jaxlib", "flax"}, path


def test_without_a_card_run_refuses(tmp_path):
    res = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "rfb300-incre.serve-int8-b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_without_the_program_run_fails(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone."""
    import shutil
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "rfb300-incre.serve-int8-b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_jax_loaded_refuses_the_result(root, capsys, monkeypatch):
    import types
    from benchmark import run
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", SERVE, "--seed", "1", "--seconds", "0.3",
                   "--trace", "0"], require_cuda=False, root=root)
    assert rc != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_runs_load_nothing_of_jax(root, capsys):
    from benchmark import run
    for cell in (SERVE, TRAIN):
        res = run_cell(root, cell, capsys=capsys)
        assert res["correct"] is True
        assert not run.loaded_forbidden()


def test_new_files_alone_make_a_new_cell(tmp_path, capsys):
    """A configuration, a cell and a per-layer metric added as new files
    (and entries of BENCHMARK.json) are found and run."""
    root = make_root(tmp_path)
    b = root / "benchmark"
    config = json.loads((b / "configs" / "tiny.json").read_text())
    config.update(name="tiny-transfer", setting="transfer", class_split=0,
                  src_classes=60, weights="seeded")
    (b / "configs" / "tiny-transfer.json").write_text(json.dumps(config))
    (b / "workloads" / "tiny-transfer.train.json").write_text(
        (b / "workloads" / f"{TRAIN}.json").read_text())
    (b / "metrics" / "steps_traced.train.py").write_text(
        "def read(run):\n"
        "    return run.trace.spans.get('bench.step') if run.trace else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-transfer", "source": "test",
                             "file": "benchmark/configs/tiny-transfer.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-transfer.train",
                               "config": "tiny-transfer",
                               "traffic": "tiny-train", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step",
                               "moves": "train_images_per_s",
                               "workloads": ["tiny-transfer.train"]})
    bench["end_to_end"][0]["workloads"].append("tiny-transfer.train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "tiny-transfer.train", trace=1, capsys=capsys)
    assert res["metrics"]["steps_traced.train"]["value"] >= 1
    assert res["correct"] is True
    res = run_cell(root, "tiny-transfer.train", trace=0, capsys=capsys)
    assert set(res["metrics"]) == {"train_images_per_s", "setup_s"}


def test_an_unknown_traffic_kind_is_refused(tmp_path, capsys):
    root = make_root(tmp_path)
    path = root / "benchmark" / "traffic" / "tiny-train.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "kind": "replay"}))
    from benchmark import run
    with pytest.raises(SystemExit, match="no driver for traffic kind"):
        run.main(["--workload", TRAIN, "--seed", "1", "--seconds", "0.3",
                  "--trace", "0"], require_cuda=False, root=root)


def test_idle_in_service_leaves_out_the_planned_waits():
    from types import SimpleNamespace
    from benchmark.harness.spec import reader
    t = SimpleNamespace(busy_s=0.6, window_s=1.0,
                        idle_by_span={"bench.wait": 0.3, "bench.fetch": 0.1})
    for name in ("device_idle_pct.serve", "device_idle_pct.capacity"):
        value = reader(REPO, name)(SimpleNamespace(kind="serve", trace=t))
        assert abs(value - 100 * 0.1 / 0.7) < 1e-9


@pytest.mark.parametrize("trace", [0, 1])
def test_a_backlog_closes_at_the_window(tmp_path, capsys, trace):
    """Above the knee (``close_at_window``) requests not started when the
    window closes are not sent; the capacity metrics are read."""
    root = make_root(tmp_path)
    b = root / "benchmark"
    traffic = json.loads((b / "traffic" / "tiny-serve.json").read_text())
    traffic.update(rate_per_s=1000.0, close_at_window=True,
                   traced_requests=2)
    (b / "traffic" / "tiny-capacity.json").write_text(json.dumps(traffic))
    (b / "workloads" / "tiny.capacity.json").write_text(
        (b / "workloads" / f"{SERVE}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.capacity", "config": "tiny",
                               "traffic": "tiny-capacity", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_images_per_s", "mfu.capacity"):
            m["workloads"].append("tiny.capacity")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "tiny.capacity", seconds=1.0, trace=trace,
                   capsys=capsys)
    assert res["correct"] is True
    assert 0 < res["attempted"] < 1000
    if trace:
        assert res["metrics"]["mfu.capacity"]["value"] > 0
        assert "busy_s" in res["device"]
    else:
        assert set(res["metrics"]) == {"serve_images_per_s", "setup_s"}
        assert res["metrics"]["serve_images_per_s"]["value"] > 0
