"""A copy of the benchmark with tiny cells, for the CPU tests.

``make_root(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into
``tmp``, links the repository's VOC fixture, writes weights of the size-64
test model (drawn from a seed, the heads scaled so that scores are
confident), and adds two cells on them: ``tiny.serve`` (int8 serving path,
batches of 2) and ``tiny.train`` (float32, batch 4 in 2 micro-batches).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
SERVE, TRAIN = "tiny.serve", "tiny.train"


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, limits=None) -> Path:
    from benchmark.harness.weights import draw
    from benchmark.reference.model import Task

    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    (root / ".parity_p2").mkdir()
    os.symlink(REPO / ".parity_p2" / "voc", root / ".parity_p2" / "voc")
    state = draw(Task("incre", 15, 21), 64, 7, "cpu")
    for k in state:
        if k.split(".")[0] in ("conf", "obj") and k.endswith("weight"):
            state[k] = state[k] * 8.0
    torch.save(state, root / "tiny.pth")

    b = root / "benchmark"
    config = json.loads((b / "configs" / "rfbnet300-incre.json").read_text())
    for key in ("weights_sha256", "test_sha256", "trainval_sha256"):
        config.pop(key)
    config.update(name="tiny", size=64, ssd="TINY_64", weights="tiny.pth",
                  priors=1280, keys=512)
    _write(b / "configs" / "tiny.json", config)
    _write(b / "traffic" / "tiny-serve.json",
           {"kind": "serve", "batch": 2, "rate_per_s": 20.0,
            "gap_spread": 0.25, "distinct_batches": 2, "warmup_requests": 1,
            "traced_requests": 3})
    _write(b / "traffic" / "tiny-train.json",
           {"kind": "train", "batch": 4, "max_objs": 3, "warmup_steps": 1, "traced_steps": 2})
    limits = limits or {}
    _write(b / "workloads" / f"{SERVE}.json",
           {"program": {"int8": True, "int8_heads": True, "bf16": False,
                        "calib_images": 2, "approx_topk": True,
                        "top_k": 16, "pool_size": 64},
            "limits": limits.get(SERVE, {"score_gap": 0.05,
                                         "unmatched_pct": 5.0})})
    _write(b / "workloads" / f"{TRAIN}.json",
           {"program": {"bf16": False, "accum_steps": 2, "lr": 0.004},
            "limits": limits.get(TRAIN, {"loss_gap": 1e-3, "grad_gap": 1e-2,
                                         "change_gap": 1e-2,
                                         "ct_grad_gap": 1e-2,
                                         "ct_change_gap": 1e-2})})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"] += [
        {"name": SERVE, "config": "tiny", "traffic": "tiny-serve",
         "chips": 1, "why": "CPU tests"},
        {"name": TRAIN, "config": "tiny", "traffic": "tiny-train",
         "chips": 1, "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve = any("serve" in w for w in m["workloads"])
            m["workloads"].append(SERVE if serve else TRAIN)
    _write(root / "BENCHMARK.json", bench)
    return root


def run_cell(root: Path, cell: str, seed: int = 3, seconds: float = 0.5,
             trace: int = 0, capsys=None) -> dict:
    """``run.py``'s main in this process on the CPU → its result line."""
    import sys
    sys.path.insert(0, str(REPO))
    from benchmark import run

    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    rc = run.main(argv, require_cuda=False, root=root)
    assert rc == 0, rc
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
