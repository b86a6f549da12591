"""What decides ``correct``: sound runs pass, the control and every
planted fault fail. On the CPU at the tiny cells' size; the control again
on the card at the serving cell's own size (``cuda`` marker)."""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark.harness.inputs import Inputs  # noqa: E402
from benchmark.harness.readings import fault  # noqa: E402
from benchmark.harness.spec import driver, load_cell  # noqa: E402
from benchmark.tests.tiny import SERVE, TRAIN, make_root, run_cell  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def failed_checks(res):
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_sound_runs_are_correct(root, capsys, cell):
    res = run_cell(root, cell, seed=2 ** 31 + 11, capsys=capsys)
    assert res["correct"] is True and not failed_checks(res)
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell, name", [
    (SERVE, "serve.stale"), (SERVE, "serve.half"), (SERVE, "serve.altered"),
    (TRAIN, "unchanged"), (TRAIN, "half"), (TRAIN, "altered"),
    (TRAIN, "ct.zero"), (TRAIN, "ct.scaled")])
def test_a_planted_fault_is_not_correct(root, capsys, cell, name):
    with fault(name):
        res = run_cell(root, cell, capsys=capsys)
    assert res["correct"] is False and failed_checks(res)


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_the_control_is_not_correct(root, cell):
    """The reference one precision below the cell's (int4 for int8, float8
    e4m3 for the float model) in the program's place fails a limit."""
    c = load_cell(cell, root)
    numbers = driver(c).control(c, 5, Inputs(), torch.device("cpu"))
    limits = c.workload["limits"]
    assert any(numbers[k] > limits[k] for k in numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 3 ** 19, 5 ** 13])
def test_the_control_fails_at_the_cells_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cells = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
    inputs = Inputs()
    for w in cells:
        c = load_cell(w["name"])
        numbers = driver(c).control(c, seed, inputs,
                                         torch.device("cuda"))
        limits = c.workload["limits"]
        assert any(numbers[k] > limits[k] for k in numbers), (w, numbers)
