"""What the port must not depend on.

The card's machine has PyTorch, but the port may not count on JAX, on the
JAX package, on an image decoder or on Triton there: ``ct_tpu_torch`` and
``chip_smoke.py`` import none of them at module level (JAX and ``ct_tpu``
nowhere), entry points default to the card and raise without one, and
``chip_smoke.py`` fails cleanly on a host without a card or outside the
repository.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "ct_tpu_torch")
NEVER = ("jax", "jaxlib", "flax", "optax", "ct_tpu")
NOT_AT_IMPORT = ("cv2", "PIL", "torchvision", "triton")


def port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PACKAGE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def port_modules():
    mods = []
    for path in port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def imported_roots(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module.split(".")[0]]
    return []


def test_the_checks_cover_every_module_of_the_port():
    mods = set(port_modules())
    assert {"chip_smoke", "ct_tpu_torch.models.fold_bn",
            "ct_tpu_torch.models.quantize", "ct_tpu_torch.ops.nms",
            "ct_tpu_torch.ops.ct_attention", "ct_tpu_torch.test"} <= mods
    n_files = sum(len([f for f in files if f.endswith(".py")])
                  for root, _, files in os.walk(PACKAGE)
                  if "__pycache__" not in root)
    assert len(mods) == n_files + 1


def test_port_imports_nothing_of_jax_or_the_jax_package():
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            for root in imported_roots(node):
                assert root not in NEVER, (path, node.lineno, root)
        for node in tree.body:      # module level
            for root in imported_roots(node):
                assert root not in NOT_AT_IMPORT, (path, node.lineno, root)


def test_port_imports_with_jax_decoders_and_triton_blocked():
    blocked = NEVER + NOT_AT_IMPORT
    code = textwrap.dedent(f"""
        import importlib, sys
        BLOCKED = {blocked!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for mod in {port_modules()!r}:
            importlib.import_module(mod)
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("imported", len({port_modules()!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as f:
            f.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_default_to_the_card(monkeypatch):
    import torch

    from ct_tpu_torch import resolve_device, test as cli
    from ct_tpu_torch.config import resolve_task
    from ct_tpu_torch.models.rfbnet import build_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = resolve_task(1, "transfer", "ours", "VOC")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_net(task, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert cli.parse_args([]).device == "cuda"
    assert resolve_device("cpu").type == "cpu"
    assert build_net(task, 64, device="cpu").loc[0].weight.is_cpu


def test_port_adds_no_large_file():
    paths = port_sources() + [
        os.path.join(PACKAGE, "csrc", f)
        for f in os.listdir(os.path.join(PACKAGE, "csrc"))]
    paths += [os.path.join(REPO, "tests", f)
              for f in os.listdir(os.path.join(REPO, "tests"))
              if f.startswith("test_torch_")]
    for path in paths:
        assert os.path.getsize(path) < 1 << 20, path
