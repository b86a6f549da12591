"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point. On
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/ct_tpu_torch/`` at the repository root and loaded with
``ctypes``; a library newer than its source is reused. Nothing is built
or loaded at import, so the module imports on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ct_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of each kernel's entry point: (name, argtypes); all return int.
SIGNATURES = {
    "ct_attention_cm": ("ct_attention_cm_f32",
                        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns {"library", "seconds", "built", "log"}; ``log`` holds what
    ``-Xptxas -v`` printed (registers, shared memory, spills).
    """
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return {"library": str(lib), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"library": str(lib), "seconds": time.perf_counter() - t0,
            "built": True, "log": (res.stdout + res.stderr).strip()}


def build_all() -> dict:
    """Build every kernel, one ``nvcc`` per source, all started together.
    Returns {name: build(name)}."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futures = {name: pool.submit(build, name) for name in SIGNATURES}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    return ctypes.CDLL(build(name)["library"])


def entry(name: str):
    """The ctypes function of kernel ``name``, with its C signature set."""
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
