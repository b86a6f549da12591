"""Build and bind the port's hand-written CUDA kernels.

Each source under ``csrc/`` holds one or more kernels behind plain C entry
points. On first use a source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library under ``build/ct_tpu_torch/`` at the repository root and
loaded with ``ctypes``; a library newer than its source is reused. Nothing
is built or loaded at import, so the module imports on a host without
``nvcc``.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ct_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64

# Each kernel entry point: (source under csrc/ without ".cu", C symbol,
# argtypes); all return int, the launch status.
SIGNATURES = {
    "ct_attention_cm": ("ct_attention_cm", "ct_attention_cm_f32",
                        (_P,) * 6 + (_I,) * 4 + (_P,)),
    "ct_attention_cm_stats": ("ct_attention_cm", "ct_attention_cm_stats_f32",
                              (_P,) * 9 + (_I,) * 4 + (_P,)),
    "ct_attention_cm_bwd_flash": ("ct_attention_cm_bwd",
                                  "ct_attention_cm_bwd_flash_f32",
                                  (_P,) * 11 + (_I,) * 4 + (_P,)),
    "pool2x2_relu_fwd": ("pool2x2_relu", "pool2x2_relu_fwd_f32",
                         (_P, _P, _L, _I, _I, _P)),
    "pool2x2_relu_bwd": ("pool2x2_relu", "pool2x2_relu_bwd_f32",
                         (_P, _P, _P, _P, _L, _I, _I, _P)),
}
SOURCES = tuple(sorted({src for src, _, _ in SIGNATURES.values()}))


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> dict:
    """Compile source ``csrc/<name>.cu`` unless an up-to-date library exists.

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
    """Build every source, one ``nvcc`` each, all started together.
    Returns {source: build(source)}."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built on first use."""
    return ctypes.CDLL(build(name)["library"])


def entry(name: str):
    """The ctypes function of kernel entry ``name``, with its C signature
    set."""
    source, symbol, argtypes = SIGNATURES[name]
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(wrapper, name: str, tensors, ints) -> None:
    """Launch kernel entry ``name`` on the current stream of the first
    tensor's card and count the launch on ``wrapper.launches``.

    ``tensors`` are the entry's contiguous CUDA tensor arguments in order,
    ``ints`` its integer arguments; a refused launch raises."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: an input is not "
                             "contiguous")
    fn = entry(name)
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed with "
                           f"CUDA error {rc}")
    wrapper.launches += 1
