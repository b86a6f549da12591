"""The port's native host library: CPU NMS, bbIoU and the COCO RLE API.

The port of ``ct_tpu/native/__init__.py`` over its own copies of
``nms.cpp`` and ``rle.cpp`` (beside this file). On first use the two
sources are compiled with ``g++`` (the JAX package's Makefile flags) into
``build/native/libct_tpu_torch_native.so`` at the repository root and
loaded with ``ctypes``; a library newer than both sources is reused.
Nothing is built or loaded at import. Where the JAX package falls back to
numpy without a compiler, the port raises with the compiler's message:
the host path has one implementation.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("nms.cpp", "rle.cpp")
BUILD_DIR = SRC_DIR.parent.parent / "build" / "native"
# a name and soname of its own: the JAX package's libctnative.so exports
# the same symbols and may be loaded in the same process
LIB_NAME = "libct_tpu_torch_native.so"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", f"-Wl,-soname,{LIB_NAME}")


def build() -> str:
    """Compile the sources unless a library newer than both exists; returns
    the library's path. A failed build raises with the compiler's output."""
    lib = BUILD_DIR / LIB_NAME
    srcs = [SRC_DIR / s for s in SOURCES]
    if lib.exists() and lib.stat().st_mtime >= max(
            s.stat().st_mtime for s in srcs):
        return str(lib)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *map(str, srcs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {LIB_NAME} failed:\n{res.stdout}"
                               f"\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(lib)


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library (built on first use), with every C signature
    set."""
    lib = ctypes.CDLL(build())

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    d = ctypes.c_double
    f = ctypes.c_float
    for name, restype, argtypes in (
            ("ct_cpu_nms", i, [f32p, i, f, i32p]),
            ("ct_cpu_soft_nms", i, [f32p, i, f, f, f, i, i32p]),
            ("ct_bb_iou", None, [f32p, i, f32p, i, u8p, f32p]),
            ("ct_rle_encode", i, [u8p, i, i, u32p, i]),
            ("ct_rle_decode", None, [u32p, i, i, i, u8p]),
            ("ct_rle_area", ctypes.c_uint64, [u32p, i]),
            ("ct_rle_merge", i, [u32p, i, u32p, i, i, i, i, u32p, i]),
            ("ct_rle_iou", d, [u32p, i, u32p, i, i, i, i]),
            ("ct_rle_to_bbox", None, [u32p, i, i, i, f64p]),
            ("ct_rle_from_bbox", i, [f64p, i, i, u32p, i]),
            ("ct_rle_from_poly", i, [f64p, i, i, i, u32p, i]),
            ("ct_rle_to_string", i, [u32p, i, ctypes.c_char_p, i]),
            ("ct_rle_from_string", i, [ctypes.c_char_p, i, u32p, i]),
            ("ct_bb_nms", None, [f64p, i, d, u8p])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _dets(dets: np.ndarray) -> np.ndarray:
    """C-contiguous float32 [N, 5] (x1, y1, x2, y2, score); float64 input
    is cast, as the JAX eval casts before its call."""
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"dets must be [N, 5], got {dets.shape}")
    return dets


# ---- NMS ------------------------------------------------------------------


def cpu_nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy NMS over [N, 5] (x1,y1,x2,y2,score) with the +1 pixel area →
    the kept indices in descending-score order."""
    dets = _dets(dets)
    keep = np.empty(len(dets), np.int32)
    n = load().ct_cpu_nms(dets, len(dets), thresh, keep)
    return keep[:n].tolist()


def cpu_soft_nms(dets: np.ndarray, iou_thresh: float = 0.3,
                 sigma: float = 0.5, score_thresh: float = 0.001,
                 method: int = 1) -> list:
    """Soft-NMS (0=hard, 1=linear, 2=gaussian). The scores of ``dets``
    decay in place when it is already C-contiguous float32 [N, 5]."""
    dets = _dets(dets)
    keep = np.empty(len(dets), np.int32)
    n = load().ct_cpu_soft_nms(dets, len(dets), iou_thresh, sigma,
                               score_thresh, method, keep)
    return keep[:n].tolist()


def bb_iou(boxes_a: np.ndarray, boxes_b: np.ndarray,
           b_is_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU of xyxy boxes ([N,4]×[M,4] → [N,M]) with exact areas;
    a crowd column divides by the first box's area."""
    a = np.ascontiguousarray(boxes_a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(boxes_b, np.float32).reshape(-1, 4)
    crowd = np.ascontiguousarray(
        b_is_crowd if b_is_crowd is not None else np.zeros(len(b)), np.uint8)
    if crowd.shape != (len(b),):
        raise ValueError("b_is_crowd must hold one flag per box of boxes_b")
    out = np.empty((len(a), len(b)), np.float32)
    load().ct_bb_iou(a, len(a), b, len(b), crowd, out)
    return out


# ---- RLE ------------------------------------------------------------------


def _counts(rle: dict) -> np.ndarray:
    return np.ascontiguousarray(rle["counts"], np.uint32)


def rle_encode(mask: np.ndarray) -> dict:
    """Binary [H, W] mask → COCO-style RLE dict {'size': [h, w], 'counts'}."""
    h, w = mask.shape
    col_major = np.ascontiguousarray(mask.T.reshape(-1), np.uint8)
    cap = h * w + 2
    cnts = np.empty(cap, np.uint32)
    m = load().ct_rle_encode(col_major, h, w, cnts, cap)
    return {"size": [h, w], "counts": cnts[:m].copy()}


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    cnts = _counts(rle)
    mask = np.empty(h * w, np.uint8)
    load().ct_rle_decode(cnts, len(cnts), h, w, mask)
    return mask.reshape(w, h).T


def rle_area(rle: dict) -> int:
    cnts = _counts(rle)
    return int(load().ct_rle_area(cnts, len(cnts)))


def rle_merge(a: dict, b: dict, intersect: bool = False) -> dict:
    h, w = a["size"]
    ca, cb = _counts(a), _counts(b)
    cap = len(ca) + len(cb) + 2
    out = np.empty(cap, np.uint32)
    m = load().ct_rle_merge(ca, len(ca), cb, len(cb), h, w, int(intersect),
                            out, cap)
    return {"size": [h, w], "counts": out[:m].copy()}


def rle_iou(a: dict, b: dict, iscrowd: bool = False) -> float:
    h, w = a["size"]
    ca, cb = _counts(a), _counts(b)
    return float(load().ct_rle_iou(ca, len(ca), cb, len(cb), h, w,
                                   int(iscrowd)))


def rle_to_bbox(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    cnts = _counts(rle)
    bb = np.empty(4, np.float64)
    load().ct_rle_to_bbox(cnts, len(cnts), h, w, bb)
    return bb


def rle_from_bbox(bbox_xywh, h: int, w: int) -> dict:
    bb = np.ascontiguousarray(bbox_xywh, np.float64)
    cap = h * w + 2
    out = np.empty(cap, np.uint32)
    m = load().ct_rle_from_bbox(bb, h, w, out, cap)
    return {"size": [h, w], "counts": out[:m].copy()}


def rle_from_poly(xy_pairs, h: int, w: int) -> dict:
    xy = np.ascontiguousarray(xy_pairs, np.float64).reshape(-1)
    cap = h * w + 2
    out = np.empty(cap, np.uint32)
    m = load().ct_rle_from_poly(xy, len(xy) // 2, h, w, out, cap)
    return {"size": [h, w], "counts": out[:m].copy()}


def rle_to_string(rle: dict) -> bytes:
    cnts = _counts(rle)
    cap = 8 * len(cnts) + 16
    buf = ctypes.create_string_buffer(cap)
    n = load().ct_rle_to_string(cnts, len(cnts), buf, cap)
    return buf.raw[:n]


def rle_from_string(s: bytes, h: int, w: int) -> dict:
    cap = len(s) + 2
    out = np.empty(cap, np.uint32)
    m = load().ct_rle_from_string(s, len(s), out, cap)
    return {"size": [h, w], "counts": out[:m].copy()}


def bb_nms(bbs_xywh: np.ndarray, thresh: float) -> np.ndarray:
    """maskApi's bbNms over xywh boxes (exact areas) → a keep flag per
    box."""
    bbs = np.ascontiguousarray(bbs_xywh, np.float64).reshape(-1, 4)
    keep = np.empty(len(bbs), np.uint8)
    load().ct_bb_nms(bbs, len(bbs), thresh, keep)
    return keep.astype(bool)
