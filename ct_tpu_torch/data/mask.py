"""The pycocotools mask API over the port's native RLE library.

The port of ``ct_tpu/data/mask.py``: ``encode``, ``decode``, ``merge``,
``area``, ``iou``, ``toBbox`` and ``frPyObjects``, with COCO-json dicts
(``counts`` as the compressed varint byte string). ``iou`` reads its
inputs as pycocotools' ``_preproc`` does: an ndarray is [N, 4] xywh
boxes, a list is boxes only when every element is a length-4 list or
ndarray and RLEs only when every element is a dict, and anything else
raises.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from ct_tpu_torch import native


def _compress(rle: dict) -> dict:
    return {"size": rle["size"], "counts": native.rle_to_string(rle)}


def _decompress(obj: dict) -> dict:
    counts = obj["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        h, w = obj["size"]
        return native.rle_from_string(counts, h, w)
    return {"size": obj["size"], "counts": np.asarray(counts, np.uint32)}


def encode(mask: np.ndarray) -> Union[dict, List[dict]]:
    """Binary mask [H, W] (or [H, W, N]) → compressed RLE dict(s)."""
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    return _compress(native.rle_encode(np.ascontiguousarray(mask)))


def decode(rle: Union[dict, Sequence[dict]]) -> np.ndarray:
    if isinstance(rle, (list, tuple)):
        return np.stack([decode(r) for r in rle], axis=2)
    return native.rle_decode(_decompress(rle))


def area(rle: Union[dict, Sequence[dict]]):
    if isinstance(rle, (list, tuple)):
        return np.asarray([area(r) for r in rle])
    return native.rle_area(_decompress(rle))


def merge(rles: Sequence[dict], intersect: bool = False) -> dict:
    out = _decompress(rles[0])
    for r in rles[1:]:
        out = native.rle_merge(out, _decompress(r), intersect=intersect)
    return _compress(out)


def toBbox(rle: Union[dict, Sequence[dict]]):
    if isinstance(rle, (list, tuple)):
        return np.stack([toBbox(r) for r in rle])
    return native.rle_to_bbox(_decompress(rle))


def _preproc(objs):
    """pycocotools' ``_preproc``: → an [N, 4] float64 array of xywh boxes,
    or a list of RLE dicts; other inputs raise."""
    if isinstance(objs, np.ndarray):
        if objs.size and (objs.ndim != 2 or objs.shape[1] != 4):
            raise ValueError("an ndarray input holds [N, 4] boxes, got "
                             f"shape {objs.shape}")
        return objs.astype(np.float64).reshape(-1, 4)
    if not isinstance(objs, list):
        raise ValueError("iou takes RLEs (a list of dicts), an ndarray of "
                         f"boxes or a list of boxes, got {type(objs)}")
    if all(isinstance(o, (list, np.ndarray)) and len(o) == 4 for o in objs):
        return np.asarray(objs, np.float64).reshape(-1, 4)
    if all(isinstance(o, dict) for o in objs):
        return objs
    raise ValueError("a list input holds boxes (each a length-4 list or "
                     "ndarray) or RLEs (each a dict), not a mix")


def iou(dt, gt, iscrowd):
    """IoU matrix [len(dt), len(gt)] between detections and ground truths,
    both xywh boxes or both RLEs; ``iscrowd`` is a per-gt flag sequence
    (crowd → intersection / det-area)."""
    iscrowd = np.asarray(iscrowd, bool)
    dt, gt = _preproc(dt), _preproc(gt)
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float32)
    if isinstance(dt, np.ndarray) != isinstance(gt, np.ndarray):
        raise ValueError("dt and gt must both be boxes or both be RLEs")
    if isinstance(dt, np.ndarray):
        d = dt.astype(np.float32)
        g = gt.astype(np.float32)
        d_xyxy = np.concatenate([d[:, :2], d[:, :2] + d[:, 2:]], axis=1)
        g_xyxy = np.concatenate([g[:, :2], g[:, :2] + g[:, 2:]], axis=1)
        return native.bb_iou(d_xyxy, g_xyxy, iscrowd.astype(np.uint8))
    dts = [_decompress(r) for r in dt]
    gts = [_decompress(r) for r in gt]
    out = np.zeros((len(dts), len(gts)))
    for i, dr in enumerate(dts):
        for j, gr in enumerate(gts):
            out[i, j] = native.rle_iou(dr, gr, bool(iscrowd[j]))
    return out


def frPyObjects(objs, h: int, w: int):
    """Polygons / xywh boxes / uncompressed RLEs → compressed RLE(s)."""
    if isinstance(objs, (list, tuple)) and objs and isinstance(
            objs[0], (list, tuple, np.ndarray)):
        return [frPyObjects(o, h, w) for o in objs]
    if isinstance(objs, dict):
        return _compress(_decompress(objs))
    arr = np.asarray(objs, np.float64).reshape(-1)
    if arr.size == 4:
        return _compress(native.rle_from_bbox(arr, h, w))
    return _compress(native.rle_from_poly(arr, h, w))
