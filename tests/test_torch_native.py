"""The port's native host library and mask API vs the JAX package's.

``ct_tpu_torch.native`` builds its own copies of ``nms.cpp`` and
``rle.cpp`` with the JAX package's compiler flags into ``build/native/``;
``ct_tpu.native`` loads ``ct_tpu/native/libctnative.so``. Both libraries
live in this one process, and on the same seeded numpy inputs their
outputs must be equal: indices, flags and RLE counts exactly, floats bit
for bit. The mask API (``data/mask.py``) over each library must agree on
masks, polygons, boxes and RLE strings, except on the input that
pycocotools refuses and ``ct_tpu/data/mask.py`` reads as boxes.
"""

import os

import numpy as np
import pytest

from ct_tpu import native as J
from ct_tpu.data import mask as j_mask
from ct_tpu_torch import native as T
from ct_tpu_torch.data import mask as t_mask


def random_dets(rng, n, dtype=np.float32, ties=False):
    mins = rng.uniform(0, 200, size=(n, 2))
    sizes = rng.uniform(10, 100, size=(n, 2))
    scores = rng.uniform(0, 1, size=(n, 1))
    if ties:   # many equal scores and repeated boxes
        scores = np.round(scores * 4) / 4
        mins[n // 2:] = mins[:n - n // 2]
        sizes[n // 2:] = sizes[:n - n // 2]
    return np.concatenate([mins, mins + sizes, scores], axis=1).astype(dtype)


def random_mask(rng, h, w, p):
    return (rng.rand(h, w) > p).astype(np.uint8)


def assert_rle_equal(a, b):
    assert list(a["size"]) == list(b["size"])
    assert a["counts"].dtype == b["counts"].dtype == np.uint32
    np.testing.assert_array_equal(a["counts"], b["counts"])


def test_library_is_the_ports_own():
    path = T.build()
    assert os.path.dirname(path) == str(T.BUILD_DIR)
    assert os.path.basename(path) == "libct_tpu_torch_native.so"
    assert J.available()
    assert os.path.realpath(J._LIB_PATH) != os.path.realpath(path)
    T.load()
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert "libct_tpu_torch_native.so" in maps and "libctnative.so" in maps


def test_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building .* failed"):
        T.build()
    assert not list((tmp_path / "native").iterdir())   # no half-built file


@pytest.mark.parametrize("seed,n,thresh,ties", [
    (0, 128, 0.45, False), (1, 300, 0.5, False), (2, 200, 0.3, True),
    (3, 1, 0.45, False), (4, 0, 0.45, False)])
def test_cpu_nms_matches_jax(seed, n, thresh, ties):
    rng = np.random.RandomState(seed)
    dets = random_dets(rng, n, ties=ties)
    keep = T.cpu_nms(dets, thresh)
    assert keep == J.cpu_nms(dets, thresh)
    assert all(isinstance(i, int) for i in keep)
    # float64 input is cast before the call, as the JAX eval casts it
    assert T.cpu_nms(dets.astype(np.float64), thresh) == keep


@pytest.mark.parametrize("method", [0, 1, 2])
def test_cpu_soft_nms_matches_jax(method):
    rng = np.random.RandomState(10 + method)
    dets = random_dets(rng, 150)
    ours, ref = dets.copy(), dets.copy()
    keep = T.cpu_soft_nms(ours, iou_thresh=0.3, sigma=0.5,
                          score_thresh=0.05, method=method)
    assert keep == J.cpu_soft_nms(ref, iou_thresh=0.3, sigma=0.5,
                                  score_thresh=0.05, method=method)
    # the scores decayed in place, bit for bit
    np.testing.assert_array_equal(ours, ref)
    assert method == 0 or not np.array_equal(ours, dets)


def test_bb_iou_and_bb_nms_match_jax():
    rng = np.random.RandomState(20)
    a = random_dets(rng, 17)[:, :4]
    b = random_dets(rng, 23)[:, :4]
    crowd = rng.rand(23) > 0.7
    for flags in (None, crowd):
        ours, ref = T.bb_iou(a, b, flags), J.bb_iou(a, b, flags)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    xywh = np.concatenate([a[:, :2], a[:, 2:] - a[:, :2]], axis=1)
    for thresh in (0.1, 0.5):
        np.testing.assert_array_equal(T.bb_nms(xywh, thresh),
                                      J.bb_nms(xywh, thresh))


@pytest.mark.parametrize("h,w,p", [(37, 53, 0.7), (25, 31, 0.2),
                                   (16, 16, 1.0), (9, 40, 0.0)])
def test_rle_codec_matches_jax(h, w, p):
    rng = np.random.RandomState(h * w)
    mask = random_mask(rng, h, w, p)
    ours, ref = T.rle_encode(mask), J.rle_encode(mask)
    assert_rle_equal(ours, ref)
    np.testing.assert_array_equal(T.rle_decode(ours), mask)
    assert T.rle_area(ours) == J.rle_area(ref) == int(mask.sum())
    s = T.rle_to_string(ours)
    assert s == J.rle_to_string(ref)
    assert_rle_equal(T.rle_from_string(s, h, w), J.rle_from_string(s, h, w))
    np.testing.assert_array_equal(T.rle_to_bbox(ours), J.rle_to_bbox(ref))


def test_rle_merge_iou_and_conversions_match_jax():
    rng = np.random.RandomState(30)
    h, w = 41, 29
    ma, mb = random_mask(rng, h, w, 0.5), random_mask(rng, h, w, 0.8)
    ta, tb = T.rle_encode(ma), T.rle_encode(mb)
    ja, jb = J.rle_encode(ma), J.rle_encode(mb)
    for intersect in (False, True):
        assert_rle_equal(T.rle_merge(ta, tb, intersect),
                         J.rle_merge(ja, jb, intersect))
    for crowd in (False, True):
        assert T.rle_iou(ta, tb, crowd) == J.rle_iou(ja, jb, crowd)
    for bb in ([3.2, 4.7, 10.5, 20.1], [-2, -3, 50, 60], [0, 0, 0, 0]):
        assert_rle_equal(T.rle_from_bbox(bb, h, w),
                         J.rle_from_bbox(bb, h, w))
    for poly in ([5, 5, 15, 5, 15, 15, 5, 15],
                 [2.5, 1.0, 27.3, 8.8, 20.0, 39.5, 1.2, 30.0, 9.9, 20.0]):
        assert_rle_equal(T.rle_from_poly(poly, h, w),
                         J.rle_from_poly(poly, h, w))


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mask_api_matches_jax_on_masks_and_strings():
    rng = np.random.RandomState(40)
    m = random_mask(rng, 33, 47, 0.65)
    stack = np.stack([m, random_mask(rng, 33, 47, 0.3)], axis=2)
    for x in (m, stack):
        ours, ref = t_mask.encode(x), j_mask.encode(x)
        _equal(ours, ref)
        _equal(t_mask.decode(ours), j_mask.decode(ref))
        _equal(t_mask.area(ours), j_mask.area(ref))
        _equal(t_mask.toBbox(ours), j_mask.toBbox(ref))
    rles = t_mask.encode(stack)
    for intersect in (False, True):
        _equal(t_mask.merge(rles, intersect), j_mask.merge(rles, intersect))
    # COCO json strings (str) and uncompressed counts (lists)
    as_str = [dict(r, counts=r["counts"].decode()) for r in rles]
    _equal(t_mask.decode(as_str), j_mask.decode(as_str))
    raw = {"size": [33, 47],
           "counts": T.rle_encode(m)["counts"].tolist()}
    _equal(t_mask.frPyObjects(raw, 33, 47), j_mask.frPyObjects(raw, 33, 47))
    for crowd in ([0, 0], [0, 1]):
        _equal(t_mask.iou(rles, rles[::-1], crowd),
               j_mask.iou(rles, rles[::-1], crowd))


def test_mask_api_matches_jax_on_boxes_and_polygons():
    rng = np.random.RandomState(41)
    dt = rng.uniform(0, 30, (5, 4))
    gt = rng.uniform(0, 30, (7, 4))
    crowd = (rng.rand(7) > 0.6).astype(int)
    for d, g in ((dt, gt), (dt.tolist(), gt.tolist()),
                 (list(dt), list(gt))):
        _equal(t_mask.iou(d, g, crowd), j_mask.iou(d, g, crowd))
    _equal(t_mask.iou(dt, [], []), j_mask.iou(dt, [], []))
    for obj in ([2.0, 2.0, 10.0, 8.0], [[2, 2, 12, 2, 12, 12, 2, 12]],
                [[1, 1, 9, 3, 6, 14], [20, 20, 30, 22, 25, 35, 18, 30]],
                [[3, 4, 10, 12]]):
        _equal(t_mask.frPyObjects(obj, 40, 40),
               j_mask.frPyObjects(obj, 40, 40))


def test_mask_iou_reads_lists_as_pycocotools_does():
    """pycocotools calls a list boxes only when every element is a
    length-4 list or ndarray, and refuses a mixed list; the JAX package
    looks at the first element only (its mask.py:72) and reads the list
    as boxes."""
    mixed = [[0.0, 0.0, 10.0, 10.0], (5.0, 5.0, 10.0, 10.0)]
    gt = [[0.0, 0.0, 10.0, 10.0]]
    assert j_mask.iou(mixed, gt, [0]).shape == (2, 1)
    with pytest.raises(ValueError, match="not a mix"):
        t_mask.iou(mixed, gt, [0])
    rle = t_mask.encode(np.ones((12, 12), np.uint8))
    with pytest.raises(ValueError, match="not a mix"):
        t_mask.iou([[0, 0, 4, 4], rle], [rle], [0])
    with pytest.raises(ValueError, match="both be boxes or both be RLEs"):
        t_mask.iou([[0, 0, 4, 4]], [rle], [0])
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        t_mask.iou(np.zeros((2, 5)), np.zeros((1, 4)), [0])
