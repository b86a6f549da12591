"""The port's serving NMS options vs the JAX package's, on the CPU.

* ``grouped_topk``: the same values and indices as JAX's on seeded and
  tie-heavy rows, whether the grouped passes run or the exact fallback
  (``passes · groups < k``) does; ties go to the lower index in both.
  The rows hold no -0.0, which ``lax.top_k`` ranks below +0.0 and torch's
  sort ties with it: NMS ranks scores above its threshold and -inf only.
* ``batched_nms`` with ``approx_top_k`` and with ``pool_size`` (and both),
  on boxes with exact duplicates and tie-heavy scores: identical
  detections (boxes, scores, classes, order and the ``>=`` cap with its
  +32 slack).
* ``postprocess`` and ``make_eval_step`` pass ``top_k``, ``approx_top_k``
  and ``pool_size`` through.
* ``nms_mask`` on CPU tensors is the plain fixpoint loop, which equals the
  JAX package's Pallas kernel (interpret mode) and its greedy oracle
  ``nms_numpy``, and records its sweeps.
* The NMS kernel's blocked scan (``csrc/nms.cu``), modelled in torch: the
  suppression mask as 32-bit words, each word's own 32×32 diagonal block
  resolved with bit operations, then the kept candidates' words ORed into
  the removed set; equal to the plain loop's mask on tie-heavy rows at K on
  both sides of a word's edge and at the kernel's largest K, with
  all-invalid rows and rows of one box repeated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.ops.nms import batched_nms as j_batched_nms
from ct_tpu.ops.nms import grouped_topk as j_grouped_topk
from ct_tpu.ops.nms import nms_numpy
from ct_tpu.ops.nms_pallas import nms_pallas
from ct_tpu_torch.config import TINY_64, VOC_300, resolve_task
from ct_tpu_torch.eval import make_eval_step
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops import detection
from ct_tpu_torch.ops.nms import (
    MAX_NMS_K, _pairwise_iou_offset, batched_nms, grouped_topk, nms_mask,
    nms_mask_reference,
)
from ct_tpu_torch.ops.priors import prior_boxes
from test_torch_eval import assert_dets_equal, tie_heavy_scores


@pytest.mark.parametrize("shape,k,ties", [((3, 1000), 50, False),
                                          ((2, 4, 1000), 50, True),
                                          ((2, 300), 200, True),
                                          ((2, 11620), 200, False)])
def test_grouped_topk_matches_jax(shape, k, ties):
    rng = np.random.default_rng(k + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2 + 0.0   # no -0.0 (see _sort_desc)
    x[..., ::7] = -np.inf            # below-threshold scores, as in NMS
    tv, ti = j_grouped_topk(jnp.asarray(x), k)
    ov, oi = grouped_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(tv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ti))


def nms_inputs(seed, b=2, p=700, c=6):
    rng = np.random.default_rng(seed)
    mins = rng.uniform(0, 400, (b, p, 2))
    sizes = rng.uniform(10, 150, (b, p, 2))
    boxes = np.concatenate([mins, mins + sizes], -1).astype(np.float32)
    boxes[:, 100:150] = boxes[:, 50:100]          # exact duplicate boxes
    return boxes, tie_heavy_scores(rng, b, p, c)


@pytest.mark.parametrize("approx,pool,top_k", [(True, 0, 200),
                                               (False, 256, 200),
                                               (True, 512, 128),
                                               (False, 100, 128)])
def test_serving_nms_matches_jax(approx, pool, top_k):
    boxes, scores = nms_inputs(top_k + pool)
    kw = dict(top_k=top_k, max_per_image=150, approx_top_k=approx,
              pool_size=pool)
    ref = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    ours = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       **kw)
    assert ours.valid.sum() > 0
    assert_dets_equal(ours, ref)


def test_postprocess_passes_the_serving_options(monkeypatch):
    seen = {}
    real = detection.batched_nms

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(detection, "batched_nms", spy)
    torch.manual_seed(0)
    net = build_net(resolve_task(1, "transfer", "ours", "VOC"), 64,
                    device="cpu")
    step = make_eval_step(net, prior_boxes(TINY_64), top_k=64,
                          approx_top_k=True, pool_size=300)
    dets = step(torch.randn(2, 3, 64, 64), torch.tensor([[64, 64]] * 2))
    assert seen["top_k"] == 64 and seen["approx_top_k"]
    assert seen["pool_size"] == 300 and dets.boxes.shape[0] == 2


@pytest.mark.parametrize("k,offset", [(200, 1.0), (128, 0.0), (37, 1.0)])
def test_nms_mask_on_the_cpu_is_the_greedy_solution(k, offset):
    rng = np.random.default_rng(k)
    n = 16
    centers = rng.uniform(0, 60, (n, k, 2))
    half = rng.uniform(2, 15, (n, k, 2))
    boxes = np.concatenate([centers - half, centers + half], -1)
    boxes = np.round(boxes).astype(np.float32)     # ties in the IoUs
    valid = rng.uniform(size=(n, k)) < 0.9
    keep = nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45,
                    offset)
    assert nms_mask_reference.sweeps > 1
    assert torch.equal(keep, nms_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(valid), 0.45, offset))
    pallas = np.asarray(nms_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                   0.45, offset, interpret=True)).astype(bool)
    np.testing.assert_array_equal(keep.numpy(), pallas)
    for r in range(n):      # the greedy oracle over each row's valid boxes
        idx = np.flatnonzero(valid[r])
        dets = np.concatenate([boxes[r, idx], -idx[:, None].astype(
            np.float32)], 1)          # descending score = ascending index
        kept = idx[nms_numpy(dets, 0.45, offset)]
        np.testing.assert_array_equal(np.flatnonzero(keep[r].numpy()),
                                      np.sort(kept))


def test_full_size_priors_serving_nms_matches_jax():
    """At the 300 prior count, where ``grouped_topk`` takes its grouped
    passes (91 groups · 6 passes ≥ 200) for both options."""
    rng = np.random.default_rng(3)
    p = prior_boxes(VOC_300).shape[0]
    mins = rng.uniform(0, 400, (1, p, 2))
    boxes = np.concatenate([mins, mins + rng.uniform(10, 150, (1, p, 2))],
                           -1).astype(np.float32)
    scores = tie_heavy_scores(rng, 1, p, 21)
    for kw in (dict(approx_top_k=True), dict(pool_size=512, top_k=128)):
        ref = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
        ours = batched_nms(torch.from_numpy(boxes),
                           torch.from_numpy(scores), **kw)
        assert_dets_equal(ours, ref)


def blocked_scan(boxes, valid, iou_threshold, pixel_offset):
    """The NMS kernel's mask and scan in torch, rows [N, K] at once → keep
    [N, K]. Word w of row j holds bits i = 32w .. 32w+31 of sup[j, i]; per
    word jb: alive = valid and not removed; candidate t of the word, when
    reached alive, is kept and clears the later ones it suppresses (the
    word's diagonal block); then each later word w ORs in word w of every
    kept candidate."""
    n, k = valid.shape
    w = -(-k // 32)
    idx = torch.arange(k)
    sup = ((_pairwise_iou_offset(boxes, pixel_offset) > iou_threshold)
           & (idx[:, None] < idx[None, :]))
    sup = torch.nn.functional.pad(sup, (0, 32 * w - k, 0, 32 * w - k))
    bit = torch.arange(32)
    words = (sup.view(n, 32 * w, w, 32).long() << bit).sum(-1)  # [N, 32W, W]
    vwords = (torch.nn.functional.pad(valid, (0, 32 * w - k))
              .view(n, w, 32).long() << bit).sum(-1)              # [N, W]
    removed = torch.zeros(n, w, dtype=torch.long)
    later = torch.arange(w)
    keep = []
    for jb in range(w):
        alive = vwords[:, jb] & ~removed[:, jb]
        for t in range(32):
            hit = ((alive >> t) & 1).bool()
            alive = torch.where(hit, alive & ~words[:, 32 * jb + t, jb],
                                alive)
        kept = ((alive[:, None] >> bit) & 1).bool()                # [N, 32]
        for t in range(32):
            row = torch.where(kept[:, t, None] & (later > jb),
                              words[:, 32 * jb + t], 0)
            removed = removed | row
        keep.append(kept)
    return torch.cat(keep, 1)[:, :k]


@pytest.mark.parametrize("k", [1, 31, 32, 33, 200, MAX_NMS_K])
def test_blocked_scan_is_the_plain_mask(k):
    rng = np.random.default_rng(k + 7)
    n = 6
    centers = rng.uniform(0, 40, (n, k, 2))
    half = rng.uniform(2, 12, (n, k, 2))
    boxes = np.round(np.concatenate([centers - half, centers + half], -1))
    valid = rng.uniform(size=(n, k)) < 0.9
    valid[0] = False                      # a row of no candidate
    boxes[1] = boxes[1, :1]               # one box repeated, all valid
    valid[1] = True
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = torch.from_numpy(valid)
    for offset in (1.0, 0.0):
        plain = nms_mask_reference(boxes, valid, 0.45, offset)
        assert torch.equal(blocked_scan(boxes, valid, 0.45, offset), plain)
    assert not plain[0].any()
    assert plain[1].sum() == 1 and plain[1, 0]
