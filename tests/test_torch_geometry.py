"""Port geometry vs the JAX package: priors and box ops, f32.

Same numpy inputs into ``ct_tpu`` and ``ct_tpu_torch``. Priors, form
conversions and IoU must be identical. ``encode``/``decode`` go through
log/exp, which XLA computes with its own approximations and fuses, so
they are held to 2 ulp of f32 (rtol 2.4e-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ct_tpu import config as jcfg
from ct_tpu.ops import boxes as jboxes
from ct_tpu.ops.priors import prior_boxes_np as j_prior_boxes_np
from ct_tpu_torch import config as tcfg
from ct_tpu_torch.ops import boxes as tboxes
from ct_tpu_torch.ops.priors import prior_boxes, prior_boxes_np


@pytest.mark.parametrize("name,count", [("TINY_64", 16 * 16 * 4 + 8 * 8 * 4),
                                        ("VOC_300", 11620),
                                        ("VOC_512", 32756)])
def test_priors_match_jax(name, count):
    ours = prior_boxes_np(getattr(tcfg, name))
    ref = j_prior_boxes_np(getattr(jcfg, name))
    assert ours.shape == (count, 4) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        prior_boxes(getattr(tcfg, name)).numpy(), ref)


def _boxes(rng, n):
    xy = rng.uniform(0, 0.8, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.02, 0.3, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 37), _boxes(rng, 23)
    priors = prior_boxes_np(tcfg.VOC_300)[:37]
    loc = rng.standard_normal((3, 37, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tp = torch.from_numpy(priors)

    exact = [
        (tboxes.point_form(tp), jboxes.point_form(jnp.asarray(priors))),
        (tboxes.center_size(ta), jboxes.center_size(jnp.asarray(a))),
        (tboxes.intersect(ta, tb),
         jboxes.intersect(jnp.asarray(a), jnp.asarray(b))),
        (tboxes.iou(ta, tb), jboxes.iou(jnp.asarray(a), jnp.asarray(b))),
    ]
    transcendental = [
        (tboxes.encode(ta, tp), jboxes.encode(jnp.asarray(a),
                                              jnp.asarray(priors))),
        (tboxes.decode(torch.from_numpy(loc), tp),
         jboxes.decode(jnp.asarray(loc), jnp.asarray(priors))),
    ]
    for ours, ref in exact:
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for ours, ref in transcendental:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=2.4e-7, atol=1e-7)


def test_decode_inverts_encode():
    rng = np.random.default_rng(1)
    priors = torch.from_numpy(prior_boxes_np(tcfg.VOC_300)[:50])
    gt = torch.from_numpy(_boxes(rng, 50))
    back = tboxes.decode(tboxes.encode(gt, priors), priors)
    np.testing.assert_allclose(back.numpy(), gt.numpy(), atol=1e-6)
