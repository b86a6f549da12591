"""The port's device augmentation and mixup against ``augment_jax.py``.

* ``rgb_to_hsv`` / ``hsv_to_rgb`` against JAX on random, grey, pure-hue
  and near-0/360 pixels: H (degrees) and V within 1e-4, S within 1e-6,
  the round trip's RGB within 1e-4.
* The apply functions, fed the parameters JAX draws from a key (by
  ``augment_batch``'s own split order: photometric from k[0], then
  ``_sample_crop(k[1])``, ``_sample_expand(k[2])``, ``bernoulli(k[3])``),
  against ``augment_batch`` on the same canvases: images within 2e-3 on
  the 0–255 scale (a flipped mean-fill pixel would be off by ~100), boxes
  within 1e-6, ``valid`` and labels equal; the draws cover flipped,
  expanded, cropped and untouched images, and the canvas is larger than
  the output, so JAX's antialias (none along x for a flipped image) is
  exercised.
* The first-accepted crop against ``_sample_crop`` on JAX's candidates.
* ``apply_mixup`` with JAX's λ and offset against ``mixup_batch``, with and
  without ``zero_ignored``: weights and boxes within 1e-6, images within
  1e-6 of the 0–255 scale (XLA fuses the blend into one multiply-add, a
  rounding step of 1.5e-5 at 255 apart from the two products).
* The port's samplers against the port's host pipeline, as
  ``tests/test_augment_jax.py`` holds JAX's: the distributions of box
  survival, geometry and pixel means.
* ``scripts/bench_pipeline.py`` at a tiny size on the CPU.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.data import augment_jax as J
from ct_tpu_torch.config import RGB_MEANS
from ct_tpu_torch.data import augment_device as D

IMG_TOL = 2e-3
BOX_TOL = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def color_cases():
    rng = np.random.RandomState(0)
    px = [rng.uniform(0, 255, (200, 3)),
          np.repeat(rng.uniform(0, 255, (8, 1)), 3, 1),      # grey
          np.asarray([[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                      [0, 0, 255], [255, 255, 0], [0, 255, 255],
                      [255, 0, 255]], np.float64),            # pure hues
          # hue just below 360 and just above 0 (r max, b a hair over g
          # and the other way round)
          np.asarray([[200, 10, 10.001], [200, 10.001, 10],
                      [250, 3, 3.0005], [250, 3.0005, 3]])]
    return np.concatenate(px).astype(np.float32)


def test_rgb_to_hsv_matches_jax():
    rgb = color_cases()
    ours = D.rgb_to_hsv(t(rgb)).numpy()
    ref = np.asarray(J.rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_allclose(ours[:, 0], ref[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[:, 1], ref[:, 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours[:, 2], ref[:, 2], rtol=0, atol=1e-4)
    assert (ref[-4:, 0] > 359).sum() == 2 and (ref[-4:, 0] < 1).sum() == 2


def test_hsv_to_rgb_matches_jax():
    rng = np.random.RandomState(1)
    hsv = np.stack([rng.uniform(0, 360, 300), rng.uniform(0, 1, 300),
                    rng.uniform(0, 255, 300)], 1).astype(np.float32)
    # sector edges, hue 360 and beyond, grey
    hsv[:8, 0] = [0, 60, 120, 180, 240, 300, 360, 419.5]
    hsv[8:12, 1] = 0
    hsv = np.concatenate([hsv, np.asarray(J.rgb_to_hsv(
        jnp.asarray(color_cases())))])
    ours = D.hsv_to_rgb(t(hsv)).numpy()
    ref = np.asarray(J.hsv_to_rgb(jnp.asarray(hsv)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def make_batch(seed, b=8, s=96, m=6):
    """Canvases (uint8, NHWC) and padded targets as the loader ships
    them; one image has no valid box."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)
    mins = rng.uniform(0.02, 0.6, (b, m, 2))
    sizes = rng.uniform(0.05, 0.45, (b, m, 2))
    boxes = np.concatenate([mins, np.minimum(mins + sizes, 0.99)],
                           -1).astype(np.float32)
    labels = rng.randint(1, 21, (b, m)).astype(np.int32)
    labels[:, 1:] = np.where(rng.rand(b, m - 1) < 0.3, -1, labels[:, 1:])
    valid = np.zeros((b, m), bool)
    for i in range(b - 1):
        valid[i, : rng.randint(1, m + 1)] = True
    return images, boxes, labels, valid


def _jax_draws(r, boxes, valid, expand_prob):
    k = jax.random.split(r, 4)
    kk = jax.random.split(k[0], 8)
    photo = (jax.random.bernoulli(kk[0], 0.5, (4,)),
             jax.random.uniform(kk[1], (), minval=-32.0, maxval=32.0),
             jax.random.uniform(kk[2], (), minval=0.5, maxval=1.5),
             jax.random.uniform(kk[3], (), minval=-36.0, maxval=36.0),
             jax.random.uniform(kk[4], (), minval=0.5, maxval=1.5))
    roi = J._sample_crop(k[1], boxes, valid)
    expand = J._sample_expand(k[2], expand_prob)
    return photo, roi, expand, jax.random.bernoulli(k[3], 0.5, ())


def jax_params(key, boxes, valid, expand_prob=0.6):
    """The parameters ``augment_batch(key, ...)`` draws for each image, by
    its own split order, as the port's parameter records. They are drawn
    under ``jit`` and ``vmap`` as there: XLA fuses the crop's arithmetic
    into multiply-adds, which an eager draw would round otherwise."""
    draw = jax.jit(jax.vmap(_jax_draws, in_axes=(0, 0, 0, None)),
                   static_argnums=3)
    photo, roi, expand, flip = draw(jax.random.split(key, boxes.shape[0]),
                                    jnp.asarray(boxes), jnp.asarray(valid),
                                    expand_prob)
    photo = D.Photometric(*(t(np.asarray(v)) for v in photo))
    geom = D.Geometry(t(np.asarray(roi)), *(t(np.asarray(v)) for v in expand),
                      flip=t(np.asarray(flip)))
    return photo, geom


def port_batch(images, boxes, labels, valid):
    return (t(images).permute(0, 3, 1, 2), t(boxes), t(labels), t(valid))


def test_augment_matches_jax_on_jax_draws():
    out_size = 64
    seen = {"flip": 0, "expand": 0, "crop": 0, "neither": 0}
    for seed in range(4):
        images, boxes, labels, valid = make_batch(seed)
        key = jax.random.PRNGKey(100 + seed)
        ref = J.augment_batch(key, jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(labels), jnp.asarray(valid),
                              out_size=out_size)
        photo, geom = jax_params(key, boxes, valid)
        ours = D.apply_augment(*port_batch(images, boxes, labels, valid),
                               photo, geom, out_size=out_size)
        img = ours["image"].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(img, np.asarray(ref["image"]), rtol=0,
                                   atol=IMG_TOL)
        np.testing.assert_allclose(ours["boxes"].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=BOX_TOL)
        np.testing.assert_array_equal(ours["valid"].numpy(),
                                      np.asarray(ref["valid"]))
        np.testing.assert_array_equal(ours["labels"].numpy(),
                                      np.asarray(ref["labels"]))
        cropped = (geom.roi != torch.tensor([0.0, 0, 1, 1])).any(1)
        expanded = (geom.ws > 1) | (geom.hs > 1)
        seen["flip"] += int(geom.flip.sum())
        seen["expand"] += int(expanded.sum())
        seen["crop"] += int(cropped.sum())
        seen["neither"] += int((~cropped & ~expanded).sum())
    assert min(seen.values()) >= 2, seen


def test_flipped_images_are_not_antialiased_along_x():
    """JAX widens the triangle kernel by 1/scale only where scale > 0: a
    flip (negative x scale) samples two source pixels per output pixel
    even where the image shrinks, as the port must."""
    scale = torch.tensor([64 / 96, -64 / 96])
    w = D.resample_weights(96, 64, scale, torch.tensor([0.0, 64.0]))
    taps = (w > 0).sum(-1)
    assert taps[0].max() == 3 and taps[1].max() == 2
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_first_accepted_crop_matches_jax():
    for seed in range(3):
        _, boxes, _, valid = make_batch(seed, b=6)
        for i in range(boxes.shape[0]):
            key = jax.random.PRNGKey(7 * seed + i)
            k = jax.random.split(key, 5)
            n = J.NUM_CANDIDATES
            mode = int(jax.random.randint(k[0], (), 0, 7))
            scale = jax.random.uniform(k[1], (n,), minval=0.3, maxval=1.0)
            min_ratio = jnp.maximum(0.5, scale * scale)
            max_ratio = jnp.minimum(2.0, 1.0 / (scale * scale))
            u = jax.random.uniform(k[2], (n,))
            ratio = jnp.sqrt(min_ratio + u * (max_ratio - min_ratio))
            w, h = scale * ratio, scale / ratio
            x1 = jax.random.uniform(k[3], (n,)) * (1 - w)
            y1 = jax.random.uniform(k[4], (n,)) * (1 - h)
            rois = np.asarray(jnp.stack([x1, y1, x1 + w, y1 + h], -1))
            ref = np.asarray(J._sample_crop(key, jnp.asarray(boxes[i]),
                                            jnp.asarray(valid[i])))
            ours = D.first_accepted_crop(torch.tensor([mode]),
                                         t(rois)[None], t(boxes[i])[None],
                                         t(valid[i])[None])[0]
            np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("zero_ignored", [False, True])
@pytest.mark.parametrize("b", [1, 6])
def test_mixup_matches_jax(b, zero_ignored):
    rng = np.random.RandomState(b)
    s, m = 16, 4
    batch = {"image": rng.rand(b, s, s, 3).astype(np.float32) * 255,
             "boxes": rng.rand(b, m, 4).astype(np.float32),
             "labels": rng.randint(-1, 10, size=(b, m)).astype(np.int32),
             "weights": rng.rand(b, m).astype(np.float32),
             "valid": rng.rand(b, m) > 0.3}
    key = jax.random.PRNGKey(3 + b)
    ref = J.mixup_batch(key, {k: jnp.asarray(v) for k, v in batch.items()},
                        zero_ignored=zero_ignored)
    k_lam, k_off = jax.random.split(key)
    lam = np.clip(np.asarray(jax.random.beta(k_lam, 1.5, 1.5, (b,))), 0, 1)
    offset = int(jax.random.randint(k_off, (), 1, max(b, 2)))
    ours = D.apply_mixup(dict({k: t(v) for k, v in batch.items()},
                              image=t(batch["image"]).permute(0, 3, 1, 2)),
                         t(lam.astype(np.float32)), offset, zero_ignored)
    np.testing.assert_allclose(ours["image"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref["image"]), rtol=0, atol=1e-6
                               * 255)
    for key_ in ("boxes", "weights"):
        np.testing.assert_allclose(ours[key_].numpy(), np.asarray(ref[key_]),
                                   rtol=0, atol=1e-6, err_msg=key_)
    for key_ in ("labels", "valid"):
        np.testing.assert_array_equal(ours[key_].numpy(),
                                      np.asarray(ref[key_]), err_msg=key_)


def test_mixup_draws():
    rng = np.random.default_rng(0)
    lams, offsets = [], []
    for _ in range(200):
        lam, off = D.sample_mixup(rng, 8)
        lams.append(lam)
        offsets.append(off)
    lams = np.concatenate(lams)
    assert 0 <= lams.min() and lams.max() <= 1
    # Beta(1.5, 1.5): mean 1/2, variance 1/16
    assert abs(lams.mean() - 0.5) < 0.02 and abs(lams.var() - 0.0625) < 0.01
    assert set(offsets) == set(range(1, 8))
    assert D.sample_mixup(rng, 1)[1] == 1


def test_augment_batch_invariants_and_determinism():
    images, boxes, labels, valid = port_batch(*make_batch(5))
    gen = torch.Generator().manual_seed(0)
    a = D.augment_batch(gen, images, boxes, labels, valid, out_size=48)
    assert a["image"].shape == (8, 3, 48, 48)
    assert a["image"].dtype == torch.float32
    assert a["boxes"].shape == boxes.shape
    assert (a["boxes"] >= 0).all() and (a["boxes"] <= 1).all()
    assert not (a["valid"] & ~valid).any()
    assert torch.equal(a["labels"], labels)
    assert a["image"].min() >= -124 and a["image"].max() <= 152
    gen.manual_seed(0)
    b = D.augment_batch(gen, images, boxes, labels, valid, out_size=48)
    assert torch.equal(a["image"], b["image"])
    c = D.augment_batch(gen, images, boxes, labels, valid, out_size=48)
    assert (a["image"] - c["image"]).abs().max() > 1


def test_device_augment_distribution_matches_host():
    """The port's samplers against the port's host pipeline, over many
    draws of one scene: survival rate, box geometry and output pixel
    means (the pipelines differ in structure, so summary statistics)."""
    from ct_tpu_torch.data.augment import RawCanvasTransform, TrainAugment

    random.seed(12)
    rng = np.random.RandomState(0)
    s0 = 256
    img = np.full((s0, s0, 3), 128, np.uint8)
    gt_px = np.asarray([[40, 60, 140, 180, 3], [150, 30, 230, 120, 7]],
                       np.float64)
    for x1, y1, x2, y2, _ in gt_px:
        img[int(y1):int(y2), int(x1):int(x2)] = rng.randint(0, 255, 3)

    host = TrainAugment(128, RGB_MEANS, 0.6)
    h_boxes, h_n, h_px = [], [], []
    for _ in range(400):
        im, tg = host(img.copy(), gt_px.copy())
        tg = np.asarray(tg).reshape(-1, 5)
        h_n.append(len(tg))
        h_px.append(float(np.mean(im)))
        h_boxes += list(tg[:, :4])

    cimg, ctg = RawCanvasTransform(192)(img.copy(), gt_px.copy())
    b = 64
    images = t(np.repeat(cimg[None], b, 0)).permute(0, 3, 1, 2)
    boxes = t(np.repeat(ctg[None, :, :4], b, 0).astype(np.float32))
    labels = t(np.repeat(ctg[None, :, 4], b, 0).astype(np.int32))
    valid = torch.ones(b, ctg.shape[0], dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    d_boxes, d_n, d_px = [], [], []
    for _ in range(6):
        out = D.augment_batch(gen, images, boxes, labels, valid,
                              out_size=128)
        d_px += out["image"].mean((1, 2, 3)).tolist()
        for bi in range(b):
            rows = out["boxes"][bi][out["valid"][bi]].numpy()
            d_n.append(len(rows))
            d_boxes += list(rows)

    hb, db = np.asarray(h_boxes), np.asarray(d_boxes)

    def stats(bx):
        return {"w": bx[:, 2] - bx[:, 0], "h": bx[:, 3] - bx[:, 1],
                "cx": (bx[:, 0] + bx[:, 2]) / 2,
                "cy": (bx[:, 1] + bx[:, 3]) / 2}

    hs, ds = stats(hb), stats(db)
    assert abs(np.mean(h_n) - np.mean(d_n)) < 0.25
    for name in hs:
        assert abs(hs[name].mean() - ds[name].mean()) < 0.06, name
    assert abs(hs["w"].std() - ds["w"].std()) < 0.06
    assert abs(hs["cx"].std() - ds["cx"].std()) < 0.06
    assert abs(np.mean(h_px) - np.mean(d_px)) < 8.0


def test_bench_pipeline_tiny_run_on_the_cpu(capsys, monkeypatch):
    """``scripts/bench_pipeline.py`` end to end on the CPU at batch 2 on the
    repo's VOC fixture: its three rates and the augmentation's time, in
    one JSON line naming the device."""
    import json
    import os

    from ct_tpu_torch.scripts import bench_pipeline

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("VOC_ROOT", os.path.join(repo, bench_pipeline
                                                .DEFAULT_ROOT))
    res = bench_pipeline.main(["--device", "cpu", "--batch-size", "2",
                               "--iters", "1", "--workers", "2", "--mixup"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["device"] == "cpu"
    for key in ("host_augment", "raw_canvas", "end_to_end", "augment_ms"):
        assert np.isfinite(res[key]) and res[key] > 0, key
