"""SSD training augmentation, batched on the device.

The port of ``ct_tpu/data/augment_jax.py``. The host only decodes each
image and resizes it to a square canvas (``RawCanvasTransform``); the rest
runs on the device for the whole batch at once:

* photometric distortion: brightness and contrast on the stored BGR
  values, hue and saturation through an exact RGB↔HSV round trip;
* the host pipeline's crop, expand and flip folded into one affine
  resample per image, with JAX's ``scale_and_translate(method="linear")``
  weights (antialiased where it shrinks), mean-filled outside the source;
* the host's rejection loops as 16 candidate crops drawn at once, of which
  the first that passes is taken;
* boxes transformed and filtered in their fixed padded shape.

Each random op is split into a sampler, which draws its parameters from an
explicit ``torch.Generator`` on the batch's device, and an apply function,
which runs the op from those parameters alone. The mixup weights
λ ~ Beta(1.5, 1.5) are drawn on the host from a ``numpy.random.Generator``
(B values; ``torch.distributions.Beta`` takes no generator) and copied to
the device without waiting for it.

Data parallel: a rank holds only its block of the global batch, and the
draws are seeded per batch, so a rank that drew for its own images alone
would give its i-th image the crop of every other rank's i-th. The
samplers therefore draw the global batch's parameters (``world`` times
the block: a few numbers an image) and keep this ``rank``'s rows, so the
ranks' blocks are augmented as one process augments the global batch.

Layouts: images come in NCHW [B, 3, S, S] in any dtype (the loader ships
uint8 canvases) and leave NCHW float32 [B, 3, out, out], mean-subtracted;
boxes [B, M, 4] in percent point form, labels [B, M], valid [B, M].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ct_tpu_torch.config import RGB_MEANS
from ct_tpu_torch.data.loader import to_device

# mode 0 = no crop; mode 6 = crop with no IoU constraint
CROP_MIN_IOUS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9, -1.0)
NUM_CANDIDATES = 16
# jax.image.compute_weight_mat: a column whose weights sum to no more than
# this is zeroed
_WEIGHT_SUM_FLOOR = 1000.0 * float(np.finfo(np.float32).eps)


# --------------------------------------------------------------------------
# colour space (exact, elementwise)
# --------------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """RGB in [0, 255] along ``dim`` → h ∈ [0, 360), s ∈ [0, 1],
    v ∈ [0, 255]."""
    r, g, b = rgb.unbind(dim)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(maxc == r, (g - b) / safe,
                    torch.where(maxc == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    # floor-mod, as jnp's %: the result takes the divisor's sign
    h = torch.remainder(torch.where(delta == 0, 0.0, h * 60.0), 360.0)
    s = torch.where(maxc == 0, 0.0,
                    delta / torch.where(maxc == 0, 1.0, maxc))
    return torch.stack([h, s, maxc], dim)


def hsv_to_rgb(hsv: torch.Tensor, dim: int = -1) -> torch.Tensor:
    h, s, v = hsv.unbind(dim)
    h6 = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*cases):    # the case of sector i (jnp.select)
        out = cases[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, cases[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim)


# --------------------------------------------------------------------------
# parameters and their samplers
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Photometric:
    """One image's photometric draws, batched: ``do`` [B, 4] bool
    (brightness, contrast, hue, saturation), then [B] each."""

    do: torch.Tensor
    beta: torch.Tensor     # brightness shift, [-32, 32)
    alpha: torch.Tensor    # contrast factor, [0.5, 1.5)
    dh: torch.Tensor       # hue shift in degrees, [-36, 36)
    ds: torch.Tensor       # saturation factor, [0.5, 1.5)


@dataclasses.dataclass
class Geometry:
    """The crop ROI [B, 4] (percent coordinates, identity [0, 0, 1, 1]
    where no crop), the expand factors and placement [B] and the flip [B]
    bool."""

    roi: torch.Tensor
    ws: torch.Tensor
    hs: torch.Tensor
    left: torch.Tensor
    top: torch.Tensor
    flip: torch.Tensor


def _constant(values: Sequence[float], device) -> torch.Tensor:
    """A float32 constant on ``device``, copied without waiting for the
    work queued there (``torch.tensor(..., device=...)`` would wait)."""
    return to_device(np.asarray(values, np.float32), device)


def _rand(gen: torch.Generator, shape, lo: float = 0.0,
          hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + u * (hi - lo)


def sample_photometric(gen: torch.Generator, b: int) -> Photometric:
    return Photometric(do=_rand(gen, (b, 4)) < 0.5,
                       beta=_rand(gen, (b,), -32.0, 32.0),
                       alpha=_rand(gen, (b,), 0.5, 1.5),
                       dh=_rand(gen, (b,), -36.0, 36.0),
                       ds=_rand(gen, (b,), 0.5, 1.5))


def first_accepted_crop(mode: torch.Tensor, rois: torch.Tensor,
                        boxes: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """The crop of each image: the first of its candidate ``rois``
    [B, N, 4] whose IoU with every valid box is at least the ``mode``'s
    minimum and that keeps at least one valid box's centre; the identity
    ROI for mode 0 or where no candidate passes."""
    min_iou = _constant(CROP_MIN_IOUS, rois.device)[mode]
    bx = boxes[:, None]                                   # [B, 1, M, 4]
    rx = rois[:, :, None]                                 # [B, N, 1, 4]
    ix1 = torch.maximum(bx[..., 0], rx[..., 0])
    iy1 = torch.maximum(bx[..., 1], rx[..., 1])
    ix2 = torch.minimum(bx[..., 2], rx[..., 2])
    iy2 = torch.minimum(bx[..., 3], rx[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_b = (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    area_r = (rx[..., 2] - rx[..., 0]) * (rx[..., 3] - rx[..., 1])
    iou = inter / (area_b + area_r - inter).clamp(min=1e-12)  # [B, N, M]
    box_valid = valid[:, None]
    iou_ok = torch.where(box_valid, iou >= min_iou[:, None, None],
                         True).all(-1)
    centers = (boxes[..., :2] + boxes[..., 2:]) / 2       # [B, M, 2]
    inside = ((rx[..., :2] < centers[:, None])
              & (centers[:, None] < rx[..., 2:])).all(-1)
    ok = iou_ok & (inside & box_valid).any(-1)             # [B, N]
    # the first candidate that passes (N where none does)
    n = rois.shape[1]
    first = torch.where(ok, torch.arange(n, device=ok.device), n).amin(1)
    pick = rois.gather(1, first.clamp(max=n - 1)[:, None, None].expand(
        -1, 1, 4))[:, 0]
    use = (mode != 0) & (first < n)
    identity = _constant((0.0, 0.0, 1.0, 1.0), rois.device)
    return torch.where(use[:, None], pick, identity)


def sample_crop(gen: torch.Generator, boxes: torch.Tensor,
                valid: torch.Tensor, rows: slice = slice(None),
                world: int = 1) -> torch.Tensor:
    """Draw a mode and 16 candidate crops for each of ``world`` blocks of
    images (the host's scale and aspect ranges), keep the ``rows`` of the
    images of ``boxes`` and the first of their candidates that passes: ROI
    [B, 4]."""
    b, n = boxes.shape[0] * world, NUM_CANDIDATES
    mode = torch.randint(0, len(CROP_MIN_IOUS), (b,), generator=gen,
                         device=gen.device)
    scale = _rand(gen, (b, n), 0.3, 1.0)
    min_ratio = (scale * scale).clamp(min=0.5)
    max_ratio = (1.0 / (scale * scale)).clamp(max=2.0)
    ratio = torch.sqrt(min_ratio + _rand(gen, (b, n))
                       * (max_ratio - min_ratio))
    w, h = scale * ratio, scale / ratio
    x1 = _rand(gen, (b, n)) * (1 - w)
    y1 = _rand(gen, (b, n)) * (1 - h)
    rois = torch.stack([x1, y1, x1 + w, y1 + h], -1)
    return first_accepted_crop(mode[rows], rois[rows], boxes, valid)


def sample_expand(gen: torch.Generator, b: int, prob: float):
    """Expand factors (ws, hs) ≥ 1 and the source's offset (left, top) in
    the virtual canvas, each [B]; (1, 1, 0, 0) where no expand is drawn."""
    do = _rand(gen, (b,)) <= prob
    scale = _rand(gen, (b,), 1.0, 4.0)
    min_ratio = (1.0 / (scale * scale)).clamp(min=0.5)
    max_ratio = (scale * scale).clamp(max=2.0)
    ratio = torch.sqrt(min_ratio + _rand(gen, (b,))
                       * (max_ratio - min_ratio))
    ws = (scale * ratio).clamp(min=1.0)
    hs = (scale / ratio).clamp(min=1.0)
    off = _rand(gen, (b, 2))
    left = off[:, 0] * (ws - 1.0)
    top = off[:, 1] * (hs - 1.0)
    return (torch.where(do, ws, 1.0), torch.where(do, hs, 1.0),
            torch.where(do, left, 0.0), torch.where(do, top, 0.0))


def sample_augment(gen: torch.Generator, boxes: torch.Tensor,
                   valid: torch.Tensor, expand_prob: float = 0.6,
                   rank: int = 0, world: int = 1):
    """All of a batch's draws, in the JAX function's order: photometric,
    crop, expand, flip; drawn for ``world`` blocks of ``boxes``' size, the
    ``rank``-th kept."""
    b = boxes.shape[0]
    rows = slice(rank * b, (rank + 1) * b)
    drawn = sample_photometric(gen, b * world)
    photo = Photometric(*(getattr(drawn, f.name)[rows]
                          for f in dataclasses.fields(drawn)))
    roi = sample_crop(gen, boxes, valid, rows, world)
    ws, hs, left, top = (x[rows] for x in sample_expand(gen, b * world,
                                                         expand_prob))
    flip = (_rand(gen, (b * world,)) < 0.5)[rows]
    return photo, Geometry(roi, ws, hs, left, top, flip)


# --------------------------------------------------------------------------
# apply functions (deterministic)
# --------------------------------------------------------------------------


def photometric_apply(images: torch.Tensor, p: Photometric) -> torch.Tensor:
    """Float BGR images [B, 3, S, S] in [0, 255] → distorted, the same."""

    def per_image(x):
        return x.view(-1, 1, 1, 1)

    do = p.do.view(-1, 4, 1, 1, 1).unbind(1)
    img = torch.where(do[0], (images + per_image(p.beta)).clamp(0, 255),
                      images)
    img = torch.where(do[1], (img * per_image(p.alpha)).clamp(0, 255), img)
    h, s, v = rgb_to_hsv(img.flip(1), dim=1).unbind(1)   # BGR → RGB
    do2, do3 = do[2][:, 0], do[3][:, 0]
    h = torch.where(do2, torch.remainder(h + p.dh.view(-1, 1, 1), 360.0), h)
    s = torch.where(do3, (s * p.ds.view(-1, 1, 1)).clamp(0, 1), s)
    return hsv_to_rgb(torch.stack([h, s, v], 1), dim=1).flip(1)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """[B, out, in] weights of ``jax.image.scale_and_translate`` along one
    axis, method "linear" with antialias: a triangle kernel widened by
    1/scale where the image shrinks (never where ``scale`` is negative, a
    flip), each output's weights normalised, and zero where the sample
    falls outside [-0.5, in - 0.5]."""
    dev = scale.device
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = inv_scale.clamp(min=1.0)[:, :, None]
    # (u + 0.5)·inv − t·inv, rounded once as XLA's fused multiply-add does
    # it: one rounding step of the sample moves a noisy image's output
    # by up to ~255·2⁻²³·S
    u = torch.arange(out_size, dtype=torch.float64, device=dev) + 0.5
    sample_f = (u * inv_scale.double()
                - (translation[:, None] * inv_scale).double()).float() - 0.5
    x = (sample_f[:, :, None]
         - torch.arange(in_size, dtype=torch.float32, device=dev)).abs() \
        / kernel_scale
    w = (1 - x).clamp(min=0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > _WEIGHT_SUM_FLOOR,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def geometry_apply(images: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, g: Geometry, out_size: int,
                   means: Sequence[float]):
    """The fused crop/expand/flip of float images [B, 3, S, S]: one affine
    resample to [B, 3, out, out], mean-filled outside the source and
    mean-subtracted, and the boxes in percent coordinates of the output,
    clipped, with ``valid`` cleared where a centre left the image or a
    side fell to 1% or less."""
    s = images.shape[-1]
    # the output samples the crop ROI placed at (left, top) in roi units
    # inside a ws × hs expanded canvas
    rw, rh = g.roi[:, 2] - g.roi[:, 0], g.roi[:, 3] - g.roi[:, 1]
    win_w, win_h = rw * g.ws, rh * g.hs
    win_x1 = g.roi[:, 0] - g.left * rw
    win_y1 = g.roi[:, 1] - g.top * rh
    sx = out_size / (win_w * s)             # output px per source px
    sy = out_size / (win_h * s)
    tx = -win_x1 * s * sx
    ty = -win_y1 * s * sy
    sx_f = torch.where(g.flip, -sx, sx)
    tx_f = torch.where(g.flip, out_size - tx, tx)
    wy = resample_weights(s, out_size, sy, ty)
    wx = resample_weights(s, out_size, sx_f, tx_f)
    out = wy[:, None] @ images @ wx[:, None].transpose(-1, -2)

    uu = torch.arange(out_size, dtype=torch.float32,
                      device=images.device) + 0.5
    src_x = (uu - tx_f[:, None]) / sx_f[:, None] / s
    src_y = (uu - ty[:, None]) / sy[:, None] / s
    in_x = (src_x >= 0) & (src_x <= 1)
    in_y = (src_y >= 0) & (src_y <= 1)
    inside = (in_y[:, :, None] & in_x[:, None, :])[:, None]
    fill = _constant(means, out.device).view(1, 3, 1, 1)
    out = torch.where(inside, out, fill) - fill

    x1, y1 = win_x1[:, None], win_y1[:, None]
    w, h = win_w[:, None], win_h[:, None]
    bx1 = (boxes[..., 0] - x1) / w
    by1 = (boxes[..., 1] - y1) / h
    bx2 = (boxes[..., 2] - x1) / w
    by2 = (boxes[..., 3] - y1) / h
    flip = g.flip[:, None]
    nb = torch.stack([torch.where(flip, 1.0 - bx2, bx1), by1,
                      torch.where(flip, 1.0 - bx1, bx2), by2], -1)
    nb_clip = nb.clamp(0.0, 1.0)
    centers = (nb[..., :2] + nb[..., 2:]) / 2
    center_in = ((centers > 0) & (centers < 1)).all(-1)
    wh = torch.minimum(nb_clip[..., 2] - nb_clip[..., 0],
                       nb_clip[..., 3] - nb_clip[..., 1])
    return out, nb_clip, valid & center_in & (wh > 0.01)


def apply_augment(images: torch.Tensor, boxes: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor,
                  photo: Photometric, geom: Geometry, out_size: int = 300,
                  means: Sequence[float] = RGB_MEANS,
                  out_dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, torch.Tensor]:
    """The augmentation from drawn parameters: images [B, 3, S, S] of any
    dtype (cast to float32 once) → the batch's augmented dict, its images
    computed in float32 and, with ``out_dtype`` (the model's compute type,
    bf16 under ``--bf16``), rounded to it once at the end."""
    img = photometric_apply(images.to(torch.float32), photo)
    img, nb, nv = geometry_apply(img, boxes, valid, geom, out_size, means)
    if out_dtype is not None:
        img = img.to(out_dtype)
    return {"image": img, "boxes": nb, "labels": labels, "valid": nv}


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  boxes: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, out_size: int = 300,
                  expand_prob: float = 0.6,
                  means: Sequence[float] = RGB_MEANS,
                  out_dtype: Optional[torch.dtype] = None,
                  rank: int = 0, world: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """Draw from ``gen`` and augment: mean-subtracted images [B, 3, out,
    out], float32 or ``out_dtype`` (as ``augment_jax.augment_batch``'s),
    and the transformed fixed-shape targets; the batch is block ``rank``
    of ``world`` of the global batch the draws are made for."""
    photo, geom = sample_augment(gen, boxes, valid, expand_prob, rank,
                                 world)
    return apply_augment(images, boxes, labels, valid, photo, geom,
                         out_size, means, out_dtype)


# --------------------------------------------------------------------------
# mixup
# --------------------------------------------------------------------------


def sample_mixup(rng: np.random.Generator, b: int, beta_a: float = 1.5,
                 beta_b: float = 1.5) -> Tuple[np.ndarray, int]:
    """λ [B] ~ Beta(beta_a, beta_b) clipped to [0, 1], and the partner
    offset in [1, max(B, 2))."""
    lam = np.clip(rng.beta(beta_a, beta_b, b), 0.0, 1.0).astype(np.float32)
    return lam, int(rng.integers(1, max(b, 2)))


def apply_mixup(batch: Mapping[str, torch.Tensor], lam: torch.Tensor,
                offset: int,
                zero_ignored: bool = False) -> Dict[str, torch.Tensor]:
    """Blend each image with its partner, the batch rolled by ``offset``,
    at λ and 1 − λ, and carry both targets (2M rows), weighted λ and
    1 − λ. ``zero_ignored`` (incre, instance shots): rows labelled −1
    weigh 0. The blend runs in float32 and comes out in the images' type
    (a second rounding for bf16 images, as in ``augment_jax``)."""
    images = batch["image"]

    def partner(x):
        return torch.roll(x, shifts=offset, dims=0)

    lam4 = lam.view(-1, 1, 1, 1)
    mixed = (lam4 * images + (1.0 - lam4) * partner(images)).to(images.dtype)
    labels = torch.cat([batch["labels"], partner(batch["labels"])], 1)
    weights = torch.cat([batch["weights"] * lam[:, None],
                         partner(batch["weights"]) * (1.0 - lam)[:, None]],
                        1)
    if zero_ignored:
        weights = torch.where(labels < 0, 0.0, weights)
    return {"image": mixed,
            "boxes": torch.cat([batch["boxes"], partner(batch["boxes"])], 1),
            "labels": labels, "weights": weights,
            "valid": torch.cat([batch["valid"], partner(batch["valid"])], 1)}


def mixup_batch(rng: np.random.Generator, batch: Mapping[str, torch.Tensor],
                beta_a: float = 1.5, beta_b: float = 1.5,
                zero_ignored: bool = False) -> Dict[str, torch.Tensor]:
    """Batch-level image-pair mixup (the reference's dataset-level mixup,
    partnered within the batch), λ and the offset drawn from ``rng``."""
    lam, offset = sample_mixup(rng, batch["image"].shape[0], beta_a, beta_b)
    return apply_mixup(batch, to_device(lam, batch["image"].device), offset,
                       zero_ignored)
