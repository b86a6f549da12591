"""The port's bfloat16 training (``train.py --bf16``) vs the JAX package's,
on the CPU.

The same numpy inputs, made from a seed, go through both packages; JAX's
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. ``bf16_step(x)`` is one bfloat16 step at |x|.

* Rows 2, 3 and 4 (``_kernel_cm_stats``, ``_bwd_kernel_cm_flash``,
  ``_bwd_kernel_cm``) and row 5's backward (the row-major ``_bwd_kernel``
  as scripts/bench_ct_bwd.py calls it), the plain bf16 versions against
  JAX's kernels on bf16 inputs, C = 15 and 60, P = 1001 (ragged against
  every block), K = 97 (not a multiple of the tiles). bf16 outputs (out,
  delta, dq) within one bf16 step of the largest output, with at most 2%
  of them a step apart; m and z to rtol 1e-5 (the same f32 values summed
  in another order); the f32 sums (dk and dv before their cast, dwz, and
  row 5's float32 dq) within SUM_MEAN_TOL of their mean |entry| in the mean
  and SUM_MAX_TOL of their largest in the max. A wrong rounding point (g·wz,
  ds or attn rounded where JAX does not, or not where it does) moves the
  mean by more than ten times that band, another order of the sums by less
  than a tenth of it (``test_bf16_bands_separate_flips_from_wrong_rounding``,
  which the card's band rests on too).
* Row 7 (``pool2x2_packed_relu``) on bf16: forward and backward bit for bit
  on tie-heavy input.
* ``ct_attention_cm`` on bf16 through autograd, flash and blockwise
  (``CT_ATTENTION_FLASH``), against ``jax.grad`` of JAX's
  ``ct_attention_cm``: dq, dk, dv, dbase in bf16 within one step of their
  largest entry, dwz as the f32 sums above.
* One train step of the size-64 phase-2 incre model in bf16 (seeded JAX
  variables through ``from_jax_variables``) against the loss sums and
  ``jax.grad`` that JAX's ``make_train_step`` takes, with ``dtype=bfloat16``,
  the Pallas CT kernels and the packed conv1 stage, on the anchors JAX
  mines: each loss and the gradient taken as one vector (the update the
  optimizer applies) within half of what bf16 moves JAX's result (the
  band of tests/test_torch_bf16.py), each gradient tensor within its own
  bf16 effect or 1% of the whole vector's (see the bands below),
  and further than that from the float32 result. The float32 result is
  the port's float32 model on the same anchors, which
  tests/test_torch_train_step.py holds to JAX's within 1e-4.
* ``augment_batch(out_dtype=bf16)`` and ``mixup_batch`` on bf16 images
  against ``augment_jax.py``: within one bf16 step of the largest value,
  at most 1% of the pixels a step apart.
* The train CLI with ``--bf16 --device-augment --mixup``: three steps of
  the bf16 model on bf16 images on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ct_tpu.config import TINY_64 as J_TINY_64
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.data import augment_jax as JA
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.layers import pack_x_pairs
from ct_tpu.ops import ct_attention as J
from ct_tpu.ops.losses import multibox_loss_sums as j_loss_sums
from ct_tpu.ops.matching import match_batch as j_match_batch
from ct_tpu.ops.pool_packed_pallas import pool2x2_packed_relu
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu_torch.config import TINY_64, resolve_task
from ct_tpu_torch.data import augment_device as D
from ct_tpu_torch.models.convert import from_jax_variables
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops import ct_attention as T
from ct_tpu_torch.ops.ct_attention import bf16_step
from ct_tpu_torch.ops.losses import loss_mask
from ct_tpu_torch.ops.matching import match_batch
from ct_tpu_torch.ops.pool_relu import pool2x2_relu
from ct_tpu_torch.ops.priors import prior_boxes
from ct_tpu_torch.train import cli
from ct_tpu_torch.train.step import LOSS_KEYS, batch_to, loss_and_grads
from scripts.bench_ct_bwd import bwd_rowmajor
from test_torch_augment_device import jax_params, make_batch as aug_batch
from test_torch_augment_device import port_batch
from test_torch_bf16 import STRICT
from test_torch_model import random_jax_variables
from test_torch_train_cli import INCRE
from test_torch_train_step import make_batch

BF16 = torch.bfloat16
MAX_DIFFERING_SHARE = 0.02
SUM_MEAN_TOL = 1e-4
SUM_MAX_TOL = 1e-3
# bf16 training against JAX: half of what bf16 moves JAX's result, for
# each loss and for the gradient as one vector; each tensor within its own
# bf16 effect (closer to JAX's bf16 result than JAX's f32 one is) or
# TENSOR_FLOOR of the whole vector's. Two bf16 computations that sum in
# other orders part in a share of the bf16 effect that varies with the
# tensor (most for the BN scales of the size-64 extras, whose maps are
# 2×2 at batch 2). The gradients that vanish in exact arithmetic (φ's
# bias, the biases of BNs that feed BNs) are rounding noise on both sides,
# and XLA's CPU backend sums the bf16 cotangent of a bias (``y + bias`` on
# bf16 y) in bf16 where torch sums in f32 and rounds once, so their own
# effect does not bound those; the floor does. The test records each
# ratio (``record_property``).
EFFECT_SHARE = 0.5
TENSOR_SHARE = 1.0
TENSOR_FLOOR = 1e-2


def to_jax(x):
    """A torch tensor → a JAX array of its type (bf16 or float32)."""
    dt = jnp.bfloat16 if x.dtype == BF16 else jnp.float32
    return jnp.asarray(x.float().numpy(), dt)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def hold_bf16(ours, ref, name):
    """A bf16 output within one bf16 step of the largest reference entry,
    at most MAX_DIFFERING_SHARE of the entries apart."""
    a, b = np32(ours), np32(ref)
    assert a.shape == b.shape, name
    err = np.abs(a - b).max()
    assert err <= bf16_step(np.abs(b).max()), (name, err, np.abs(b).max())
    assert (a != b).mean() <= MAX_DIFFERING_SHARE, (name, (a != b).mean())


def hold_sum(ours, ref, name):
    """An f32 sum within SUM_MEAN_TOL of its mean |entry| in the mean and
    SUM_MAX_TOL of its largest entry in the max."""
    a, b = np32(ours), np32(ref)
    assert a.shape == b.shape, name
    d = np.abs(a - b)
    assert d.mean() <= SUM_MEAN_TOL * np.abs(b).mean(), (name, d.mean())
    assert d.max() <= SUM_MAX_TOL * np.abs(b).max(), (name, d.max())


def attention_inputs(c, seed, scale=1.0, b=2, p=1001, kk=97):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(BF16)
    q, k, v, base, g = mk(b, c, p), mk(b, kk, c), mk(b, kk, c), mk(b, c, p), \
        mk(b, c, p)
    wz = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    return q, k, v, base, g, wz


def jax_stats(q, k, v, base, wz):
    return J.ct_attention_cm_stats(*map(to_jax, (q, k, v, base, wz)),
                                   interpret=True)


@pytest.mark.parametrize("c", [15, 60])
def test_row2_plain_bf16_matches_jax_kernel(c):
    q, k, v, base, _, wz = attention_inputs(c, c)
    ref = jax_stats(q, k, v, base, wz)
    assert all(r.dtype == d for r, d in zip(
        ref, (jnp.bfloat16, jnp.bfloat16, jnp.float32, jnp.float32)))
    with torch.no_grad():
        ours = T.ct_attention_cm_stats(q, k, v, base, wz)
    assert T.ct_attention_cm_stats_bf16.launches == 0    # CPU: plain
    assert [o.dtype for o in ours] == [BF16, BF16, torch.float32,
                                       torch.float32]
    hold_bf16(ours[0], ref[0], "out")
    hold_bf16(ours[1], ref[1], "delta")
    for name, a, r in zip(("m", "z"), ours[2:], ref[2:]):
        np.testing.assert_allclose(np32(a), np32(r), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("c", [15, 60])
def test_row3_plain_bf16_matches_jax_kernel(c):
    """The flash backward from JAX's own saved delta, m and z, its colsum
    taken as ``_bwd_call_cm_flash`` takes it (from the bf16 g and delta in
    f32)."""
    q, k, v, base, g, wz = attention_inputs(c, 10 + c)
    _, delta, m, z = jax_stats(q, k, v, base, wz)
    gd = to_jax(g).astype(jnp.float32) * delta.astype(jnp.float32)
    colsum = jnp.sum(gd * to_jax(wz)[None, :, None], axis=1, keepdims=True)
    cm = lambda x: jnp.moveaxis(to_jax(x), -1, 1)
    ref = J._bwd_call_cm_flash(to_jax(q), cm(k), cm(v), to_jax(wz),
                               to_jax(g), delta, m, z, interpret=True)
    ours = T.ct_attention_cm_bwd_flash(
        q, k, v, wz, g, *(torch.tensor(np32(x)) for x in (m, z, colsum)))
    assert ours[0].dtype == BF16 and ours[1].dtype == torch.float32
    hold_bf16(ours[0], ref[0], "dq")
    hold_sum(ours[1], jnp.moveaxis(ref[1], 1, -1), "dk")
    hold_sum(ours[2], jnp.moveaxis(ref[2], 1, -1), "dv")
    np.testing.assert_allclose(np32(gd.sum(axis=(0, 2))),
                               np32(jnp.asarray(ref[3])), rtol=1e-6)


@pytest.mark.parametrize("c", [15, 60])
def test_row4_plain_bf16_matches_jax_kernel(c):
    q, _, _, _, g, wz = attention_inputs(c, 20 + c)
    _, k, v, _, _, _ = attention_inputs(c, 30 + c)
    cm = lambda x: jnp.moveaxis(to_jax(x), -1, 1)
    ref = J._bwd_call_cm(to_jax(q), cm(k), cm(v), to_jax(wz), to_jax(g),
                         interpret=True)
    ours = T.ct_attention_cm_bwd(q, k, v, wz, g)
    assert T.ct_attention_cm_bwd_bf16.launches == 0
    assert ours[0].dtype == BF16 and ours[3].dtype == torch.float32
    hold_bf16(ours[0], ref[0], "dq")
    hold_sum(ours[1], jnp.moveaxis(ref[1], 1, -1), "dk")
    hold_sum(ours[2], jnp.moveaxis(ref[2], 1, -1), "dv")
    hold_sum(ours[3], ref[3], "dwz")


@pytest.mark.parametrize("c", [15, 60])
def test_row5_bwd_plain_bf16_matches_jax_bench(c):
    """The row-major backward as scripts/bench_ct_bwd.py calls it, on its
    bf16 inputs (normal × 0.3, wz float32): all four outputs float32."""
    q, k, v, _, g, wz = attention_inputs(c, 40 + c, scale=0.3)
    q, g = q.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
    with pltpu.force_tpu_interpret_mode():
        ref = bwd_rowmajor(*map(to_jax, (q, k, v, wz, g)))
    ours = T.ct_attention_bwd(q, k, v, wz, g)
    assert T.ct_attention_bwd_bf16.launches == 0
    assert all(o.dtype == torch.float32 for o in ours)
    for name, a, r in zip(("dq", "dk", "dv", "dwz"), ours, ref):
        hold_sum(a, r, name)


def test_row7_plain_bf16_bitexact_vs_jax():
    shape = (2, 16, 12, 20)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal(
        (2, 16, 6, 10)).astype(np.float32)).to(BF16)
    xt = x.clone().requires_grad_()
    y = pool2x2_relu(xt)
    y.backward(g)
    assert y.dtype == BF16 and xt.grad.dtype == BF16
    nhwc = lambda t: jnp.asarray(np.transpose(np32(t), (0, 2, 3, 1)),
                                 jnp.bfloat16)
    jy, vjp = jax.vjp(lambda a: pool2x2_packed_relu(pack_x_pairs(a), True),
                      nhwc(x))
    (jdx,) = vjp(nhwc(g))
    assert jy.dtype == jnp.bfloat16 and jdx.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np32(y), np.transpose(np32(jy),
                                                        (0, 3, 1, 2)))
    np.testing.assert_array_equal(np32(xt.grad),
                                  np.transpose(np32(jdx), (0, 3, 1, 2)))
    assert (np32(xt.grad) != 0).sum() > 0


def test_bf16_bands_separate_flips_from_wrong_rounding(record_property):
    """The band that holds the bf16 backward kernels to their plain versions
    on the card (``chip_smoke.py`` BF16_SUM_MEAN_TOL, 1e-4 of the mean
    |entry|) against what it must tell apart, on the plain flash backward
    at a full image's K (one image, C=60, unit inputs, a peaked softmax):
    the scores summed in another order (float64, then rounded), which only
    flips values at bf16 rounding boundaries, as the kernels' own order
    does, move each output's mean by far less than the band; a wrong
    rounding point (g·wz, ds or attn left unrounded) moves some output's
    mean by far more."""
    q, k, v, base, g, wz = attention_inputs(60, 77, b=1, p=2048, kk=1858)
    wz = wz * 0.1
    _, delta, m, z = T.ct_attention_cm_stats_reference_bf16(q, k, v, base,
                                                            wz)
    gd = g.float() * delta.float()
    colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
    bf = lambda x: x.to(BF16).float()

    def flash(s=None, round_g=True, round_ds=True, round_attn=True):
        if s is None:
            s = torch.einsum("bkc,bcp->bkp", k.float(), q.float())
        attn = torch.exp(s - m) * (1.0 / z)
        gv = g.float() * wz[None, :, None]
        gv = bf(gv) if round_g else gv
        ds = attn * (torch.einsum("bkc,bcp->bkp", v.float(), gv) - colsum)
        ds = bf(ds) if round_ds else ds
        return (torch.einsum("bkc,bkp->bcp", k.float(), ds),
                torch.einsum("bcp,bkp->bkc", q.float(), ds),
                torch.einsum("bcp,bkp->bkc", gv,
                             bf(attn) if round_attn else attn))

    def mean_rel(outs, ref):
        return max(float((a - r).abs().mean() / r.abs().mean())
                   for a, r in zip(outs, ref))

    ref = flash()
    s64 = torch.einsum("bkc,bcp->bkp", k.double(), q.double()).float()
    flips = mean_rel(flash(s=s64), ref)
    record_property("flips_mean_rel", flips)
    assert 0 < flips <= 0.1 * SUM_MEAN_TOL
    for name, kw in (("g", dict(round_g=False)), ("ds", dict(round_ds=False)),
                     ("attn", dict(round_attn=False))):
        wrong = mean_rel(flash(**kw), ref)
        record_property(f"unrounded_{name}_mean_rel", wrong)
        assert wrong >= 10 * SUM_MEAN_TOL, (name, wrong)


def blockwise_in_kernel_order(q, k, v, wz, g, divide, round_attn=True):
    """The plain bf16 blockwise backward (``ct_attention_cm_bwd_reference_
    bf16``) in the order of the card's kernels: the row max and the sum of
    e^(s − m) taken together, online, over key tiles of the kernels' size
    (l ← l·e^(m_old − m_new) + Σ e^(s − m_new)), then the weights against
    the final m and l: e·(1/l) or, with ``divide`` (row 5), e / l as
    Markstein's correction of e·(1/l) (r = 1/l, q0 = e·r, ρ = e − q0·l
    exactly as an FMA takes it, q = q0 + ρ·r). The rest as the plain
    version; ``round_attn=False`` leaves bf(attn) unrounded."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q.float())
    m = torch.full_like(s[:, :1], -float("inf"))
    total = torch.zeros_like(m)
    for j0 in range(0, s.shape[1], T.BF16_TILE):
        tile = s[:, j0:j0 + T.BF16_TILE]
        mn = torch.maximum(m, tile.amax(dim=1, keepdim=True))
        total = total * torch.exp(m - mn) + torch.exp(tile - mn).sum(
            dim=1, keepdim=True)
        m = mn
    e = torch.exp(s - m)
    r = 1.0 / total
    if divide:
        q0 = e * r
        rho = (e.double() - q0.double() * total.double()).float()
        attn = (q0.double() + rho.double() * r.double()).float()
    else:
        attn = e * r
    af = attn.to(BF16).float() if round_attn else attn
    gf = g.float()
    gv = (gf * wz[None, :, None]).to(BF16).float()
    dv = torch.einsum("bcp,bkp->bkc", gv, af)
    dattn = torch.einsum("bkc,bcp->bkp", v.float(), gv)
    colsum = (af * dattn).sum(dim=1, keepdim=True)
    ds = (af * (dattn - colsum)).to(BF16).float()
    dq = torch.einsum("bkc,bkp->bcp", k.float(), ds)
    dk = torch.einsum("bcp,bkp->bkc", q.float(), ds)
    delta = torch.einsum("bkc,bkp->bcp", v.float(), af)
    if not divide:
        dq = dq.to(BF16)
    return dq, dk, dv, (gf * delta).sum(dim=(0, 2))


@pytest.mark.parametrize("c", [15, 60])
@pytest.mark.parametrize("row_major", [False, True])
def test_bf16_kernel_order_within_band(c, row_major, record_property):
    """The card's blockwise stats order (two walks over the keys: the
    online max and sum over 64-key tiles, then the weights; row 5's
    division by Markstein's correction) against the plain bf16 blockwise
    backward, class-major and row-major (the division), on one image at a
    full image's K with a peaked softmax: each output's mean moves by at
    most a tenth of SUM_MEAN_TOL (f32 rounding of the sum flips a few
    weights by a bf16 step), while leaving bf(attn) unrounded moves one by
    ten times the band or more."""
    q, k, v, _, g, wz = attention_inputs(c, 90 + c, b=1, p=2048, kk=1858)
    wz = wz * 0.1
    ref = T.ct_attention_cm_bwd_reference_bf16(
        q, k, v, wz, g, divide=row_major, round_dq=not row_major)

    def mean_rel(outs):
        return max(float((a.float() - r.float()).abs().mean()
                         / r.float().abs().mean())
                   for a, r in zip(outs, ref))

    moved = mean_rel(blockwise_in_kernel_order(q, k, v, wz, g, row_major))
    record_property("kernel_order_mean_rel", moved)
    assert moved <= 0.1 * SUM_MEAN_TOL
    wrong = mean_rel(blockwise_in_kernel_order(q, k, v, wz, g, row_major,
                                               round_attn=False))
    record_property("unrounded_attn_mean_rel", wrong)
    assert wrong >= 10 * SUM_MEAN_TOL


def forward_in_kernel_order(q, k, v, base, wz):
    """The plain bf16 training forward (``ct_attention_cm_stats_reference_
    bf16``) in the order of the card's kernel: the row max over all keys
    first (its first walk), the weights rounded to bf16 against it, then
    each 64-key tile's numerators and denominator (v's ones column) as one
    f32 product, added to the running sums with rounded f32 adds → (out,
    delta, m, z)."""
    s = torch.einsum("bkc,bcp->bkp", k.float(), q.float())
    m = s.amax(dim=1, keepdim=True)
    e = torch.exp(s - m).to(BF16).float()
    v1 = torch.cat([v.float(), torch.ones_like(v[..., :1]).float()], dim=2)
    acc = torch.zeros(q.shape[0], q.shape[1] + 1, q.shape[2])
    for j0 in range(0, k.shape[1], T.BF16_TILE):
        tile = slice(j0, j0 + T.BF16_TILE)
        acc = acc + torch.einsum("bkp,bkc->bcp", e[:, tile], v1[:, tile])
    num, z = acc[:, :-1], acc[:, -1:]
    delta = num / z
    out = base.float() + delta * wz[None, :, None]
    return out.to(BF16), delta.to(BF16), m, z


@pytest.mark.parametrize("c", [15, 60])
def test_bf16_forward_kernel_order_within_band(c, record_property):
    """The card's bf16 forward order (the max over the keys, the weights
    rounded against it, a 64-key tile's num and den as one product added
    with rounded f32 adds) against JAX's ``_kernel_cm`` and
    ``_kernel_cm_stats`` on bf16 operands, in interpret mode, at K = 300
    (five tiles, the last ragged): out and delta within one bf16 step of
    the largest output, at most MAX_DIFFERING_SHARE of them a step apart;
    m and z to rtol 1e-5. Records the distances."""
    q, k, v, base, _, wz = attention_inputs(c, 30 + c, b=1, p=1001, kk=300)
    ours = forward_in_kernel_order(q, k, v, base, wz)
    ref = jax_stats(q, k, v, base, wz)
    ref_eval = J.ct_attention_cm(*map(to_jax, (q, k, v, base, wz)), 1024,
                                 True)
    for name, a, r in (("out", ours[0], ref[0]), ("delta", ours[1], ref[1]),
                       ("eval_out", ours[0], ref_eval)):
        a, r = np32(a), np32(r)
        record_property(f"{name}_max_in_steps",
                        float(np.abs(a - r).max()
                              / bf16_step(np.abs(r).max())))
        record_property(f"{name}_differing_share", float((a != r).mean()))
    hold_bf16(ours[0], ref[0], "out")
    hold_bf16(ours[1], ref[1], "delta")
    hold_bf16(ours[0], ref_eval, "eval out")
    for name, a, r in zip(("m", "z"), ours[2:], ref[2:]):
        np.testing.assert_allclose(np32(a), np32(r), rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("flash", [True, False])
def test_ct_attention_cm_autograd_bf16_matches_jax_grad(flash, monkeypatch):
    c = 60
    q, k, v, base, g, wz = attention_inputs(c, 50 + flash)
    monkeypatch.setattr(J, "_USE_FLASH", flash)

    def loss(*args):
        out = J.ct_attention_cm(*args, 1024, True)
        return jnp.sum(out.astype(jnp.float32) * to_jax(g).astype(
            jnp.float32))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(to_jax, (q, k, v, base, wz)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, base, wz)]
    out = T.ct_attention_cm(*leaves, flash=flash)
    assert out.dtype == BF16
    (out.float() * g.float()).sum().backward()
    for name, a, r in zip(("dq", "dk", "dv", "dbase"), leaves, ref[:4]):
        assert a.grad.dtype == BF16 and r.dtype == jnp.bfloat16, name
        hold_bf16(a.grad, r, name)
    assert leaves[4].grad.dtype == torch.float32
    hold_sum(leaves[4].grad, ref[4], "dwz")


# --- the size-64 train step ------------------------------------------------

@pytest.fixture(scope="module")
def train_case():
    """JAX's bf16 train-step loss sums and gradients (``jax.grad`` of the
    sums ``make_train_step`` differentiates, divided by N) and its objectness
    logits, whose mined anchors both sides then count (Pallas CT kernels
    in interpret mode, the packed conv1 stage), from seeded variables."""
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=5)
    batch = make_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpriors = j_prior_boxes(J_TINY_64)
    out = {}
    for key, net in (("16", dataclasses.replace(
            j_build_net(jtask, 64, dtype=jnp.bfloat16, pack_conv1=True),
            use_pallas_ct=True)),):
        def sums_fn(params, net=net):
            preds, _ = net.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb["image"], train=True, mutable=["batch_stats"])
            matched = j_match_batch(jb["boxes"], jb["labels"], jb["weights"],
                                    jb["valid"], jpriors)
            sums, n = j_loss_sums(preds.loc, preds.conf, preds.obj, matched)
            return sum(sums.values()), (n, sums, preds.obj)

        fn = jax.jit(jax.value_and_grad(sums_fn, has_aux=True))
        with pltpu.force_tpu_interpret_mode(), \
                jax.default_matmul_precision("highest"):
            (_, (n, sums, obj)), grads = fn.lower(
                variables["params"]).compile(compiler_options=STRICT)(
                    variables["params"])
        n = max(float(n), 1.0)
        out[key] = {
            "losses": {k: float(v) / n for k, v in sums.items()},
            "grads": from_jax_variables({"params": jax.tree_util.tree_map(
                lambda x: np.asarray(x) / n, grads)}),
            "obj": torch.tensor(np.asarray(obj))}
    return dict(out, task=resolve_task(2, "incre", "ours", "VOC"),
                variables=variables, batch=batch_to(batch, "cpu"))


def port_step(case, dtype, mask):
    net = build_net(case["task"], 64, device="cpu", dtype=dtype)
    net.load_state_dict(from_jax_variables(case["variables"]))
    losses, _ = loss_and_grads(net, case["batch"], prior_boxes(TINY_64),
                               mask=mask)
    return ({k: float(losses[k]) for k in LOSS_KEYS},
            {n: p.grad.detach().clone() for n, p in net.named_parameters()})


def test_bf16_train_step_matches_jax_size64(train_case, record_property):
    c = train_case
    b = c["batch"]
    matched = match_batch(b["boxes"], b["labels"], b["weights"], b["valid"],
                          prior_boxes(TINY_64), 0.5)
    mask = loss_mask(c["16"]["obj"], matched)[0]       # the anchors JAX mined
    losses16, grads16 = port_step(c, BF16, mask)
    losses32, grads32 = port_step(c, torch.float32, mask)
    for k in LOSS_KEYS:
        effect = abs(c["16"]["losses"][k] - losses32[k])
        assert effect > 0, k
        dist = abs(losses16[k] - c["16"]["losses"][k])
        record_property(f"{k}_over_effect", dist / effect)
        assert dist <= EFFECT_SHARE * effect, (k, losses16[k],
                                               c["16"]["losses"][k], effect)
    ref16, ref32 = c["16"]["grads"], grads32
    assert set(grads16) <= set(ref16)
    names = sorted(grads16)
    cat = lambda d: torch.cat([d[n].reshape(-1) for n in names])
    effect = (cat(ref16) - cat(ref32)).norm()
    to_bf16 = float((cat(grads16) - cat(ref16)).norm() / effect)
    to_f32 = float((cat(grads16) - cat(ref32)).norm() / effect)
    record_property("grads_over_effect", to_bf16)
    record_property("grads_to_f32_over_effect", to_f32)
    assert to_bf16 <= EFFECT_SHARE
    assert to_f32 > EFFECT_SHARE     # not the float32 model
    worst = 0.0
    for n in names:
        assert grads16[n].dtype == torch.float32, n
        d = (grads16[n] - ref16[n]).norm()
        band = max(TENSOR_SHARE * (ref16[n] - ref32[n]).norm(),
                   TENSOR_FLOOR * effect)
        worst = max(worst, float(d / band))
        assert d <= band, (n, float(d), float(band))
    record_property("worst_tensor_over_band", worst)


# --- the device augmentation's bf16 feed -----------------------------------

def test_bf16_augment_and_mixup_match_jax():
    out_size = 64
    images, boxes, labels, valid = aug_batch(3)
    key = jax.random.PRNGKey(103)
    ref = JA.augment_batch(key, jnp.asarray(images), jnp.asarray(boxes),
                           jnp.asarray(labels), jnp.asarray(valid),
                           out_size=out_size, out_dtype=jnp.bfloat16)
    assert ref["image"].dtype == jnp.bfloat16
    photo, geom = jax_params(key, boxes, valid)
    ours = D.apply_augment(*port_batch(images, boxes, labels, valid), photo,
                           geom, out_size=out_size, out_dtype=BF16)
    assert ours["image"].dtype == BF16
    a = np32(ours["image"].permute(0, 2, 3, 1))
    r = np32(ref["image"])
    assert np.abs(a - r).max() <= bf16_step(np.abs(r).max())
    assert (a != r).mean() <= 1e-2
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(ref["boxes"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours["valid"].numpy(),
                                  np.asarray(ref["valid"]))

    # mixup blends the bf16 images in f32 and emits bf16
    weights = np.ones(labels.shape, np.float32)
    jbatch = dict(ref, weights=jnp.asarray(weights))
    mkey = jax.random.PRNGKey(9)
    jmixed = JA.mixup_batch(mkey, jbatch, zero_ignored=True)
    k_lam, k_off = jax.random.split(mkey)
    b = images.shape[0]
    lam = np.clip(np.asarray(jax.random.beta(k_lam, 1.5, 1.5, (b,))), 0, 1)
    offset = int(jax.random.randint(k_off, (), 1, max(b, 2)))
    pbatch = {k: torch.tensor(np.asarray(v)) for k, v in ref.items()
              if k != "image"}
    pbatch["image"] = torch.tensor(np.transpose(r, (0, 3, 1, 2))).to(BF16)
    pbatch["weights"] = torch.from_numpy(weights)
    mixed = D.apply_mixup(pbatch, torch.from_numpy(lam.astype(np.float32)),
                          offset, zero_ignored=True)
    assert mixed["image"].dtype == BF16 and jmixed["image"].dtype == \
        jnp.bfloat16
    a = np32(mixed["image"].permute(0, 2, 3, 1))
    r = np32(jmixed["image"])
    assert np.abs(a - r).max() <= bf16_step(np.abs(r).max())
    assert (a != r).mean() <= 1e-2
    np.testing.assert_allclose(mixed["weights"].numpy(),
                               np.asarray(jmixed["weights"]), atol=1e-6)


# --- the train CLI ----------------------------------------------------------

def test_train_cli_bf16_device_augment_mixup(tmp_path, monkeypatch):
    """Three steps of ``--bf16 --device-augment --mixup`` at 300 on the
    CPU at batch 2 after one OBJ_Target init batch (two intra-op threads,
    as the CLI tests take): the model computes in bf16 and is fed bf16
    images; finite losses; the checkpoint holds float32 parameters."""
    from fixtures import make_mini_voc
    from ct_tpu_torch.train import step as step_mod

    monkeypatch.setenv("VOC_ROOT", make_mini_voc(str(tmp_path / "voc")))
    seen = []
    real = step_mod.loss_and_grads

    def spy(model, batch, *a, **kw):
        seen.append((model.dtype, batch["image"].dtype))
        return real(model, batch, *a, **kw)

    monkeypatch.setattr(step_mod, "loss_and_grads", spy)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        save = str(tmp_path / "w")
        row = cli.main(INCRE + [
            "--init-iter", "1", "-d", "VOC", "--max-iter", "3", "-b", "2",
            "--num-workers", "2", "--bf16", "--device-augment",
            "--canvas", "320",
            "--checkpoint-period", "100", "--save-folder", save,
            "--device", "cpu"])
    finally:
        torch.set_num_threads(before)
    assert row["iteration"] == 2 and all(np.isfinite(v) for v in row.values())
    assert seen == [(BF16, BF16)] * 3
    state = torch.load(os.path.join(save, "model_final.pth"),
                       map_location="cpu")["model"]
    assert all(v.dtype == torch.float32 for v in state.values()
               if v.is_floating_point())
    with open(os.path.join(save, "log.txt")) as f:
        assert "Fine tuning on 1-shot task" in f.read()
