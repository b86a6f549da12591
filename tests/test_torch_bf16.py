"""The port's bfloat16 eval and serving (``test.py --bf16``) vs the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages; JAX's
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. ``bf16_step(x)`` is one bfloat16 step at |x| (2^(⌊log2 |x|⌋ − 7),
between 2⁻⁸·|x| and 2⁻⁷·|x|).

* Row 1 (``ct_attention_cm``) and row 6 (``ct_attention_serving``), the
  plain bf16 versions vs JAX's kernels on bf16 inputs, C = 15 and 60, P
  ragged against the blocks, K = 97: bf16 out, max |Δ| within one bf16 step
  of the largest output (the two sum in another f32 order before the
  output is rounded, so a value at a rounding boundary moves by a step);
  the share of entries that differ at all is recorded (``record_property``)
  and held under 2%.
* Row 6's bf16 CUDA kernel emulated in torch in its own order (θ, the
  max over all keys, e by its exp2 form against it, each 64-key tile's
  numerators and denominator as one product added with rounded f32 adds,
  then the division, the residual, rsqrt, bf16 novel and the classifier)
  against JAX's kernel at K = 300 (five tiles, the last ragged), in the
  same band: the kernel's summation order, which the card tests hold to
  the plain version, is itself within a step of JAX's.
* Row 5's forward and row 10 (the attention bench's bf16-exponent
  variant) on the bench's bf16 inputs, against JAX's row-major kernel and
  the bench's ``make_variant``, in the same band; and row 10's unfused
  float32-exponent body (``ct_attention_variant_unfused_bf16``: the
  denominator summed before the weights' rounding) against
  ``make_variant(jnp.float32, 1024, fuse_denom=False)``, in the same band
  and with fewer differing entries than the fused form has against it.
* The plain version of the bf16 kernels' prep of k and v (which the card
  test holds the kernel to) against the tile layout written out element
  by element.
* What the bf16 path refuses: mixed types, C = 64 (the kernels' ones
  column), with a gradient to take too (bf16 training runs,
  tests/test_torch_bf16_train.py).
* The size-64 model (phase 2 incre ``ours``, seeded weights through
  ``from_jax_variables``), the port's bf16 forward vs JAX's ``build_net(...,
  dtype=jnp.bfloat16)`` with its Pallas CT kernel: loc, conf and obj in
  JAX's types (float32 for evaluation), each within half of what bf16 itself
  moves JAX's output by, |jax_bf16 − jax_f32|, in the mean and in the max;
  the max may also reach one bf16 step of the largest output (loc and obj
  are bf16 head outputs: one rounding that goes the other way at their
  largest entry is a step, up to 2/3 of that max effect at this size,
  while their mean distance is 2-6% of the mean effect); and further than
  each of those halves from the port's own float32 output, so the bands
  cannot pass a model that ran in float32. The JAX models are compiled with
  XLA's excess precision off (``STRICT``), so that they round where the
  model's types say.
* The int8 serving model under bf16 (``--int8 --int8-heads --bf16``, JAX's
  folded weights and its bf16 calibration's scales): loc, obj and
  conf_feat within max |Δ| ≤ 2e-2 and mean |Δ| ≤ 1e-3 of the largest
  output, the CT scores within 1e-1 (the bands of
  tests/test_torch_serving.py); conf and obj bf16 as in JAX; the port's
  own bf16 calibration within one bf16 step of JAX's for every conv.
* Post-processing with bf16 scores: ``postprocess`` vs JAX's on the same
  bf16 probabilities, drawn on a coarse grid so that more than 32 scores
  tie at the k-th of the cap and scores tie across classes, exact, with
  ``--approx-topk`` and with ``--pool-size``: the same detections (boxes
  to 1e-6 relative, as decode's exp in XLA and in PyTorch agree to 2 ulp;
  scores, classes, order and ``valid`` equal).
* The eval CLI with ``--bf16``, and with the JAX bench's full serving
  config (``--int8 --int8-heads --bf16 --approx-topk on --top-k 128
  --pool-size 512``), on two fixture images on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.fold_bn import fold_variables
from ct_tpu.models.quantize import SKIP_CT_ONLY as J_SKIP_CT_ONLY
from ct_tpu.models.quantize import calibrate as j_calibrate
from ct_tpu.models.quantize import quantize_variables as j_quantize_variables
from ct_tpu.models.rfbnet import eval_scores as j_eval_scores
from ct_tpu.models.rfbnet import vgg_pool_chains as j_vgg_pool_chains
from ct_tpu.ops.ct_attention import ct_attention_cm as j_ct_attention_cm
from ct_tpu.ops.ct_attention import ct_attention_serving as j_serving
from ct_tpu.ops.detection import postprocess as j_postprocess
from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.convert import from_jax_variables, quant_from_jax
from ct_tpu_torch.models.fold_bn import fold_bn
from ct_tpu_torch.models.quantize import attach, calibrate
from ct_tpu_torch.models.rfbnet import build_net, eval_scores
from ct_tpu_torch.ops.ct_attention import (
    bf16_step, ct_attention_cm, ct_attention_cm_bf16,
    ct_attention_prep_kv_bf16, ct_attention_serving,
    ct_attention_serving_bf16,
)
from ct_tpu_torch.ops.detection import postprocess
from test_torch_eval import assert_dets_equal
from test_torch_model import random_jax_variables
from test_torch_serving import (
    PARITY, SERVING_MEAN_TOL, SERVING_TOL, _voc_root, by_name, nhwc,
)

BF16 = torch.bfloat16
# the share of a kernel's outputs that may differ from JAX's at all
MAX_DIFFERING_SHARE = 0.02


def to_jax(x):
    """A bf16 torch tensor or a float32 array → a JAX array of its type."""
    if isinstance(x, torch.Tensor):
        dt = jnp.bfloat16 if x.dtype == BF16 else jnp.float32
        return jnp.asarray(x.float().numpy(), dt)
    return jnp.asarray(x)


def hold_to_one_step(ours, ref, record_property, name):
    """ours (bf16 tensor) within one bf16 step of ref's largest entry;
    the share of entries that differ is recorded and held small."""
    a = ours.float().numpy()
    b = np.asarray(ref, np.float32)
    assert ours.dtype == BF16 and a.shape == b.shape
    err = np.abs(a - b).max()
    share = float((a != b).mean())
    record_property(f"{name}_max_abs_err", float(err))
    record_property(f"{name}_differing_share", share)
    assert err <= bf16_step(np.abs(b).max()), (err, np.abs(b).max())
    assert share <= MAX_DIFFERING_SHARE, share


@pytest.mark.parametrize("c", [15, 60])
def test_row1_plain_bf16_matches_jax_kernel(c, record_property):
    rng = np.random.default_rng(c)
    b, p, kk = 2, 1001, 97
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(BF16)
    q, k, v, base = mk(b, c, p), mk(b, kk, c), mk(b, kk, c), mk(b, c, p)
    wz = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    ref = j_ct_attention_cm(*map(to_jax, (q, k, v, base, wz)),
                            interpret=True)
    assert ref.dtype == jnp.bfloat16
    before = ct_attention_cm_bf16.launches
    with torch.no_grad():
        ours = ct_attention_cm(q, k, v, base, wz)
    assert ct_attention_cm_bf16.launches == before     # CPU: plain version
    hold_to_one_step(ours, np.asarray(ref.astype(jnp.float32)),
                     record_property, "row1")


@pytest.mark.parametrize("c,n", [(15, 5), (60, 20)])
def test_row6_plain_bf16_matches_jax_kernel(c, n, record_property):
    rng = np.random.default_rng(c + n)
    b, p, kk = 2, 1001, 97
    t = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    bf = lambda a: torch.from_numpy(a).to(BF16)
    f32 = torch.from_numpy
    args = (bf(t(b, c, p)), bf(t(b, kk, c, scale=0.3)), bf(t(b, kk, c)),
            bf(t(c, c, scale=0.2)), f32(t(c, scale=0.1)),
            f32(t(c, scale=0.3)), bf(t(n, c)))
    ref = j_serving(*map(to_jax, args), interpret=True)
    assert ref.dtype == jnp.bfloat16
    before = ct_attention_serving_bf16.launches
    with torch.no_grad():
        ours = ct_attention_serving(*args)
    assert ct_attention_serving_bf16.launches == before
    hold_to_one_step(ours, np.asarray(ref.astype(jnp.float32)),
                     record_property, "row6")


# the CUDA kernels' tile of keys (csrc wg::kTile) and their log2(e) in f32
KEY_TILE = 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def serving_kernel_order_bf16(conf, k, v, wt, bt, wz, obj, scale=5.0):
    """The bf16 serving head in the order of its CUDA kernel
    (``csrc/ct_attention_serving.cu``): each f32 product of bf16 operands
    exact in float64 and rounded once to f32 (the tensor cores' sums, up to
    their truncation), the adds between them rounded in f32."""
    f64 = torch.float64
    c = conf.shape[1]
    x = conf.float()
    th = torch.einsum("co,bcp->bop", wt.to(f64), conf.to(f64)).float()
    q = ((th + bt[None, :, None]) + x).to(BF16)
    s = torch.einsum("bkc,bcp->bkp", k.to(f64), q.to(f64)).float()
    ml = s.amax(dim=1, keepdim=True) * LOG2E
    # e = ex2(fma(s, log2 e, -m log2 e)), rounded to bf16
    e = torch.exp2((s.to(f64) * LOG2E.to(f64) - ml.to(f64)).float()).to(BF16)
    vv = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1).to(f64)
    o = torch.zeros((x.shape[0], c + 1, x.shape[2]))
    for j0 in range(0, k.shape[1], KEY_TILE):   # a fresh product a tile
        o = o + torch.einsum("bkp,bkc->bcp", e[:, j0:j0 + KEY_TILE].to(f64),
                             vv[:, j0:j0 + KEY_TILE]).float()
    n = x + (o[:, :c] / o[:, c:]) * wz[None, :, None]
    ss = (n.to(f64) ** 2).sum(dim=1, keepdim=True).float()
    novel = (n * torch.rsqrt(ss)).to(BF16)
    return (torch.einsum("nc,bcp->bnp", obj.to(f64), novel.to(f64)).float()
            * scale).to(BF16)


@pytest.mark.parametrize("c,n", [(15, 5), (60, 20)])
def test_row6_kernel_order_bf16_matches_jax_kernel(c, n, record_property):
    rng = np.random.default_rng(c + n + 1)
    b, p, kk = 2, 1001, 300      # five 64-key tiles, the last ragged
    t = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    bf = lambda a: torch.from_numpy(a).to(BF16)
    f32 = torch.from_numpy
    args = (bf(t(b, c, p, scale=3.0)), bf(t(b, kk, c, scale=0.3)),
            bf(t(b, kk, c)), bf(t(c, c, scale=0.2)), f32(t(c, scale=0.1)),
            f32(t(c, scale=0.3)), bf(t(n, c)))
    ref = j_serving(*map(to_jax, args), interpret=True)
    ours = serving_kernel_order_bf16(*args)
    hold_to_one_step(ours, np.asarray(ref.astype(jnp.float32)),
                     record_property, f"row6_kernel_order_c{c}")


def test_rowmajor_and_bench_variant_plain_bf16_match_jax(record_property):
    """Row 5's forward (``ct_attention``) and row 10 (the attention bench's
    bfloat16-exponent variant) on the JAX bench's bf16 inputs (normal ×
    0.3, wz float32) against JAX's row-major kernel and the bench's
    ``make_variant(jnp.bfloat16, ..., fuse_denom=True)``."""
    from ct_tpu.ops.ct_attention import ct_attention as j_ct_attention
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention, ct_attention_bf16, ct_attention_variant,
        ct_attention_variant_bf16,
    )
    from scripts.bench_ct_attention import make_variant as j_make_variant

    rng = np.random.default_rng(5)
    b, p, kk, c = 2, 1001, 97, 60
    mk = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.3).astype(np.float32)).to(BF16)
    args = (mk(b, p, c), mk(b, kk, c), mk(b, kk, c), mk(b, p, c),
            torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    jargs = tuple(map(to_jax, args))
    before = (ct_attention_bf16.launches, ct_attention_variant_bf16.launches)
    with torch.no_grad():
        ours, ours_v = ct_attention(*args), ct_attention_variant(*args)
    assert (ct_attention_bf16.launches,
            ct_attention_variant_bf16.launches) == before
    ref = j_ct_attention(*jargs, 1024, True)
    hold_to_one_step(ours, np.asarray(ref.astype(jnp.float32)),
                     record_property, "row5")
    with pltpu.force_tpu_interpret_mode():
        ref_v = j_make_variant(jnp.bfloat16, 1024, fuse_denom=True)(*jargs)
    hold_to_one_step(ours_v, np.asarray(ref_v.astype(jnp.float32)),
                     record_property, "row10")
    # the variant's rounded argument moves some outputs
    assert not torch.equal(ours, ours_v)


def test_bench_unfused_variant_plain_bf16_matches_jax(record_property):
    """Row 10's unfused float32-exponent body on the JAX bench's bf16
    inputs: v times the weights rounded to bf16, over the f32 sum of the
    weights before their rounding (``make_variant(jnp.float32, ...,
    fuse_denom=False)``, interpret mode). The fused form (the production
    kernel's function, the sum of the rounded weights) is further from it:
    more of its entries differ."""
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_bf16, ct_attention_reference_bf16,
        ct_attention_variant_unfused_bf16,
    )
    from scripts.bench_ct_attention import make_variant as j_make_variant

    rng = np.random.default_rng(5)
    b, p, kk, c = 2, 1001, 97, 60
    mk = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.3).astype(np.float32)).to(BF16)
    args = (mk(b, p, c), mk(b, kk, c), mk(b, kk, c), mk(b, p, c),
            torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    before = ct_attention_variant_unfused_bf16.launches
    with torch.no_grad():
        ours = ct_attention_variant_unfused_bf16(*args)
        fused = ct_attention_bf16(*args)
    assert ct_attention_variant_unfused_bf16.launches == before
    with pltpu.force_tpu_interpret_mode():
        ref = j_make_variant(jnp.float32, 1024, fuse_denom=False)(
            *map(to_jax, args))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    hold_to_one_step(ours, ref, record_property, "row10_unfused")
    differ = lambda t: int((t.float().numpy() != ref).sum())
    record_property("row10_unfused_differing", differ(ours))
    record_property("row10_fused_vs_unfused_differing", differ(fused))
    assert differ(ours) < differ(fused)
    torch.testing.assert_close(
        ours, ct_attention_reference_bf16(*args, unfused=True), rtol=0,
        atol=0)
    with pytest.raises(TypeError, match="bfloat16"):
        ct_attention_variant_unfused_bf16(*(t.float() for t in args))


@pytest.mark.parametrize("c,kk", [(15, 70), (60, 130), (1, 1)])
def test_bf16_prep_plain_version_is_the_tile_layout(c, kk):
    """The plain version of the bf16 kernels' prep of k and v (the one the
    card test holds the kernel to) against the tile layout written out
    element by element (``wg::at``: chunk c of row r at c ^ (r % 8) for
    CP = 64, c ^ ((r / 4) % 2) for CP = 16): zero past C and K, v's column
    C one for each live key with ``ones``; on the CPU the wrapper is the
    plain version and launches nothing."""
    rng = np.random.default_rng(c + kk)
    k, v = (torch.from_numpy(rng.standard_normal((2, kk, c)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    cp = 16 if c < 16 else 64
    rows = -(-kk // 64) * 64
    before = ct_attention_prep_kv_bf16.launches
    for ones in (True, False):
        kp, vp = ct_attention_prep_kv_bf16(k, v, ones)
        assert kp.shape == vp.shape == (2, rows, cp)
        want_k = torch.zeros(2, rows, cp, dtype=torch.bfloat16)
        want_v = torch.zeros(2, rows, cp, dtype=torch.bfloat16)
        for r in range(rows):
            for col in range(cp):
                ch = col >> 3
                at = 8 * (ch ^ (r % 8) if cp == 64 else ch ^ ((r >> 2) & 1))
                at += col & 7
                if r < kk and col < c:
                    want_k[:, r, at] = k[:, r, col]
                    want_v[:, r, at] = v[:, r, col]
                elif ones and r < kk and col == c:
                    want_v[:, r, at] = 1
        assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
    assert ct_attention_prep_kv_bf16.launches == before


def test_bf16_refuses_mixed_types_gradients_and_training():
    """The bf16 path's refusals: mixed types and C = 64 (the walk's ones
    column). A gradient and a bf16 model in train mode are no longer
    refused: bf16 training runs (tests/test_torch_bf16_train.py)."""
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(BF16)
    q, k, v, base = mk(2, 15, 40), mk(2, 9, 15), mk(2, 9, 15), mk(2, 15, 40)
    wz = torch.zeros(15)
    with pytest.raises(TypeError, match="float32"):
        ct_attention_cm(q, k, v, base, wz.to(BF16))
    with pytest.raises(TypeError, match="bfloat16"):
        ct_attention_cm(q, k.float(), v, base, wz)
    with pytest.raises(ValueError, match="63 classes"):
        w = torch.zeros(2, 64, 40, dtype=BF16)
        kw = torch.zeros(2, 9, 64, dtype=BF16)
        ct_attention_cm(w, kw, kw, w, torch.zeros(64))
    # with a gradient to take, the training kernels refuse the same
    with pytest.raises(ValueError, match="63 classes"):
        ct_attention_cm(w.requires_grad_(), kw, kw, w, torch.zeros(64))
    with pytest.raises(TypeError, match="bfloat16"):
        ct_attention_cm(q.requires_grad_(), k.float(), v, base, wz)


@pytest.fixture(scope="module")
def incre():
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=21)
    x = np.random.default_rng(8).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    return dict(jtask=jtask, task=resolve_task(2, "incre", "ours", "VOC"),
                variables=variables, x=x)


# XLA keeps a bf16 value in float32 where the f32 ops that consume it
# allow (its excess precision): on the CPU backend a conv's f32 sums run
# into the float32 BN after it unrounded, where the flax model rounds the
# conv's output to bf16 first (measured: 28% of a BN's outputs a step
# apart). The JAX side is compiled without it, so that it rounds where its
# model's types say, as the port does.
STRICT = {"xla_allow_excess_precision": False}


def jax_apply(net, variables, x, variables_extra=None):
    fn = jax.jit(lambda v, xx: net.apply(v, xx, train=False))
    args = (dict(variables, **(variables_extra or {})), nhwc(x))
    with pltpu.force_tpu_interpret_mode():
        return fn.lower(*args).compile(compiler_options=STRICT)(*args)


def port_apply(net, x):
    with torch.inference_mode():
        return net(torch.from_numpy(x))


def test_bf16_model_matches_jax_size64(incre):
    jtask, variables, x = incre["jtask"], incre["variables"], incre["x"]
    ref32 = jax_apply(j_build_net(jtask, 64), variables, x)
    jnet = dataclasses.replace(j_build_net(jtask, 64, dtype=jnp.bfloat16),
                               use_pallas_ct=True)
    ref16 = jax_apply(jnet, variables, x)
    state = from_jax_variables(variables)
    nets = {}
    for dt in (torch.float32, BF16):
        nets[dt] = build_net(incre["task"], 64, device="cpu", dtype=dt)
        nets[dt].load_state_dict(state)
    ours16 = port_apply(nets[BF16], x)
    ours32 = port_apply(nets[torch.float32], x)
    for name in ("loc", "conf", "obj"):
        a = getattr(ours16, name)
        b = np.asarray(getattr(ref16, name))
        assert a.dtype == torch.float32 and b.dtype == np.float32, name
        effect = np.abs(b - np.asarray(getattr(ref32, name)))
        err = np.abs(a.numpy() - b)
        band = max(0.5 * effect.max(), bf16_step(np.abs(b).max()))
        assert err.max() <= band, (name, err.max(), effect.max())
        assert err.mean() <= 0.5 * effect.mean(), (name, err.mean(),
                                                   effect.mean())
        # the bands are narrower than the distance to the f32 model
        own = np.abs(a.numpy() - getattr(ours32, name).numpy())
        assert own.max() > 0.5 * effect.max(), (name, own.max())
        assert own.mean() > 0.5 * effect.mean(), (name, own.mean())


def test_bf16_int8_serving_matches_jax_size64(incre):
    jtask, variables, x = incre["jtask"], incre["variables"], incre["x"]
    folded = fold_variables(variables)
    fnet = dataclasses.replace(j_build_net(jtask, 64, dtype=jnp.bfloat16),
                               fold_bn=True)
    j_calib = j_calibrate(fnet, folded, [nhwc(x)])
    quant = j_quantize_variables(folded["params"], j_calib, J_SKIP_CT_ONLY,
                                 j_vgg_pool_chains(64))
    snet = dataclasses.replace(fnet, use_pallas_ct=True)
    ref = jax_apply(snet, folded, x, {"quant": quant})
    jconf, jobj = j_eval_scores(ref)

    # the port's own calibration of its bf16 folded model
    net = build_net(incre["task"], 64, device="cpu", dtype=BF16)
    net.load_state_dict(from_jax_variables(variables))
    own = calibrate(fold_bn(net), [torch.from_numpy(x)])
    jc = by_name(j_calib)
    assert set(own) == set(jc)
    for name, val in jc.items():
        assert abs(own[name].item() - float(val)) <= bf16_step(float(val)), \
            name

    snet_t = build_net(incre["task"], 64, device="cpu", fold_bn=True,
                       dtype=BF16)
    snet_t.load_state_dict(from_jax_variables(folded))
    attach(snet_t, quant_from_jax(quant))
    ours = port_apply(snet_t, x)
    with torch.inference_mode():
        conf, obj = eval_scores(ours)
    assert conf.dtype == obj.dtype == BF16
    assert jconf.dtype == jobj.dtype == jnp.bfloat16
    for name in ("loc", "obj", "conf_feat", "conf"):
        a = getattr(ours, name)
        b = getattr(ref, name)
        assert (a.dtype == BF16) == (b.dtype == jnp.bfloat16), name
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a - b) / np.abs(b).max()
        assert err.mean() <= SERVING_MEAN_TOL, (name, err.mean())
        assert err.max() <= SERVING_TOL[name], (name, err.max())


def bf16_tie_scores(rng, b, p, c):
    """bf16 (conf, obj) probabilities on a coarse grid of exact bf16
    values: their products tie within a class, across classes and at the
    cap's k-th score."""
    conf = rng.integers(1, 9, (b, p, c)).astype(np.float32) / 16.0
    fg = rng.integers(2, 9, (b, p)).astype(np.float32) / 8.0
    obj = np.stack([1.0 - fg, fg], -1).astype(np.float32)
    return (torch.from_numpy(conf).to(BF16), torch.from_numpy(obj).to(BF16))


@pytest.mark.parametrize("approx,pool,top_k", [(False, 0, 200),
                                               (True, 0, 200),
                                               (False, 512, 128),
                                               (True, 512, 128)])
def test_postprocess_on_bf16_ties_matches_jax(approx, pool, top_k):
    rng = np.random.default_rng(top_k + pool + approx)
    b, p, c = 2, 900, 20
    centers = rng.uniform(20, 280, (p, 2))
    sizes = rng.uniform(0.01, 0.1, (p, 2))
    priors = np.concatenate([centers / 300.0, sizes], -1).astype(np.float32)
    loc = (rng.standard_normal((b, p, 4)) * 0.1).astype(np.float32)
    conf, obj = bf16_tie_scores(rng, b, p, c)
    sizes_hw = np.array([[375, 500], [500, 333]], np.int32)
    kw = dict(top_k=top_k, approx_top_k=approx, pool_size=pool)
    ref = j_postprocess(jnp.asarray(loc), to_jax(conf), to_jax(obj),
                        jnp.asarray(priors), jnp.asarray(sizes_hw), **kw)
    ours = postprocess(torch.from_numpy(loc), conf, obj,
                       torch.from_numpy(priors), torch.from_numpy(sizes_hw),
                       **kw)
    # the cap keeps ties of its k-th score beyond the 200th detection
    assert ours.valid.sum(1).max() > 200
    # decode's exp: XLA's and PyTorch's agree to 2 ulp of f32
    np.testing.assert_allclose(ours.boxes.numpy(), np.asarray(ref.boxes),
                               rtol=1e-6, atol=0)
    ref = ref._replace(boxes=jnp.asarray(ours.boxes.numpy()),
                       scores=ref.scores.astype(jnp.float32))
    assert_dets_equal(ours, ref)


@pytest.mark.parametrize("flags", [
    ["--bf16"],
    ["--int8", "--int8-heads", "--calib-images", "2", "--bf16",
     "--approx-topk", "on", "--top-k", "128", "--pool-size", "512"]],
    ids=["bf16", "bench_serving_config"])
def test_eval_cli_bf16_on_a_small_voc_root(tmp_path, monkeypatch, flags):
    from ct_tpu_torch import test as cli

    monkeypatch.setenv("VOC_ROOT", _voc_root(tmp_path, 2, 2))
    save = str(tmp_path / "out")
    before = (ct_attention_cm_bf16.launches,
              ct_attention_serving_bf16.launches)
    res = cli.main(["-p", "2", "--setting", "incre", "--split", "1",
                    "--load-file", os.path.join(PARITY, "ref_model.pth"),
                    "--save-folder", save, "-b", "2", "--device", "cpu"]
                   + flags)
    # on the CPU the plain versions run, and no kernel launches
    assert (ct_attention_cm_bf16.launches,
            ct_attention_serving_bf16.launches) == before
    assert set(res) == {"mAP", "APs", "base_mAP", "novel_mAP"}
    with open(os.path.join(save, "inference", "speed.json")) as f:
        speed = json.load(f)
    assert speed["bf16"] and speed["int8"] == ("--int8" in flags)
    assert speed["images"] == 2 and speed["device"] == "cpu"
