"""The precision argument of the CT attention backward's tensor-core kernels.

The dq and dk/dv kernels of ``ct_tpu_torch/csrc/ct_attention_cm_bwd.cu``
run their five products (the scores s = k·q, dattn = v·(g·wz), dq = ds·k,
dk = dsᵀ·q, dv = attnᵀ·g·wz) on the tensor cores in 3xTF32: each operand a
is split as big = a rounded to TF32 (to nearest, ties away, as
``cvt.rna.tf32.f32`` rounds) and small = a − big, which the tensor cores
read truncated to TF32, and a·b = small·big + big·small + big·big, summed
in float32. Here a torch emulation of that arithmetic (rounding to TF32 on
the mantissa bits, float32 sums) runs the flash backward at C=60 on
seeded inputs of the card check's scale (normal q, k, v, g; wz normal ×
0.1, so scores reach |s| ≈ 30), against the plain backward in float64:

* 3xTF32 stays within ``BWD_TOL``, the band the card check holds each
  backward kernel to (max |Δ| ≤ 1e-4 of each output's largest entry), with
  small truncated as the kernels leave it or rounded to nearest too;
* a single TF32 product (big·big only) lies outside it: an error of 2⁻¹¹
  in s moves attn by ~1%. So the band tells a kernel that drops the split
  from one that keeps it.

And the sums over all anchors (dk, dv) or keys (dq): the tensor cores
truncate their f32 accumulator at every m16n8k8 step, so a sum of thousands
of steps kept in the accumulator drifts (on the card, 2.3e-4 of dk's
largest entry at the 512 bench's 32,756 anchors); the kernels form each
step's product in a fresh accumulator and add it with a rounded f32 add.

The forwards (``ct_attention_cm.cu``) and the blockwise backward's stats
pass run the same arithmetic since they too moved to the tensor cores: the
scores in 3xTF32, an online softmax over tiles of 32 keys (the running max
and denominator, the accumulators rescaled when the max grows), and P·V in
3xTF32, each tile's product formed from zero and added to the running sum
with a rounded f32 add. Emulated here at the same C=60 inputs: out and
delta within ``KERNEL_TOL``, m within it, z relative within 1e-5, and the
stats pass's colsum within ``BWD_TOL`` of its largest entry; a single TF32
pass lies outside the band. The bfloat16-exponent variant's weights
e = bf16(exp(bf16(s - m))) have 8 significant bits, so their small part is
0 and e·v needs two products, not three, bit for bit.

The serving head (``ct_attention_serving.cu``) runs that walk too, after a
prologue that forms q = conf·(Wθ + I) + bθ on the tensor cores, and ends in
the residual, the ℓ2 norm and the classifier in float32. Emulated at C=60,
N=20 on the card check's serving inputs: within ``SERVING_TOL`` of the
largest score with the θ product in 3xTF32, and outside it with a single
TF32 θ product, which rounds conf (the residual folded into θ) itself by
2⁻¹¹.
"""

import functools

import numpy as np
import pytest
import torch

from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm_bwd_flash_reference, ct_attention_cm_stats_reference,
)

BWD_TOL = 1e-4    # chip_smoke.py's band for the backward kernels
KERNEL_TOL = 1e-4  # chip_smoke.py's band for the forward kernels
B, C, P, K = 1, 60, 4096, 1858
TILE = 32          # keys a tile of the forward's walk


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped
    bits' range to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits dropped, as the tensor cores read a
    TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_split(a, b, small=tf32_truncated):
    """a @ b in 3xTF32: big = tf32(x), small = ``small``(x - big); the small
    terms, then big × big, in float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = small(a - ah), small(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_split_rounded(a, b):
    """3xTF32 with small rounded to nearest as well."""
    return mm_split(a, b, small=tf32)


def mm_single(a, b):
    """a @ b with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def backward(q, k, v, wz, g, m, z, colsum, mm):
    """The flash backward as the kernels compute it, each product by
    ``mm``; q, g [B, C, P], k, v [B, K, C] → (dq, dk, dv)."""
    gw = g * wz[None, :, None]
    s = mm(k, q)                                  # [B, K, P]
    attn = torch.exp(s - m) * (1.0 / z)
    ds = attn * (mm(v, gw) - colsum)
    dq = mm(k.transpose(1, 2), ds)                # [B, C, P]
    dk = mm(ds, q.transpose(1, 2))                # [B, K, C]
    dv = mm(attn, g.transpose(1, 2)) * wz         # [B, K, C]
    return dq, dk, dv


@functools.cache
def inputs():
    """The seeded inputs at the card check's scale: q, k, v, g, wz."""
    rng = np.random.default_rng(0)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
    q, g = t(B, C, P), t(B, C, P)
    k, v = t(B, K, C), t(B, K, C)
    wz = t(C, scale=0.1)
    return q, k, v, g, wz


@functools.cache
def errors():
    """max |Δ| / max |plain f64| per output, for 3xTF32 and single TF32;
    and the largest |s|."""
    q, k, v, g, wz = inputs()
    with torch.no_grad():
        d64 = [x.double() for x in (q, k, v, g)]
        _, delta, m, z = ct_attention_cm_stats_reference(
            d64[0], d64[1], d64[2], torch.zeros_like(d64[0]), wz.double())
        colsum = (d64[3] * delta * wz.double()[None, :, None]).sum(
            dim=1, keepdim=True)
        ref = ct_attention_cm_bwd_flash_reference(
            d64[0], d64[1], d64[2], wz.double(), d64[3], m, z, colsum)
        stats = [x.float() for x in (m, z, colsum)]
        out = {}
        for name, mm in (("split", mm_split),
                         ("split_rounded", mm_split_rounded),
                         ("single", mm_single)):
            grads = backward(q, k, v, wz, g, *stats, mm)
            out[name] = {n: ((a.double() - r).abs().max()
                             / r.abs().max()).item()
                         for n, a, r in zip(("dq", "dk", "dv"), grads, ref)}
        s_max = torch.einsum("bkc,bcp->bkp", d64[1], d64[0]).abs().max()
    return out, s_max.item()


def truncated_to_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 x rounded toward zero to float32."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def stepwise_sum(a, b, rounded_adds: bool):
    """a @ b in float32 over the inner dimension in steps of 8, as a chain
    of m16n8k8 products takes it. Each step's sum of products is exact and
    rounded toward zero, as the tensor cores leave it; with
    ``rounded_adds`` it is formed from zero and added to the running sum
    with a rounded f32 add, else the running sum is the accumulator."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for n0 in range(0, a.shape[1], 8):
        prod = a[:, n0:n0 + 8].double() @ b[n0:n0 + 8].double()
        if rounded_adds:
            acc = acc + truncated_to_f32(prod)
        else:
            acc = truncated_to_f32(acc.double() + prod)
    return acc


def test_long_sums_take_each_product_with_a_rounded_add():
    # dv = attnᵀ g over the 32,756 anchors of the 512 bench (its inputs:
    # normal × 0.3), for 256 keys
    rng = np.random.default_rng(2)
    q, g = (torch.from_numpy(rng.standard_normal((32756, C)) * 0.3)
            for _ in range(2))
    k = torch.from_numpy(rng.standard_normal((256, C)) * 0.3)
    attn = torch.softmax(k @ q.T, dim=0)
    ref = attn @ g
    err = {}
    for rounded in (False, True):
        out = stepwise_sum(attn.float(), g.float(), rounded)
        err[rounded] = ((out.double() - ref).abs().max()
                        / ref.abs().max()).item()
    assert err[True] <= BWD_TOL / 10, err
    assert err[False] >= 20 * err[True], err


def test_tf32_rounds_to_nearest_on_the_mantissa():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11),
                      1.0 + 2.0**-12, 3.0])
    # ties away from zero; below half a TF32 step rounds down
    assert tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10,
                                -(1.0 + 2.0**-10), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    hi = tf32(y)
    assert ((hi - y).abs() <= 2.0**-11 * y.abs()).all()
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()


def test_inputs_reach_the_scores_that_need_the_split():
    _, s_max = errors()
    assert s_max > 20


@pytest.mark.parametrize("split", ["split", "split_rounded"])
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_three_pass_tf32_backward_is_within_the_band(grad, split):
    (out, _) = errors()
    assert out[split][grad] <= BWD_TOL, out


def test_single_pass_tf32_backward_is_outside_the_band():
    (out, _) = errors()
    assert max(out["single"].values()) > BWD_TOL, out
    # the scores' error reaches dq and dk through ds
    assert out["single"]["dq"] > 10 * out["split"]["dq"], out


def tile_product(a, b, split: bool):
    """a @ b over one tile's keys as the tensor cores leave it: the 3xTF32
    terms (or, without ``split``, the single TF32 one) summed exactly and
    rounded toward zero to f32."""
    ah, bh = tf32(a), tf32(b)
    prod = ah.double() @ bh.double()
    if split:
        al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
        prod = prod + al.double() @ bh.double() + ah.double() @ bl.double()
    return truncated_to_f32(prod)


def forward(q, k, v, mm):
    """The forward's walk as the kernels take it, one image: q [C, P], k,
    v [K, C] → (delta [C, P], m [P], z [P]). Tiles of 32 keys; the scores
    by ``mm``; the running max and denominator, the accumulators rescaled
    where the max grows; each tile's P·V in the same precision (3xTF32 with
    ``mm_split``, else single TF32), rounded toward zero to f32 (the tensor
    cores' accumulator) and added to the running sum with a rounded f32
    add."""
    m = torch.full((q.shape[1],), -torch.inf)
    z = torch.zeros(q.shape[1])
    o = torch.zeros(q.shape)
    for j0 in range(0, k.shape[0], TILE):
        s = mm(k[j0:j0 + TILE], q)                      # [n, P]
        grown = torch.maximum(m, s.amax(dim=0))
        corr = torch.where(grown > m, torch.exp(m - grown), 1.0)
        z, o, m = z * corr, o * corr, grown
        e = torch.exp(s - m)
        z = z + e.sum(dim=0)
        o = o + tile_product(v[j0:j0 + TILE].T, e, mm is mm_split)
    return o / z, m, z


@functools.cache
def forward_errors():
    """The forward's and the stats pass's outputs against float64, for
    3xTF32 and for single TF32: out and delta max |Δ|, m max |Δ|, z max
    relative |Δ|, colsum max |Δ| over its largest entry."""
    q, k, v, g, wz = (x[0] if x.dim() == 3 else x for x in inputs())
    with torch.no_grad():
        s64 = k.double() @ q.double()
        m64 = s64.amax(dim=0)
        e64 = torch.exp(s64 - m64)
        z64 = e64.sum(dim=0)
        delta64 = (v.double().T @ e64) / z64
        colsum64 = (g.double() * delta64 * wz.double()[:, None]).sum(dim=0)
        out = {}
        for name, mm in (("split", mm_split), ("single", mm_single)):
            delta, m, z = forward(q, k, v, mm)
            colsum = (g * delta * wz[:, None]).sum(dim=0)
            out[name] = {
                "out": ((delta * wz[:, None]).double()
                        - delta64 * wz.double()[:, None]).abs().max().item(),
                "delta": (delta.double() - delta64).abs().max().item(),
                "m": (m.double() - m64).abs().max().item(),
                "z": ((z.double() - z64).abs() / z64).max().item(),
                "colsum": ((colsum.double() - colsum64).abs().max()
                           / colsum64.abs().max()).item(),
            }
    return out


FORWARD_BANDS = {"out": KERNEL_TOL, "delta": KERNEL_TOL, "m": KERNEL_TOL,
                 "z": 1e-5, "colsum": BWD_TOL}


@pytest.mark.parametrize("output", sorted(FORWARD_BANDS))
def test_three_pass_tf32_forward_is_within_the_band(output):
    out = forward_errors()
    assert out["split"][output] <= FORWARD_BANDS[output], out


def test_single_pass_tf32_forward_is_outside_the_band():
    out = forward_errors()
    assert out["single"]["delta"] > KERNEL_TOL, out
    assert out["single"]["delta"] > 10 * out["split"]["delta"], out


def test_bf16_weights_need_two_products():
    # the weights of the bfloat16-exponent variant: their small part is 0,
    # so small·big drops out and e·v is e·v_lo + e·v_hi, bit for bit
    q, k, v, _, _ = (x[0] if x.dim() == 3 else x for x in inputs())
    s = mm_split(k[:TILE], q)
    x = (s - s.amax(dim=0)).to(torch.bfloat16).float()
    e = torch.exp(x).to(torch.bfloat16).float()
    assert torch.equal(tf32_truncated(e), e)
    assert torch.equal(tf32(e), e)
    assert not tf32_truncated(e - tf32(e)).any()
    vt = v[:TILE].T
    vh = tf32(vt)
    two = vh @ e + tf32_truncated(vt - vh) @ e
    assert torch.equal(mm_split(vt, e), two)


SERVING_TOL = 1e-4  # chip_smoke.py's band for the serving head
N_NOVEL = 20        # the transfer head's classifier (VOC's 20 classes)


def stepwise_split(a, b, split: bool = True):
    """a @ b as a chain of m16n8k8 products over the inner dimension in
    steps of 8, the accumulator kept across steps: per step the 3xTF32
    terms (small·big, big·small, big·big; or, without ``split``, big·big
    alone), each added exactly and rounded toward zero to f32, as the
    tensor cores leave their accumulator."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k0 in range(0, a.shape[1], 8):
        x, y = a[:, k0:k0 + 8], b[k0:k0 + 8]
        xh, yh = tf32(x), tf32(y)
        terms = [(xh, yh)]
        if split:
            terms = [(tf32_truncated(x - xh), yh),
                     (xh, tf32_truncated(y - yh)), (xh, yh)]
        for u, w in terms:
            acc = truncated_to_f32(acc + u.double() @ w.double()).double()
    return acc.float()


@functools.cache
def serving_errors():
    """The serving head as its kernel computes it, one image at C=60,
    N=20, on the card check's inputs (conf normal × 3, k × 0.3, v normal,
    Wθ × 0.2, bθ × 0.1, wz × 0.3, OBJ normal): q = conf·(Wθ + I) + bθ on
    the tensor cores (3xTF32, or a single TF32 product), the forward's walk
    in 3xTF32, the residual, the ℓ2 norm and the classifier in float32;
    max |Δ| over the largest score against float64."""
    rng = np.random.default_rng(5)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
    conf, k, v = t(C, P, scale=3.0), t(K, C, scale=0.3), t(K, C)
    wt, bt, wz = t(C, C, scale=0.2), t(C, scale=0.1), t(C, scale=0.3)
    obj = t(N_NOVEL, C)
    with torch.no_grad():
        d = [x.double() for x in (conf, k, v, wt, bt, wz, obj)]
        q64 = d[3].T @ d[0] + d[4][:, None] + d[0]
        s64 = d[1] @ q64
        e64 = torch.exp(s64 - s64.amax(dim=0))
        novel64 = d[0] + (d[2].T @ e64) / e64.sum(dim=0) * d[5][:, None]
        novel64 = novel64 / novel64.norm(dim=0)
        ref = d[6] @ novel64 * 5.0
        w1 = wt + torch.eye(C)
        out = {}
        for name, split in (("split", True), ("single", False)):
            # the θ product with anchors as rows: [P, C] @ [C, C]
            q = stepwise_split(conf.T, w1, split).T + bt[:, None]
            delta, _, _ = forward(q, k, v, mm_split)
            novel = conf + delta * wz[:, None]
            novel = novel * torch.rsqrt((novel * novel).sum(dim=0))
            score = obj @ novel * 5.0
            out[name] = ((score.double() - ref).abs().max()
                         / ref.abs().max()).item()
    return out


def test_three_pass_tf32_serving_head_is_within_the_band():
    out = serving_errors()
    assert out["split"] <= SERVING_TOL, out


def test_single_pass_tf32_theta_is_outside_the_serving_band():
    out = serving_errors()
    assert out["single"] > SERVING_TOL, out
    assert out["single"] > 10 * out["split"], out
