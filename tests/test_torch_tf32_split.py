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
"""

import functools

import numpy as np
import pytest
import torch

from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm_bwd_flash_reference, ct_attention_cm_stats_reference,
)

BWD_TOL = 1e-4    # chip_smoke.py's band for the backward kernels
B, C, P, K = 1, 60, 4096, 1858


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
def errors():
    """max |Δ| / max |plain f64| per output, for 3xTF32 and single TF32;
    and the largest |s|."""
    rng = np.random.default_rng(0)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
    q, g = t(B, C, P), t(B, C, P)
    k, v = t(B, K, C), t(B, K, C)
    wz = t(C, scale=0.1)
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
