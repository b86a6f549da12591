"""The port's row-major CT attention and its bench variants on the CPU vs
the JAX package.

On CPU tensors ``ct_attention``, ``ct_attention_bwd`` and
``ct_attention_variant`` take their plain versions (the CUDA kernels run
only on the card: chip_smoke.py, tests/test_torch_cuda.py):

* the forward against the JAX package's ``ct_attention`` (the Pallas
  kernel ``_kernel``) at block_q 128 in interpret mode, and its autograd
  gradients against ``jax.grad`` of it, whose custom VJP runs
  ``ct_attention_bwd_pallas`` in interpret mode; ``ct_attention_bwd``
  against ``ct_attention_bwd_pallas`` directly; at the sizes of
  tests/test_ct_attention.py (B=2, P=300 = 128+128+44, K=64, C=15 and 60).
  Bands: 1e-5 on the forward, 1e-4 on the gradients, as there;
* the bench's variants (``make_variant``): the bfloat16 one
  (``ct_attention_variant``, the exponential rounded as a bfloat16 one)
  against the same math written in ``jnp`` (the JAX bench's
  ``jnp.exp(x.astype(bfloat16))``), and the float32 one (``ct_attention``)
  against ``ct_attention_reference``; 1e-5;
* the three ported benches and the bf16 backwards' bench run on the CPU at
  tiny sizes and print their lines (the attention benches here, the
  forward one on bf16 inputs with its three variant bodies and in float32
  with two; the bias+ReLU one in tests/test_torch_bias_relu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.ops import ct_attention as cta
from ct_tpu_torch.ops.ct_attention import (
    ct_attention, ct_attention_bwd, ct_attention_variant,
    ct_attention_variant_reference,
)

SHAPES = [(15, 300, 64), (60, 300, 64)]


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX at full float32 precision in its products: the comparison is of
    the algorithms in float32."""
    with jax.default_matmul_precision("highest"):
        yield


def make_inputs(seed, b, c, p, k, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, p, c), np.float32) * scale
    kk = rng.standard_normal((b, k, c), np.float32) * scale
    v = rng.standard_normal((b, k, c), np.float32) * scale
    base = rng.standard_normal((b, p, c), np.float32)
    wz = rng.standard_normal((c,), np.float32) * 0.1
    g = rng.standard_normal((b, p, c), np.float32)
    return q, kk, v, base, wz, g


@pytest.mark.parametrize("c,p,k", SHAPES)
def test_forward_and_gradients_match_the_pallas_kernels(c, p, k):
    q, kk, v, base, wz, g = make_inputs(c + p + k, 2, c, p, k)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    before = (ct_attention.launches, ct_attention_bwd.launches)
    out = ct_attention(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g))

    jargs = tuple(map(jnp.asarray, (q, kk, v, base, wz)))
    jout = cta.ct_attention(*jargs, 128, True)

    def loss(*a):
        return jnp.sum(cta.ct_attention(*a, 128, True) * jnp.asarray(g))

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    assert out.shape == (2, p, c)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for name, ours, ref in zip(("dq", "dk", "dv", "dbase", "dwz"), grads,
                               jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # CPU tensors take the plain versions: no kernel launch
    assert (ct_attention.launches, ct_attention_bwd.launches) == before


@pytest.mark.parametrize("c,p,k", SHAPES)
def test_backward_matches_ct_attention_bwd_pallas(c, p, k):
    q, kk, v, _, wz, g = make_inputs(7 * c + p, 2, c, p, k)
    ours = ct_attention_bwd(*map(torch.from_numpy, (q, kk, v, wz, g)))
    ref = cta.ct_attention_bwd_pallas(*map(jnp.asarray, (q, kk, v, wz, g)),
                                      128, True)
    for name, a, r in zip(("dq", "dk", "dv", "dwz"), ours, ref):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_no_grad_call_takes_the_forward_alone():
    q, kk, v, base, wz, _ = make_inputs(3, 1, 15, 50, 9)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    with torch.no_grad():
        assert ct_attention(*args).grad_fn is None
    assert ct_attention(*args).grad_fn is not None


def test_rowmajor_wrappers_refuse_what_the_kernels_do_not_take():
    q, kk, v, base, wz, g = map(torch.from_numpy,
                                make_inputs(4, 2, 15, 40, 9))
    with pytest.raises(ValueError, match="shapes"):
        ct_attention(q, kk, v, base.transpose(1, 2), wz)
    with pytest.raises(ValueError, match="B, P, C"):
        ct_attention_bwd(q[0], kk, v, wz, g)
    with pytest.raises(TypeError, match="float32"):
        ct_attention_variant(q.double(), kk, v, base, wz)
    with pytest.raises(ValueError, match="65"):
        w = torch.zeros(2, 40, 65)
        ct_attention(w, torch.zeros(2, 9, 65), torch.zeros(2, 9, 65), w,
                     torch.zeros(65))


def jnp_variant(q, k, v, base, wz):
    """The JAX bench's variant kernel in ``jnp``: the exponential of
    (s - max s) taken on a bfloat16 argument and rounded to bfloat16."""
    s = jnp.einsum("bpc,bkc->bpk", q, k)
    e = jnp.exp((s - jnp.max(s, -1, keepdims=True)).astype(jnp.bfloat16))
    e = e.astype(jnp.float32)
    delta = jnp.einsum("bpk,bkc->bpc", e, v) / jnp.sum(e, -1, keepdims=True)
    return base + delta * wz


@pytest.mark.parametrize("c,p,k", SHAPES)
def test_variant_matches_the_bench_math(c, p, k):
    # the bench's inputs: normal × 0.3
    q, kk, v, base, wz, _ = make_inputs(c * k, 2, c, p, k, scale=0.3)
    from ct_tpu_torch.scripts.bench_ct_attention import make_variant

    t = tuple(map(torch.from_numpy, (q, kk, v, base, wz)))
    before = (ct_attention.launches, ct_attention_variant.launches)
    bf16 = make_variant(torch.bfloat16, 512)(*t)
    np.testing.assert_allclose(
        bf16.numpy(), np.asarray(jnp_variant(*map(jnp.asarray, (q, kk, v,
                                                                 base, wz)))),
        rtol=1e-5, atol=1e-5)
    f32 = make_variant(torch.float32, 512)(*t)
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(cta.ct_attention_reference(
            *map(jnp.asarray, (q, kk, v, base, wz)))), rtol=1e-5, atol=1e-5)
    # the bfloat16 rounding moves the output, the float32 one does not
    assert (bf16 - f32).abs().max().item() > 1e-5
    torch.testing.assert_close(bf16, ct_attention_variant_reference(*t))
    assert (ct_attention.launches, ct_attention_variant.launches) == before


def test_make_variant_keeps_its_options():
    from ct_tpu_torch.scripts.bench_ct_attention import make_variant

    fn = make_variant(torch.bfloat16, 1024, fuse_denom=True)
    assert (fn.exp_dtype, fn.block_q, fn.fuse_denom) == (torch.bfloat16,
                                                         1024, True)
    q, kk, v, base, wz, _ = map(torch.from_numpy,
                                make_inputs(2, 1, 15, 30, 7, 0.3))
    torch.testing.assert_close(
        fn(q, kk, v, base, wz),
        ct_attention_variant_reference(q, kk, v, base, wz))
    torch.testing.assert_close(
        make_variant(torch.float32, 2048)(q, kk, v, base, wz),
        ct_attention(q, kk, v, base, wz))
    with pytest.raises(ValueError, match="exp_dtype"):
        make_variant(torch.float16, 512)


def test_attention_benches_run_on_the_cpu(capsys):
    from ct_tpu_torch.scripts import bench_ct_attention, bench_ct_bwd

    tiny = ["--device", "cpu", "--iters", "1", "--batch", "1", "--anchors",
            "130", "--keys", "33", "--classes", "15"]
    # on bf16 inputs (the default, as the JAX bench's) three bodies: the
    # float32 exponential fused (the production kernel's function) and
    # unfused (its own denominator), and the bfloat16 one; in float32 two,
    # fuse_denom changing nothing; together they stand for all 12 variants
    for dtype, want in (("bfloat16", [("float32", [True], 3),
                                      ("float32", [False], 3),
                                      ("bfloat16", [False, True], 6)]),
                        ("float32", [("float32", [False, True], 6),
                                     ("bfloat16", [False, True], 6)])):
        res = bench_ct_attention.main(tiny + ["--dtype", dtype])
        out = capsys.readouterr().out
        assert "production kernel" in out
        assert out.count("exp=") == len(want) and "no counterpart" in out
        assert [(r["exp_dtype"], r["fuse_denom"],
                 len(r["fuse_denom"]) * len(r["block_q"]))
                for r in res["variants"]] == want
        assert res["variants"][0]["max_abs_err"] <= 1e-6
    # the backward bench on bf16 inputs (its default, as the JAX bench's)
    # and in float32: in float32 the blockwise and flash backwards agree
    # to 1e-5; in bf16 they round at other points (a reading), and on the
    # CPU each wrapper is its plain version
    for size, dtype in (("300", "float32"), ("512", "float32"),
                        ("300", "bfloat16")):
        res = bench_ct_bwd.main(tiny + ["--size", size, "--dtype", dtype])
        out = capsys.readouterr().out
        for line in ("row-major bwd", "class-major bwd", "cm fwd (stats)",
                     "cm bwd (flash)", "plain check at batch 1"):
            assert line in out, line
        assert res["dtype"] == dtype
        if dtype == "float32":
            assert max(e["rel"] for e in
                       res["blockwise_vs_flash"].values()) <= 1e-5
        else:
            assert all(e["max_abs_err"] == 0
                       for check in ("rowmajor_vs_plain",
                                     "classmajor_vs_plain", "flash_vs_plain")
                       for e in res[check].values())


def test_bwd_bf16_bench_runs_on_the_cpu(capsys, tmp_path):
    """The bf16 backwards' bench (rows 3, 4 and 5's backward, both widths)
    at a tiny size: one record a row and width, printed and in its JSON
    file; on the CPU each wrapper is its plain version (no error) and no
    kernel split is taken."""
    import json

    from ct_tpu_torch.scripts import bench_bwd_bf16

    out = tmp_path / "bwd.json"
    res = bench_bwd_bf16.main(["--device", "cpu", "--iters", "1", "--batch",
                               "1", "--anchors", "130", "--keys", "65",
                               "--widths", "15", "60", "--json", str(out)])
    assert [(r["row"], r["C"]) for r in res["rows"]] == [
        (row, c) for c in (15, 60) for row in ("3", "4", "5 bwd")]
    assert all(e["max_rel"] == 0 and e["mean_rel"] == 0
               for r in res["rows"] for e in r["errors"].values())
    assert all("kernels_ms" not in r for r in res["rows"])
    assert capsys.readouterr().out.count('"row"') == 6
    assert json.loads(out.read_text())["rows"] == res["rows"]


def test_fwd_bf16_bench_runs_on_the_cpu(capsys, tmp_path):
    """The bf16 forwards' bench (rows 1, 2 and 6 at both widths, 6 again at
    the bench's batch, 5's forward, 10 and 10's unfused body at the
    widest) at a tiny size: one record a row and width, printed and in its
    JSON file; on the CPU each wrapper is its plain version (no error) and
    no library time or kernel split is taken. Row 6 at a bench batch of 9
    holds its first 8 images to the plain version."""
    import json

    from ct_tpu_torch.scripts import bench_fwd_bf16

    out = tmp_path / "fwd.json"
    res = bench_fwd_bf16.main(["--device", "cpu", "--iters", "1",
                               "--batches", "1", "2", "9", "--anchors", "130",
                               "--keys", "65", "--widths", "15", "60",
                               "--json", str(out)])
    assert [(r["row"], r["C"], r["B"]) for r in res["rows"]] == [
        ("1", 15, 1), ("2", 15, 2), ("6", 15, 1), ("1", 60, 1), ("2", 60, 2),
        ("6", 60, 1), ("6", 60, 9), ("5 fwd", 60, 9), ("10", 60, 9),
        ("10 unfused", 60, 9)]
    assert all(v == 0 for r in res["rows"] for e in r["errors"].values()
               for v in e.values())
    assert [sorted(r["errors"]) for r in res["rows"][:3]] == [
        ["out"], ["delta", "m", "out", "z"], ["out"]]
    assert [r.get("held_images") for r in res["rows"]][5:7] == [None, 8]
    assert all("library_ms" not in r and "kernels_ms" not in r
               for r in res["rows"])
    assert capsys.readouterr().out.count('"row"') == 10
    assert json.loads(out.read_text())["rows"] == res["rows"]
