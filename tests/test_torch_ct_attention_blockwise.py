"""The port's blockwise (non-flash) CT backward on the CPU vs the JAX package.

On CPU tensors ``ct_attention_cm_bwd`` takes its plain version (the CUDA
kernel runs only on the card: chip_smoke.py, tests/test_torch_cuda.py). It
is held to the JAX package's ``_bwd_call_cm`` (the Pallas kernel
``_bwd_kernel_cm``) in interpret mode at the sizes of
tests/test_ct_attention.py (B=2, P=300 = 128+128+44 at block_q 128, K=64,
C=15 and 60); ``ct_attention_cm(flash=False)``'s autograd gradients are
held to ``jax.grad`` through the JAX custom VJP with its flash switch off.
Bands are those of tests/test_ct_attention.py: 1e-5 on the forward, 1e-4
on the gradients.

The train CLI reads the reference's switch, ``CT_ATTENTION_FLASH``, on
every call of ``main``: two calls in one process, with the variable set to
0 and then unset, build the model with the matching backward and train
the same losses.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.ops import ct_attention as cta
from ct_tpu_torch.ops import ct_attention as ops
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_cm_bwd, ct_attention_cm_bwd_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODEL = os.path.join(REPO, ".parity_p2", "ref_model.pth")
SHAPES = [(15, 300, 64), (60, 300, 64), (15, 640, 96)]


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX at full float32 precision in its products: the comparison is of
    the algorithms in float32."""
    with jax.default_matmul_precision("highest"):
        yield


def make_inputs(seed, b, c, p, k):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, p), np.float32)
    kk = rng.standard_normal((b, k, c), np.float32)
    v = rng.standard_normal((b, k, c), np.float32)
    base = rng.standard_normal((b, c, p), np.float32)
    wz = rng.standard_normal((c,), np.float32) * 0.1
    g = rng.standard_normal((b, c, p), np.float32)
    return q, kk, v, base, wz, g


@pytest.mark.parametrize("c,p,k", SHAPES)
def test_blockwise_backward_matches_the_pallas_kernel(c, p, k):
    q, kk, v, _, wz, g = make_inputs(c + p + k, 2, c, p, k)
    before = ct_attention_cm_bwd.launches
    ours = ct_attention_cm_bwd(*map(torch.from_numpy, (q, kk, v, wz, g)))
    jq, jk, jv, jwz, jg = map(jnp.asarray, (q, kk, v, wz, g))
    ref = cta._bwd_call_cm(jq, jnp.moveaxis(jk, -1, 1),
                           jnp.moveaxis(jv, -1, 1), jwz, jg, 128, True)
    for name, a, r, to_rows in zip(("dq", "dk", "dv", "dwz"), ours, ref,
                                   (False, True, True, False)):
        r = np.asarray(r)
        r = np.moveaxis(r, 1, -1) if to_rows else r
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # a CPU tensor takes the plain version: no kernel launch
    assert ct_attention_cm_bwd.launches == before


@pytest.mark.parametrize("c,p,k", SHAPES[:2])
def test_autograd_matches_jax_grad_with_the_flash_switch_off(c, p, k):
    q, kk, v, base, wz, g = make_inputs(3 * c + k, 2, c, p, k)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    out = ct_attention_cm(*args, flash=False)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g))

    def loss(*a):
        return jnp.sum(cta.ct_attention_cm(*a, 128, True) * jnp.asarray(g))

    jargs = tuple(map(jnp.asarray, (q, kk, v, base, wz)))
    old = cta._USE_FLASH
    cta._USE_FLASH = False
    try:
        jout = cta.ct_attention_cm(*jargs, 128, True)
        jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    finally:
        cta._USE_FLASH = old
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for name, ours, ref in zip(("dq", "dk", "dv", "dbase", "dwz"), grads,
                               jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_each_backward_runs_its_plain_version(monkeypatch):
    """On the CPU ``flash`` picks the plain version of its backward: the
    flash one by default, the blockwise one with ``flash=False``; without
    a gradient both run the eval forward."""
    calls = []
    for name in ("ct_attention_cm_bwd_reference",
                 "ct_attention_cm_bwd_flash_reference"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    q, kk, v, base, wz, _ = make_inputs(5, 1, 15, 50, 9)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    for flash in (False, True):
        torch.autograd.grad(ct_attention_cm(*args, flash=flash).sum(), args)
        with torch.no_grad():
            assert ct_attention_cm(*args, flash=flash).grad_fn is None
    assert calls == ["ct_attention_cm_bwd_reference",
                     "ct_attention_cm_bwd_flash_reference"]


def test_plain_blockwise_backward_is_the_autograd_of_the_forward():
    q, kk, v, base, wz, g = map(torch.from_numpy,
                                make_inputs(6, 2, 7, 130, 65))
    args = [t.clone().requires_grad_() for t in (q, kk, v, wz)]
    out = ops.ct_attention_reference_cm(args[0], args[1], args[2], base,
                                        args[3])
    auto = torch.autograd.grad(out, args, g)
    for name, a, r in zip(("dq", "dk", "dv", "dwz"),
                          ct_attention_cm_bwd_reference(q, kk, v, wz, g),
                          auto):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_blockwise_backward_refuses_what_the_kernel_does_not_take():
    q, kk, v, _, wz, g = map(torch.from_numpy, make_inputs(4, 2, 15, 40, 9))
    with pytest.raises(ValueError, match="shapes"):
        ct_attention_cm_bwd(q, kk, v, wz, g[:, :, :39])
    with pytest.raises(TypeError, match="float32"):
        ct_attention_cm_bwd(q, kk, v, wz.double(), g)
    with pytest.raises(ValueError, match="no kernel"):
        ct_attention_cm_bwd(*(t.to("meta") for t in (q, kk, v, wz, g)))


@pytest.fixture
def two_threads():
    """The full-width CPU runs below take two intra-op threads: the suite
    runs several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_cli_reads_ct_attention_flash_on_every_call(
        tmp_path, monkeypatch, two_threads):
    from fixtures import make_mini_voc

    from ct_tpu_torch.models import rfbnet
    from ct_tpu_torch.train import cli

    built = []
    real_build = rfbnet.build_net

    def build_net(*args, **kw):
        net = real_build(*args, **kw)
        built.append(net.ct_flash)
        return net

    backwards = []
    for name in ("ct_attention_cm_bwd_reference",
                 "ct_attention_cm_bwd_flash_reference"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name: (
            backwards.append(_n), _r(*a))[1])
    monkeypatch.setattr(rfbnet, "build_net", build_net)
    monkeypatch.setenv("VOC_ROOT", make_mini_voc(str(tmp_path / "voc")))
    rows = {}
    for flag in ("0", None):
        if flag is None:
            monkeypatch.delenv("CT_ATTENTION_FLASH")
        else:
            monkeypatch.setenv("CT_ATTENTION_FLASH", flag)
        # the augmentation draws from Python's random: one loader thread
        # from one seed gives both calls the same batches
        random.seed(0)
        np.random.seed(0)
        rows[flag] = cli.main([
            "-d", "VOC", "-p", "2", "--setting", "incre", "--split", "1",
            "--shot", "1", "--init-iter", "1", "--max-iter", "2", "-b", "2",
            "--num-workers", "1", "--load-file", REF_MODEL,
            "--save-folder", str(tmp_path / f"w{flag}"), "--device", "cpu"])
        backwards.append("|")
    assert built == [False, True]
    assert backwards == ["ct_attention_cm_bwd_reference"] * 2 + ["|"] + [
        "ct_attention_cm_bwd_flash_reference"] * 2 + ["|"]
    for key in ("loss_box_reg", "loss_cls", "loss_obj", "total_loss"):
        assert np.isfinite(rows[None][key])
        np.testing.assert_allclose(rows["0"][key], rows[None][key],
                                   rtol=1e-5, err_msg=key)
