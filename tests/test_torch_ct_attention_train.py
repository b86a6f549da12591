"""The port's training CT attention on the CPU vs the JAX package.

On CPU tensors ``ct_attention_cm_stats`` and ``ct_attention_cm_bwd_flash``
take their plain versions (the CUDA kernels run only on the card:
chip_smoke.py, tests/test_torch_cuda.py). They are held to the JAX
package's Pallas kernels run in interpret mode — ``ct_attention_cm_stats``
and ``_bwd_call_cm_flash`` — at the sizes of tests/test_ct_attention.py
(B=2, P=640, K=96, C=15 and 60) and at P and K that fill no tile; the
autograd Function behind ``ct_attention_cm`` is held to ``jax.grad`` of
``ct_attention_reference_cm``. Bands are those of tests/test_ct_attention.py:
1e-5 on the forward and the softmax statistics, 1e-4 on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.ops import ct_attention as cta
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_cm_bwd_flash, ct_attention_cm_stats,
)

SHAPES = [(15, 640, 96), (60, 640, 96), (15, 333, 70), (60, 130, 1500)]


@pytest.fixture(autouse=True)
def _f32_dots():
    """JAX at full float32 precision in its products: the comparison is of
    the algorithms in float32, and a DEFAULT-precision product on the CPU
    backend is not guaranteed to be a full float32 one."""
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
def test_stats_forward_and_flash_backward_match_jax_kernels(c, p, k):
    q, kk, v, base, wz, g = make_inputs(c + p, 2, c, p, k)
    t = lambda a: torch.from_numpy(a)
    before = (ct_attention_cm_stats.launches,
              ct_attention_cm_bwd_flash.launches)
    out, delta, m, z = ct_attention_cm_stats(t(q), t(kk), t(v), t(base),
                                             t(wz))
    jq, jk, jv, jbase, jwz, jg = map(jnp.asarray, (q, kk, v, base, wz, g))
    jout, jdelta, jm, jz = cta.ct_attention_cm_stats(jq, jk, jv, jbase, jwz,
                                                     128, True)
    for ours, ref in ((out, jout), (delta, jdelta), (m, jm), (z, jz)):
        assert tuple(ours.shape) == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    gd = t(g) * delta
    colsum = (gd * t(wz)[None, :, None]).sum(dim=1, keepdim=True)
    dq, dk, dv = ct_attention_cm_bwd_flash(t(q), t(kk), t(v), t(wz), t(g),
                                           m, z, colsum)
    jdq, jdk, jdv, jdwz = cta._bwd_call_cm_flash(
        jq, jnp.moveaxis(jk, -1, 1), jnp.moveaxis(jv, -1, 1), jwz, jg,
        jdelta, jm, jz, 128, True)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), np.moveaxis(np.asarray(jdk), 1, -1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), np.moveaxis(np.asarray(jdv), 1, -1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gd.sum(dim=(0, 2)).numpy(), np.asarray(jdwz),
                               rtol=1e-4, atol=1e-4)
    # CPU tensors take the plain versions: no kernel launch
    assert (ct_attention_cm_stats.launches,
            ct_attention_cm_bwd_flash.launches) == before


@pytest.mark.parametrize("c,p,k", SHAPES[:3])
def test_autograd_matches_jax_grad_of_reference(c, p, k):
    q, kk, v, base, wz, g = make_inputs(7 * c + k, 2, c, p, k)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    out = ct_attention_cm(*args)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g))

    def loss(*a):
        return jnp.sum(cta.ct_attention_reference_cm(*a) * jnp.asarray(g))

    jout = cta.ct_attention_reference_cm(*map(jnp.asarray, (q, kk, v, base,
                                                            wz)))
    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, kk, v, base, wz)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for name, ours, ref in zip(("dq", "dk", "dv", "dbase", "dwz"), grads,
                               jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_no_grad_call_takes_the_eval_path():
    q, kk, v, base, wz, _ = make_inputs(3, 1, 15, 50, 9)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, kk, v, base,
                                                           wz)]
    with torch.no_grad():
        out = ct_attention_cm(*args)
    assert out.grad_fn is None
    assert ct_attention_cm(*args).grad_fn is not None


def test_flash_backward_refuses_bad_statistics():
    q, kk, v, _, wz, g = map(torch.from_numpy, make_inputs(4, 2, 15, 40, 9))
    ok = torch.ones(2, 1, 40)
    with pytest.raises(ValueError, match="colsum"):
        ct_attention_cm_bwd_flash(q, kk, v, wz, g, ok, ok, ok[:, :, :39])
    with pytest.raises(ValueError, match="m must be"):
        ct_attention_cm_bwd_flash(q, kk, v, wz, g, ok.double(), ok, ok)
