"""The port's ``ct_attention_cm`` on the CPU vs the JAX package.

On a CPU tensor the wrapper takes its plain version; it is held to the
Pallas kernel run in interpret mode and to the JAX reference, at the
incre (C=15) and transfer (C=60) widths with P and K that fill no tile.
Tolerance 1e-5, the band of tests/test_ct_attention.py. The CUDA kernel
itself runs only on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ct_tpu.ops.ct_attention import ct_attention_cm as j_ct_attention_cm
from ct_tpu.ops.ct_attention import (
    ct_attention_reference_cm as j_reference_cm,
)
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_reference_cm,
)


def make_inputs(seed, b, c, p, k):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, p), np.float32)
    kk = rng.standard_normal((b, k, c), np.float32)
    v = rng.standard_normal((b, k, c), np.float32)
    base = rng.standard_normal((b, c, p), np.float32)
    wz = rng.standard_normal((c,), np.float32) * 0.1
    return q, kk, v, base, wz


@pytest.mark.parametrize("c,p,k", [(15, 500, 97), (60, 300, 130)])
def test_matches_jax_kernel_and_reference(c, p, k):
    args = make_inputs(c, 2, c, p, k)
    launches = ct_attention_cm.launches
    ours = ct_attention_cm(*map(torch.from_numpy, args))
    assert ct_attention_cm.launches == launches   # CPU: no kernel launch
    assert ours.shape == (2, c, p) and ours.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    pallas = j_ct_attention_cm(*jargs, 256, True)   # interpret on CPU
    ref = j_reference_cm(*jargs)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ct_attention_reference_cm(*map(torch.from_numpy, args)).numpy(),
        np.asarray(ref), rtol=1e-5, atol=1e-5)


def _bad_inputs():
    q, k, v, base, wz = map(torch.from_numpy, make_inputs(0, 2, 15, 40, 9))
    yield "dtype", (TypeError, "float32"), (q.double(), k, v, base, wz)
    yield "wz dtype", (TypeError, "float32"), (q, k, v, base, wz.half())
    yield "k width", (ValueError, "shapes"), (q, k[..., :14], v, base, wz)
    yield "v keys", (ValueError, "shapes"), (q, k, v[:, :8], base, wz)
    yield "base", (ValueError, "shapes"), (q, k, v, base[:, :, :39], wz)
    yield "wz", (ValueError, "shapes"), (q, k, v, base, wz[:14])
    yield "rank", (ValueError, "B, C, P"), (q[0], k, v, base, wz)
    yield "empty", (ValueError, "empty"), (q[:, :, :0], k, v,
                                            base[:, :, :0], wz)
    w = torch.zeros(2, 65, 40)
    kw = torch.zeros(2, 9, 65)
    yield "too wide", (ValueError, "65"), (w, kw, kw, w, torch.zeros(65))
    meta = [t.to("meta") for t in (q, k, v, base, wz)]
    yield "device", (ValueError, "no kernel"), tuple(meta)


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _, (exc, msg), args = case
    with pytest.raises(exc, match=msg):
        ct_attention_cm(*args)
