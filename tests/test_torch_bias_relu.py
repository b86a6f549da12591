"""The port's bias+ReLU backward on the CPU vs the JAX bench's math.

On CPU tensors ``bias_relu_bwd`` takes its plain version (the CUDA kernel
runs only on the card: chip_smoke.py, tests/test_torch_cuda.py). It is held
to ``xla_ref`` of ``scripts/bench_bias_relu_bwd.py``, the reference that
bench holds its Pallas kernel to, run on the NHWC transpose of the same
inputs: the mask bit for bit, dbias at rtol 1e-5 (atol 1e-5 of the
channel's Σ|masked|, for sums that cancel), at shapes whose planes are
and are not a multiple of 4 long, with ties at y = 0 and a -0.0 in g.
The ported bench runs on the CPU at tiny sizes and prints its lines.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu_torch.ops.bias_relu import bias_relu_bwd, bias_relu_bwd_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_bias_relu_bwd",
        os.path.join(REPO, "scripts", "bench_bias_relu_bwd.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(seed, shape):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    g.flat[0] = -0.0
    y = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    return g, y


@pytest.mark.parametrize("shape", [(2, 8, 30, 30), (3, 5, 7, 9),
                                   (1, 16, 38, 38)])
def test_matches_the_jax_bench_reference(shape):
    g, y = inputs(sum(shape), shape)
    before = bias_relu_bwd.launches
    masked, dbias = bias_relu_bwd(torch.from_numpy(g), torch.from_numpy(y))
    to_nhwc = (0, 2, 3, 1)
    ref_masked, ref_dbias = jax_bench().xla_ref(
        jnp.asarray(g.transpose(to_nhwc)), jnp.asarray(y.transpose(to_nhwc)))
    ref_masked = np.asarray(ref_masked).transpose(0, 3, 1, 2)
    assert masked.dtype == torch.float32 and dbias.shape == (shape[1],)
    np.testing.assert_array_equal(masked.numpy().view(np.uint32),
                                  ref_masked.view(np.uint32))
    scale = np.abs(ref_masked).sum(axis=(0, 2, 3))
    assert (np.abs(dbias.numpy() - np.asarray(ref_dbias))
            <= 1e-5 * np.abs(np.asarray(ref_dbias)) + 1e-5 * scale).all()
    # a CPU tensor takes the plain version: no kernel launch
    assert bias_relu_bwd.launches == before


def test_plain_version_is_the_autograd_of_bias_relu():
    g, y = map(torch.from_numpy, inputs(1, (2, 4, 6, 6)))
    x = torch.randn(2, 4, 6, 6, generator=torch.Generator().manual_seed(0))
    x[0, 0, 0, :3] = torch.tensor([0.0, -0.0, 1e-30])
    bias = torch.zeros(4, requires_grad=True)
    xr = x.clone().requires_grad_()
    out = torch.relu(xr + bias[None, :, None, None])
    out.backward(g)
    masked, dbias = bias_relu_bwd_reference(g, out.detach())
    torch.testing.assert_close(masked, xr.grad, rtol=0, atol=0)
    torch.testing.assert_close(dbias, bias.grad)


def test_refuses_what_the_kernel_does_not_take():
    g, y = map(torch.from_numpy, inputs(2, (2, 3, 4, 4)))
    with pytest.raises(TypeError, match="float32"):
        bias_relu_bwd(g.double(), y)
    with pytest.raises(ValueError, match="NCHW"):
        bias_relu_bwd(g[0], y[0])
    with pytest.raises(ValueError, match="NCHW"):
        bias_relu_bwd(g, y[:, :2])
    with pytest.raises(ValueError, match="planes"):
        bias_relu_bwd(g[:, :0], y[:, :0])
    with pytest.raises(ValueError, match="no kernel"):
        bias_relu_bwd(g.to("meta"), y.to("meta"))


def test_bench_runs_on_the_cpu(capsys):
    from ct_tpu_torch.scripts import bench_bias_relu_bwd

    res = bench_bias_relu_bwd.main(["--device", "cpu", "--iters", "1",
                                    "--shape", "2", "3", "8", "8",
                                    "--shape", "1", "2", "5", "7"])
    out = capsys.readouterr().out
    assert "(2, 3, 8, 8)" in out and "(1, 2, 5, 7)" in out
    assert out.count("library") == 2 and len(res) == 2
    assert bench_bias_relu_bwd.SHAPES[0] == (64, 64, 300, 300)
