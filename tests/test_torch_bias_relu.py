"""The port's bias+ReLU backward on the CPU vs the JAX bench's math.

On CPU tensors ``bias_relu_bwd`` takes its plain version (the CUDA kernel
runs only on the card: chip_smoke.py, tests/test_torch_cuda.py). It is held
to ``xla_ref`` of ``scripts/bench_bias_relu_bwd.py``, the reference that
bench holds its Pallas kernel to, run on the NHWC transpose of the same
inputs: the mask bit for bit, dbias at rtol 1e-5 (atol 1e-5 of the
channel's Σ|masked|, for sums that cancel), at shapes whose planes are
and are not a multiple of 4 long, with ties at y = 0 and a -0.0 in g.

bfloat16, the type the JAX bench feeds its kernel: the port's bf16 path
against the bench's Pallas kernel itself (``bias_relu_bwd_pallas`` at
block_rows 256, in interpret mode) and against ``xla_ref``, on bf16
inputs, at shapes whose N·H·W rows are and are not a multiple of 256 and
whose planes are 8k, 4k (not 8k) and odd long (the kernel's 16-, 8- and
2-byte loads), with ties at y = 0, a -0.0 in y and a -0.0 in g where
y > 0: masked bf16 and bit for bit (uint16 view), dbias float32 in the
band above. A bf16 sum of the masked values (``masked.sum()`` on the
bf16 tensor) misses that band, so the test tells the two apart. Mixed
types are refused. The ported bench runs on the CPU at tiny sizes, on
bf16 (its default) and float32, and prints its lines.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from ct_tpu_torch.ops.bias_relu import (
    bias_relu_bwd, bias_relu_bwd_bf16, bias_relu_bwd_reference,
)

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


TO_NHWC, TO_NCHW = (0, 2, 3, 1), (0, 3, 1, 2)


def bf16_inputs(seed, shape):
    """bf16 g and y (torch, NCHW) as the JAX bench draws them, with ties
    at y = 0, a -0.0 in y and a -0.0 in g where y > 0."""
    g, y = inputs(seed, shape)
    y.flat[0] = 1.0          # g's -0.0 passes through
    y.flat[1] = -0.0         # and a -0.0 in y masks
    return (torch.from_numpy(g).to(torch.bfloat16),
            torch.from_numpy(y).to(torch.bfloat16))


def jax_bf16(t):
    """A bf16 torch NCHW tensor → the JAX bench's bf16 NHWC array."""
    return jnp.asarray(t.float().numpy().transpose(TO_NHWC), jnp.bfloat16)


def bits(a):
    return np.asarray(a).view(np.uint16)


def within_dbias_band(ours, ref, masked):
    """|Δ| ≤ 1e-5·|ref| + 1e-5·Σ|masked| per channel (the file's band)."""
    scale = np.abs(np.asarray(masked, np.float32)).sum(axis=(0, 2, 3))
    ref = np.asarray(ref)
    return np.abs(np.asarray(ours) - ref) <= 1e-5 * np.abs(ref) + 1e-5 * scale


# N·H·W rows: 512 and 1,800 against block_rows 256 (a multiple, not);
# planes H·W 256 (8k), 900 (4k, not 8k) and 63 (odd)
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (2, 8, 30, 30),
                                   (3, 5, 7, 9)])
def test_bf16_matches_the_jax_kernel(shape):
    g, y = bf16_inputs(sum(shape) + 1, shape)
    before = (bias_relu_bwd.launches, bias_relu_bwd_bf16.launches)
    masked, dbias = bias_relu_bwd(g, y)
    assert masked.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    assert (bias_relu_bwd.launches, bias_relu_bwd_bf16.launches) == before
    ours = masked.view(torch.int16).numpy().view(np.uint16)
    bench = jax_bench()
    with pltpu.force_tpu_interpret_mode():
        k_masked, k_dbias = bench.bias_relu_bwd_pallas(
            jax_bf16(g), jax_bf16(y), block_rows=256)
    x_masked, x_dbias = bench.xla_ref(jax_bf16(g), jax_bf16(y))
    for ref_masked, ref_dbias in ((k_masked, k_dbias), (x_masked, x_dbias)):
        assert ref_masked.dtype == jnp.bfloat16
        assert ref_dbias.dtype == jnp.float32
        np.testing.assert_array_equal(
            ours, bits(ref_masked).transpose(TO_NCHW))
        assert within_dbias_band(dbias.numpy(), ref_dbias,
                                 masked.float().numpy()).all()
    # the -0.0 of g where y > 0 kept its sign; the -0.0 of y masked to +0.0
    assert ours.flat[0] == 0x8000 and ours.flat[1] == 0


def test_bf16_sum_misses_the_band():
    """The trap of a bf16 plain version: ``masked.sum()`` on a bf16 tensor
    returns a bf16 sum, 8 significant bits, far outside the band that the
    float32 sum of the JAX kernel meets."""
    g, y = bf16_inputs(7, (2, 8, 30, 30))
    masked, dbias = bias_relu_bwd_reference(g, y)
    _, ref_dbias = jax_bench().xla_ref(jax_bf16(g), jax_bf16(y))
    m = masked.float().numpy()
    assert within_dbias_band(dbias.numpy(), ref_dbias, m).all()
    bf16_sum = masked.sum(dim=(0, 2, 3)).float().numpy()
    assert masked.sum(dim=(0, 2, 3)).dtype == torch.bfloat16
    assert not within_dbias_band(bf16_sum, ref_dbias, m).all()


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
    # mixed types: bf16 g with float32 y, and the other way round
    with pytest.raises(TypeError, match="one type"):
        bias_relu_bwd(g.bfloat16(), y)
    with pytest.raises(TypeError, match="one type"):
        bias_relu_bwd(g, y.bfloat16())
    with pytest.raises(TypeError, match="bfloat16 kernel"):
        bias_relu_bwd_bf16(g, y)
    with pytest.raises(ValueError, match="NCHW"):
        bias_relu_bwd(g[0], y[0])
    with pytest.raises(ValueError, match="NCHW"):
        bias_relu_bwd(g, y[:, :2])
    with pytest.raises(ValueError, match="planes"):
        bias_relu_bwd(g[:, :0], y[:, :0])
    with pytest.raises(ValueError, match="no kernel"):
        bias_relu_bwd(g.to("meta"), y.to("meta"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_runs_on_the_cpu(capsys, dtype):
    from ct_tpu_torch.scripts import bench_bias_relu_bwd

    argv = ["--device", "cpu", "--iters", "1", "--shape", "2", "3", "8", "8",
            "--shape", "1", "2", "5", "7"]
    if dtype == "float32":
        argv += ["--dtype", "float32"]
    res = bench_bias_relu_bwd.main(argv)
    out = capsys.readouterr().out
    assert f"cpu {dtype}" in out
    assert "(2, 3, 8, 8)" in out and "(1, 2, 5, 7)" in out
    assert out.count("library") == 2 and len(res) == 2
    assert bench_bias_relu_bwd.SHAPES[0] == (64, 64, 300, 300)
