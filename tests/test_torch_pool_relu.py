"""The port's fused conv1 pool + ReLU on the CPU vs the JAX package.

On CPU tensors ``pool2x2_relu_fwd``/``pool2x2_relu_bwd`` take their plain
versions (the CUDA kernels run only on the card: chip_smoke.py,
tests/test_torch_cuda.py). On tie-heavy quantised inputs, as
tests/test_packed_stage.py uses, the forward equals the JAX package's
``pool2x2_packed_relu`` run in interpret mode, and the gradient equals it
bit for bit; both also equal torch's autograd of ``F.relu`` then
``F.max_pool2d`` bit for bit. In train mode the model routes the conv1
stage through it, with the same outputs as eval-mode layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ct_tpu.models.layers import pack_x_pairs
from ct_tpu.ops.pool_packed_pallas import pool2x2_packed_relu
from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.pool_relu import (
    pool2x2_relu, pool2x2_relu_bwd, pool2x2_relu_fwd,
)


def tie_heavy(seed, shape):
    rng = np.random.default_rng(seed)
    return (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 64, 16, 24), (3, 8, 6, 10),
                                   (1, 5, 2, 2)])
def test_forward_equal_and_gradient_bitexact_vs_jax(shape):
    x = tie_heavy(sum(shape), shape)
    g = np.random.default_rng(1).standard_normal(
        (shape[0], shape[1], shape[2] // 2, shape[3] // 2)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    y = pool2x2_relu(xt)
    y.backward(torch.from_numpy(g))

    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    jy, vjp = jax.vjp(lambda a: pool2x2_packed_relu(pack_x_pairs(a), True),
                      x_nhwc)
    (jdx,) = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.transpose(np.asarray(jy), (0, 3, 1, 2)))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.transpose(np.asarray(jdx), (0, 3, 1, 2)))

    # and torch's autograd of relu → max_pool2d, the reference's order
    xr = torch.from_numpy(x).requires_grad_()
    F.max_pool2d(F.relu(xr), 2, 2).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), xr.grad.numpy())
    assert (xt.grad != 0).sum() > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 6, 8)
    with pytest.raises(ValueError, match="even"):
        pool2x2_relu_fwd(torch.zeros(2, 3, 5, 8))
    with pytest.raises(TypeError, match="float32"):
        pool2x2_relu_fwd(x.double())
    with pytest.raises(ValueError, match="NCHW"):
        pool2x2_relu_fwd(x[0])
    with pytest.raises(ValueError, match="g must be"):
        pool2x2_relu_bwd(x, torch.zeros(2, 3, 3, 4), torch.zeros(2, 3, 3, 3))
    with pytest.raises(ValueError, match="no kernel"):
        pool2x2_relu_fwd(x.to("meta"))


def test_train_mode_fuses_the_conv1_pool():
    task = resolve_task(2, "incre", "ours", "VOC")
    torch.manual_seed(0)
    net = build_net(task, 64, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    calls = []
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, inp, out: calls.append(mod))
    try:
        net.train()
        train_out = net(x)
        trained_layers = [m for m in calls if m in set(net.base)]
        calls.clear()
        net.eval()
        eval_out = net(x)
        eval_layers = [m for m in calls if m in set(net.base)]
    finally:
        handle.remove()
    # the ReLU and pool at base[1], base[2] run fused in train mode only
    assert net.fused_relu_idx == 1
    assert net.base[1] not in trained_layers
    assert net.base[2] not in trained_layers
    assert net.base[1] in eval_layers and net.base[2] in eval_layers
    assert len(trained_layers) == len(eval_layers) - 2
    # BN in train mode uses batch statistics: outputs differ from eval
    assert not torch.allclose(train_out.loc, eval_out.loc)
