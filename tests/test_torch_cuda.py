"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each wrapper on CUDA tensors launches its hand-written kernel, held to its
plain version on the same card, f32 with TF32 off:

* ``ct_attention_cm`` (eval forward) and ``ct_attention_cm_stats``: max
  |Δ| ≤ 1e-4 on out, delta and m, and relative 1e-4 on the denominator z
  (sums over up to 1,858 keys in another order);
* ``ct_attention_cm_bwd_flash``: max |Δ| ≤ 1e-4 · max |plain| per output,
  against the plain flash backward and against torch autograd of the
  plain forward; and the autograd path runs the two kernels once each;
* ``pool2x2_relu_fwd``/``_bwd``: equal, bit for bit, to torch autograd of
  ``F.relu`` then ``F.max_pool2d`` on tie-heavy inputs.

The size-64 model on the card is held to the same model on the CPU, in
eval mode and for one training loss-and-gradients call (over the anchors
the CPU mined: losses to rtol 1e-4, each gradient to 1e-3 of its largest
entry; the shallow size-64 net keeps its f32 sums short enough for that).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_cm_bwd_flash,
    ct_attention_cm_bwd_flash_reference, ct_attention_cm_stats,
    ct_attention_cm_stats_reference, ct_attention_reference_cm,
)
from ct_tpu_torch.ops.pool_relu import (
    pool2x2_relu, pool2x2_relu_bwd, pool2x2_relu_fwd,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(seed, b, c, p, k, device):
    rng = np.random.default_rng(seed)
    shapes = [(b, c, p), (b, k, c), (b, k, c), (b, c, p)]
    out = [torch.from_numpy(rng.standard_normal(s, np.float32)).to(device)
           for s in shapes]
    wz = rng.standard_normal((c,), np.float32) * 0.1
    return (*out, torch.from_numpy(wz).to(device))


@pytest.mark.parametrize("b,c,p,k", [(2, 15, 11620, 1858),
                                     (2, 60, 1001, 97), (1, 7, 130, 65),
                                     (3, 64, 257, 1), (1, 16, 128, 64)])
def test_kernel_matches_plain_version(cuda, b, c, p, k):
    args = inputs(c + p, b, c, p, k, cuda)
    before = ct_attention_cm.launches
    with torch.inference_mode():
        out = ct_attention_cm(*args)
        ref = ct_attention_reference_cm(*args)
    torch.cuda.synchronize()
    assert ct_attention_cm.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, base, wz = inputs(0, 2, 15, 300, 40, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ct_attention_cm(q.transpose(1, 2).contiguous().transpose(1, 2),
                        k, v, base, wz)
    with pytest.raises(ValueError, match="is on cpu"):
        ct_attention_cm(q.detach(), k.cpu(), v, base, wz)
    with pytest.raises(ValueError, match="even"):
        pool2x2_relu_fwd(torch.zeros(1, 2, 5, 6, device=cuda))


@pytest.mark.parametrize("b,c,p,k", [(2, 15, 11620, 1858),
                                     (3, 60, 1001, 97), (2, 7, 130, 65),
                                     (2, 64, 257, 3)])
def test_training_kernels_match_plain_versions(cuda, b, c, p, k):
    q, kk, v, base, wz = inputs(c * p + k, b, c, p, k, cuda)
    g = torch.randn(b, c, p, device=cuda, generator=torch.Generator(
        cuda).manual_seed(k))
    before = (ct_attention_cm_stats.launches,
              ct_attention_cm_bwd_flash.launches)
    out, delta, m, z = ct_attention_cm_stats(q, kk, v, base, wz)
    ref = ct_attention_cm_stats_reference(q, kk, v, base, wz)
    for a, r in zip((out, delta, m), ref[:3]):
        assert (a - r).abs().max().item() <= 1e-4
    assert ((z - ref[3]).abs() / ref[3]).max().item() <= 1e-4

    gd = g * delta
    colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
    grads = ct_attention_cm_bwd_flash(q, kk, v, wz, g, m, z, colsum)
    plain = ct_attention_cm_bwd_flash_reference(q, kk, v, wz, g, m, z,
                                                colsum)
    args = [t.clone().requires_grad_() for t in (q, kk, v)]
    auto = torch.autograd.grad(
        ct_attention_reference_cm(*args, base, wz), args, g)
    torch.cuda.synchronize()
    for a, r1, r2 in zip(grads, plain, auto):
        scale = r1.abs().max().item()
        assert (a - r1).abs().max().item() <= 1e-4 * scale
        assert (a - r2).abs().max().item() <= 1e-4 * scale
    assert (ct_attention_cm_stats.launches,
            ct_attention_cm_bwd_flash.launches) == (before[0] + 1,
                                                    before[1] + 1)


def test_autograd_runs_the_training_kernels(cuda):
    q, kk, v, base, wz = inputs(5, 2, 15, 2000, 300, cuda)
    args = [t.requires_grad_() for t in (q, kk, v, base, wz)]
    before = (ct_attention_cm.launches, ct_attention_cm_stats.launches,
              ct_attention_cm_bwd_flash.launches)
    out = ct_attention_cm(*args)
    grads = torch.autograd.grad(out.square().sum(), args)
    after = (ct_attention_cm.launches, ct_attention_cm_stats.launches,
             ct_attention_cm_bwd_flash.launches)
    assert after == (before[0], before[1] + 1, before[2] + 1)
    ref = torch.autograd.grad(
        ct_attention_reference_cm(*args).square().sum(), args)
    for a, r in zip(grads, ref):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.parametrize("shape", [(2, 64, 300, 300), (3, 5, 6, 10)])
def test_pool_kernels_bitexact_vs_autograd(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(cuda)
    xk = x.clone().requires_grad_()
    before = (pool2x2_relu_fwd.launches, pool2x2_relu_bwd.launches)
    y = pool2x2_relu(xk)
    g = torch.randn_like(y)
    y.backward(g)
    assert (pool2x2_relu_fwd.launches, pool2x2_relu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    xr = x.clone().requires_grad_()
    yr = F.max_pool2d(F.relu(xr), 2, 2)
    yr.backward(g)
    assert torch.equal(y, yr)
    assert torch.equal(xk.grad, xr.grad)


def test_model_on_the_card_matches_the_cpu(cuda):
    task = resolve_task(2, "transfer", "ours", "VOC")
    torch.manual_seed(0)
    cpu_net = build_net(task, 64, device="cpu")
    with torch.no_grad():
        cpu_net.Wz.normal_(0, 0.3)
    gpu_net = build_net(task, 64, device=cuda)
    gpu_net.load_state_dict(cpu_net.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    before = ct_attention_cm.launches
    with torch.inference_mode():
        ref = cpu_net(x)
        out = gpu_net(x.to(cuda))
    assert ct_attention_cm.launches == before + 1
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_train_loss_and_grads_on_the_card_match_the_cpu(cuda):
    from ct_tpu_torch.config import TINY_64
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.step import loss_and_grads

    task = resolve_task(2, "incre", "ours", "VOC")
    torch.manual_seed(0)
    cpu_net = build_net(task, 64, device="cpu")
    with torch.no_grad():
        cpu_net.Wz.normal_(0, 0.3)
    gpu_net = build_net(task, 64, device=cuda)
    gpu_net.load_state_dict(cpu_net.state_dict())
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (2, 3, 64, 64)).astype(np.float32)),
             "boxes": torch.tensor([[[0.1, 0.1, 0.5, 0.6]],
                                    [[0.3, 0.2, 0.9, 0.7]]]),
             "labels": torch.tensor([[3], [17]], dtype=torch.int32),
             "weights": torch.ones(2, 1),
             "valid": torch.ones(2, 1, dtype=torch.bool)}
    before = (pool2x2_relu_fwd.launches, pool2x2_relu_bwd.launches,
              ct_attention_cm_stats.launches,
              ct_attention_cm_bwd_flash.launches)
    # the card's gradients over the anchors the CPU mined: near-tied
    # negatives may rank the other way round on the card
    ref, mask = loss_and_grads(cpu_net, batch, prior_boxes(TINY_64))
    out, _ = loss_and_grads(gpu_net,
                            {k: v.to(cuda) for k, v in batch.items()},
                            prior_boxes(TINY_64, cuda), mask=mask.to(cuda))
    assert (pool2x2_relu_fwd.launches, pool2x2_relu_bwd.launches,
            ct_attention_cm_stats.launches,
            ct_attention_cm_bwd_flash.launches) == tuple(
                n + 1 for n in before)
    for key, val in ref.items():
        np.testing.assert_allclose(out[key].item(), val.item(), rtol=1e-4)
    for (name, p), q in zip(gpu_net.named_parameters(),
                            cpu_net.parameters()):
        scale = q.grad.abs().max().item()
        assert (p.grad.cpu() - q.grad).abs().max().item() <= max(
            1e-3 * scale, 1e-6), name
