"""The port's CUDA kernel on the card (marker ``cuda``; skips without one).

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

``ct_attention_cm`` on CUDA tensors launches the hand-written kernel; it
is held to its plain version on the same card, f32 with TF32 off, at
max |Δ| ≤ 1e-4 (sums over up to 1,858 keys in another order). The
size-64 model on the card is held to the same model on the CPU.
"""

import numpy as np
import pytest
import torch

from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_cm, ct_attention_reference_cm,
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
    with pytest.raises(NotImplementedError, match="backward"):
        ct_attention_cm(q.requires_grad_(), k, v, base, wz)
    with pytest.raises(ValueError, match="is on cpu"):
        ct_attention_cm(q.detach(), k.cpu(), v, base, wz)


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
