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
  ``F.relu`` then ``F.max_pool2d`` on tie-heavy inputs;
* ``ct_attention_serving`` (the fused serving CT head): max |Δ| ≤ 1e-4 of
  the largest score, against its plain version (sums over up to 1,858 keys
  and the θ and classifier products in another order), also at the edges
  of the forwards' walk that it runs (P = 63, 64, 65; K = 1, 31, 32, 33;
  C = 7, 16, 17, 64; N = 1, 64), and two launches give the same bits;
* ``nms_mask`` (the NMS kernel): the keep mask equal, bit for bit, to the
  plain fixpoint loop's on the card and on the CPU, on seeded and
  tie-heavy boxes, at K = 1, 32, 33 and 1,024 with rows of no candidate
  and of one box repeated, the same twice; ``batched_nms`` on the card
  equal to the CPU's;
* ``ct_attention_cm_bwd`` (the blockwise backward) and the row-major
  ``ct_attention`` / ``ct_attention_bwd``: max |Δ| ≤ 1e-4 on the forward,
  ≤ 1e-4 · max |plain| per gradient (dwz too), and the autograd paths run
  their kernels once each; the three backwards also at the edges of the
  tiles of their dq and dk/dv kernels (P and K below, at and one past a
  tile, C = 16, 17 and 64, class-major rows not 16-byte aligned), the
  flash one also over the 512 bench's 32,756 anchors, and two launches on
  the same inputs give the same bits; the four forwards (eval, training,
  row-major, bfloat16 exponent) and the blockwise backward, which run on
  the tensor cores too, at the edges of their tiles (P = 1, 63, 64, 65,
  1001; K = 1, 31, 32, 33, 97; C = 1, 7, 8, 15, 16, 17, 60) and over the
  512 size's 4,964 keys, each launched twice for the same bits;
  ``ct_attention_variant`` (the bfloat16
  exponential) within half of max |plain bf16 - plain f32|, what the
  bfloat16 rounding itself moves the output by, and further than that
  from the float32 kernel ``ct_attention``;
* ``bias_relu_bwd`` in float32 and (``bias_relu_bwd_bf16``) bfloat16: the
  mask equal, bit for bit (the sign of zero too), to the plain version's,
  and dbias float32 within 1e-5 of each channel's Σ |masked| (f32 sums
  over up to 5.8 million values in another order), at planes whose length
  is a multiple of 8, of 4 only, and odd, and from a start 8 bytes off a
  16-byte alignment; one launch counted on the wrapper of its type.

The bfloat16 forwards (``ct_attention_cm_bf16``, ``ct_attention_bf16``,
``ct_attention_variant_bf16``, ``ct_attention_variant_unfused_bf16`` on
the ``wgmma`` tiles of ``csrc/ct_attention_cm.cu``;
``ct_attention_serving_bf16`` on the same tiles and walks, in
``csrc/ct_attention_serving.cu``): within one bf16 step of the largest
output of their plain bf16 versions (``bf16_step``: the two sum in another
f32 order and the output is rounded to bf16, so a value at a rounding
boundary moves by a step), at the eval shapes and at the edges of the
tiles (P = 1, 63, 64, 65, 127, 128, 129, 1001; K = 1, 31, 32, 33, 63, 64,
65, 97, 127, 128, 129 and the 512 size's 4,964; C = 1, 7, 15, 16, 17, 60,
63; the serving head also at N = 1, 20 and 64), the same bits twice, one
launch counted a call; the serving head on 9 images, sliced to the first
3, bit for bit the head on those 3 alone; the prep of k and v
that they share with the bf16 backwards bit for bit against a torch
rearrangement into the tile layout, with and without v's ones column; and
they refuse C = 64 and mixed types; a call that needs a gradient runs the
bf16 training forward. The unfused variant (the denominator summed in f32
before the weights' rounding) at the bench's inputs also differs from the
fused kernel, and in fewer entries from its plain version than that.

The bfloat16 training kernels (``train.py --bf16``: rows 2, 3, 4, 5's
backward and 7): the stats forward, the flash, blockwise and row-major
backwards against their plain bf16 versions at the same edges, at those
of the backward kernels' 64-row tiles (P and K = 63, 64, 65, 127, 129; C =
16 and 48 among them) and over 4,964 keys, each output within 1e-4 of its
mean |entry| in the mean and one bf16 step (the forward's outputs) or 1e-2
(the backward's sums) of its largest in the max, the same bits twice; row
5's division (Markstein's correction) bit for bit against ``__fdiv_rn``
over 2²⁰ pairs; the autograd paths run their kernels once each;
the bf16 pool bit for bit against torch autograd; the size-64 bf16 model's
gradients on the card against the CPU's by the bf16 effect; the
augmentation's bf16 images on the card against the CPU's.

The device augmentation (``data/augment_device.py``), drawn on the card,
applied on the card and on the CPU from the same parameters: images within
2e-3 on the 0-255 scale, boxes within 1e-6, ``valid`` and labels equal;
``mixup_batch`` on the card against ``apply_mixup`` on the CPU within 1e-6.

The size-64 model on the card is held to the same model on the CPU, in
eval mode, as the int8 serving model (on the same scales: the int8 sums
are exact, the float heads agree to 1e-4) and for one training
loss-and-gradients call (over the anchors
the CPU mined: losses to rtol 1e-4, each gradient to 1e-3 of its largest
entry; the shallow size-64 net keeps its f32 sums short enough for that).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.rfbnet import build_net
from ct_tpu_torch.ops.bias_relu import (
    bias_relu_bwd, bias_relu_bwd_bf16, bias_relu_bwd_reference,
)
from ct_tpu_torch.ops.ct_attention import (
    bf16_step, ct_attention_bf16, ct_attention_bwd_bf16,
    ct_attention_bwd_bf16_division, ct_attention_bwd_reference_bf16,
    ct_attention_cm_bf16,
    ct_attention_cm_bwd_bf16, ct_attention_cm_bwd_flash_bf16,
    ct_attention_cm_bwd_flash_reference_bf16,
    ct_attention_cm_bwd_reference_bf16, ct_attention_cm_stats_bf16,
    ct_attention_cm_stats_reference_bf16, ct_attention_prep_kv_bf16,
    ct_attention_reference_bf16, ct_attention_reference_cm_bf16,
    ct_attention_serving_bf16, ct_attention_serving_reference_bf16,
    ct_attention_variant_bf16, ct_attention_variant_unfused_bf16,
    prep_kv_reference_bf16,
)
from ct_tpu_torch.ops.ct_attention import (
    ct_attention, ct_attention_bwd, ct_attention_bwd_reference,
    ct_attention_cm, ct_attention_cm_bwd, ct_attention_cm_bwd_flash,
    ct_attention_cm_bwd_flash_reference, ct_attention_cm_bwd_reference,
    ct_attention_cm_stats, ct_attention_cm_stats_reference,
    ct_attention_reference, ct_attention_reference_cm, ct_attention_serving,
    ct_attention_serving_reference, ct_attention_variant,
    ct_attention_variant_reference,
)
from ct_tpu_torch.ops.nms import batched_nms, nms_mask, nms_mask_reference
from ct_tpu_torch.ops.pool_relu import (
    pool2x2_relu, pool2x2_relu_bwd, pool2x2_relu_bwd_bf16, pool2x2_relu_fwd,
    pool2x2_relu_fwd_bf16,
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


# the backward's tiles: dq owns 64 anchors and walks keys 32 at a time,
# dk/dv owns 64 keys and walks anchors 32 at a time; CP=16 serves C <= 16,
# CP=64 C = 17..64; class-major rows of P=1001 anchors are not 16-byte
# aligned (4-byte copies), those of P=640 are (16-byte copies)
TILE_EDGE_SHAPES = [(1, 16, 5, 2), (2, 17, 65, 65), (1, 64, 33, 33),
                    (2, 16, 1001, 32), (1, 64, 640, 129)]

# the 512 bench's P: dk and dv sum over 32,756 anchors, where an f32 sum
# kept in the tensor cores' truncating accumulator leaves the band
LONG_SUM_SHAPE = (1, 60, 32756, 129)


@pytest.mark.parametrize("b,c,p,k", [(2, 15, 11620, 1858),
                                     (3, 60, 1001, 97), (2, 7, 130, 65),
                                     (2, 64, 257, 3)] + TILE_EDGE_SHAPES
                         + [LONG_SUM_SHAPE])
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


def serving_inputs(seed, b, c, p, k, n, device):
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
    return (t(b, c, p), t(b, k, c, scale=0.3), t(b, k, c), t(c, c, scale=0.2),
            t(c, scale=0.1), t(c, scale=0.3), t(n, c))


@pytest.mark.parametrize("b,c,p,k,n", [(2, 15, 11620, 1858, 5),
                                       (2, 60, 11620, 1858, 20),
                                       (3, 60, 1001, 97, 20),
                                       (2, 7, 130, 65, 3),
                                       (1, 64, 257, 1, 64)])
def test_serving_kernel_matches_plain_version(cuda, b, c, p, k, n):
    args = serving_inputs(c + p + n, b, c, p, k, n, cuda)
    before = ct_attention_serving.launches
    out = ct_attention_serving(*args)
    ref = ct_attention_serving_reference(*args)
    torch.cuda.synchronize()
    assert ct_attention_serving.launches == before + 1
    assert out.shape == (b, n, p)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(out, ct_attention_serving(*args))


# the serving head's walk is the forwards': 64 anchors a block, keys 32 at a
# time, CP=16 for C <= 16 and 64 for C = 17..64; each P with each K, each C
# with the narrowest and the widest classifier
SERVING_EDGE_SHAPES = [
    (1, 7, 63, 1, 1), (2, 16, 63, 31, 64), (1, 17, 63, 32, 1),
    (2, 64, 63, 33, 64), (2, 7, 64, 31, 64), (1, 16, 64, 32, 1),
    (2, 17, 64, 33, 64), (1, 64, 64, 1, 1), (1, 7, 65, 32, 64),
    (2, 16, 65, 33, 1), (1, 17, 65, 1, 64), (2, 64, 65, 31, 1)]


@pytest.mark.parametrize("b,c,p,k,n", SERVING_EDGE_SHAPES)
def test_serving_kernel_at_tile_edges(cuda, b, c, p, k, n):
    args = serving_inputs(c * p + k + n, b, c, p, k, n, cuda)
    first = ct_attention_serving(*args)
    second = ct_attention_serving(*args)
    ref = ct_attention_serving_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert first.shape == (b, n, p)
    assert (first - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def nms_case(seed, n, k, device, ties):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 60 if ties else 500, (n, k, 2))
    half = rng.uniform(2, 15 if ties else 120, (n, k, 2))
    boxes = np.concatenate([centers - half, centers + half], -1)
    if ties:
        boxes = np.round(boxes)
    valid = rng.uniform(size=(n, k)) < 0.9
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("n,k,offset,ties", [(160, 200, 1.0, False),
                                             (160, 200, 1.0, True),
                                             (160, 128, 0.0, True),
                                             (7, 33, 1.0, True),
                                             (3, 1024, 1.0, False)])
def test_nms_kernel_keep_mask_is_the_plain_one(cuda, n, k, offset, ties):
    boxes, valid = nms_case(n + k, n, k, cuda, ties)
    before = nms_mask.launches
    keep = nms_mask(boxes, valid, 0.45, offset)
    torch.cuda.synchronize()
    assert nms_mask.launches == before + 1
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    assert torch.equal(keep, nms_mask_reference(boxes, valid, 0.45, offset))
    assert torch.equal(keep.cpu(), nms_mask(boxes.cpu(), valid.cpu(), 0.45,
                                            offset))


@pytest.mark.parametrize("k", [1, 32, 33, 1024])
def test_nms_kernel_at_word_edges(cuda, k):
    # K below, at and past a 32-candidate word, and the kernel's largest;
    # a row of no candidate, a row of one box repeated
    boxes, valid = nms_case(k + 11, 12, k, cuda, True)
    valid[0] = False
    boxes[1] = boxes[1, :1]
    valid[1] = True
    first = nms_mask(boxes, valid, 0.45, 1.0)
    second = nms_mask(boxes, valid, 0.45, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, nms_mask_reference(boxes, valid, 0.45, 1.0))
    assert not first[0].any()
    assert first[1, 0] and first[1].sum().item() == 1


def test_batched_nms_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(4)
    b, p, c = 2, 3000, 21
    mins = rng.uniform(0, 400, (b, p, 2))
    boxes = np.concatenate([mins, mins + rng.uniform(10, 150, (b, p, 2))],
                           -1).astype(np.float32)
    scores = (rng.integers(0, 12, (b, p, c)) / 16.0).astype(np.float32)
    for kw in ({}, {"approx_top_k": True}, {"pool_size": 512,
                                            "top_k": 128}):
        ref = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          **kw)
        out = batched_nms(torch.from_numpy(boxes).to(cuda),
                          torch.from_numpy(scores).to(cuda), **kw)
        for a, r in zip(out, ref):
            assert torch.equal(a.cpu(), r), kw


def test_serving_model_on_the_card_matches_the_cpu(cuda):
    from ct_tpu_torch.models.fold_bn import fold_bn
    from ct_tpu_torch.models.quantize import attach, calibrate, quantize
    from ct_tpu_torch.models.rfbnet import vgg_pool_chains

    task = resolve_task(2, "incre", "ours", "VOC")
    torch.manual_seed(0)
    cpu_net = build_net(task, 64, device="cpu")
    with torch.no_grad():
        cpu_net.Wz.normal_(0, 0.3)
    cpu_net = fold_bn(cpu_net)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    quant = quantize(cpu_net, calibrate(cpu_net, [x]),
                     chains=vgg_pool_chains(64))
    gpu_net = build_net(task, 64, device=cuda, fold_bn=True)
    gpu_net.load_state_dict({k: v for k, v in cpu_net.state_dict().items()
                             if not k.endswith(("act_scale", "kernel_int8",
                                                "kernel_scale", "out_scale"))
                             })
    attach(gpu_net, quant)
    before = ct_attention_serving.launches
    with torch.inference_mode():
        ref = cpu_net(x)
        out = gpu_net(x.to(cuda))
    assert ct_attention_serving.launches == before + 1
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


BLOCKWISE_SHAPES = [(2, 15, 11620, 1858), (3, 60, 1001, 97), (2, 7, 130, 65),
                    (2, 64, 257, 3)] + TILE_EDGE_SHAPES


def assert_grads_close(grads, ref, tol=1e-4):
    for name, a, r in zip(("dq", "dk", "dv", "dwz"), grads, ref):
        scale = r.abs().max().item()
        assert (a - r).abs().max().item() <= tol * scale, name


@pytest.mark.parametrize("b,c,p,k", BLOCKWISE_SHAPES)
def test_blockwise_backward_matches_plain_version(cuda, b, c, p, k):
    q, kk, v, _, wz = inputs(c * p + k + 1, b, c, p, k, cuda)
    g = torch.randn(b, c, p, device=cuda, generator=torch.Generator(
        cuda).manual_seed(k))
    before = ct_attention_cm_bwd.launches
    grads = ct_attention_cm_bwd(q, kk, v, wz, g)
    plain = ct_attention_cm_bwd_reference(q, kk, v, wz, g)
    torch.cuda.synchronize()
    assert ct_attention_cm_bwd.launches == before + 1
    assert_grads_close(grads, plain)


def test_blockwise_autograd_runs_its_kernels(cuda):
    q, kk, v, base, wz = inputs(6, 2, 60, 2000, 300, cuda)
    args = [t.requires_grad_() for t in (q, kk, v, base, wz)]
    counters = (ct_attention_cm, ct_attention_cm_stats,
                ct_attention_cm_bwd_flash, ct_attention_cm_bwd)
    before = [f.launches for f in counters]
    out = ct_attention_cm(*args, flash=False)
    grads = torch.autograd.grad(out.square().sum(), args)
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 0, 0, 1]
    ref = torch.autograd.grad(
        ct_attention_reference_cm(*args).square().sum(), args)
    for a, r in zip(grads, ref):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def rowmajor(args):
    q, kk, v, base, wz = args
    return (q.transpose(1, 2).contiguous(), kk, v,
            base.transpose(1, 2).contiguous(), wz)


@pytest.mark.parametrize("b,c,p,k", BLOCKWISE_SHAPES)
def test_rowmajor_kernels_match_plain_versions(cuda, b, c, p, k):
    q, kk, v, base, wz = rowmajor(inputs(c + p + k, b, c, p, k, cuda))
    g = torch.randn(b, p, c, device=cuda, generator=torch.Generator(
        cuda).manual_seed(p))
    before = (ct_attention.launches, ct_attention_bwd.launches)
    with torch.no_grad():
        out = ct_attention(q, kk, v, base, wz)
        ref = ct_attention_reference(q, kk, v, base, wz)
        grads = ct_attention_bwd(q, kk, v, wz, g)
        plain = ct_attention_bwd_reference(q, kk, v, wz, g)
    torch.cuda.synchronize()
    assert (ct_attention.launches, ct_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert (out - ref).abs().max().item() <= 1e-4
    assert_grads_close(grads, plain)


def test_rowmajor_autograd_runs_its_kernels(cuda):
    args = [t.requires_grad_() for t in rowmajor(inputs(8, 2, 15, 2000, 300,
                                                        cuda))]
    before = (ct_attention.launches, ct_attention_bwd.launches)
    grads = torch.autograd.grad(ct_attention(*args).square().sum(), args)
    assert (ct_attention.launches, ct_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = torch.autograd.grad(
        ct_attention_reference(*args).square().sum(), args)
    for a, r in zip(grads, ref):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.parametrize("path", ["flash", "blockwise", "rowmajor"])
def test_backward_kernels_are_deterministic(cuda, path):
    # no float atomics: two launches on the same inputs give the same bits
    q, kk, v, base, wz = inputs(9, 2, 60, 11620, 1858, cuda)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(9))
    if path == "flash":
        _, delta, m, z = ct_attention_cm_stats(q, kk, v, base, wz)
        colsum = (g * delta * wz[None, :, None]).sum(dim=1, keepdim=True)
        run = lambda: ct_attention_cm_bwd_flash(q, kk, v, wz, g, m, z,
                                                colsum)
    elif path == "blockwise":
        run = lambda: ct_attention_cm_bwd(q, kk, v, wz, g)
    else:
        qr, gr = q.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
        run = lambda: ct_attention_bwd(qr, kk, v, wz, gr)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,c,p,k", [(2, 60, 11620, 1858), (3, 15, 1001, 97)])
def test_variant_matches_plain_version(cuda, b, c, p, k):
    # the attention bench's inputs: normal × 0.3
    args = tuple(t * 0.3 for t in rowmajor(inputs(c * k, b, c, p, k, cuda)))
    before = ct_attention_variant.launches
    out = ct_attention_variant(*args)
    ref = ct_attention_variant_reference(*args)
    torch.cuda.synchronize()
    assert ct_attention_variant.launches == before + 1
    tol = 0.5 * (ref - ct_attention_reference(*args)).abs().max().item()
    assert (out - ref).abs().max().item() <= tol
    assert (out - ct_attention(*args)).abs().max().item() > tol


@pytest.mark.parametrize("b,c,p,k", [(2, 60, 11620, 1858), (3, 15, 1001, 97)])
def test_unfused_variant_bf16_matches_plain_version(cuda, b, c, p, k):
    """The attention bench's unfused float32-exponent body on its bf16
    inputs (normal × 0.3): within one bf16 step of its plain version, and
    not the fused kernel's output (a kernel that divided by the rounded
    weights' sum, its ones column, would be)."""
    *qkvb, wz = rowmajor(inputs(c * k + 1, b, c, p, k, cuda))
    args = (*(t.mul(0.3).to(torch.bfloat16) for t in qkvb), wz)
    before = ct_attention_variant_unfused_bf16.launches
    with torch.no_grad():
        out = ct_attention_variant_unfused_bf16(*args)
        ref = ct_attention_reference_bf16(*args, unfused=True)
        fused = ct_attention_bf16(*args)
    torch.cuda.synchronize()
    assert ct_attention_variant_unfused_bf16.launches == before + 1
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= bf16_step(ref.float().abs().max().item()), err
    assert not torch.equal(out, fused)
    assert (out != ref).sum().item() < (fused != ref).sum().item()


@pytest.mark.parametrize("shape", [(2, 64, 300, 300), (3, 5, 7, 9),
                                   (4, 512, 38, 38), (2, 128, 150, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_relu_kernel_matches_plain_version(cuda, shape, dtype):
    # planes of 90,000 (8k), 22,500 and 1,444 (4k, not 8k) and 63 elements:
    # the bf16 kernel's 16-, 8- and 2-byte loads
    rng = np.random.default_rng(sum(shape))
    g = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(cuda,
                                                                    dtype)
    y = torch.from_numpy(np.maximum(rng.standard_normal(shape, np.float32),
                                    0)).to(cuda, dtype)
    g.view(-1)[0], y.view(-1)[0] = -0.0, 1.0      # a -0.0 passes through
    wrapper = bias_relu_bwd_bf16 if dtype == torch.bfloat16 else bias_relu_bwd
    counts = lambda: {f: f.launches for f in (bias_relu_bwd,
                                              bias_relu_bwd_bf16)}
    before = counts()
    masked, dbias = bias_relu_bwd(g, y)
    ref, ref_dbias = bias_relu_bwd_reference(g, y)
    torch.cuda.synchronize()
    assert counts() == {f: n + (f is wrapper) for f, n in before.items()}
    assert masked.dtype == dtype and dbias.dtype == torch.float32
    # bit for bit, the sign of zero included
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(masked.view(bits), ref.view(bits))
    assert ((dbias - ref_dbias).abs()
            <= 1e-5 * ref.float().abs().sum(dim=(0, 2, 3))).all()
    # an input whose start is 8 bytes past an alignment of 16 takes the
    # narrower loads and gives the same result
    if shape[2] * shape[3] % 8 == 0:
        gs = torch.empty(g.numel() + 8, dtype=dtype, device=cuda)
        ys = torch.empty_like(gs)
        off = 8 // g.element_size()
        gs[off:off + g.numel()] = g.view(-1)
        ys[off:off + g.numel()] = y.view(-1)
        m2, d2 = bias_relu_bwd(gs[off:off + g.numel()].view(shape),
                               ys[off:off + g.numel()].view(shape))
        assert torch.equal(m2.view(bits), ref.view(bits))
        assert ((d2 - ref_dbias).abs()
                <= 1e-5 * ref.float().abs().sum(dim=(0, 2, 3))).all()


# the forwards' tiles (and the blockwise stats pass's): a block owns 64
# anchors and walks the keys 32 at a time; CP=16 serves C <= 16, CP=64
# C = 17..64; class-major rows of P=1001 anchors are not 16-byte aligned
FWD_EDGE_SHAPES = [(1, 1, 1, 1), (2, 7, 63, 31), (1, 8, 64, 32),
                   (2, 15, 65, 33), (1, 16, 1001, 97), (2, 17, 64, 1),
                   (1, 60, 1001, 33), (2, 60, 65, 32)]
# the 512 size: P·V sums over 4,964 keys, a rounded add a tile
LONG_K_SHAPE = (1, 60, 4096, 4964)


def forward_case(path, args):
    """(kernel, plain version) of one forward on the class-major ``args``."""
    q, kk, v, base, wz = args
    if path == "eval":
        return (lambda: (ct_attention_cm(q, kk, v, base, wz),),
                lambda: (ct_attention_reference_cm(q, kk, v, base, wz),))
    if path == "stats":
        return (lambda: ct_attention_cm_stats(q, kk, v, base, wz),
                lambda: ct_attention_cm_stats_reference(q, kk, v, base, wz))
    rm = rowmajor(args)
    if path == "rowmajor":
        return (lambda: (ct_attention(*rm),),
                lambda: (ct_attention_reference(*rm),))
    rm = tuple(t * 0.3 for t in rm)   # the attention bench's inputs
    return (lambda: (ct_attention_variant(*rm),),
            lambda: (ct_attention_variant_reference(*rm),))


@pytest.mark.parametrize("b,c,p,k", FWD_EDGE_SHAPES + [LONG_K_SHAPE])
@pytest.mark.parametrize("path", ["eval", "stats", "rowmajor", "variant"])
def test_forward_kernels_at_tile_edges(cuda, path, b, c, p, k):
    if path == "variant" and k == 1:
        pytest.skip("one key: the bfloat16 weight is 1, the band is empty")
    args = inputs(c * p + k + 2, b, c, p, k, cuda)
    kernel, plain = forward_case(path, args)
    with torch.no_grad():
        first, second = kernel(), kernel()
        ref = plain()
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a, r)
    if path == "variant":
        rm = tuple(t * 0.3 for t in rowmajor(args))
        tol = 0.5 * (ref[0] - ct_attention_reference(*rm)).abs().max().item()
        assert (first[0] - ref[0]).abs().max().item() <= tol
        assert (first[0] - ct_attention(*rm)).abs().max().item() > tol
        return
    for a, r in zip(first[:3], ref[:3]):   # out (delta, m)
        assert (a - r).abs().max().item() <= 1e-4
    if path == "stats":
        assert ((first[3] - ref[3]).abs() / ref[3]).max().item() <= 1e-4


# the backward's K=1 is left out: with one key the exact dq and dk are 0,
# and a band relative to their largest entry holds nothing
@pytest.mark.parametrize("b,c,p,k", [s for s in FWD_EDGE_SHAPES if s[3] > 1]
                         + [(1, 1, 1, 97), (2, 17, 64, 31), LONG_K_SHAPE])
def test_blockwise_stats_pass_at_tile_edges(cuda, b, c, p, k):
    q, kk, v, _, wz = inputs(c * p + k + 3, b, c, p, k, cuda)
    g = torch.randn(b, c, p, device=cuda, generator=torch.Generator(
        cuda).manual_seed(p + k))
    first = ct_attention_cm_bwd(q, kk, v, wz, g)
    second = ct_attention_cm_bwd(q, kk, v, wz, g)
    plain = ct_attention_cm_bwd_reference(q, kk, v, wz, g)
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a, r)
    assert_grads_close(first, plain)


def _params_on_cpu(params):
    import dataclasses

    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).cpu()
        for f in dataclasses.fields(params)})


@pytest.mark.parametrize("b,canvas,out_size", [(64, 384, 300), (5, 97, 64)])
def test_device_augment_on_the_card_matches_the_cpu(cuda, b, canvas,
                                                    out_size):
    """``augment_batch``'s draws on the card, applied on the card and on
    the CPU: images within 2e-3 on the 0-255 scale, boxes within 1e-6,
    ``valid`` and labels equal (the CPU tests' bands against JAX); and
    ``mixup_batch`` on the card against ``apply_mixup`` on the CPU with the
    same λ and offset, within 1e-6 (relative to 255 for the images)."""
    from ct_tpu_torch.data import augment_device as D

    rng = np.random.default_rng(b)
    images = torch.from_numpy(rng.integers(0, 256, (b, 3, canvas, canvas),
                                           dtype=np.uint8))
    mins = rng.uniform(0.0, 0.6, (b, 6, 2))
    boxes = torch.from_numpy(np.concatenate(
        [mins, np.minimum(mins + rng.uniform(0.05, 0.4, (b, 6, 2)), 1.0)],
        -1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 21, (b, 6)).astype(np.int32))
    valid = torch.from_numpy(rng.random((b, 6)) < 0.7)
    weights = valid.float()
    gen = torch.Generator(cuda).manual_seed(b)
    photo, geom = D.sample_augment(gen, boxes.to(cuda), valid.to(cuda))
    out = D.apply_augment(images.to(cuda), boxes.to(cuda), labels.to(cuda),
                          valid.to(cuda), photo, geom, out_size)
    ref = D.apply_augment(images, boxes, labels, valid,
                          _params_on_cpu(photo), _params_on_cpu(geom),
                          out_size)
    assert out["image"].shape == (b, 3, out_size, out_size)
    assert (out["image"].cpu() - ref["image"]).abs().max().item() <= 2e-3
    assert (out["boxes"].cpu() - ref["boxes"]).abs().max().item() <= 1e-6
    assert torch.equal(out["valid"].cpu(), ref["valid"])
    assert torch.equal(out["labels"].cpu(), ref["labels"])

    batch = dict(ref, weights=weights)
    mixed = D.mixup_batch(np.random.default_rng(3),
                          {k: v.to(cuda) for k, v in batch.items()},
                          zero_ignored=True)
    lam, offset = D.sample_mixup(np.random.default_rng(3), b)
    plain = D.apply_mixup(batch, torch.from_numpy(lam), offset, True)
    for key, val in plain.items():
        scale = 255.0 if key == "image" else 1.0
        assert (mixed[key].cpu().float() - val.float()).abs().max().item() \
            <= 1e-6 * scale, key


# --- bfloat16 forwards --------------------------------------------------------

BF16_SHAPES = [(8, 15, 11620, 1858), (8, 60, 11620, 1858), (1, 1, 1, 1),
               (2, 7, 63, 31), (1, 15, 64, 32), (2, 16, 65, 33),
               (1, 17, 1001, 97), (2, 60, 64, 1), (1, 63, 1001, 33),
               # one below, at and one past the forwards' 64-row tiles of
               # anchors (a block's) and of keys (a staged tile's)
               (2, 15, 63, 63), (1, 60, 64, 64), (2, 16, 65, 65),
               (1, 7, 127, 127), (2, 60, 128, 128), (1, 63, 129, 129),
               # the 512 size: P·V over 4,964 keys, a rounded add a tile
               (1, 60, 4096, 4964)]


def bf16_inputs(seed, b, c, p, k, device, scale=1.0):
    """Class-major q and base, k, v in bf16 and wz in float32."""
    q, kk, v, base, wz = inputs(seed, b, c, p, k, device)
    return (*(t.mul(scale).to(torch.bfloat16) for t in (q, kk, v, base)),
            wz)


def bf16_case(path, args):
    q, kk, v, base, wz = args
    if path == "cm":
        return (ct_attention_cm_bf16, (q, kk, v, base, wz),
                ct_attention_reference_cm_bf16)
    rm = (q.transpose(1, 2).contiguous(), kk, v,
          base.transpose(1, 2).contiguous(), wz)
    if path == "rowmajor":
        return ct_attention_bf16, rm, ct_attention_reference_bf16
    if path == "unfused":
        return (ct_attention_variant_unfused_bf16, rm,
                lambda *a: ct_attention_reference_bf16(*a, unfused=True))
    return (ct_attention_variant_bf16, rm,
            lambda *a: ct_attention_reference_bf16(*a, exp_bf16=True))


@pytest.mark.parametrize("b,c,p,k", BF16_SHAPES)
@pytest.mark.parametrize("path", ["cm", "rowmajor", "variant", "unfused"])
def test_bf16_forwards_match_plain_versions(cuda, path, b, c, p, k):
    args = bf16_inputs(c * p + k + 5, b, c, p, k, cuda, scale=0.5)
    kernel, kargs, plain = bf16_case(path, args)
    before = kernel.launches
    with torch.no_grad():
        first, second = kernel(*kargs), kernel(*kargs)
        ref = plain(*kargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert first.dtype == torch.bfloat16 and first.shape == ref.shape
    assert torch.equal(first, second)
    err = (first.float() - ref.float()).abs().max().item()
    assert err <= bf16_step(ref.float().abs().max().item()), err


@pytest.mark.parametrize("b,c,k", [(2, 15, 63), (1, 16, 64), (2, 60, 65),
                                   (1, 63, 129), (1, 1, 1)])
@pytest.mark.parametrize("ones", [True, False])
def test_bf16_prep_writes_the_tile_layout(cuda, b, c, k, ones):
    """The bf16 kernels' shared prep (``prep_kv``): its k and v tiles, with
    and without v's ones column, equal a torch rearrangement of the
    zero-padded tensors into the swizzled tile layout (``wg::at``)."""
    _, kk, v, _, _ = bf16_inputs(c + k, b, c, 7, k, cuda)
    before = ct_attention_prep_kv_bf16.launches
    kp, vp = ct_attention_prep_kv_bf16(kk, v, ones)
    ref = prep_kv_reference_bf16(kk, v, ones)
    torch.cuda.synchronize()
    assert ct_attention_prep_kv_bf16.launches == before + 1
    assert torch.equal(kp, ref[0]) and torch.equal(vp, ref[1])


BF16_SERVING_SHAPES = [(8, 15, 11620, 1858, 5), (8, 60, 11620, 1858, 20),
                       (1, 7, 63, 1, 1), (2, 15, 64, 31, 64),
                       (1, 17, 65, 33, 3), (2, 63, 1001, 97, 64),
                       # one below, at and one past the 64-row tiles of
                       # anchors and of keys, and two tiles and one more;
                       # C at both tile widths' edges; N = 1, 20 and 64
                       (1, 1, 63, 64, 1), (2, 15, 64, 65, 20),
                       (1, 16, 65, 129, 64), (2, 63, 129, 63, 20),
                       (1, 63, 64, 129, 1), (1, 1, 129, 65, 64),
                       # the 512 size's keys: 78 tiles of rounded adds
                       (1, 60, 4096, 4964, 20)]


@pytest.mark.parametrize("b,c,p,k,n", BF16_SERVING_SHAPES)
def test_bf16_serving_matches_plain_version(cuda, b, c, p, k, n):
    conf, kk, v, wt, bt, wz, obj = serving_inputs(c + p + n, b, c, p, k, n,
                                                  cuda)
    bf = lambda t: t.to(torch.bfloat16)
    args = (bf(conf), bf(kk), bf(v), bf(wt), bt, wz, bf(obj))
    before = ct_attention_serving_bf16.launches
    first = ct_attention_serving_bf16(*args)
    second = ct_attention_serving_bf16(*args)
    ref = ct_attention_serving_reference_bf16(*args)
    torch.cuda.synchronize()
    assert ct_attention_serving_bf16.launches == before + 2
    assert first.dtype == torch.bfloat16 and first.shape == (b, n, p)
    assert torch.equal(first, second)
    err = (first.float() - ref.float()).abs().max().item()
    assert err <= bf16_step(ref.float().abs().max().item()), err
    # the public wrapper takes bf16 conf to the same kernel
    assert torch.equal(ct_attention_serving(*args), first)


@pytest.mark.parametrize("c,n", [(15, 5), (60, 20)])
def test_bf16_serving_is_batch_independent(cuda, c, n):
    """A block of the bf16 serving head owns 64 anchors of one image: its
    scores on 9 images, sliced to the first 3, equal bit for bit its
    scores on those 3 alone (what chip_smoke.py's batch-128 case leans
    on)."""
    bf = lambda t: t.to(torch.bfloat16)
    conf, kk, v, wt, bt, wz, obj = serving_inputs(c + n, 9, c, 1001, 130, n,
                                                  cuda)
    args = (bf(conf), bf(kk), bf(v), bf(wt), bt, wz, bf(obj))
    whole = ct_attention_serving_bf16(*args)
    alone = ct_attention_serving_bf16(
        *(a[:3] if a.dim() == 3 else a for a in args))
    torch.cuda.synchronize()
    assert torch.equal(whole[:3], alone)


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, kk, v, base, wz = bf16_inputs(1, 2, 64, 100, 40, cuda)
    with pytest.raises(ValueError, match="63 classes"):
        ct_attention_cm(q, kk, v, base, wz)
    q, kk, v, base, wz = bf16_inputs(1, 2, 15, 100, 40, cuda)
    with pytest.raises(TypeError, match="float32"):
        ct_attention_cm(q, kk, v, base, wz.to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        ct_attention_cm(q, kk.float(), v, base, wz)
    # a call that needs a gradient runs the bf16 training forward
    before = ct_attention_cm_stats_bf16.launches
    out = ct_attention_cm(q.requires_grad_(), kk, v, base, wz)
    assert out.dtype == torch.bfloat16
    assert ct_attention_cm_stats_bf16.launches == before + 1


# --- bfloat16 training kernels ----------------------------------------------

# the bands of chip_smoke.py's bf16 training cases: each output within
# 1e-4 of its mean |entry| in the mean (flips at bf16 rounding boundaries
# move it by at most 5e-6, a wrong rounding point by 1.4e-3 or more), and in
# the max within one bf16 step of its largest entry (the forward's out and
# delta) or 1e-2 of it (the backward's sums dq, dk, dv, dwz)
BF16_MEAN_TOL = 1e-4
BF16_MAX_TOL = 1e-2
BF16_TRAIN_SHAPES = [(2, 15, 11620, 1858), (2, 60, 11620, 1858),
                     (1, 1, 1, 1), (2, 7, 63, 31), (1, 15, 64, 32),
                     (2, 16, 65, 33), (1, 17, 1001, 97), (2, 60, 64, 1),
                     (1, 63, 1001, 33), (1, 60, 4100, 4964),
                     # one below, at and one past the backward kernels'
                     # 64-row tiles of anchors and of keys
                     (1, 60, 63, 65), (2, 16, 64, 64), (1, 15, 65, 63),
                     (2, 48, 129, 127)]


def hold_bf16_training(outs, plains, names):
    for n, a, r in zip(names, outs, plains):
        a, r = a.float(), r.float()
        d = (a - r).abs()
        scale = r.abs().max().item()
        tol = (bf16_step(scale) if n in ("out", "delta")
               else BF16_MAX_TOL * scale)
        assert d.max().item() <= tol, (n, d.max().item(), tol)
        assert d.mean().item() <= BF16_MEAN_TOL * r.abs().mean().item() \
            + 1e-30, (n, d.mean().item())


def bf16_training_case(path, b, c, p, k, device):
    """(kernel, its arguments, plain version, output names, its launch
    counter) of one bf16 training kernel on seeded inputs."""
    q, kk, v, base, wz = bf16_inputs(c * p + k + 9, b, c, p, k, device)
    g = bf16_inputs(c + p + k, b, c, p, k, device)[0]
    if path == "stats":
        return (ct_attention_cm_stats_bf16, (q, kk, v, base, wz),
                ct_attention_cm_stats_reference_bf16, ("out", "delta"))
    if path == "flash":
        _, delta, m, z = ct_attention_cm_stats_bf16(q, kk, v, base, wz)
        gd = g.float() * delta.float()
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        return (ct_attention_cm_bwd_flash_bf16,
                (q, kk, v, wz, g, m, z, colsum),
                ct_attention_cm_bwd_flash_reference_bf16, ("dq", "dk", "dv"))
    if path == "blockwise":
        return (ct_attention_cm_bwd_bf16, (q, kk, v, wz, g),
                ct_attention_cm_bwd_reference_bf16, ("dq", "dk", "dv", "dwz"))
    rm = lambda t: t.mul(0.3).transpose(1, 2).contiguous()
    return (ct_attention_bwd_bf16, (rm(q), kk.mul(0.3), v.mul(0.3), wz, rm(g)),
            ct_attention_bwd_reference_bf16, ("dq", "dk", "dv", "dwz"))


# the backwards at one key are left out: a softmax over one key has no
# derivative, so dq and dk vanish in exact arithmetic and both sides hold
# only the cancellation of dattn − colsum, rounding noise
BF16_TRAIN_CASES = [(path, *shape) for path in ("stats", "flash",
                                                "blockwise", "rowmajor")
                    for shape in BF16_TRAIN_SHAPES
                    if path == "stats" or shape[3] > 1]


@pytest.mark.parametrize("path,b,c,p,k", BF16_TRAIN_CASES)
def test_bf16_training_kernels_match_plain_versions(cuda, path, b, c, p, k):
    kernel, args, plain, names = bf16_training_case(path, b, c, p, k, cuda)
    before = kernel.launches
    with torch.no_grad():
        first, second = kernel(*args), kernel(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    hold_bf16_training(first, ref, names)
    if path == "stats":
        assert (first[2] - ref[2]).abs().max().item() <= \
            1e-5 * ref[2].abs().max().item()
        assert (first[3] - ref[3]).abs().max().item() <= 2.0 ** -5


def test_bf16_backward_division_matches_fdiv_rn(cuda):
    """Row 5's weights e / l: the backward kernels' quotient (1/l once a
    row, then Markstein's correction of e·(1/l); the division itself for
    tiny e) against ``__fdiv_rn`` and torch's division, bit for bit, over
    2²⁰ pairs across the kernels' range: e in [2⁻¹⁴⁹, 1], subnormals
    included, l in [1, 5000]."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 1 << 20
    u = lambda: torch.rand(n, generator=gen, device=cuda, dtype=torch.float64)
    # half spread over the exponents, half uniform in (0, 1]
    e = torch.cat([torch.exp2(-149 * u()[: n // 2]),
                   1 - u()[: n // 2]]).float().clamp_min(2.0 ** -149)
    l = torch.cat([1 + 4999 * u()[: n // 2],
                   torch.exp2(12.28 * u()[: n // 2])]).float()
    assert e.min() > 0 and e.max() <= 1 and (e < 2.0 ** -126).sum() > 1000
    assert l.min() >= 1 and l.max() <= 5000
    before = ct_attention_bwd_bf16_division.launches
    out, ref = ct_attention_bwd_bf16_division(e, l)
    torch.cuda.synchronize()
    assert ct_attention_bwd_bf16_division.launches == before + 1
    bits = lambda t: t.view(torch.int32)
    assert torch.equal(bits(out), bits(ref))
    assert torch.equal(bits(out), bits(e / l))


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_autograd_runs_the_training_kernels(cuda, flash):
    q, kk, v, base, wz = bf16_inputs(11, 2, 60, 1001, 97, cuda)
    g = bf16_inputs(12, 2, 60, 1001, 97, cuda)[0]
    kernels = ((ct_attention_cm_stats_bf16, ct_attention_cm_bwd_flash_bf16)
               if flash else (ct_attention_cm_bf16, ct_attention_cm_bwd_bf16))
    before = [fn.launches for fn in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, kk, v, base, wz)]
    out = ct_attention_cm(*leaves, flash=flash)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels] == [n + 1 for n in before]
    assert [t.dtype for t in grads] == [torch.bfloat16] * 4 + [torch.float32]
    assert torch.equal(grads[3], g)
    # the row-major layout, on its backward kernel
    rm = lambda t: t.transpose(1, 2).contiguous().requires_grad_()
    before = ct_attention_bwd_bf16.launches
    leaves = [rm(q), kk.clone().requires_grad_(), v.clone().requires_grad_(),
              rm(base), wz.clone().requires_grad_()]
    dq = torch.autograd.grad(ct_attention(*leaves), leaves[0],
                             g.transpose(1, 2).contiguous())[0]
    assert ct_attention_bwd_bf16.launches == before + 1
    assert dq.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 64, 300, 300), (3, 5, 6, 10)])
def test_bf16_pool_kernels_bitexact_vs_autograd(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    before = (pool2x2_relu_fwd_bf16.launches, pool2x2_relu_bwd_bf16.launches)
    xk = x.clone().requires_grad_()
    y = pool2x2_relu(xk)
    g = torch.randn(y.shape, device=cuda).to(torch.bfloat16)
    y.backward(g)
    xr = x.clone().requires_grad_()
    yr = F.max_pool2d(F.relu(xr), 2, 2)
    yr.backward(g)
    assert (pool2x2_relu_fwd_bf16.launches,
            pool2x2_relu_bwd_bf16.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, yr) and torch.equal(xk.grad, xr.grad)
    assert xk.grad.dtype == torch.bfloat16


def test_bf16_train_step_on_the_card_matches_the_cpu(cuda):
    """The size-64 bf16 model's loss and gradients on the card against the
    same model on the CPU, on the CPU's mined anchors, by what bf16 moves
    the CPU's result (its f32 model on them): the card's gradient vector
    as far from the f32 one as the CPU's bf16 one, within 0.5-1.5 of that
    effect, and within twice it of the CPU's bf16 one (chip_smoke.py's
    BF16_F32_SPAN and BF16_CARD_CPU_SPAN)."""
    from ct_tpu_torch.config import TINY_64
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.step import loss_and_grads

    task = resolve_task(2, "incre", "ours", "VOC")
    torch.manual_seed(0)
    state = build_net(task, 64, device="cpu").state_dict()
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (2, 3, 64, 64), np.float32)),
             "boxes": torch.tensor([[[0.1, 0.1, 0.6, 0.7]],
                                    [[0.3, 0.2, 0.9, 0.8]]]),
             "labels": torch.tensor([[3], [17]], dtype=torch.int32),
             "weights": torch.ones(2, 1),
             "valid": torch.ones(2, 1, dtype=torch.bool)}
    grads, mask = {}, None
    for key, dt, dev in (("cpu16", torch.bfloat16, "cpu"),
                         ("cpu32", torch.float32, "cpu"),
                         ("card16", torch.bfloat16, cuda)):
        net = build_net(task, 64, device=dev, dtype=dt)
        net.load_state_dict(state)
        _, m = loss_and_grads(net, {k: v.to(dev) for k, v in batch.items()},
                              prior_boxes(TINY_64, dev),
                              mask=None if mask is None else mask.to(dev))
        mask = m.cpu() if mask is None else mask
        grads[key] = torch.cat([p.grad.float().cpu().reshape(-1)
                                for p in net.parameters()])
    effect = (grads["cpu16"] - grads["cpu32"]).norm()
    to_f32 = (grads["card16"] - grads["cpu32"]).norm() / effect
    assert 0.5 <= to_f32 <= 1.5, float(to_f32)
    assert (grads["card16"] - grads["cpu16"]).norm() <= 2.0 * effect


def test_bf16_device_augment_on_the_card_matches_the_cpu(cuda):
    from ct_tpu_torch.data import augment_device as D

    b, canvas = 16, 384
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (b, 3, canvas, canvas),
                                           dtype=np.uint8))
    boxes = torch.tensor([[[0.1, 0.2, 0.5, 0.7]]] * b)
    labels = torch.full((b, 1), 3, dtype=torch.int32)
    valid = torch.ones(b, 1, dtype=torch.bool)
    gen = torch.Generator(device=cuda).manual_seed(5)
    photo, geom = D.sample_augment(gen, boxes.to(cuda), valid.to(cuda))
    out = D.apply_augment(images.to(cuda), boxes.to(cuda), labels.to(cuda),
                          valid.to(cuda), photo, geom,
                          out_dtype=torch.bfloat16)
    cpu = lambda r: type(r)(*(t.cpu() for t in (
        getattr(r, f) for f in r.__dataclass_fields__)))
    ref = D.apply_augment(images, boxes, labels, valid, cpu(photo),
                          cpu(geom), out_dtype=torch.bfloat16)
    assert out["image"].dtype == torch.bfloat16
    d = (out["image"].cpu().float() - ref["image"].float()).abs()
    assert d.max().item() <= bf16_step(ref["image"].float().abs().max()
                                       .item())
    assert (d > 0).float().mean().item() <= 1e-2
