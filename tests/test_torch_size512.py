"""RFBNet512 in the port vs the JAX package, on the CPU, on seeded weights.

The repository holds no trained 512 weights, so the models start from the
port's seeded init (BN statistics and CT parameters randomized), carried
into JAX by the JAX package's importer of reference state dicts
(``test_torch_train_accum.seeded_state``): no test pays JAX's init at 512.
One image of unit scale (at image scale these untrained weights saturate
the CT softmax), P = 32,756 priors, K = 4,964 CT keys (``CT_POOL[512]``,
the JAX package's extension past the reference).

* The forward of phase 1 ``transfer``, phase 2 ``incre`` and phase 2
  ``transfer``, with the bands of the size-300 test
  (``tests/test_torch_model.py``): logits rtol 1e-3 / atol 2e-3, softmaxed
  scores rtol 1e-3 / atol 1e-4.
* The eval step of the phase-2 incre model (forward → NMS → detections)
  against JAX's ``make_eval_step``, with the default top-k 200 and with
  the serving options of ``bench.py`` (approximate top-k 128 in a pool of
  512), in its two halves: the forward by the bands above (the forward
  test's phase-2 incre case, on the same image), and the
  port's post-processing on JAX's forward outputs against JAX's whole
  step by the band of ``test_slice_matches_jax_on_fixture_images`` (the
  same count, per box IoU ≥ 0.999, |Δscore| ≤ 1e-4); the test says why.
* int8 serving at 512 (``bench.py``'s 512 serving config): BN folded bit
  for bit as ``fold_variables``, each conv's calibrated absmax within
  rtol 1e-5 of JAX's, the ``quant`` collection (``SKIP_CT_ONLY``,
  ``vgg_pool_chains(512)``) bit for bit from JAX's calibration, and the
  serving model against JAX's folded, quantized net on JAX's scales: the
  chained int8 trunk maps at most one int8 step apart, and the outputs
  within ``test_torch_serving.py``'s max |Δ| ≤ 2e-2 of the largest
  output (1e-1 for the CT scores). Where XLA contracts a rescale into
  one fused multiply-add (``test_torch_serving.py``'s docstring), a
  value at a rounding boundary flips by one step; at 64 the test's
  images meet no such boundary in the trunk, at 512 (16.7M entries in
  conv1_2's map) they do: 2 entries of conv1_2's map, 1.6% of conv4_3's
  and 4.5% of conv5_3's after the flips have travelled through the
  trunk. So the mean band of ``test_torch_serving.py`` (1e-3 of the
  largest output) is not held here (measured 0.8e-3 to 1.1e-3); the test
  records the mean, and holds each map's flipped share within about
  twice its reading (``FLIP_SHARE``). JAX's CT head runs its XLA path
  (its kernel in interpret mode at P·K = 1.6e8 would cost minutes;
  ``test_torch_serving.py`` holds the port's plain head to it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import VOC_512 as J_VOC_512
from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.fold_bn import fold_variables
from ct_tpu.models.quantize import SKIP_CT_ONLY as J_SKIP_CT_ONLY
from ct_tpu.models.quantize import calibrate as j_calibrate
from ct_tpu.models.quantize import quantize_variables as j_quantize_variables
from ct_tpu.models.rfbnet import CT_POOL as J_CT_POOL
from ct_tpu.models.rfbnet import vgg_pool_chains as j_vgg_pool_chains
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu.ops.priors import prior_boxes as j_prior_boxes
from ct_tpu.train.step import make_eval_step as j_make_eval_step
from ct_tpu_torch.config import VOC_512, resolve_task
from ct_tpu_torch.eval import compare_detections
from ct_tpu_torch.models.convert import (
    from_jax_variables, quant_from_jax, serving_from_jax,
)
from ct_tpu_torch.models.fold_bn import fold_bn
from ct_tpu_torch.models.quantize import (
    SKIP_CT_ONLY, calibrate, quantize_variables,
)
from ct_tpu_torch.models.rfbnet import CT_POOL, build_net, vgg_pool_chains
from ct_tpu_torch.ops.detection import postprocess
from ct_tpu_torch.ops.priors import prior_boxes
from test_torch_model import assert_preds_close, jax_forward, port_forward
from test_torch_serving import SERVING_TOL, by_name, nhwc
from test_torch_train_accum import seeded_state
from test_torch_train_cli import two_threads  # noqa: F401

SIZE = 512
P, K = 32756, 4964
# the share of each chained int8 map's entries one step from JAX's. The
# flips grow through the trunk (measured: conv1_2 1.2e-7, conv2_2 6.7e-5,
# conv3_3 2.7e-3, conv4_3 1.6e-2, conv5_3 4.5e-2); each bound leaves about
# twice its reading or more, so a fault that moves many entries by one
# step (a rounding mode, a scale) fails at the map where it enters
FLIP_SHARE = {"base.2": 1e-5, "base.7": 1e-3, "base.14": 1e-2,
              "base.21": 4e-2, "base.28": 1e-1}


@pytest.fixture(autouse=True)
def _two_threads(two_threads):
    """Two torch threads: the suite runs its files in parallel processes."""
    yield


def image(seed, n=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, SIZE, SIZE)).astype(np.float32)


@pytest.fixture(scope="module")
def incre():
    """The phase-2 incre 512 model's seeded state and JAX variables."""
    task = resolve_task(2, "incre", "ours", "VOC")
    state = seeded_state(task, SIZE, seed=21)
    return task, j_resolve_task(2, "incre", "ours", "VOC"), state, \
        torch_state_to_variables(state)


@pytest.fixture(scope="module")
def incre_forward(incre):
    """One image through the phase-2 incre model's JAX forward and the
    port's, run once for the forward test and the eval step's."""
    task, jtask, state, variables = incre
    x = image(7)
    return x, jax_forward(jtask, SIZE, variables, x), port_forward(
        task, SIZE, state, x)


@pytest.mark.parametrize("phase,setting", [(1, "transfer"), (2, "incre"),
                                           (2, "transfer")])
def test_forward_matches_jax_size512(phase, setting, request):
    if (phase, setting) == (2, "incre"):
        _, ref, ours = request.getfixturevalue("incre_forward")
    else:
        task = resolve_task(phase, setting, "ours", "VOC")
        jtask = j_resolve_task(phase, setting, "ours", "VOC")
        state = seeded_state(task, SIZE, seed=20 + phase)
        x = image(phase)
        ref = jax_forward(jtask, SIZE, torch_state_to_variables(state), x)
        ours = port_forward(task, SIZE, state, x)
    assert ours[0].loc.shape == (1, P, 4)
    assert tuple(CT_POOL[SIZE]) == tuple(J_CT_POOL[SIZE])
    assert_preds_close(ours, ref, atol=2e-3)


@pytest.mark.parametrize("options", [
    {}, {"approx_top_k": True, "top_k": 128, "pool_size": 512}],
    ids=["top200", "serving"])
def test_eval_step_matches_jax_size512(options, incre, incre_forward):
    """The eval step in its two halves. Seeded heads regress boxes at
    random, so hundreds of boxes of a class overlap with scores a few 1e-6
    apart, and the forwards' last bits (XLA's and torch's f32 sums; torch's
    change with its thread count) reorder them ahead of NMS. So the
    forward is held by the forward bands (as in
    ``test_forward_matches_jax_size512``, on the same outputs), and the
    port's post-processing, fed JAX's forward outputs, to JAX's whole eval
    step by the band of ``test_slice_matches_jax_on_fixture_images``."""
    task, jtask, state, variables = incre
    x, ref, ours = incre_forward
    assert_preds_close(ours, ref, atol=2e-3)
    sizes = np.asarray([[375, 500]], np.int32)
    jstep = j_make_eval_step(j_build_net(jtask, SIZE),
                             j_prior_boxes(J_VOC_512), **options)
    jdets = jstep(variables["params"], variables["batch_stats"], nhwc(x),
                  jnp.asarray(sizes))
    preds, conf, obj = ref
    dets = postprocess(torch.from_numpy(np.array(preds.loc)),
                       torch.from_numpy(np.array(conf)),
                       torch.from_numpy(np.array(obj)),
                       prior_boxes(VOC_512), torch.from_numpy(sizes),
                       **options)
    agree = compare_detections(dets, jdets, image=0)
    assert agree["ok"] and agree["count_a"] > 0, agree


def test_int8_serving_matches_jax_size512(incre, record_property):
    task, jtask, state, variables = incre
    x = image(9)
    # fold: bit for bit
    net = build_net(task, SIZE, device="cpu")
    net.load_state_dict(state)
    folded = fold_bn(net)
    jfolded = fold_variables(variables)
    ref = from_jax_variables(jfolded)
    assert set(folded.state_dict()) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(folded.state_dict()[key].numpy(),
                                      val.numpy(), err_msg=key)
    # calibration
    fnet = dataclasses.replace(j_build_net(jtask, SIZE), fold_bn=True)
    jcalib = j_calibrate(fnet, jfolded, [nhwc(x)])
    calib = calibrate(folded, [torch.from_numpy(x)])
    jabs = by_name(jcalib)
    assert set(calib) == set(jabs)
    for name, val in jabs.items():
        np.testing.assert_allclose(calib[name].numpy(), val, rtol=1e-5,
                                   err_msg=name)
    # the chains and the quant collection from JAX's calibration
    chains = vgg_pool_chains(SIZE)
    assert [tuple(n.replace("base.", "vgg_") for n in pair)
            for pair in chains] == j_vgg_pool_chains(SIZE)
    jquant = j_quantize_variables(jfolded["params"], jcalib, J_SKIP_CT_ONLY,
                                  j_vgg_pool_chains(SIZE))
    ours = quantize_variables(
        folded, {k: torch.tensor(v) for k, v in jabs.items()}, SKIP_CT_ONLY,
        chains)
    qref = quant_from_jax(jquant)
    assert set(ours) == set(qref)
    for name, q in qref.items():
        assert set(ours[name]) == set(q), name
        for key, val in q.items():
            np.testing.assert_array_equal(ours[name][key], val,
                                          err_msg=f"{name}.{key}")
    # the serving model on JAX's scales
    ref, inter = jax.jit(lambda v, xx: fnet.apply(
        v, xx, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(dict(jfolded, quant=jquant), nhwc(x))
    served = serving_from_jax(task, SIZE, jfolded, jquant, "cpu")
    maps = {}
    for producer, _ in chains:
        served.get_submodule(producer).register_forward_hook(
            lambda m, a, y, name=producer: maps.__setitem__(name, y))
    with torch.inference_mode():
        out = served(torch.from_numpy(x))
    # the chained int8 trunk maps: at most one int8 step apart (a rescale
    # at a rounding boundary, see the module docstring)
    for (producer, _), (jname, _) in zip(chains, j_vgg_pool_chains(SIZE)):
        ours_map = maps[producer].numpy().transpose(0, 2, 3, 1)
        ref_map = np.asarray(inter["intermediates"][jname]["__call__"][0])
        assert ours_map.dtype == ref_map.dtype == np.int8, producer
        step = np.abs(ours_map.astype(np.int16) - ref_map)
        share = float((step > 0).mean())
        record_property(f"{producer}_flipped_share", share)
        assert step.max() <= 1, producer
        assert share <= FLIP_SHARE[producer], (producer, share)
    for name in ("loc", "obj", "conf_feat", "conf"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape
        err = np.abs(a - b) / np.abs(b).max()
        record_property(f"{name}_mean_err", float(err.mean()))
        assert err.max() <= SERVING_TOL[name], (name, err.max())
