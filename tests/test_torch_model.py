"""The port's RFBNet forward vs the JAX package's, on the same weights.

Weights go JAX → port through ``from_jax_variables``; the same numpy
image goes into both (NHWC for JAX, NCHW for the port). Size 64 (the
reduced test plan) covers phase 1, phase 2 incre and phase 2 transfer
with random weights whose BN statistics and CT parameters are randomized,
so every head and the CT attention carry signal; one image at size 300
runs the full-width phase-2 incre model with ``.parity_p2/ref_model.pth``.

Bands (those of tests/test_model_parity.py): f32 convolutions sum in
another order in XLA and in PyTorch, so outputs agree to rtol 1e-3 with
atol 1e-4 at size 64 and atol 2e-3 for the logits of the full-width net;
softmaxed scores to rtol 1e-3 / atol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.rfbnet import eval_scores as j_eval_scores
from ct_tpu.models.torch_export import variables_to_torch_state
from ct_tpu.models.torch_import import torch_state_to_variables
from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.convert import from_jax_variables, load_reference_pth
from ct_tpu_torch.models.rfbnet import build_net, eval_scores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODEL = os.path.join(REPO, ".parity_p2", "ref_model.pth")


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def random_jax_variables(task, size, seed):
    """JAX-initialized variables with randomized BN statistics, Wz,
    OBJ_Target and fc_base (their inits are zeros or near zero)."""
    net = j_build_net(task, size)
    variables = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    variables = _to_numpy({k: variables[k]
                           for k in ("params", "batch_stats")})
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif key == "mean":
                tree[key] = rng.standard_normal(val.shape, np.float32) * 0.1
            elif key == "var":
                tree[key] = rng.uniform(0.5, 1.5, val.shape).astype(
                    np.float32)
            elif key in ("Wz", "OBJ_Target") or "fc_base" in path:
                tree[key] = rng.standard_normal(val.shape, np.float32) * 0.3

    walk(variables)
    return variables


def jax_forward(task, size, variables, x_nchw):
    net = j_build_net(task, size)
    preds = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1))))
    conf, obj = j_eval_scores(preds)
    return preds, np.asarray(conf), np.asarray(obj)


def port_forward(task, size, state_dict, x_nchw):
    net = build_net(task, size, device="cpu")
    net.load_state_dict(state_dict)
    with torch.inference_mode():
        preds = net(torch.from_numpy(x_nchw))
        conf, obj = eval_scores(preds)
    return preds, conf.numpy(), obj.numpy()


def assert_preds_close(ours, ref, atol, rtol=1e-3, score_atol=1e-4):
    (p, conf, obj), (jp, jconf, jobj) = ours, ref
    for name in ("loc", "conf", "obj", "conf_feat"):
        a, b = getattr(p, name).numpy(), np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_allclose(conf, jconf, rtol=rtol, atol=score_atol)
    np.testing.assert_allclose(obj, jobj, rtol=rtol, atol=score_atol)


@pytest.mark.parametrize("phase,setting", [(1, "transfer"), (2, "incre"),
                                           (2, "transfer")])
def test_forward_matches_jax_size64(phase, setting):
    jtask = j_resolve_task(phase, setting, "ours", "VOC")
    task = resolve_task(phase, setting, "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=phase)
    # unit scale: these untrained weights are not normalized for
    # image-scale inputs (at x20 the conf logits reach ~120 and the CT
    # softmax saturates); the size-300 test below runs trained weights on
    # image-scale inputs
    x = np.random.default_rng(7).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)
    ref = jax_forward(jtask, 64, variables, x)
    ours = port_forward(task, 64, from_jax_variables(variables), x)
    assert ours[0].conf.shape[-1] == (jtask.num_classes - 1
                                      if phase == 2 else jtask.src_cls_dim)
    assert_preds_close(ours, ref, atol=1e-4)


def test_forward_matches_jax_size300_ref_model():
    task = resolve_task(2, "incre", "ours", "VOC")
    jtask = j_resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    variables = torch_state_to_variables(state)
    rng = np.random.default_rng(3)
    x = (rng.uniform(0, 255, (1, 3, 300, 300)) - 117).astype(np.float32)
    ref = jax_forward(jtask, 300, variables, x)
    ours = port_forward(task, 300, state, x)
    assert ours[0].conf.shape == (1, 11620, 20)
    assert_preds_close(ours, ref, atol=2e-3)


@pytest.mark.parametrize("phase,setting", [(1, "transfer"), (2, "incre"),
                                           (2, "transfer")])
def test_state_dict_round_trips_through_reference_key_space(phase, setting):
    jtask = j_resolve_task(phase, setting, "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=10 + phase)
    ours = from_jax_variables(variables)
    # the port's copy of the key mapping agrees with the JAX package's
    ref = variables_to_torch_state(variables)
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    # every tensor of the port's module is covered, and back again
    net = build_net(resolve_task(phase, setting, "ours", "VOC"), 64,
                    device="cpu")
    net.load_state_dict(ours)          # strict: no missing/unexpected keys
    back = torch_state_to_variables(net.state_dict())
    got, want = dict(_flatten(back)), dict(_flatten(variables))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg="/".join(key))


def test_load_reference_pth_loads_strict():
    state = load_reference_pth(REF_MODEL)
    assert len(state) == 383
    net = build_net(resolve_task(2, "incre", "ours", "VOC"), 300,
                    device="cpu")
    net.load_state_dict(state)
    assert net.OBJ_Target.weight.shape == (5, 15)


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val
