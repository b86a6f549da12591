"""The port's int8 serving path vs the JAX package's, on the CPU.

Weights go JAX → port through ``from_jax_variables``; the same numpy
images go into both. The size-64 test plan at batch 2, random weights with
randomized BN statistics and CT parameters (``random_jax_variables``).

* ``fold_bn``: the folded weights equal the JAX package's
  ``fold_variables`` bit for bit (the same float32 operations, the square
  root correctly rounded); the folded model's outputs match the unfolded
  model's to 1e-5, and its scores, which the fused serving head computes
  with ``rsqrt`` where the unfused one divides, to 1e-4.
* Calibration: each conv's input absmax within rtol 1e-5 of JAX
  ``calibrate`` (the float convs before it sum in another order).
* Quantization from JAX's calibration: ``kernel_int8``, ``kernel_scale``,
  ``act_scale`` and ``out_scale`` bit for bit; the chain lists at 64 and
  300 name the same convs.
* One int8 conv vs JAX ``Conv2d`` on the same scales: the int32 sum is
  exact, so ``y`` agrees to 1 ulp (XLA may fuse the rescale and the bias
  add into one rounding); a chained producer's int8 output and its
  consumer agree exactly.
* Pool chains: chained and unchained int8 serving are bit for bit equal
  in the port (round and clip commute with ReLU and max: the port runs
  the ReLU before the pool, the JAX package after).
* ``ct_attention_serving_reference`` vs the JAX kernel in interpret mode,
  at ragged P and K, C=15/N=5 and C=60/N=20: rtol/atol 1e-5 (f32 sums over
  K in another order).
* The serving model (incre and transfer; ``SKIP_DEFAULT`` and
  ``SKIP_CT_ONLY``) vs JAX's ``fold_bn=True, use_pallas_ct=True`` net in
  interpret mode, on JAX's scales. The VGG trunk's chained int8 maps agree
  bit for bit: every int8 conv sums exactly. Past them the int8 values
  may flip by one step: XLA contracts some rescales ``acc·s + bias`` into
  one fused multiply-add where the port rounds twice, as the JAX package
  writes it, so ``y`` moves by an ulp (measured: 28% of a Norm conv's
  outputs), and where ``y/scale`` lies that close to a rounding boundary
  the next conv's int8 input flips. The float head convs and the CT head
  also sum in another order. So the outputs are held to
  mean |Δ| ≤ 1e-3 and max |Δ| ≤ 2e-2 of the largest output for loc, obj
  and conf_feat (measured ≤ 5.6e-3 max), and max |Δ| ≤ 1e-1 for the CT
  scores, whose softmax and normalisation amplify a flip (measured
  ≤ 4.7e-2).
* The eval CLI with ``--int8 --calib-images 2`` on a small VOC root, on
  the CPU; each flag the port refuses raises and names its ROADMAP item
  (``--bf16`` runs: tests/test_torch_bf16.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ct_tpu.config import resolve_task as j_resolve_task
from ct_tpu.models import build_net as j_build_net
from ct_tpu.models.fold_bn import fold_variables
from ct_tpu.models.layers import Conv2d as JConv2d
from ct_tpu.models.quantize import SKIP_CT_ONLY as J_SKIP_CT_ONLY
from ct_tpu.models.quantize import SKIP_DEFAULT as J_SKIP_DEFAULT
from ct_tpu.models.quantize import calibrate as j_calibrate
from ct_tpu.models.quantize import quantize_variables as j_quantize_variables
from ct_tpu.models.rfbnet import vgg_pool_chains as j_vgg_pool_chains
from ct_tpu.ops.ct_attention import ct_attention_serving as j_serving
from ct_tpu_torch.config import resolve_task
from ct_tpu_torch.models.convert import (
    from_jax_variables, quant_from_jax, serving_from_jax, torch_module_name,
)
from ct_tpu_torch.models.fold_bn import fold_bn
from ct_tpu_torch.models.layers import Conv2d, MaxPool2d
from ct_tpu_torch.models.quantize import (
    SKIP_CT_ONLY, SKIP_DEFAULT, attach, calibrate, quantize_variables,
)
from ct_tpu_torch.models.rfbnet import build_net, vgg_pool_chains
from ct_tpu_torch.ops.ct_attention import (
    ct_attention_serving, ct_attention_serving_reference,
)
from test_torch_model import random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, ".parity_p2")
# bands of the serving model vs JAX, relative to the largest output (see
# the module docstring)
SERVING_MEAN_TOL = 1e-3
SERVING_TOL = {"loc": 2e-2, "obj": 2e-2, "conf_feat": 2e-2, "conf": 1e-1}
SKIPS = {"default": (SKIP_DEFAULT, J_SKIP_DEFAULT),
         "ct_only": (SKIP_CT_ONLY, J_SKIP_CT_ONLY)}


def images(seed, n=2, size=64):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def by_name(tree, leaf="act_absmax"):
    """A flax tree of per-module values → {the port's module name: value}."""
    out = {}

    def walk(node, path):
        if leaf in node:
            v = node[leaf]
            out[torch_module_name(path)] = np.asarray(
                v[0] if isinstance(v, (tuple, list)) else v)
            return
        for key, child in node.items():
            walk(child, path + (key,))

    walk(tree, ())
    return out


def port_net(task, variables, fold=False):
    net = build_net(task, 64, device="cpu", fold_bn=fold)
    net.load_state_dict(from_jax_variables(variables))
    return net


@pytest.fixture(scope="module", params=["incre", "transfer"])
def case(request):
    """One setting's JAX serving state: variables, folded variables, the
    calibration and the folded net, on two seeded images."""
    setting = request.param
    jtask = j_resolve_task(2, setting, "ours", "VOC")
    task = resolve_task(2, setting, "ours", "VOC")
    variables = random_jax_variables(jtask, 64, seed=11)
    folded = fold_variables(variables)
    fnet = dataclasses.replace(j_build_net(jtask, 64), fold_bn=True)
    x = images(5)
    calib = j_calibrate(fnet, folded, [nhwc(x)])
    return dict(setting=setting, jtask=jtask, task=task, x=x,
                variables=variables, folded=folded, fnet=fnet, calib=calib)


def test_fold_bn_matches_jax_and_the_unfolded_model(case):
    net = port_net(case["task"], case["variables"])
    folded = fold_bn(net)
    assert not folded.training and folded.fold_bn and not net.fold_bn
    ours = folded.state_dict()
    ref = from_jax_variables(case["folded"])
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val.numpy(),
                                      err_msg=key)
    # the unfolded net is left as it was, and the two agree in eval mode;
    # the unfused and fused CT heads differ in rounding only
    assert any(".bn." in k for k in net.state_dict())
    x = torch.from_numpy(case["x"])
    with torch.inference_mode():
        a, b = net(x), folded(x)
    for name, tol in (("loc", 1e-5), ("obj", 1e-5), ("conf_feat", 1e-5),
                      ("conf", 1e-4)):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   getattr(a, name).numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


def test_calibration_matches_jax(case):
    folded = port_net(case["task"], case["folded"], fold=True)
    ours = calibrate(folded, [torch.from_numpy(case["x"])])
    ref = by_name(case["calib"])
    assert set(ours) == set(ref) and len(ref) == 36   # every conv
    for name, val in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), val, rtol=1e-5,
                                   err_msg=name)
    # the Norm source taps the chained int8 conv4_3 map: its absmax is the
    # one base.10 (the chain's consumer at 64) calibrates
    assert ours["Norm.branch0.0.conv"] == ours["base.10"]


@pytest.mark.parametrize("skip", list(SKIPS))
def test_quantize_matches_jax_bit_for_bit(case, skip):
    ours_skip, j_skip = SKIPS[skip]
    folded = port_net(case["task"], case["folded"], fold=True)
    calib = {k: torch.tensor(v) for k, v in by_name(case["calib"]).items()}
    ours = quantize_variables(folded, calib, ours_skip, vgg_pool_chains(64))
    ref = quant_from_jax(j_quantize_variables(
        case["folded"]["params"], case["calib"], j_skip,
        j_vgg_pool_chains(64)))
    assert set(ours) == set(ref)
    heads = [n for n in ours if n.split(".")[0] in ("loc", "conf", "obj")]
    assert (len(heads) > 0) == (skip == "ct_only")
    for name, q in ref.items():
        assert set(ours[name]) == set(q), name
        for key, val in q.items():
            assert ours[name][key].dtype == val.dtype, (name, key)
            np.testing.assert_array_equal(ours[name][key], val,
                                          err_msg=f"{name}.{key}")
    assert sum("out_scale" in q for q in ours.values()) == 3


@pytest.mark.parametrize("size", [64, 300])
def test_pool_chains_name_the_jax_chains(size):
    ref = [tuple(torch_module_name((n,)) for n in pair)
           for pair in j_vgg_pool_chains(size)]
    assert vgg_pool_chains(size) == ref
    if size == 300:
        assert ("base.21", "base.24") in ref     # across the Norm tap


def jax_conv(x, kernel, bias, quant, **kw):
    conv = JConv2d(kernel.shape[-1], kernel.shape[:2], **kw)
    return np.asarray(conv.apply(
        {"params": {"kernel": kernel, "bias": bias}, "quant": quant},
        jnp.asarray(x)))


def port_conv(x, kernel, bias, quant, stride=1, padding=0, dilation=1):
    kh, kw, cin, cout = kernel.shape
    conv = Conv2d(cin, cout, (kh, kw), stride=stride, padding=padding,
                  dilation=dilation)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(bias))
    conv.set_quant(**{k: torch.from_numpy(np.asarray(
        np.transpose(v, (3, 2, 0, 1)) if k == "kernel_int8" else v))
        for k, v in quant.items()})
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))
    with torch.inference_mode():
        y = conv(xt)
    return np.transpose(y.numpy(), (0, 2, 3, 1))


def scales(rng, x, kernel):
    w_s = (np.abs(kernel).reshape(-1, kernel.shape[-1]).max(0)
           / 127.0).astype(np.float32)
    return {"act_scale": np.float32(np.abs(x).max() / 127.0),
            "kernel_int8": np.clip(np.rint(kernel / w_s), -127,
                                   127).astype(np.int8),
            "kernel_scale": w_s}


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1),
                                                     (1, 3, 3)])
def test_int8_conv_matches_jax(stride, padding, dilation):
    rng = np.random.default_rng(stride * 10 + dilation)
    x = rng.standard_normal((2, 13, 11, 12)).astype(np.float32)
    k1 = rng.standard_normal((3, 3, 12, 20)).astype(np.float32) * 0.1
    b1 = rng.standard_normal(20).astype(np.float32)
    k2 = rng.standard_normal((1, 3, 20, 9)).astype(np.float32) * 0.1
    b2 = rng.standard_normal(9).astype(np.float32)
    q1 = scales(rng, x, k1)
    kw = dict(strides=(stride, stride), padding=((padding,) * 2,) * 2,
              kernel_dilation=(dilation, dilation))
    pkw = dict(stride=stride, padding=padding, dilation=dilation)
    y = jax_conv(x, k1, b1, q1, **kw)
    ours = port_conv(x, k1, b1, q1, **pkw)
    assert y.dtype == ours.dtype == np.float32
    np.testing.assert_array_max_ulp(ours, y, maxulp=1)
    # a chained producer emits int8 at its consumer's scale; the consumer
    # takes it as it is
    q2 = scales(rng, np.maximum(y, 0), k2)
    q1c = dict(q1, out_scale=q2["act_scale"])
    y8 = jax_conv(x, k1, b1, q1c, **kw)
    ours8 = port_conv(x, k1, b1, q1c, **pkw)
    assert y8.dtype == ours8.dtype == np.int8
    np.testing.assert_array_equal(ours8, y8)
    z = jax_conv(np.maximum(y8, 0), k2, b2, q2, padding=((0, 0), (1, 1)))
    ours_z = port_conv(np.maximum(ours8, 0), k2, b2, q2, padding=(0, 1))
    np.testing.assert_array_max_ulp(ours_z, z, maxulp=1)


def test_int8_pool_commutes_with_relu():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -127, 128, (2, 5, 9, 9)).astype(np.int8))
    for pool in (MaxPool2d(2, 2, ceil_mode=True), MaxPool2d(3, 1, padding=1)):
        a = torch.relu(pool(x))
        assert a.dtype == torch.int8
        assert torch.equal(a, pool(torch.relu(x)))
        assert torch.equal(a, torch.relu(pool(x.float())).to(torch.int8))


def test_pool_chains_are_bit_exact_in_the_port(case):
    x = torch.from_numpy(images(6))
    nets = []
    for chains in ((), vgg_pool_chains(64)):
        net = port_net(case["task"], case["folded"], fold=True)
        calib = calibrate(net, [x])
        attach(net, quantize_variables(net, calib, chains=chains))
        nets.append(net)
    assert nets[1].base[0].out_scale is not None
    assert nets[0].base[0].out_scale is None
    with torch.inference_mode():
        a, b = nets[0](x), nets[1](x)
    for name in ("loc", "conf", "obj", "conf_feat"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("c,n", [(15, 5), (60, 20)])
def test_serving_head_matches_jax_kernel(c, n):
    rng = np.random.default_rng(c)
    b, p, kk = 2, 1001, 97      # P and K ragged against the kernels' tiles
    arrs = dict(conf_cm=rng.standard_normal((b, c, p)),
                k=rng.standard_normal((b, kk, c)) * 0.3,
                v=rng.standard_normal((b, kk, c)),
                w_theta=rng.standard_normal((c, c)) * 0.2,
                b_theta=rng.standard_normal(c) * 0.1,
                wz=rng.standard_normal(c) * 0.3,
                obj_target=rng.standard_normal((n, c)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    ref = np.asarray(j_serving(**{k: jnp.asarray(v) for k, v in arrs.items()},
                               interpret=True))
    before = ct_attention_serving.launches
    tens = {k: torch.from_numpy(v) for k, v in arrs.items()}
    ours = ct_attention_serving(**tens)
    assert ct_attention_serving.launches == before     # CPU: plain version
    assert ours.shape == (b, n, p)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ours.numpy(), ct_attention_serving_reference(**tens).numpy())


@pytest.mark.parametrize("skip", list(SKIPS))
def test_serving_model_matches_jax(case, skip):
    ours_skip, j_skip = SKIPS[skip]
    quant = j_quantize_variables(case["folded"]["params"], case["calib"],
                                 j_skip, j_vgg_pool_chains(64))
    snet = dataclasses.replace(case["fnet"], use_pallas_ct=True)
    x = case["x"]
    with pltpu.force_tpu_interpret_mode():
        ref, inter = jax.jit(lambda v, xx: snet.apply(
            v, xx, train=False, capture_intermediates=True,
            mutable=["intermediates"]))(dict(case["folded"], quant=quant),
                                        nhwc(x))
    ref_chain = {torch_module_name((n,)): np.asarray(
        inter["intermediates"][n]["__call__"][0])
        for n, _ in j_vgg_pool_chains(64)}

    net = serving_from_jax(case["task"], 64, case["folded"], quant, "cpu")
    outs = {}
    for name in ref_chain:
        net.get_submodule(name).register_forward_hook(
            lambda m, a, y, name=name: outs.__setitem__(name, y))
    with torch.inference_mode():
        ours = net(torch.from_numpy(x))
    # the int8 trunk: every chained producer's int8 map, bit for bit
    for name, val in ref_chain.items():
        assert outs[name].dtype == torch.int8 and val.dtype == np.int8
        np.testing.assert_array_equal(
            np.transpose(outs[name].numpy(), (0, 2, 3, 1)), val,
            err_msg=name)
    for name in ("loc", "obj", "conf_feat", "conf"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        err = np.abs(a - b) / np.abs(b).max()
        assert err.mean() <= SERVING_MEAN_TOL, (name, err.mean())
        assert err.max() <= SERVING_TOL[name], (name, err.max())


def _voc_root(tmp_path, n_test, n_train):
    """A VOC root of the first fixture test images and train-split images
    (symlinks)."""
    src = os.path.join(PARITY, "voc", "VOCdevkit", "VOC2007")
    dst = tmp_path / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (dst / sub).mkdir(parents=True)
    main = os.path.join(src, "ImageSets", "Main")
    lists = {}
    for name, n in (("test", n_test), ("trainval_split1", n_train)):
        with open(os.path.join(main, name + ".txt")) as f:
            lists[name] = [line.strip() for line in f][:n]
        (dst / "ImageSets" / "Main" / (name + ".txt")).write_text(
            "".join(i + "\n" for i in lists[name]))
    for i in set(lists["test"]) | set(lists["trainval_split1"]):
        os.symlink(os.path.join(src, "Annotations", i + ".xml"),
                   dst / "Annotations" / (i + ".xml"))
        os.symlink(os.path.join(src, "JPEGImages", i + ".jpg"),
                   dst / "JPEGImages" / (i + ".jpg"))
    return str(tmp_path / "VOCdevkit")


def test_eval_cli_int8_on_a_small_voc_root(tmp_path, monkeypatch, caplog):
    from ct_tpu_torch import test as cli

    monkeypatch.setenv("VOC_ROOT", _voc_root(tmp_path, 2, 2))
    save = str(tmp_path / "out")
    before = ct_attention_serving.launches
    with caplog.at_level("INFO", logger="ct_tpu_torch.test"):
        res = cli.main(["-p", "2", "--setting", "incre", "--split", "1",
                        "--load-file", os.path.join(PARITY, "ref_model.pth"),
                        "--save-folder", save, "-b", "2", "--int8",
                        "--calib-images", "2", "--approx-topk", "on",
                        "--pool-size", "512", "--top-k", "128",
                        "--device", "cpu"])
    assert ct_attention_serving.launches == before
    assert "int8 calibration: 2 train-split images" in caplog.text
    assert "66 convs quantized" in caplog.text
    assert set(res) == {"mAP", "APs", "base_mAP", "novel_mAP"}
    with open(os.path.join(save, "inference", "speed.json")) as f:
        speed = json.load(f)
    assert speed["int8"] and speed["images"] == 2 and speed["device"] == "cpu"


@pytest.mark.parametrize("flag,item", [
    (["--ndev", "2"], "Queue 1 item 8"),
    (["--pallas-ct", "on"], "always runs its CT kernels")])
def test_eval_cli_refuses_what_is_not_ported(flag, item):
    from ct_tpu_torch import test as cli

    with pytest.raises(SystemExit, match=item):
        cli.main(flag + ["--device", "cpu"])


def test_eval_cli_needs_weights(tmp_path):
    from ct_tpu_torch import test as cli

    with pytest.raises(SystemExit, match="--load-file is required"):
        cli.main(["--resume", "--save-folder", str(tmp_path),
                  "--device", "cpu"])
