"""The port's vision ops and layers against the JAX package, on the CPU, in
float32.

Ops (``nd.Convolution``, ``nd.Pooling``, ``nd.BatchNorm``, ``nd.Activation``,
``nd.Flatten``) take the same numpy inputs in both packages; forward values
and gradients (of ``sum(out * head)`` with a random head) agree within 1e-5
of the largest reference value, the two libraries' float32 summation
orders. The models (LeNet, ResNet) are held in
``test_torch_vision_models.py``.
"""
import numpy as onp
import pytest
import torch

import jax  # noqa: F401  (JAX_PLATFORMS=cpu is set by conftest)

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

OP_REL = 1e-5


def _assert_rel(got, ref, rel, what=""):
    """max |got - ref| <= rel * max |ref| over the finite entries; infinite
    entries must be equal."""
    got, ref = onp.asarray(got, dtype=onp.float64), onp.asarray(ref, onp.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    fin = onp.isfinite(ref)
    assert onp.array_equal(got[~fin], ref[~fin]), what
    scale = onp.abs(ref[fin]).max() if fin.any() else 0.0
    err = onp.abs(got[fin] - ref[fin]).max() if fin.any() else 0.0
    assert err <= rel * scale + 1e-30, "%s: max abs err %.3g > %.1g x %.3g" \
        % (what, err, rel, scale)


def _jax_op(fn, arrays, head, train_mode=True):
    """(out, grads of sum(out * head) for every array) of a JAX nd op."""
    nds = [mx.nd.array(a) for a in arrays]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record(train_mode=train_mode):
        out = fn(*nds)
    out.backward(mx.nd.array(head))
    return out.asnumpy(), [a.grad.asnumpy() for a in nds]


def _port_op(fn, arrays, head, train_mode=True):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    with mxt.autograd.record(train_mode=train_mode):
        out = fn(*ts)
    out.backward(torch.from_numpy(head))
    return out.detach().numpy(), [t.grad.numpy() if t.grad is not None
                                  else onp.zeros_like(a)
                                  for t, a in zip(ts, arrays)]


def _hold_op(jfn, tfn, arrays, train_mode=True, seed=0):
    """``tfn`` against ``jfn`` on ``arrays``: forward and every gradient of
    ``sum(out * head)`` within ``OP_REL``; returns the port's output."""
    with mx.autograd.record(train_mode=train_mode):
        shape = jfn(*[mx.nd.array(a) for a in arrays]).shape
    head = onp.random.RandomState(seed).randn(*shape).astype("float32")
    ref_out, ref_grads = _jax_op(jfn, arrays, head, train_mode)
    out, grads = _port_op(tfn, arrays, head, train_mode)
    _assert_rel(out, ref_out, OP_REL, "forward")
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        _assert_rel(g, r, OP_REL, "gradient of input %d" % i)
    return out


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("case", [
    dict(x=(2, 3, 9, 9), w=(4, 3, 3, 3), kw=dict(kernel=(3, 3))),
    dict(x=(2, 4, 11, 8), w=(6, 4, 3, 3), bias=True,
         kw=dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    dict(x=(1, 4, 10, 10), w=(6, 2, 3, 3),
         kw=dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_group=2)),
    dict(x=(2, 3, 12), w=(5, 3, 4), bias=True,
         kw=dict(kernel=(4,), stride=(2,), pad=(1,))),
    dict(x=(1, 2, 5, 6, 4), w=(3, 2, 3, 3, 3),
         kw=dict(kernel=(3, 3, 3), pad=(1, 1, 1))),
], ids=["3x3", "stride2-pad1-bias", "dilate2-groups2", "1d", "3d"])
def test_convolution_matches_jax(case):
    rng = onp.random.RandomState(1)
    arrays = [rng.randn(*case["x"]).astype("float32"),
              rng.randn(*case["w"]).astype("float32")]
    if case.get("bias"):
        arrays.append(rng.randn(case["w"][0]).astype("float32"))
    kw = dict(case["kw"], num_filter=case["w"][0])
    n = len(case["kw"]["kernel"])
    _hold_op(lambda *a: mx.nd.Convolution(*a, no_bias=len(a) == 2, **kw),
             lambda *a: mxt.nd.Convolution(*a, no_bias=len(a) == 2, **kw),
             arrays)
    assert mxt.nd.Convolution(torch.from_numpy(arrays[0]),
                              torch.from_numpy(arrays[1]), None,
                              layout="NC" + "DHW"[3 - n:], no_bias=True,
                              **kw).shape[1] == case["w"][0]


@pytest.mark.parametrize("kw,shape", [
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
     (2, 3, 9, 9)),
    (dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
          pooling_convention="full"), (2, 3, 8, 11)),
    # the last window lies wholly in the padding: -inf / 0 in both
    (dict(pool_type="max", kernel=(3, 3), stride=(3, 3), pad=(1, 1),
          pooling_convention="full"), (1, 2, 2, 5)),
    (dict(pool_type="avg", kernel=(3, 3), stride=(3, 3), pad=(1, 1),
          pooling_convention="full"), (1, 2, 2, 5)),
    (dict(pool_type="avg", kernel=(2, 2), stride=(2, 2)), (2, 3, 8, 8)),
    (dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          pooling_convention="full"), (2, 3, 9, 7)),
    (dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
          pooling_convention="full", count_include_pad=False), (2, 3, 9, 7)),
    (dict(pool_type="avg", kernel=(3, 2), stride=(1, 2), pad=(1, 0),
          count_include_pad=False), (1, 2, 7, 6)),
    (dict(pool_type="sum", kernel=(2, 3), stride=(2, 1)), (2, 2, 7, 7)),
    (dict(pool_type="max", global_pool=True, kernel=(1, 1)), (2, 3, 5, 7)),
    (dict(pool_type="avg", global_pool=True, kernel=(1, 1)), (2, 3, 5, 7)),
], ids=["max-pad", "max-full", "max-full-pad-window", "avg-full-pad-window",
        "avg", "avg-full-incl-pad", "avg-full-excl-pad", "avg-excl-pad",
        "sum", "global-max", "global-avg"])
def test_pooling_matches_jax(kw, shape):
    x = onp.random.RandomState(2).randn(*shape).astype("float32")
    _hold_op(lambda a: mx.nd.Pooling(a, **kw),
             lambda a: mxt.nd.Pooling(a, **kw), [x])


def test_max_pool_ties_after_relu_give_the_same_gradient():
    """After ReLU most windows hold ties at 0. The two libraries may route a
    tie's gradient to different positions, but ReLU's gradient at 0 is 0 in
    both, so the gradient through relu → max-pool agrees."""
    x = onp.random.RandomState(3).randn(2, 3, 8, 8).astype("float32") - 1.0
    kw = dict(pool_type="max", kernel=(2, 2), stride=(2, 2))
    with mx.autograd.record():
        pooled = mx.nd.Pooling(mx.nd.Activation(mx.nd.array(x),
                                                 act_type="relu"),
                                **kw).asnumpy()
    assert (pooled == 0).mean() > 0.3          # ties at 0 are common here
    _hold_op(lambda a: mx.nd.Pooling(mx.nd.Activation(a, act_type="relu"),
                                     **kw),
             lambda a: mxt.nd.Pooling(mxt.nd.Activation(a, act_type="relu"),
                                      **kw), [x])


@pytest.mark.parametrize("mode", ["train", "train-fix-gamma", "inference",
                                  "use-global-stats"])
def test_batchnorm_matches_jax(mode):
    """Forward, gradients of x, gamma and beta, and the running statistics
    after the call (updated in training mode only)."""
    rng = onp.random.RandomState(4)
    x = (rng.randn(4, 3, 5, 6) * 2 + 1).astype("float32")
    g = (rng.rand(3) + 0.5).astype("float32")
    b = rng.randn(3).astype("float32")
    mm = (rng.randn(3) * 0.1).astype("float32")
    mv = (rng.rand(3) + 0.5).astype("float32")
    kw = dict(fix_gamma=mode == "train-fix-gamma",
              use_global_stats=mode == "use-global-stats")
    train = mode != "inference"
    jstats = [mx.nd.array(mm), mx.nd.array(mv)]
    tstats = [torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())]
    head = rng.randn(*x.shape).astype("float32")
    ref, ref_grads = _jax_op(lambda *a: mx.nd.BatchNorm(*a, *jstats, **kw),
                             [x, g, b], head, train)
    out, grads = _port_op(lambda *a: mxt.nd.BatchNorm(*a, *tstats, **kw),
                          [x, g, b], head, train)
    _assert_rel(out, ref, OP_REL, "forward")
    for name, got, want in zip(("x", "gamma", "beta"), grads, ref_grads):
        _assert_rel(got, want, OP_REL, "gradient of " + name)
    for got, want, init in zip(tstats, jstats, (mm, mv)):
        _assert_rel(got.numpy(), want.asnumpy(), OP_REL, "running statistic")
        assert (not onp.array_equal(got.numpy(), init)) == \
            (mode in ("train", "train-fix-gamma"))


def test_batchnorm_running_statistics_after_two_training_forwards():
    rng = onp.random.RandomState(5)
    xs = [(rng.randn(6, 4, 3, 3) * 3 + 2).astype("float32") for _ in range(2)]
    jbn, tbn = jgluon.nn.BatchNorm(), mxt.gluon.nn.BatchNorm()
    jbn.initialize()
    tbn.initialize(ctx=mxt.cpu())
    for x in xs:
        with mx.autograd.record():
            jbn(mx.nd.array(x))
        with mxt.autograd.record():
            tbn(torch.from_numpy(x))
    for name in ("running_mean", "running_var"):
        ref = getattr(jbn, name).data().asnumpy()
        got = getattr(tbn, name).data().asnumpy()
        assert not onp.allclose(ref, 0.0 if name == "running_mean" else 1.0)
        _assert_rel(got, ref, OP_REL, name)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "log_sigmoid", "mish"])
def test_activation_matches_jax(act):
    x = (onp.random.RandomState(6).randn(3, 7) * 3).astype("float32")
    _hold_op(lambda a: mx.nd.Activation(a, act_type=act),
             lambda a: mxt.nd.Activation(a, act_type=act), [x])


def test_flatten_matches_jax():
    x = onp.random.RandomState(7).randn(2, 3, 4, 5).astype("float32")
    _hold_op(lambda a: mx.nd.flatten(a), lambda a: mxt.nd.Flatten(a), [x])
    assert mxt.gluon.nn.Flatten()(torch.from_numpy(x)).shape == (2, 60)


# ----------------------------------------------------------------- layers
def test_cast_bfloat16_keeps_batchnorm_fp32():
    net = tvision.resnet18_v1(classes=10)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu())
    net.cast("bfloat16")       # before the first forward: shapes deferred
    net(torch.randn(2, 3, 32, 32).to(torch.bfloat16))
    for name, p in net.collect_params().items():
        want = "float32" if name.rsplit(".", 1)[1] in (
            "gamma", "beta", "running_mean", "running_var") \
            else "bfloat16"
        assert p.data().dtype == want, name


def test_conv_layers_defer_channels_and_refuse_other_layouts():
    conv = mxt.gluon.nn.Conv2D(8, 3, padding=1, groups=2)
    conv.initialize(ctx=mxt.cpu())
    assert conv.weight._data is None
    assert conv(torch.randn(1, 6, 5, 5)).shape == (1, 8, 5, 5)
    assert conv.weight.data().shape == (8, 3, 3, 3)
    for layer in (lambda: mxt.gluon.nn.Conv2D(8, 3, layout="NHWC"),
                  lambda: mxt.gluon.nn.MaxPool2D(layout="NHWC")):
        with pytest.raises(ValueError, match="NCHW"):
            layer()
    # params= shares now (it raised before sharing was ported): an empty
    # dict shares nothing, another Dense's params its weight and bias
    alone = mxt.gluon.nn.Dense(3, params=mxt.gluon.ParameterDict())
    shared = mxt.gluon.nn.Dense(3, params=alone.params)
    assert shared.weight is alone.weight and shared.bias is alone.bias


def test_model_zoo_names_and_pretrained():
    assert isinstance(mxt.gluon.model_zoo.get_model("ResNet50_v1"),
                      tvision.ResNetV1)
    assert isinstance(mxt.gluon.model_zoo.vision.resnet18_v2(),
                      tvision.ResNetV2)
    with pytest.raises(RuntimeError, match="pretrained"):
        tvision.resnet18_v1(pretrained=True)
    # vgg16 is ported now; a name the zoo does not hold still raises
    assert isinstance(mxt.gluon.model_zoo.get_model("vgg16"), tvision.VGG)
    with pytest.raises(ValueError, match="not supported"):
        mxt.gluon.model_zoo.get_model("vgg17")


def test_numpy_params_carry_running_statistics_as_a_snapshot():
    """to_numpy_params gives copies (a later training forward does not
    change them) with the running statistics, and from_jax_params takes
    them back."""
    bn = mxt.gluon.nn.BatchNorm(in_channels=3)
    bn.initialize(ctx=mxt.cpu())
    snap = mxt.to_numpy_params(bn)
    assert set(snap) == {"gamma", "beta", "running_mean", "running_var"}
    with mxt.autograd.record():
        bn(torch.randn(4, 3, 2, 2) * 3 + 1)
    assert onp.array_equal(snap["running_mean"], onp.zeros(3, "float32"))
    assert not onp.array_equal(bn.running_mean.data().asnumpy(),
                               onp.zeros(3, "float32"))
    mxt.from_jax_params(bn, snap, strict=True)
    assert onp.array_equal(bn.running_mean.data().asnumpy(),
                           onp.zeros(3, "float32"))
