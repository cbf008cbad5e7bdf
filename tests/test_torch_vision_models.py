"""The port's vision models against the JAX package, on the CPU, in float32
(the ops and layers are held in ``test_torch_vision.py``).

Models (LeNet, ResNet-18/50 v1 with 10 classes) are built in both
packages; the JAX model is initialized and its weights, running statistics
included, are carried into the port with ``from_jax_params(strict=True)``.
In inference mode the two forwards agree within 1e-5 of the largest logit.
In training mode each BatchNorm normalises with the batch statistics of
JAX's shifted one-pass form, ``var = E[(x-s)^2] - (E[x]-s)^2``: the two
libraries round it differently (their reductions sum in another order), and
each BatchNorm divides by the batch's standard deviation, so the difference
grows with depth (about 2e-5 of the largest value after the first
bottleneck of ResNet-50, 3e-4 after the last, measured on this input). The
training-mode inputs are sized so that every BatchNorm sees at least 16
values per channel (at 2 values, as ResNet's last stage at 32x32 and batch
2 gives, the variance is ill-conditioned and the two packages differ in the
first digit): ResNet-18 at (8, 3, 32, 32), ResNet-50 at (4, 3, 64, 64).
"""
import numpy as onp
import pytest
import torch

import jax  # noqa: F401  (JAX_PLATFORMS=cpu is set by conftest)

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from test_torch_vision import _assert_rel


def _jax_arrays(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _pair(name, x, classes=10):
    """(JAX net, port net) of model ``name`` with the JAX net's weights in
    both; one inference forward on ``x`` finishes the deferred shapes."""
    if name == "lenet":
        jnet, tnet = jmodels.LeNet(classes=classes), \
            tmodels.LeNet(classes=classes)
    else:
        jnet = jvision.get_model(name, classes=classes)
        tnet = tvision.get_model(name, classes=classes)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    tnet(torch.from_numpy(x))
    mxt.from_jax_params(tnet, _jax_arrays(jnet), strict=True)
    return jnet, tnet


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1"])
def test_resnet_keys_and_inference_forward_match_jax(name):
    x = onp.random.RandomState(8).randn(2, 3, 32, 32).astype("float32")
    jnet, tnet = _pair(name, x)
    assert set(tnet.collect_params().keys()) == set(_jax_arrays(jnet))
    ref = jnet(mx.nd.array(x)).asnumpy()
    got = mxt.jit.EvalStep(tnet)(x).asnumpy()
    assert got.shape == (2, 10)
    _assert_rel(got, ref, 1e-5, name)


@pytest.mark.parametrize("name,shape,rel", [
    ("resnet18_v1", (8, 3, 32, 32), 1e-4),
    ("resnet50_v1", (4, 3, 64, 64), 2e-3),
])
def test_resnet_training_forward_and_running_stats_match_jax(name, shape,
                                                             rel):
    """One training-mode forward (batch statistics, running statistics
    updated once); tolerance per the module docstring."""
    x = onp.random.RandomState(9).randn(*shape).astype("float32")
    jnet, tnet = _pair(name, x)
    with mx.autograd.record():
        ref = jnet(mx.nd.array(x)).asnumpy()
    with mxt.autograd.record():
        got = tnet(torch.from_numpy(x)).detach().numpy()
    _assert_rel(got, ref, rel, "logits")
    ref_p, got_p = _jax_arrays(jnet), mxt.to_numpy_params(tnet)
    for k in ref_p:
        if "running" in k:
            _assert_rel(got_p[k], ref_p[k], rel, k)


def _steps(name, x, y, lr):
    """(JAX net, port net, JAX TrainStep, port TrainStep, initial arrays) of
    model ``name`` with SGD (momentum 0.9) at ``lr``."""
    jnet, tnet = _pair(name, x)
    opt = {"learning_rate": lr, "momentum": 0.9}
    jstep = jjit.TrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                           jgluon.Trainer(jnet.collect_params(), "sgd", opt))
    tstep = mxt.jit.TrainStep(tnet, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mxt.gluon.Trainer(tnet.collect_params(), "sgd",
                                                opt))
    return jnet, tnet, jstep, tstep, _jax_arrays(jnet)


def _batch(shape, seed=10):
    rng = onp.random.RandomState(seed)
    return (rng.randn(*shape).astype("float32"),
            rng.randint(0, 10, shape[0]).astype("float32"))


def test_lenet_train_steps_match_jax():
    """Three SGD TrainSteps (lr 0.01, momentum 0.9) of LeNet on (4, 1, 28,
    28) from the same weights: per-step losses and every parameter after
    the steps within 1e-5 of the largest value (no BatchNorm: summation
    order only)."""
    x, y = _batch((4, 1, 28, 28))
    jnet, tnet, jstep, tstep, before = _steps("lenet", x, y, 0.01)
    got = [tstep(x, y).asnumpy() for _ in range(3)]
    for i, g in enumerate(got):
        _assert_rel(g, jstep(mx.nd.array(x), mx.nd.array(y)).asnumpy(), 1e-5,
                    "loss of step %d" % i)
    assert got[-1].mean() < got[0].mean()
    ref_p, got_p = _jax_arrays(jnet), mxt.to_numpy_params(tnet)
    assert set(ref_p) == set(got_p)
    for k in ref_p:
        assert not onp.array_equal(ref_p[k], before[k]), k
        _assert_rel(got_p[k], ref_p[k], 1e-5, k)


def test_resnet18_train_steps_match_jax():
    """Two SGD TrainSteps (lr 0.01, momentum 0.9) of ResNet-18 on (8, 3,
    32, 32). Per-step losses and the running statistics within 2e-4 of the
    largest value (the forward's BatchNorm rounding, module docstring).
    After the first step every parameter's change within 1e-3 of its
    largest change (measured 2e-4). After the second step the changes agree
    as a whole within 2e-2 in L2 norm (measured 4e-3), not element by
    element: the first step leaves the two packages' weights about 1e-6
    apart, which flips the ReLU mask of the few activations that lie that
    close to 0 and reroutes their gradients (the port fed the JAX package's
    own weights after the first step gives its gradients within 2e-5)."""
    x, y = _batch((8, 3, 32, 32))
    jnet, tnet, jstep, tstep, before = _steps("resnet18_v1", x, y, 0.01)
    losses = []
    for i in range(2):
        ref = jstep(mx.nd.array(x), mx.nd.array(y)).asnumpy()
        losses.append(tstep(x, y).asnumpy())
        _assert_rel(losses[-1], ref, 2e-4, "loss of step %d" % i)
        ref_p, got_p = _jax_arrays(jnet), mxt.to_numpy_params(tnet)
        assert set(ref_p) == set(got_p)
        for k in ref_p:
            if "running" in k:
                _assert_rel(got_p[k], ref_p[k], 2e-4, k)
            elif i == 0:
                _assert_rel(got_p[k] - before[k], ref_p[k] - before[k], 1e-3,
                            "change of " + k)
    diff = sum(onp.sum(((got_p[k] - ref_p[k]) ** 2)) for k in ref_p)
    change = sum(onp.sum((ref_p[k] - before[k]) ** 2) for k in ref_p)
    assert onp.sqrt(diff / change) <= 2e-2
    assert losses[-1].mean() < losses[0].mean()


def test_train_step_equals_the_eager_step_for_a_resnet():
    """TrainStep = autograd.record() forward, backward, Trainer.step(B)
    on NDArrays, exactly, over two steps, running statistics included."""
    rng = onp.random.RandomState(11)
    x = mxt.nd.array(rng.randn(8, 3, 32, 32).astype("float32"),
                     ctx=mxt.cpu())
    y = mxt.nd.array(rng.randint(0, 10, 8).astype("float32"), ctx=mxt.cpu())
    nets = []
    for _ in range(2):
        net = tvision.resnet18_v1(classes=10)
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(0))
        net(x)
        nets.append(net)
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    step = mxt.jit.TrainStep(nets[0], loss_fn, mxt.gluon.Trainer(
        nets[0].collect_params(), "sgd", opt))
    trainer = mxt.gluon.Trainer(nets[1].collect_params(), "sgd", opt)
    for _ in range(2):
        a = step(x, y)
        with mxt.autograd.record():
            b = loss_fn(nets[1](x), y)
        b.backward()
        trainer.step(8)
        assert onp.array_equal(a.asnumpy(), b.asnumpy())
    for name, p in nets[0].collect_params().items():
        assert onp.array_equal(
            p.data().asnumpy(),
            nets[1].collect_params()[name].data().asnumpy()), name
