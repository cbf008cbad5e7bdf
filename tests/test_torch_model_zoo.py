"""The model zoo's new families against the JAX package, on the CPU: VGG
(with and without batch norm), AlexNet, DenseNet, SqueezeNet 1.0/1.1,
MobileNet v1 and v2 and Inception v3.

- Keys: every ``get_model`` name builds in both packages with the same
  structural parameter names and declared shapes.
- Each family, batch 2, at the smallest input it takes (VGG's five pools
  need 32², AlexNet 63², DenseNet's final 7² pool 224²; MobileNet at
  64²): the port's weights copied into the JAX model (hybridized), an
  eval-mode forward within 1e-4 of the largest logit, then one SGD step
  in training mode with dropout off (the two packages' masks cannot
  match) and batch norm on its running statistics (at these inputs the
  last batch norms normalise a few values a channel, which turns float32
  rounding into visible differences; training-mode batch norm is held in
  ``test_torch_gluon_layers.py`` and ``test_torch_vision_models.py``):
  the loss within 1e-4, every gradient within 1e-3 in relative L2 norm,
  against its own norm or 1 % of the model's largest gradient norm,
  whichever is larger (a bias before a batch norm has a zero gradient up
  to rounding; a sum over a channel's positions may cancel), and every
  weight after the step within 1e-5 of its largest entry or of 1 % of
  the model's largest weight.
- To keep the JAX package's CPU time down: VGG runs VGG 11 with batch norm
  and SqueezeNet 1.1 (their variants take the same code, and their keys
  are checked above); DenseNet runs its class at a narrow width (8
  initial features, growth 4, two layers a block); Inception v3, whose
  smallest input is 299², runs its stem convolution and its five mixed
  blocks (A to E) in a row at 31². The card runs every family whole at
  its published widths (``chip_smoke.py``'s model-zoo phase).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

NEW = sorted(k for k in jvision._models if not k.startswith("resnet"))


def _rel(got, ref, what="", tol=1e-4, floor=1e-30):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), floor)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def test_every_model_name_builds_with_the_references_keys():
    assert sorted(tvision._models) == sorted(jvision._models)
    for name in NEW:
        jnet = jvision.get_model(name, classes=10)
        tnet = tvision.get_model(name, classes=10)
        want = {k: p.shape for k, p in
                jnet._collect_params_with_prefix().items()}
        got = {k: p.shape for k, p in
               tnet._collect_params_with_prefix().items()}
        assert got == want, name
    with pytest.raises(RuntimeError, match="pretrained"):
        tvision.get_model("mobilenet1.0", pretrained=True)


def _fix_train_mode(net, children):
    """Dropout off (rate 0; the two packages' masks cannot match) and batch
    norm on its running statistics everywhere in ``net``."""
    stack = [net]
    while stack:
        b = stack.pop()
        if hasattr(b, "_rate"):
            b._rate = 0.0
        if hasattr(b, "_use_global_stats"):
            b._use_global_stats = True
        stack.extend(children(b))


#: batch norm's parameters drawn around their initial values, so that no
#: activation sits exactly on a ReLU's or ReLU6's kink (a zero input patch
#: would give exactly 0 there, where the JAX package's clip splits the
#: gradient and MXNet's passes it)
_STATS = {"gamma": (0.8, 1.2), "beta": (-0.2, 0.2),
          "running_mean": (-0.2, 0.2), "running_var": (0.8, 1.2)}


def _pair(make, x):
    """(JAX net, port net) with the same weights, He-initialised (Xavier,
    normal, fan-in, magnitude 2: activations keep their scale through the
    depth): the port's deferred shapes fixed by one forward of ``x``, the
    JAX net's parameters given those shapes and the port's values (so the
    JAX package, compiling op by op, runs no extra forward), then
    hybridized."""
    tnet = make(mxt.gluon, tvision)
    tnet.initialize(mxt.init.Xavier("gaussian", "in", 2), ctx=mxt.cpu(),
                    generator=torch.Generator().manual_seed(0))
    with mxt.cpu():
        tnet(tnd.array(x, ctx=mxt.cpu()))
    rng = onp.random.RandomState(3)
    for name, p in tnet.collect_params().items():
        low, high = _STATS.get(name.rsplit(".", 1)[-1], (None, None))
        if low is not None:
            p.set_data(rng.uniform(low, high, p.shape).astype("float32"))
    jnet = make(jgluon, jvision)
    jparams = jnet._collect_params_with_prefix()
    values = mxt.to_numpy_params(tnet)
    assert set(jparams) == set(values)
    for k, p in jparams.items():
        p.shape = values[k].shape
    jnet.initialize()
    for k, p in jparams.items():
        p.set_data(values[k])
    jnet.hybridize()
    return jnet, tnet


def _forward_eval(jnet, tnet, x):
    want = jnet(jnd.array(x)).asnumpy()
    with mxt.cpu():
        got = tnet(tnd.array(x, ctx=mxt.cpu())).asnumpy()
    assert got.shape == want.shape
    _rel(got, want, "eval logits")


def _sgd_step(jnet, tnet, x, y):
    _fix_train_mode(jnet, lambda b: list(b._children.values()))
    _fix_train_mode(tnet, lambda b: list(b.children()))
    rounds = []
    for net, m, ag, gluon, ctx in (
            (jnet, jnd, jautograd, jgluon, {}),
            (tnet, tnd, tautograd, mxt.gluon, dict(ctx=mxt.cpu()))):
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        with ag.record():
            out = net(m.array(x, **ctx))
            loss = loss_fn(out.reshape((out.shape[0], -1)),
                           m.array(y, **ctx))
        loss.backward()
        params = net._collect_params_with_prefix()
        grads = {k: p.grad().asnumpy() for k, p in params.items()
                 if p.grad_req != "null"}
        tr.step(x.shape[0])
        rounds.append((loss.asnumpy(), grads,
                       {k: p.data().asnumpy() for k, p in params.items()}))
    (jl, jg, jw), (tl, tg, tw) = rounds
    _rel(tl, jl, "loss")
    assert set(tg) == set(jg)
    floor = 1e-2 * max(float(onp.linalg.norm(g)) for g in jg.values())
    for k in jg:
        err = float(onp.linalg.norm(tg[k].astype("float64") - jg[k])) \
            / max(float(onp.linalg.norm(jg[k])), floor)
        assert err <= 1e-3, "gradient of %s: %.3g relative" % (k, err)
    floor = 1e-2 * max(float(onp.abs(w).max()) for w in jw.values())
    for k in jw:
        _rel(tw[k], jw[k], k + " after the step", tol=1e-5, floor=floor)


FAMILIES = {
    "vgg11_bn": (lambda g, v: v.vgg11_bn(classes=10), 32),
    "alexnet": (lambda g, v: v.alexnet(classes=10), 63),
    "densenet": (lambda g, v: v.DenseNet(8, 4, [2, 2, 2, 2], bn_size=2,
                                         classes=10), 224),
    "squeezenet1.1": (lambda g, v: v.squeezenet1_1(classes=10), 40),
    "mobilenet0.25": (lambda g, v: v.mobilenet0_25(classes=10), 64),
    "mobilenetv2_1.0": (lambda g, v: v.mobilenet_v2_1_0(classes=10), 64),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_forward_and_one_sgd_step(family):
    make, size = FAMILIES[family]
    rng = onp.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype("float32")
    y = rng.randint(0, 10, 2).astype("float32")
    jnet, tnet = _pair(make, x)
    _forward_eval(jnet, tnet, x)
    _sgd_step(jnet, tnet, x, y)


def _inception_parts(g, v):
    """Inception v3's stem convolution and its five mixed blocks (A-E) in
    a row, at their real widths."""
    net = g.nn.HybridSequential()
    net.add(v._make_basic_conv(channels=32, kernel_size=3, strides=2),
            v._make_A(32, "A_"), v._make_B("B_"), v._make_C(128, "C_"),
            v._make_D("D_"), v._make_E("E_"), g.nn.GlobalAvgPool2D(),
            g.nn.Dense(10))
    return net


def test_inception_v3_blocks_forward_and_one_sgd_step():
    rng = onp.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 3, 31, 31)).astype("float32")
    y = rng.randint(0, 10, 2).astype("float32")
    jnet, tnet = _pair(_inception_parts, x)
    _forward_eval(jnet, tnet, x)
    _sgd_step(jnet, tnet, x, y)
