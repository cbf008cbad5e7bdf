"""The port's SSD (``models.SSD``) against the JAX package's, on the CPU.

A small SSD (``base_channels`` 8, 3 classes) on 32² inputs: 340 anchors
over four scales (8², 4², 2², 1²), Xavier weights from a seed. The JAX
model's weights carried across
by ``convert.from_jax_params(strict=True)`` give the same anchors, class
and box predictions (float32, within 1e-5 of the largest value). One
training step of the reference's SSD pipeline (example/detection/
train_ssd.py: synthetic boxes from a seed, ``MultiBoxTarget`` with hard
negative mining at 3 under ``autograd.pause()``, softmax cross-entropy
over the anchors whose target is at least 0 plus smooth-L1 under the box
mask, each over its count of valid terms, SGD with momentum 0.9 and
weight decay 5e-4) through the port's
``Trainer.step`` loop and through ``jit.TrainStep`` gives the JAX eager
step's per-image losses within 1e-5 relative and its weights and running
statistics within 1e-5 of each one's largest value.
"""
import jax
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray
from incubator_mxnet_tpu.ops import MultiBoxTarget as JMultiBoxTarget

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch.ops import MultiBoxTarget as TMultiBoxTarget

CLASSES, BASE, SIZE, BATCH = 3, 8, 32, 2
TOL = 1e-5


def _rel(got, ref, what):
    got, ref = onp.asarray(got, "float64"), onp.asarray(ref, "float64")
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(got - ref).max()) / scale
    assert err <= TOL, "%s: %.3g of the largest value" % (what, err)


def synthetic_batch(batch, size, seed=0, rows=4):
    """example/detection/train_ssd.py's synthetic_batches: boxes around
    class-coloured squares, labels padded to ``rows`` rows of class -1."""
    rng = onp.random.RandomState(seed)
    img = rng.rand(batch, 3, size, size).astype("float32") * 0.1
    label = onp.full((batch, rows, 5), -1.0, "float32")
    for i in range(batch):
        cls = rng.randint(0, 3)
        x1, y1 = rng.uniform(0.05, 0.5, 2)
        w = rng.uniform(0.2, 0.4)
        label[i, 0] = (cls, x1, y1, min(x1 + w, 0.95), min(y1 + w, 0.95))
        xa, ya, wb = int(x1 * size), int(y1 * size), int(w * size)
        img[i, cls, ya: ya + wb, xa: xa + wb] += 0.8
    return img, label


def ssd_loss(nd, autograd, multibox_target):
    """The SSD loss, per image: softmax cross-entropy over the anchors
    whose target is at least 0 (the ignored ones, -1, masked out: the
    port's pick clips -1 to 0) plus smooth-L1 under the box mask, each
    divided by its count of valid terms (MXNet's example/ssd,
    normalization="valid"), as ``chip_smoke.py``'s SSD phase trains.
    Written in ``nd`` operators, so NDArrays and the port's tensors (inside
    ``TrainStep``) both run it."""
    def loss(out, label):
        anchors, cls_preds, loc_preds = out
        with autograd.pause():
            loc_t, loc_mask, cls_t = multibox_target(
                anchors, label, cls_preds, negative_mining_ratio=3)
        valid = nd.cast(cls_t >= 0, "float32")
        logp = nd.log_softmax(cls_preds, axis=1)
        ce = -(nd.pick(logp, nd.relu(cls_t), axis=1) * valid).sum(axis=1)
        box = (nd.smooth_l1(loc_preds - loc_t, scalar=1.0) * loc_mask) \
            .sum(axis=1)
        return ce / nd.maximum(valid.sum(axis=1), 1.0) + \
            box / nd.maximum(loc_mask.sum(axis=1), 1.0)
    return loss


def _jax_ssd(img, path):
    """The JAX SSD with Xavier weights drawn from a seed. They are drawn
    by the port's initializer and read by the JAX package's
    ``load_parameters``, which finishes its deferred shapes from the file,
    so the JAX model needs no eager forward (op by op) to learn them."""
    net = mxt.models.SSD(num_classes=CLASSES, base_channels=BASE)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(0))
    with mxt.cpu():
        net(mxt.nd.array(img, ctx=mxt.cpu()))
    net.save_parameters(path)
    jnet = mx.models.SSD(num_classes=CLASSES, base_channels=BASE)
    jnet.initialize()
    jnet.load_parameters(path)
    return jnet


def _jitted_targets(anchors, label, cls_preds, **kw):
    """The JAX package's MultiBoxTarget traced into one program."""
    fn = jax.jit(lambda a, l, c: [o._data for o in JMultiBoxTarget(
        JNDArray(a), JNDArray(l), JNDArray(c), **kw)])
    return [JNDArray(o) for o in fn(anchors._data, label._data,
                                    cls_preds._data)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX SSD, its weights before the step, and its eager training
    step's losses and weights after it."""
    img, label = synthetic_batch(BATCH, SIZE)
    jnet = _jax_ssd(img, str(tmp_path_factory.mktemp("ssd") / "w.params"))
    jnet.hybridize()          # the forward as one program: compiled once
    before = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    want_out = [o.asnumpy() for o in jnet(mx.nd.array(img))]
    trainer = jgluon.Trainer(jnet.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4})
    loss_fn = ssd_loss(mx.nd, mx.autograd, _jitted_targets)
    with mx.autograd.record():
        loss = loss_fn(jnet(mx.nd.array(img)), mx.nd.array(label))
    loss.backward()
    trainer.step(BATCH)
    after = {k: p.data().asnumpy()
             for k, p in jnet._collect_params_with_prefix().items()}
    return dict(img=img, label=label, jnet=jnet, before=before,
                out=want_out, loss=loss.asnumpy(), after=after)


def _port_from(reference):
    net = mxt.models.SSD(num_classes=CLASSES, base_channels=BASE)
    net.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        net(mxt.nd.array(reference["img"], ctx=mxt.cpu()))
    mxt.from_jax_params(net, reference["before"], strict=True)
    return net


def test_ssd_forward_with_the_jax_weights(reference):
    net = _port_from(reference)
    with mxt.cpu():
        got = net(mxt.nd.array(reference["img"], ctx=mxt.cpu()))
    assert len(got) == 3
    anchors, cls_preds, loc_preds = [g.asnumpy() for g in got]
    assert anchors.shape == (1, 340, 4)
    assert cls_preds.shape == (BATCH, CLASSES + 1, 340)
    assert loc_preds.shape == (BATCH, 340 * 4)
    for g, w, what in zip((anchors, cls_preds, loc_preds), reference["out"],
                          ("anchors", "class predictions",
                           "box predictions")):
        _rel(g, w, what)


def test_ssd_structural_names_are_the_jax_models(reference):
    net = _port_from(reference)
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(reference["before"])
    heads = {k.split(".")[0] for k in reference["before"]}
    assert heads == {"backbone", "stage1", "stage2", "stage3", "cls0",
                     "cls1", "cls2", "cls3", "loc0", "loc1", "loc2", "loc3"}


def _check_step(net, reference, loss):
    _rel(loss, reference["loss"], "per-image loss")
    got = mxt.to_numpy_params(net)
    for k, want in reference["after"].items():
        _rel(got[k], want, k)


def _trainer(net):
    return mxt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4})


def test_ssd_gluon_loop_step_matches_the_jax_step(reference):
    net = _port_from(reference)
    trainer = _trainer(net)
    loss_fn = ssd_loss(mxt.nd, mxt.autograd, TMultiBoxTarget)
    with mxt.cpu():
        x = mxt.nd.array(reference["img"], ctx=mxt.cpu())
        y = mxt.nd.array(reference["label"], ctx=mxt.cpu())
        with mxt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(BATCH)
    _check_step(net, reference, loss.asnumpy())


def test_ssd_train_step_matches_the_jax_step(reference):
    net = _port_from(reference)
    step = tjit.TrainStep(net, ssd_loss(mxt.nd, mxt.autograd,
                                        TMultiBoxTarget), _trainer(net))
    loss = step(reference["img"], reference["label"])
    _check_step(net, reference, loss.asnumpy())


def test_ssd_hybridized_equals_plain_on_the_cpu(reference):
    nets = [_port_from(reference) for _ in range(2)]
    nets[0].hybridize()
    outs = []
    with mxt.cpu():
        for net in nets:
            with mxt.autograd.record():
                out = net(mxt.nd.array(reference["img"], ctx=mxt.cpu()))
            outs.append([o.asnumpy() for o in out])
    for a, b in zip(*outs):
        assert onp.array_equal(a, b)


def test_ssd_detection_after_the_forward(reference):
    """The reference script's detection: softmax over the classes, then
    MultiBoxDetection; class ids exact, scores and boxes within 1e-5."""
    anchors, cls_preds, loc_preds = reference["out"]
    prob = onp.exp(cls_preds - cls_preds.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype("float32")
    want = onp.asarray(jax.jit(lambda c, l, a: mx.ops.MultiBoxDetection(
        JNDArray(c), JNDArray(l), JNDArray(a), nms_threshold=0.45)._data)(
            prob, loc_preds, anchors))
    with mxt.cpu():
        got = mxt.ops.MultiBoxDetection(
            mxt.nd.array(prob, ctx=mxt.cpu()),
            mxt.nd.array(loc_preds, ctx=mxt.cpu()),
            mxt.nd.array(anchors, ctx=mxt.cpu()), nms_threshold=0.45,
            nms_topk=400).asnumpy()
    assert onp.array_equal(got[..., 0], want[..., 0])
    _rel(got[..., 1:], want[..., 1:], "scores and boxes")


def test_models_get_model_builds_the_zoos_family():
    jnet = mx.models.get_model("squeezenet1.1", classes=7)
    tnet = mxt.models.get_model("squeezenet1.1", classes=7)
    assert type(tnet).__name__ == type(jnet).__name__
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    with pytest.raises(ValueError):
        mxt.models.get_model("no_such_model")


def test_ssd512_counts():
    """SSD-512 at the class defaults: 87,040 anchors, and the shapes the
    card's phase trains (checked on a 1-image forward at base 4, whose
    scales are the same)."""
    net = mxt.models.SSD(base_channels=4)
    net.initialize(ctx=mxt.cpu())
    with mxt.cpu(), torch.no_grad():
        anchors, cls_preds, loc_preds = net(torch.zeros(1, 3, 512, 512))
    assert anchors.shape == (1, 87040, 4)
    assert cls_preds.shape == (1, 21, 87040)
    assert loc_preds.shape == (1, 87040 * 4)
