"""The port's contrib.amp against the JAX package's, on the CPU (the JAX
package's ``tests/test_amp.py``, mirrored): ``convert_hybrid_block`` to
bf16, the loss scaler's dynamics held step by step to the JAX scaler's on
the same gradients, its overflow check as one reduction with one transfer
to the host, and bf16 training with fp32 master weights.

bf16 training tolerance: 20 SGD-momentum TrainSteps of a small MLP from the
same weights, in bf16 with fp32 masters in both packages; each step's mean
loss within 2e-2 relative of the JAX package's (the forward rounds to bf16
at every layer, about 2^-8 relative each, and the two libraries' bf16
matrix products round their sums at other points; measured 3.1e-3), and
the fp32 masters after the steps within 2e-2 of their largest value
(measured 9.3e-3).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit
from incubator_mxnet_tpu.contrib import amp as jamp

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.contrib import amp


def _mlp(gluon):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu", in_units=16),
            gluon.nn.Dense(4, in_units=32))
    return net


def test_convert_hybrid_block_bf16():
    net = _mlp(mxt.gluon)
    net.initialize(ctx=mxt.cpu())
    bnet = amp.convert_hybrid_block(net)
    assert bnet is net
    out = bnet(mxt.nd.ones((2, 16), ctx=mxt.cpu()).astype("bfloat16"))
    assert out.dtype == "bfloat16"
    assert all(p.data().dtype == "bfloat16"
               for p in net.collect_params().values())


def test_init_and_convert_model_and_trainer():
    amp.init("float16")
    assert amp._INITIALIZED == {"flag": True, "dtype": "bfloat16"}
    args = {"w": mxt.nd.ones((2, 2), ctx=mxt.cpu())}
    aux = {"m": mxt.nd.zeros((2,), ctx=mxt.cpu())}
    sym, new_args, new_aux = amp.convert_model("sym", args, aux)
    assert sym == "sym" and new_args["w"].dtype == "bfloat16"
    assert new_aux["m"].dtype == "float32"
    net = _mlp(mxt.gluon)
    net.initialize(ctx=mxt.cpu())
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    amp.init_trainer(trainer)
    assert trainer.optimizer.multi_precision is True


def _grad_sets():
    """Gradient lists for a run of checks: finite ones, an inf, a NaN and
    one too large for fp16 yet finite in fp32."""
    rng = onp.random.RandomState(0)
    sets = []
    for bad in (None, None, None, "inf", None, None, "nan", None, None,
                None, "big", None):
        g = [rng.randn(3, 4).astype("float32"),
             rng.randn(5).astype("float32")]
        if bad == "inf":
            g[1][2] = onp.inf
        elif bad == "nan":
            g[0][1, 1] = onp.nan
        elif bad == "big":
            g[0] *= 1e30
        sets.append(g)
    return sets


@pytest.mark.parametrize("window", [1, 2, 3])
def test_loss_scaler_dynamics_match_jax(window):
    """The same gradients through both scalers: each check's verdict and
    the scale after it equal, and scaling and unscaling a loss and a
    gradient give the same numbers."""
    ours = amp.LossScaler(init_scale=2.0 ** 4, scale_factor=2.0,
                          scale_window=window)
    ref = jamp.LossScaler(init_scale=2.0 ** 4, scale_factor=2.0,
                          scale_window=window)
    for g in _grad_sets():
        got = ours.check_and_update([torch.from_numpy(a) for a in g])
        want = ref.check_and_update([mx.nd.array(a) for a in g])
        assert got is want
        assert ours.loss_scale == ref.loss_scale
        assert ours._unskipped == ref._unskipped
    loss = onp.array([1.5, -2.0], "float32")
    assert onp.array_equal(
        ours.scale(mxt.nd.array(loss, ctx=mxt.cpu())).asnumpy(),
        ref.scale(mx.nd.array(loss)).asnumpy())
    tg, jg = mxt.nd.array(loss, ctx=mxt.cpu()), mx.nd.array(loss)
    ours.unscale([tg])
    ref.unscale([jg])
    assert onp.array_equal(tg.asnumpy(), jg.asnumpy())


def test_loss_scaler_single_fused_transfer(monkeypatch):
    """The overflow check transfers one scalar to the host, and no host
    numpy sees the gradients; one poisoned gradient anywhere in the list
    still skips the step and shrinks the scale."""
    import numpy
    ls = amp.LossScaler(init_scale=2.0, scale_factor=2.0, scale_window=100)
    grads = [mxt.nd.ones((4, 4), ctx=mxt.cpu()) for _ in range(16)]
    calls = {"item": 0, "bool": 0}
    item, to_bool = torch.Tensor.item, torch.Tensor.__bool__

    def spy_item(self):
        calls["item"] += 1
        return item(self)

    def spy_bool(self):
        calls["bool"] += 1
        return to_bool(self)

    def boom(*a, **kw):
        raise AssertionError("host-side numpy finite check in LossScaler")

    monkeypatch.setattr(torch.Tensor, "item", spy_item)
    monkeypatch.setattr(torch.Tensor, "__bool__", spy_bool)
    monkeypatch.setattr(mxt.nd.NDArray, "asnumpy", boom)
    monkeypatch.setattr(numpy, "isfinite", boom)
    monkeypatch.setattr(numpy, "isnan", boom)
    assert ls.check_and_update(grads) is True
    assert calls["item"] + calls["bool"] == 1
    grads[7] = mxt.nd.array([float("nan")] * 4, ctx=mxt.cpu())
    s = ls.loss_scale
    assert ls.check_and_update(grads) is False
    assert ls.loss_scale == s / 2.0
    assert calls["item"] + calls["bool"] == 2


def test_scale_loss_and_unscale_through_the_trainer():
    net = _mlp(mxt.gluon)
    net.initialize(ctx=mxt.cpu())
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    x = mxt.nd.ones((2, 16), ctx=mxt.cpu())
    with mxt.autograd.record():
        loss = amp.scale_loss(net(x).sum(), trainer)
    loss.backward()
    scale = trainer._amp_loss_scaler.loss_scale
    g = net[0].weight.grad().asnumpy().copy()
    amp.unscale(trainer)
    onp.testing.assert_allclose(net[0].weight.grad().asnumpy(), g / scale,
                                rtol=1e-7)


def test_bf16_training_with_master_weights_matches_jax():
    rng = onp.random.RandomState(3)
    data = rng.randn(256, 16).astype("float32")
    label = (data @ rng.randn(16, 4)).argmax(1).astype("float32")
    jnet = _mlp(jgluon)
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(data))
    tnet = _mlp(mxt.gluon)
    tnet.initialize(mxt.init.Zero(), ctx=mxt.cpu())
    mxt.from_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                               jnet._collect_params_with_prefix().items()})
    jamp.convert_hybrid_block(jnet)
    amp.convert_hybrid_block(tnet)
    opt = {"learning_rate": 0.2, "momentum": 0.9, "multi_precision": True}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", opt)
    ttr = mxt.gluon.Trainer(tnet.collect_params(), "sgd", opt)
    jstep = jjit.TrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), jtr)
    tstep = mxt.jit.TrainStep(tnet, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                              ttr)
    jx, jy = mx.nd.array(data).astype("bfloat16"), mx.nd.array(label)
    tx = mxt.nd.array(data, ctx=mxt.cpu()).astype("bfloat16")
    ty = mxt.nd.array(label, ctx=mxt.cpu())
    losses = []
    for _ in range(20):
        want = float(jstep(jx, jy).astype("float32").mean().asnumpy())
        got = float(tstep(tx, ty).astype("float32").mean().asnumpy())
        assert abs(got - want) <= 2e-2 * abs(want)
        losses.append(got)
    assert losses[-1] < losses[0] * 0.5
    assert all(p.data().dtype == "bfloat16"
               for p in tnet.collect_params().values())
    for i in range(len(ttr._params)):
        master = ttr._states[i][0].numpy()
        ref = onp.asarray(jtr._states[i][0].asnumpy())
        assert ttr._params[i].data().dtype == "bfloat16"
        assert torch.equal(ttr._params[i]._tensor(),
                           ttr._states[i][0].bfloat16())
        assert float(onp.abs(master - ref).max()) <= \
            2e-2 * float(onp.abs(ref).max())
