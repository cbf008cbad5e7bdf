"""The port's optimizers and Trainer against the JAX package, on the CPU.

The same weights and gradients (made with numpy from a seed) go through
the JAX optimizer's eager ``update`` / ``update_multi_precision`` and the
port's, for a few steps. Tolerances: fp32 weights within 1e-6 relative
(the same fp32 arithmetic; the two differ only in whether a multiply-add
is fused and in computing Adam's step size in double); a bf16 weight with
an fp32 master within one bf16 rounding (2^-7 relative), its master
within 1e-6.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import optimizer as topt

STEPS = 4
SHAPE = (5, 7)


def _data(seed):
    rng = onp.random.RandomState(seed)
    w = rng.randn(*SHAPE).astype("float32")
    grads = [rng.randn(*SHAPE).astype("float32") * 3 for _ in range(STEPS)]
    return w, grads


def _run_jax(name, kw, w, grads, dtype):
    opt = mx.optimizer.create(name, **kw)
    weight = mx.nd.array(w).astype(dtype)
    state = opt.create_state_multi_precision(0, weight)
    for g in grads:
        state = opt.update_multi_precision(
            0, weight, mx.nd.array(g).astype(dtype), state)
    master = state[0].asnumpy() if dtype == "bfloat16" else None
    return weight.astype("float32").asnumpy(), master


def _run_port(name, kw, w, grads, dtype):
    opt = topt.create(name, **kw)
    tdtype = getattr(torch, dtype)
    weight = torch.from_numpy(w.copy()).to(tdtype)
    state = opt.create_state_multi_precision(0, weight)
    for g in grads:
        state = opt.update_multi_precision(
            0, weight, torch.from_numpy(g).to(tdtype), state)
    master = state[0].numpy() if dtype == "bfloat16" else None
    return weight.float().numpy(), master


CASES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_jax(name, dtype):
    kw = dict(CASES[name], wd=0.01,
              multi_precision=dtype == "bfloat16")
    w, grads = _data(seed=len(name))
    ref, ref_master = _run_jax(name, kw, w, grads, dtype)
    got, master = _run_port(name, kw, w, grads, dtype)
    assert not onp.allclose(got, w)          # the steps moved the weight
    if dtype == "float32":
        onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    else:
        onp.testing.assert_allclose(master, ref_master, rtol=1e-6,
                                    atol=1e-7)
        onp.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=0)
        assert onp.array_equal(got, torch.from_numpy(master).bfloat16()
                               .float().numpy())


@pytest.mark.parametrize("option", ["wd", "clip_gradient", "rescale_grad"])
def test_options_are_applied_as_jax_applies_them(option):
    value = {"wd": 0.5, "clip_gradient": 0.3, "rescale_grad": 0.25}[option]
    kw = dict(learning_rate=0.1, momentum=0.5, **{option: value})
    w, grads = _data(seed=11)
    ref, _ = _run_jax("sgd", kw, w, grads, "float32")
    got, _ = _run_port("sgd", kw, w, grads, "float32")
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    plain, _ = _run_port("sgd", dict(learning_rate=0.1, momentum=0.5), w,
                         grads, "float32")
    assert not onp.allclose(got, plain)      # the option changed the result


def test_registry_and_lr_wd_mult():
    assert isinstance(topt.create("Adam"), topt.Adam)
    with pytest.raises(ValueError, match="not registered"):
        topt.create("nadam")
    p = mxt.gluon.Parameter("weight", shape=(2,), lr_mult=0.5, wd_mult=0.0)
    opt = topt.create("sgd", learning_rate=0.2, wd=0.1,
                      param_dict={0: p})
    assert opt._get_lr(0) == pytest.approx(0.1) and opt._get_wd(0) == 0.0


def _dense(seed=0):
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net


def test_trainer_step_updates_from_grads_and_consumes_them():
    """Trainer.step(B) rescales by 1/B, updates every parameter in place and
    releases the 'write' gradients, so the next backward writes afresh."""
    net = _dense()
    x = torch.from_numpy(onp.random.RandomState(0).randn(6, 4)
                         .astype("float32"))
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    w0 = net.weight.data().detach().clone()
    with mxt.autograd.record():
        loss = net(x).sum(dim=1)
    mxt.autograd.backward(loss)
    g = net.weight.grad().clone()
    trainer.step(6)
    torch.testing.assert_close(net.weight.data().detach(), w0 - 0.5 * g / 6)
    assert net.weight.data().grad is None
    assert torch.equal(net.weight.grad(), torch.zeros_like(w0))
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.1)
    assert trainer.optimizer.lr == 0.1
    assert net.weight.list_ctx() == [mxt.cpu()]


def test_trainer_refuses_distributed_kvstore():
    params = _dense().collect_params()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        mxt.gluon.Trainer(params, "sgd", kvstore="dist_sync")
    mxt.gluon.Trainer(params, "sgd", kvstore=None)
