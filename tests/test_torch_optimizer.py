"""The port's optimizers and Trainer against the JAX package, on the CPU.

The same weights and gradients (made with numpy from a seed) go through
the JAX optimizer's eager ``update`` / ``update_multi_precision`` and the
port's, for a few steps. Tolerances: fp32 weights within 1e-6 relative
(the same fp32 arithmetic; the two differ only in whether a multiply-add
is fused and in computing Adam's step size in double); a bf16 weight with
an fp32 master within one bf16 rounding (2^-7 relative), its master
within 1e-6.

MXNet's custom training loop hands the optimizer NDArrays
(``opt.update(i, p.data(), p.grad(), states[i])``): the same steps on
NDArrays give the JAX package's weights and states within 1e-6 relative
(fp32 and the masters) and the port's own tensor path bit for bit, with
the caller's arrays written in place; row-sparse gradients follow the
reference's lazy update (only the rows they carry move under SGD's
``lazy_update``; other optimizers make them dense), within 1e-6.
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
        topt.create("no_such_optimizer")
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
    """Trainer.step(B) rescales by 1/B and updates every parameter in
    place from the gradients the backward wrote, which it leaves as they
    are (the JAX package's grad() after a step is the step's gradient);
    the next backward writes them afresh ("write")."""
    net = _dense()
    x = torch.from_numpy(onp.random.RandomState(0).randn(6, 4)
                         .astype("float32"))
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    w0 = net.weight.data().asnumpy()
    with mxt.autograd.record():
        loss = net(x).sum(dim=1)
    mxt.autograd.backward(loss)
    g = net.weight.grad().asnumpy()
    trainer.step(6)
    onp.testing.assert_allclose(net.weight.data().asnumpy(),
                                w0 - 0.5 * g / 6, rtol=1.3e-6, atol=1e-5)
    assert onp.array_equal(net.weight.grad().asnumpy(), g)
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.1)
    assert trainer.optimizer.lr == 0.1
    assert net.weight.list_ctx() == [mxt.cpu()]


def test_trainer_refuses_distributed_kvstore():
    """A Trainer over a dist kvstore updates through the store
    (tests/test_torch_dist.py); a jit.TrainStep runs its own update and
    refuses such a trainer rather than skip the sum over the processes."""
    net = _dense()
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                kvstore="dist_sync")
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.L2Loss(), trainer)
    x = torch.ones(2, 4)
    with pytest.raises(NotImplementedError, match="dist_sync"):
        step(x, torch.zeros(2, 3))
    local = mxt.gluon.Trainer(net.collect_params(), "sgd", kvstore=None)
    mxt.jit.TrainStep(net, mxt.gluon.loss.L2Loss(), local)(
        x, torch.zeros(2, 3))


# ------------------------------------------- MXNet's loop over NDArrays

NDARRAY_CASES = {
    "sgd-update": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01),
                   "float32"),
    "adam-update": ("adam", dict(learning_rate=0.01, wd=0.01), "float32"),
    "adam-fp16-masters": ("adam", dict(learning_rate=0.01, wd=0.01,
                                       multi_precision=True), "float16"),
    "sgd-bf16-masters": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                     multi_precision=True), "bfloat16"),
}


def _flat(state):
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [] if state is None else [state]


def _ndarray_loop(pkg, name, kw, w, grads, dtype):
    """The loop on NDArrays: ``create_state``/``update`` for an fp32
    weight, the multi-precision pair otherwise."""
    ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
    opt = pkg.optimizer.create(name, **kw)
    weight = pkg.nd.array(w, **ctx).astype(dtype)
    multi = dtype != "float32"
    state = (opt.create_state_multi_precision if multi
             else opt.create_state)(0, weight)
    update = opt.update_multi_precision if multi else opt.update
    for g in grads:
        state = update(0, weight, pkg.nd.array(g, **ctx).astype(dtype),
                       state)
    return weight, state


@pytest.mark.parametrize("case", sorted(NDARRAY_CASES))
def test_update_takes_the_ndarrays_of_mxnets_loop(case):
    name, kw, dtype = NDARRAY_CASES[case]
    w, grads = _data(seed=len(case))
    jw, jstate = _ndarray_loop(mx, name, kw, w, grads, dtype)
    tw, tstate = _ndarray_loop(mxt, name, kw, w, grads, dtype)
    w_id = id(tw._data)
    tstate_arrays = _flat(tstate)
    assert all(isinstance(a, mxt.nd.NDArray) for a in tstate_arrays)
    for got, want in zip(tstate_arrays, _flat(jstate), strict=True):
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-6, atol=1e-7)
    got, ref = tw.astype("float32").asnumpy(), jw.astype("float32").asnumpy()
    assert not onp.allclose(got, w)
    if dtype == "float32":
        onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    else:
        master = tstate_arrays[0]._data
        assert torch.equal(tw._data, master.to(tw._data.dtype))
        rounding = 2.0 ** (-7 if dtype == "bfloat16" else -10)
        onp.testing.assert_allclose(got, ref, rtol=rounding, atol=0)
    # the caller's arrays were written in place, and the tensor path
    # gives the same bits
    assert id(tw._data) == w_id
    tensor_w, _ = _run_port(name, dict(kw, multi_precision=dtype !=
                                       "float32"), w, grads, dtype)
    assert onp.array_equal(got, tensor_w)


def test_update_of_mxnets_sgd_example_is_the_references():
    """The reference's own formula check, on both packages."""
    res = []
    for pkg in (mx, mxt):
        ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.01)
        w = pkg.nd.array([1.0, 2.0], **ctx)
        opt.update(0, w, pkg.nd.array([0.5, 0.5], **ctx),
                   opt.create_state(0, w))
        res.append(w.asnumpy())
    onp.testing.assert_allclose(res[1], res[0], rtol=1e-6)
    onp.testing.assert_allclose(res[1], [0.949, 1.948], rtol=1e-6)


SPARSE_CASES = {
    "sgd-lazy": ("sgd", dict(momentum=0.0)),
    "sgd-momentum-lazy": ("sgd", dict(momentum=0.9)),
    "sgd-dense": ("sgd", dict(momentum=0.9, lazy_update=False)),
    "nag-dense": ("nag", dict(momentum=0.9)),
    "adam-dense": ("adam", {}),
}


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_row_sparse_gradients_update_as_the_reference(case):
    name, kw = SPARSE_CASES[case]
    rng = onp.random.RandomState(3)
    w0 = rng.randn(6, 3).astype("float32")
    grads = []
    for rows in ([1, 4], [0, 4]):
        g = onp.zeros((6, 3), "float32")
        g[rows] = rng.randn(len(rows), 3)
        grads.append(g)
    res = []
    for pkg in (mx, mxt):
        ctx = {"ctx": mxt.cpu()} if pkg is mxt else {}
        opt = pkg.optimizer.create(name, learning_rate=0.5, wd=0.1, **kw)
        w = pkg.nd.array(w0, **ctx)
        state = opt.create_state(0, w)
        for g in grads:
            state = opt.update(0, w, pkg.nd.array(g, **ctx)
                               .tostype("row_sparse"), state)
        res.append((w.asnumpy(), [s.asnumpy() for s in _flat(state)]))
    (jw, js), (tw, ts) = res
    onp.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    for got, want in zip(ts, js, strict=True):
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    untouched = [2, 3, 5]
    lazy = case.endswith("-lazy")
    assert onp.array_equal(tw[untouched], w0[untouched]) == lazy
