"""The port's imperative autograd against the JAX package's, on the CPU.

Every test runs the same numpy inputs, made from a seed, through
``incubator_mxnet_tpu`` and ``incubator_mxnet_tpu_torch`` and compares the
gradients within 1e-6 (float32: the same products, maybe summed in another
order), unless it says otherwise:

- "write" gradients: two ``record()``/``backward()`` rounds give the last
  backward's gradient, not the sum (a fault the port had); a variable the
  backward does not reach keeps its gradient;
- ``Trainer.step`` leaves ``Parameter.grad()`` as the backward wrote it (a
  fault the port had: it zeroed it), and ``TrainStep`` leaves it alone;
- "add" sums the backwards, "null" has no gradient;
- ``autograd.grad`` returns the gradients without touching ``.grad``, and
  with ``create_graph`` gives a second derivative;
- a custom ``autograd.Function`` and ``mark_variables`` with the caller's
  gradient buffers;
- a write (``x[:] =``, ``+=``, ``-=``, ``*=``, ``/=``) into a variable or a
  recorded intermediate after ``record()`` leaves the recorded graph its
  old value (the JAX package's tape), within 1e-6.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import jit as jjit

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tag

TOL = dict(atol=1e-6, rtol=1e-6)


def _dense_pair(seed=0):
    """Dense(2, in_units=3) in both packages with the same weights."""
    rng = onp.random.RandomState(seed)
    w = rng.randn(2, 3).astype("float32")
    b = rng.randn(2).astype("float32")
    jnet = jgluon.nn.Dense(2, in_units=3)
    jnet.initialize()
    jnet.weight.set_data(mx.nd.array(w))
    jnet.bias.set_data(mx.nd.array(b))
    tnet = mxt.gluon.nn.Dense(2, in_units=3)
    tnet.initialize(ctx=mxt.cpu())
    tnet.weight.set_data(w)
    tnet.bias.set_data(b)
    return jnet, tnet


def _batch(seed=1, n=4):
    return onp.random.RandomState(seed).randn(n, 3).astype("float32")


def _two_backwards(net, nd, autograd, xs):
    for x in xs:
        with autograd.record():
            loss = (net(nd.array(x, **_ctx(nd))) ** 2).sum()
        loss.backward()


def _ctx(nd):
    return {"ctx": mxt.cpu()} if nd is mxt.nd else {}


def test_write_gives_the_last_backwards_gradient():
    """Fault: the port let torch add into .grad, so two "write" backwards
    gave the sum of their gradients."""
    jnet, tnet = _dense_pair()
    xs = [_batch(1), _batch(2)]
    _two_backwards(jnet, mx.nd, jag, xs)
    _two_backwards(tnet, mxt.nd, tag, xs)
    for name in ("weight", "bias"):
        want = getattr(jnet, name).grad().asnumpy()
        got = getattr(tnet, name).grad().asnumpy()
        onp.testing.assert_allclose(got, want, **TOL)
    # the last backward alone gives the same gradient
    _, fresh = _dense_pair()
    _two_backwards(fresh, mxt.nd, tag, xs[1:])
    onp.testing.assert_array_equal(fresh.weight.grad().asnumpy(),
                                   tnet.weight.grad().asnumpy())


def test_trainer_step_leaves_the_gradient_as_the_reference_does():
    """Fault: the port's Trainer.step zeroed every "write" gradient after
    the update; the reference's grad() after the step is the step's."""
    jnet, tnet = _dense_pair()
    x = _batch(3)
    for net, nd, autograd, gluon in ((jnet, mx.nd, jag, jgluon),
                                     (tnet, mxt.nd, tag, mxt.gluon)):
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        with autograd.record():
            loss = (net(nd.array(x, **_ctx(nd))) ** 2).sum()
        loss.backward()
        trainer.step(4)
    want = jnet.weight.grad().asnumpy()
    assert onp.abs(want).sum() > 0
    onp.testing.assert_allclose(tnet.weight.grad().asnumpy(), want, **TOL)
    onp.testing.assert_allclose(tnet.weight.data().asnumpy(),
                                jnet.weight.data().asnumpy(), **TOL)


def test_train_step_leaves_the_gradient_as_the_jax_train_step_does():
    """A backward writes grad(); a TrainStep after it updates from its own
    gradients and leaves grad() as the backward wrote it, in both."""
    jnet, tnet = _dense_pair()
    x, y = _batch(4), onp.random.RandomState(5).randn(4, 2) \
        .astype("float32")
    for net, nd, autograd, gluon, jit in (
            (jnet, mx.nd, jag, jgluon, jjit),
            (tnet, mxt.nd, tag, mxt.gluon, mxt.jit)):
        with autograd.record():
            loss = net(nd.array(x, **_ctx(nd))).sum()
        loss.backward()
        before = net.weight.grad().asnumpy()
        step = jit.TrainStep(net, gluon.loss.L2Loss(), gluon.Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.1}))
        step(nd.array(x, **_ctx(nd)), nd.array(y, **_ctx(nd)))
        onp.testing.assert_array_equal(net.weight.grad().asnumpy(), before)
    onp.testing.assert_allclose(tnet.weight.data().asnumpy(),
                                jnet.weight.data().asnumpy(), **TOL)


def _variable_run(nd, autograd, req, xs):
    a = nd.array(onp.array([0.5, -1.5, 2.0], "float32"), **_ctx(nd))
    a.attach_grad(req)
    for x in xs:
        with autograd.record():
            y = (a * nd.array(x, **_ctx(nd))).sum() + (a * a).sum()
        y.backward()
    return a


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_the_reference(req):
    xs = [onp.random.RandomState(i).randn(3).astype("float32")
          for i in (6, 7)]
    ja = _variable_run(mx.nd, jag, req, xs)
    ta = _variable_run(mxt.nd, tag, req, xs)
    if req == "null":
        assert ta.grad is None
        return
    onp.testing.assert_allclose(ta.grad.asnumpy(), ja.grad.asnumpy(), **TOL)
    one = _variable_run(mxt.nd, tag, req, xs[1:]).grad.asnumpy()
    if req == "write":
        onp.testing.assert_array_equal(ta.grad.asnumpy(), one)
    else:
        assert not onp.allclose(ta.grad.asnumpy(), one)


def test_write_keeps_the_gradient_of_a_variable_the_backward_misses():
    outs = []
    for nd, autograd in ((mx.nd, jag), (mxt.nd, tag)):
        a = nd.array(onp.array([1.0, 2.0], "float32"), **_ctx(nd))
        b = nd.array(onp.array([3.0, -1.0], "float32"), **_ctx(nd))
        a.attach_grad()
        b.attach_grad()
        with autograd.record():
            y = (a * b).sum()
        y.backward()
        with autograd.record():
            z = (a * a).sum()
        z.backward()
        outs.append((a.grad.asnumpy(), b.grad.asnumpy()))
    (ja, jb), (ta, tb) = outs
    onp.testing.assert_allclose(ta, ja, **TOL)
    onp.testing.assert_allclose(tb, jb, **TOL)
    onp.testing.assert_array_equal(tb, [1.0, 2.0])


def test_grad_returns_gradients_and_leaves_dot_grad_alone():
    x0 = onp.array([0.5, -1.0, 2.0], "float32")
    res = []
    for nd, autograd in ((mx.nd, jag), (mxt.nd, tag)):
        x = nd.array(x0, **_ctx(nd))
        x.attach_grad()
        with autograd.record():
            y = (x * x * x).sum()
        g = autograd.grad(y, x)
        res.append((g.asnumpy(), x.grad.asnumpy()))
    (jg, jxg), (tg, txg) = res
    onp.testing.assert_allclose(tg, jg, **TOL)
    onp.testing.assert_allclose(tg, 3 * x0 ** 2, **TOL)
    onp.testing.assert_array_equal(txg, jxg)
    onp.testing.assert_array_equal(txg, onp.zeros(3, "float32"))


def test_grad_with_create_graph_gives_the_second_derivative():
    x0 = onp.array([0.5, -1.0, 2.0], "float32")
    x = mxt.nd.array(x0, ctx=mxt.cpu())
    x.attach_grad()
    with tag.record():
        y = (x * x * x).sum()
        (g,) = tag.grad(y, [x], create_graph=True)
        z = (g * g).sum()          # sum (3x²)² → d/dx = 36 x³
    onp.testing.assert_allclose(g.asnumpy(), 3 * x0 ** 2, **TOL)
    z.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 36 * x0 ** 3, **TOL)


def _sigmoid_function(nd, autograd):
    class Sigmoid(autograd.Function):
        def forward(self, x):
            y = 1 / (1 + nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid()


def test_custom_function_matches_the_reference():
    x0 = onp.random.RandomState(8).randn(2, 3).astype("float32")
    head = onp.random.RandomState(9).randn(2, 3).astype("float32")
    res = []
    for nd, autograd in ((mx.nd, jag), (mxt.nd, tag)):
        x = nd.array(x0, **_ctx(nd))
        x.attach_grad()
        with autograd.record():
            y = _sigmoid_function(nd, autograd)(x * 2)
        y.backward(nd.array(head, **_ctx(nd)))
        res.append((y.asnumpy(), x.grad.asnumpy()))
    (jy, jg), (ty, tg) = res
    onp.testing.assert_allclose(ty, jy, **TOL)
    onp.testing.assert_allclose(tg, jg, **TOL)
    s = 1 / (1 + onp.exp(-2 * x0))
    onp.testing.assert_allclose(tg, head * s * (1 - s) * 2, atol=1e-6,
                                rtol=1e-5)


def test_mark_variables_writes_the_callers_gradient_buffers():
    x0 = onp.array([1.0, 2.0, 3.0], "float32")
    res = []
    for nd, autograd in ((mx.nd, jag), (mxt.nd, tag)):
        x = nd.array(x0, **_ctx(nd))
        buf = nd.zeros((3,), **_ctx(nd))
        autograd.mark_variables([x], [buf], "add")
        for _ in range(2):
            with autograd.record():
                y = (x * x).sum()
            autograd.backward([y])
        res.append(buf.asnumpy())
        assert x.grad is buf
    onp.testing.assert_allclose(res[1], res[0], **TOL)
    onp.testing.assert_allclose(res[1], 4 * x0, **TOL)


def test_backward_on_a_head_without_variables_changes_nothing():
    """As in the reference, a head no variable feeds leaves every gradient
    as it was; NDArray operations outside record() are not recorded."""
    x = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu())
    x.attach_grad()
    y = (x * 3).sum()                          # outside record()
    y.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 0.0])
    with tag.record():
        z = mxt.nd.ones_like(x).sum()
    z.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 0.0])


def test_parameter_data_is_the_parameter_and_a_write_into_it_lands():
    jnet, tnet = _dense_pair()
    d = tnet.weight.data()
    assert d is tnet.weight.data()
    assert d._data is dict(tnet.named_parameters())["weight"]
    g = tnet.weight.grad()
    assert g is tnet.weight.grad()
    x = _batch(6)
    for net, nd, autograd in ((jnet, mx.nd, jag), (tnet, mxt.nd, tag)):
        net.weight.data()[:] = nd.ones((2, 3), **_ctx(nd))
        net.weight.data()[0, 1] = 5.0
        with autograd.record():
            loss = (net(nd.array(x, **_ctx(nd))) ** 2).sum()
        loss.backward()
    want = onp.ones((2, 3), "float32")
    want[0, 1] = 5.0
    onp.testing.assert_array_equal(tnet.state_dict()["weight"].numpy(), want)
    onp.testing.assert_array_equal(jnet.weight.data().asnumpy(), want)
    assert float(tnet.weight.data()[0, 1].asscalar()) == 5.0
    assert tnet.weight.grad() is g
    onp.testing.assert_allclose(g.asnumpy(), jnet.weight.grad().asnumpy(),
                                **TOL)


def test_a_write_into_parameter_data_inside_record_lands():
    """MXNet records no write into a variable: inside record() as outside,
    ``p.data()[:] = v`` and ``p.data() += d`` change the parameter."""
    jnet, tnet = _dense_pair()
    x = _batch(7)
    delta = onp.random.RandomState(8).randn(2, 3).astype("float32")
    for net, nd, autograd in ((jnet, mx.nd, jag), (tnet, mxt.nd, tag)):
        with autograd.record():
            net.weight.data()[:] = nd.ones((2, 3), **_ctx(nd))
            w = net.weight.data()
            w += nd.array(delta, **_ctx(nd))
            loss = (net(nd.array(x, **_ctx(nd))) ** 2).sum()
        loss.backward()
    onp.testing.assert_allclose(tnet.state_dict()["weight"].numpy(),
                                1 + delta, **TOL)
    onp.testing.assert_allclose(tnet.weight.data().asnumpy(),
                                jnet.weight.data().asnumpy(), **TOL)
    onp.testing.assert_allclose(tnet.weight.grad().asnumpy(),
                                jnet.weight.grad().asnumpy(), **TOL)


def test_an_array_taken_from_a_parameter_keeps_its_values_after_a_step():
    """``p.data().reshape(-1)`` and ``p.data().astype(p.dtype)`` are arrays
    of their own, as JAX arrays are: Trainer.step's in-place update of the
    parameter does not show in them, and a write into them does not reach
    the parameter."""
    jnet, tnet = _dense_pair()
    x = _batch(9)
    init = tnet.weight.data().asnumpy()
    res = []
    for net, nd, autograd, gluon in ((jnet, mx.nd, jag, jgluon),
                                     (tnet, mxt.nd, tag, mxt.gluon)):
        flat = net.weight.data().reshape(-1)
        same = net.weight.data().astype("float32")
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        with autograd.record():
            loss = (net(nd.array(x, **_ctx(nd))) ** 2).sum()
        loss.backward()
        trainer.step(4)
        after = net.weight.data().asnumpy()
        same[:] = 0
        res.append((flat.asnumpy(), after, net.weight.data().asnumpy()))
    (jflat, jafter, jnow), (tflat, tafter, tnow) = res
    onp.testing.assert_array_equal(jflat, init.reshape(-1))
    onp.testing.assert_array_equal(tflat, init.reshape(-1))
    assert not onp.allclose(tafter, init)
    onp.testing.assert_allclose(tafter, jafter, **TOL)
    onp.testing.assert_array_equal(tnow, tafter)
    onp.testing.assert_array_equal(jnow, jafter)


def test_eval_step_outputs_are_ordinary_arrays():
    """EvalStep's NDArrays take in-place writes, attach_grad and use inside
    record(), as the JAX package's do."""
    jnet, tnet = _dense_pair()
    x = _batch(10)
    res = []
    for net, nd, autograd, jit in ((jnet, mx.nd, jag, jjit),
                                   (tnet, mxt.nd, tag, mxt.jit)):
        out = jit.EvalStep(net)(nd.array(x, **_ctx(nd)))
        out += 1
        out[0] = 2.0
        out.attach_grad()
        with autograd.record():
            y = (out * out).sum()
        y.backward()
        res.append((out.asnumpy(), out.grad.asnumpy()))
    (jo, jg), (to, tg) = res
    onp.testing.assert_allclose(to, jo, **TOL)
    onp.testing.assert_allclose(tg, jg, **TOL)


def test_in_place_add_on_a_variable_is_in_place_outside_record():
    """Outside record() and inside it (MXNet records no write into a
    variable): the variable stays the same leaf, and a later backward
    gives its gradient at the new value, as in the JAX package."""
    x = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu())
    x.attach_grad()
    leaf = x._data
    x += 1
    assert x._data is leaf and x._data.requires_grad
    onp.testing.assert_array_equal(x.asnumpy(), [2.0, 3.0])
    res = []
    for nd, autograd, v in ((mx.nd, jag, None), (mxt.nd, tag, x)):
        if v is None:
            v = nd.array([2.0, 3.0])
            v.attach_grad()
        with autograd.record():
            v += 1
            y = (v * v * v).sum()
        y.backward()
        res.append((v.asnumpy(), v.grad.asnumpy()))
    assert x._data is leaf
    (jv, jg), (tv, tg) = res
    onp.testing.assert_array_equal(tv, [3.0, 4.0])
    onp.testing.assert_array_equal(tv, jv)
    onp.testing.assert_allclose(tg, jg, **TOL)
    onp.testing.assert_allclose(tg, 3 * tv ** 2, **TOL)
    with pytest.raises(ValueError):
        tag.mark_variables([x], [mxt.nd.zeros((3,), ctx=mxt.cpu())])
    assert isinstance(tag.is_recording(), bool)
    assert torch.is_grad_enabled()


WRITES = {
    "setitem": lambda a: a.__setitem__(slice(None), 0.5),
    "iadd": lambda a: a.__iadd__(100.0),
    "isub": lambda a: a.__isub__(1.0),
    "imul": lambda a: a.__imul__(3.0),
    "itruediv": lambda a: a.__itruediv__(2.0),
}


@pytest.mark.parametrize("where", ["leaf", "intermediate"])
@pytest.mark.parametrize("write", sorted(WRITES))
def test_a_write_after_record_leaves_the_recorded_graph(write, where):
    """y = sum(h * h) with h = x (a leaf) or h = 2x (an intermediate),
    recorded; then h is written outside record() and y.backward() gives
    the gradient at the recorded value, as the JAX package's tape does.
    The leaf keeps the gradient array attach_grad made and rebinds its
    tensor (a live graph holds it); once nothing holds it, a write is in
    place again."""
    x0 = onp.random.RandomState(5).randn(3).astype("float32")
    res = []
    for nd, autograd in ((mx.nd, jag), (mxt.nd, tag)):
        x = nd.array(x0, **_ctx(nd))
        x.attach_grad()
        buf = x.grad
        with autograd.record():
            h = x if where == "leaf" else x * 2
            y = (h * h).sum()
        before = x._data
        WRITES[write](h)
        y.backward()
        res.append((x.grad.asnumpy(), h.asnumpy()))
        if nd is mxt.nd:
            assert x.grad is buf
            assert (x._data is before) == (where == "intermediate")
            del y
            now = x._data
            x += 1.0
            assert x._data is now and x._data.requires_grad
    (jg, jh), (tg, th) = res
    onp.testing.assert_allclose(tg, jg, **TOL)
    onp.testing.assert_allclose(tg, (2 if where == "leaf" else 8) * x0,
                                **TOL)
    onp.testing.assert_allclose(th, jh, **TOL)
