"""``mx.np`` and ``mx.npx`` of the port against the JAX package's, on the
CPU.

Every ``mx.np`` case of ``tests/np_cases.py`` (each name of
``test_np_parity.py``'s ``NP_TOP`` and ``NP_LINALG`` lists, and the rest
of the reference's ``__all__``) runs the same seeded inputs through both
namespaces: float32 within 1e-5 + 1e-6 relative, ints and bools exact,
shapes equal. ``np.random`` and ``npx.random`` are held by their moments
(the two packages' streams differ). ``mx.npx`` is in
``tests/test_torch_numpy_extension.py``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu_torch as mxt

import np_cases as C

@pytest.fixture(scope="module")
def both():
    with mxt.cpu():
        return C.inputs(mx.np), C.inputs(mxt.np)


_CASES = C.NP_CASES + C.LINALG_CASES


@pytest.mark.parametrize("label,fn", _CASES, ids=[c[0] for c in _CASES])
def test_name_against_the_reference(both, label, fn):
    xj, xt = both
    want = C.host(fn(mx.np, mx.npx, xj))
    with mxt.cpu():
        got = C.host(fn(mxt.np, mxt.npx, xt))
    C.compare(got, want, label)


@pytest.mark.parametrize("label,draw,moments", C.RANDOM_CASES,
                         ids=[c[0] for c in C.RANDOM_CASES])
def test_random_by_distribution(label, draw, moments):
    mxt.npx.random.seed(11)
    with mxt.cpu():
        s = draw(mxt.np, mxt.npx)
    C.moments_ok(s.asnumpy(), *moments, label)
    mxt.npx.random.seed(11)
    with mxt.cpu():
        again = draw(mxt.np, mxt.npx)
    onp.testing.assert_array_equal(again.asnumpy(), s.asnumpy())


def test_gradient_through_a_chain_of_np_ops():
    """The port's autograd through matmul, tanh, concatenate, exp,
    square, mean, arange and sum against ``jax.grad`` of the same chain
    through the JAX package's mx.np."""
    rng = onp.random.RandomState(2)
    x = rng.randn(3, 4).astype("float32")
    w = rng.randn(4, 5).astype("float32")

    def chain(np, a, b):
        h = np.tanh(np.matmul(a, b))
        h = np.concatenate([h, np.exp(-np.square(h))], axis=1)
        return np.sum(np.mean(h, axis=0) * np.arange(10) / 10.0)

    def ref(a):
        return chain(mx.np, mx.np.ndarray(a), mx.np.array(w))._data

    want = jax.grad(ref)(jnp.asarray(x))
    with mxt.cpu():
        a = mxt.np.array(x)
        b = mxt.np.array(w)
        a.attach_grad()
        with mxt.autograd.record():
            y = chain(mxt.np, a, b)
        y.backward()
        assert isinstance(y, mxt.np.ndarray)
    C.compare(a.grad.asnumpy(), onp.asarray(want), "grad")


def test_ndarray_semantics():
    with mxt.cpu():
        a = mxt.np.array(onp.array([1.0, -2.0, 3.0]))     # float64 in
        assert a.dtype == onp.float32
        assert (a == None) is False and (a != None) is True  # noqa: E711
        m = a > 0
        assert m.dtype == onp.bool_ and isinstance(m, mxt.np.ndarray)
        assert a[m].tolist() == [1.0, 3.0]
        assert mxt.np.array([1, 2]).dtype == onp.float32
        assert mxt.np.arange(3).dtype == onp.int32
        assert mxt.np.sum(mxt.np.array(onp.arange(3, dtype="int64"))) \
            .dtype == onp.int32
        a.attach_grad()
        with mxt.autograd.record():
            y = (a.as_nd_ndarray() * 2).sum()
        y.backward()
        onp.testing.assert_array_equal(a.grad.asnumpy(), [2.0, 2.0, 2.0])


def test_dispatch_protocol_and_ufunc_out():
    with mxt.cpu():
        a = mxt.np.array([[1.0, 2.0], [3.0, 4.0]])
        assert isinstance(onp.mean(a), mxt.np.ndarray)
        onp.testing.assert_allclose(onp.sin(a).asnumpy(),
                                    onp.sin(a.asnumpy()), rtol=1e-6)
        assert onp.concatenate([a, a]).shape == (4, 2)
        out = mxt.np.zeros((2, 2))
        r = onp.add(a, 1.0, out=out)
        assert r is out and out.tolist() == [[2.0, 3.0], [4.0, 5.0]]
        t = mxt.np.zeros((2, 2), dtype="int32")
        with pytest.raises(TypeError):
            onp.multiply(a, 0.5, out=t)
        # a ufunc keyword the namespace lacks runs NumPy on the host
        w = onp.add(a, 1.0, where=onp.array([[True, False], [False, True]]),
                    out=mxt.np.zeros((2, 2)))
        assert w.tolist() == [[2.0, 0.0], [0.0, 5.0]]
