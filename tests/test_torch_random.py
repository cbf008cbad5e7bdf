"""``nd.random`` of the port, on the CPU: shapes, dtypes, repetition under
``seed`` and the moments of each distribution. The streams are torch's,
not the JAX package's threefry keys, so values are never compared with
the JAX package; shapes and dtypes are. Moments over 200 000 draws are
held within 5 standard errors of the distribution's (a false alarm about
once in 3 million runs)."""
import numpy as onp
import pytest

import incubator_mxnet_tpu as mx

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.ndarray import random as trandom

N = 200_000
CPU = mxt.cpu()


def _draws(name, **kw):
    return getattr(trandom, name)(shape=(N,), ctx=CPU, **kw).asnumpy() \
        .astype("float64")


def _hold(x, mean, var):
    se = onp.sqrt(var / x.size)
    assert abs(x.mean() - mean) < 5 * se, (x.mean(), mean)
    # the sample variance's standard error, from the fourth moment
    se_var = onp.sqrt(onp.mean((x - x.mean()) ** 4) / x.size)
    assert abs(x.var() - var) < 5 * se_var + 1e-12, (x.var(), var)


@pytest.mark.parametrize("name,kw,mean,var", [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16.0 / 12),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25),
    ("exponential", dict(scale=2.0), 2.0, 4.0),
    ("gamma", dict(alpha=3.0, beta=0.5), 1.5, 0.75),
    ("poisson", dict(lam=4.0), 4.0, 4.0),
    ("randint", dict(low=0, high=10), 4.5, 99.0 / 12)])
def test_moments(name, kw, mean, var):
    _hold(_draws(name, **kw), mean, var)


def test_bernoulli_moments_and_shapes():
    x = trandom.bernoulli(prob=0.3, shape=(N,), ctx=CPU).asnumpy()
    assert set(onp.unique(x)) <= {0.0, 1.0}
    _hold(x.astype("float64"), 0.3, 0.21)
    p = mxt.nd.array([0.0, 1.0, 1.0], ctx=CPU)
    onp.testing.assert_array_equal(trandom.bernoulli(prob=p).asnumpy(),
                                   [0.0, 1.0, 1.0])
    assert trandom.bernoulli(prob=0.5, ctx=CPU).shape == \
        mx.nd.random.bernoulli(prob=0.5).shape == ()
    logit = trandom.bernoulli(logit=mxt.nd.array([-50.0, 50.0], ctx=CPU))
    onp.testing.assert_array_equal(logit.asnumpy(), [0.0, 1.0])


@pytest.mark.parametrize("name,kw", [
    ("uniform", {}), ("normal", {}), ("exponential", {}), ("gamma", {}),
    ("poisson", {}), ("randint", dict(low=0, high=5))])
def test_shapes_and_dtypes_match_the_jax_package(name, kw):
    for shape in ((2, 3), 4):
        ref = getattr(mx.nd.random, name)(shape=shape, **kw)
        got = getattr(trandom, name)(shape=shape, ctx=CPU, **kw)
        assert got.shape == ref.shape and got.dtype == ref.dtype
    dtype = "int64" if name == "randint" else "float16"
    got = getattr(trandom, name)(shape=(2, 2), ctx=CPU, dtype=dtype, **kw)
    assert got.dtype == dtype


def test_seed_repeats_the_draws_globally_and_per_context():
    trandom.seed(42)
    a = [trandom.normal(shape=(5,), ctx=CPU).asnumpy(),
         trandom.uniform(shape=(3,), ctx=CPU).asnumpy(),
         trandom.shuffle(mxt.nd.arange(10, ctx=CPU)).asnumpy()]
    trandom.seed(42)
    b = [trandom.normal(shape=(5,), ctx=CPU).asnumpy(),
         trandom.uniform(shape=(3,), ctx=CPU).asnumpy(),
         trandom.shuffle(mxt.nd.arange(10, ctx=CPU)).asnumpy()]
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x, y)
    assert not onp.array_equal(a[0], trandom.normal(shape=(5,),
                                                    ctx=CPU).asnumpy())
    trandom.seed(7, ctx=CPU)
    c = trandom.normal(shape=(5,), ctx=CPU).asnumpy()
    trandom.seed(7, ctx=CPU)
    onp.testing.assert_array_equal(
        c, trandom.normal(shape=(5,), ctx=CPU).asnumpy())
    assert sorted(a[2]) == list(range(10))


def test_randn_shuffle_and_ndarray_bounds():
    assert trandom.randn(2, 3, ctx=CPU).shape == (2, 3)
    x = mxt.nd.array(onp.arange(12).reshape(6, 2), ctx=CPU)
    s = trandom.shuffle(x).asnumpy()
    assert sorted(map(tuple, s)) == sorted(map(tuple, x.asnumpy()))
    low = mxt.nd.array([0.0, 10.0], ctx=CPU)
    high = mxt.nd.array([1.0, 20.0], ctx=CPU)
    u = trandom.uniform(low, high, shape=(1000,)).asnumpy()
    assert u.shape == (2, 1000)
    assert (u[0] >= 0).all() and (u[0] < 1).all()
    assert (u[1] >= 10).all() and (u[1] < 20).all()
    out = mxt.nd.zeros((4,), ctx=CPU)
    res = trandom.normal(shape=(4,), ctx=CPU, out=out)
    assert res is out and not onp.array_equal(out.asnumpy(), onp.zeros(4))
