"""``nd.linalg`` against the JAX package's, on the CPU.

Every operator runs on the same numpy inputs (from a seed) through both
packages, float32 within 1e-5 of the largest value of the reference's
output (1e-4 for the inverses and solves, whose conditioning amplifies
rounding), and float64 (the reference under ``jax.enable_x64``) within
1e-10. Gradients of the differentiable operators are held against
``jax.vjp`` of the reference's operator within the same tolerances. The
factorisations (``gelqf``, ``svd``, ``syevd``) are compared after fixing
each factor's signs (the first nonzero entry of each vector positive), and
through their reconstructions.

Departures, each MXNet's behaviour (``test_*_departs_*``): ``trsm`` with
``rightside=True`` and ``trmm`` read only the triangle ``lower`` names;
``gemm``/``gemm2`` honour ``axis=``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import nd as tnd

TOL = {"float32": 1e-5, "float64": 1e-10}


def _close(got, want, tol, what=""):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()), 1e-30)
    err = float(onp.abs(got - want).max()) / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _spd(rng, n, batch=(2,)):
    a = rng.randn(*batch, n, n)
    return a @ onp.swapaxes(a, -1, -2) + n * onp.eye(n)


def _inputs(name, rng):
    """(the operator's arrays, its keyword arguments) for ``name``."""
    m = rng.randn(2, 3, 4)
    sq = rng.randn(2, 4, 4) + 4 * onp.eye(4)
    low = onp.tril(sq)
    return {
        "gemm": ([m, rng.randn(2, 4, 5), rng.randn(2, 3, 5)],
                 dict(alpha=0.7, beta=-1.3)),
        "gemm_t": ([rng.randn(2, 4, 3), rng.randn(2, 5, 4),
                    rng.randn(2, 3, 5)],
                   dict(transpose_a=True, transpose_b=True)),
        "gemm2": ([m, rng.randn(2, 4, 5)], dict(alpha=1.5)),
        "potrf": ([_spd(rng, 4)], {}),
        "potrf_upper": ([_spd(rng, 4)], dict(lower=False)),
        "potri": ([onp.linalg.cholesky(_spd(rng, 4))], {}),
        "trsm": ([low, rng.randn(2, 4, 3)], dict(alpha=2.0)),
        "trsm_t": ([low, rng.randn(2, 4, 3)], dict(transpose=True)),
        "trmm": ([low, rng.randn(2, 4, 3)], dict(alpha=0.5)),
        "trmm_right": ([low, rng.randn(2, 3, 4)],
                       dict(rightside=True, transpose=True)),
        "syrk": ([m], dict(alpha=0.3)),
        "syrk_t": ([m], dict(transpose=True)),
        "sumlogdiag": ([_spd(rng, 4)], {}),
        "extractdiag": ([sq], dict(offset=1)),
        "makediag": ([rng.randn(2, 3)], dict(offset=-1)),
        "extracttrian": ([sq], dict(offset=0, lower=False)),
        "extracttrian_off": ([sq], dict(offset=-1)),
        "maketrian": ([rng.randn(2, 10)], {}),
        "maketrian_off": ([rng.randn(2, 6)], dict(offset=1)),
        "inverse": ([sq], {}),
        "det": ([sq], {}),
        "slogdet": ([sq - 6 * onp.eye(4)], {}),
    }[name]


PLAIN = ["gemm", "gemm_t", "gemm2", "potrf", "potrf_upper", "potri", "trsm",
         "trsm_t", "trmm", "trmm_right", "syrk", "syrk_t", "sumlogdiag",
         "extractdiag", "makediag", "extracttrian", "extracttrian_off",
         "maketrian", "maketrian_off", "inverse", "det", "slogdet"]
LOOSE = ("inverse", "potri", "trsm", "trsm_t", "slogdet", "det")


def _datas(out):
    if isinstance(out, (list, tuple)):
        return [_datas(o) for o in out]
    return out._data


def _ref(name, arrays, kw):
    fn = getattr(jnd.linalg, name.split("_")[0])
    return jax.jit(lambda *xs: _datas(fn(*[JNDArray(x) for x in xs],
                                          **kw)))(*arrays)


def _port(name, arrays, kw, dtype):
    fn = getattr(tnd.linalg, name.split("_")[0])
    ins = [tnd.array(a, ctx=mxt.cpu(), dtype=dtype) for a in arrays]
    return fn(*ins, **kw), ins


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", PLAIN)
def test_linalg_forward_and_gradient(name, dtype):
    rng = onp.random.RandomState(sorted(PLAIN).index(name))
    arrays, kw = _inputs(name, rng)
    arrays = [a.astype(dtype) for a in arrays]
    tol = TOL[dtype] * (10 if name in LOOSE else 1)
    with jax.enable_x64(dtype == "float64"):
        jin = [jnp.asarray(a) for a in arrays]
        want = _as_list(_ref(name, jin, kw))
        got, ins = _port(name, arrays, kw, dtype)
        got = _as_list(got)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.asnumpy(), onp.asarray(w), tol, name)
        if name in ("slogdet",):
            return
        cot = [rng.randn(*onp.shape(w)).astype(dtype) for w in want]
        for x in ins:
            x.attach_grad()
        fn = getattr(tnd.linalg, name.split("_")[0])
        with tautograd.record():
            outs = _as_list(fn(*ins, **kw))
            total = sum((o * tnd.array(c, ctx=mxt.cpu(), dtype=dtype)).sum()
                        for o, c in zip(outs, cot))
        total.backward()
        jfn = getattr(jnd.linalg, name.split("_")[0])
        _, vjp = jax.vjp(lambda *xs: _as_list(_datas(
            jfn(*[JNDArray(x) for x in xs], **kw))), *jin)
        jgrads = vjp([jnp.asarray(c) for c in cot])
        for i, (x, jg) in enumerate(zip(ins, jgrads)):
            got_g, want_g = x.grad.asnumpy(), onp.asarray(jg)
            if name.startswith("trmm") and i == 0:
                # the port reads (and differentiates) A's lower triangle
                # only; the JAX package's trmm differentiates all of A
                want_g = onp.tril(want_g)
            _close(got_g, want_g, tol * 10, name + " gradient")


def _fix_rows(v):
    """Each row of ``v`` (..., k, n) with its largest entry positive."""
    idx = onp.abs(v).argmax(-1)[..., None]
    return v * onp.sign(onp.take_along_axis(v, idx, -1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_linalg_factorisations(dtype):
    rng = onp.random.RandomState(11)
    a = rng.randn(2, 3, 5).astype(dtype)
    s = _spd(rng, 4).astype(dtype)
    tol = TOL[dtype] * 10
    with jax.enable_x64(dtype == "float64"):
        ta = tnd.array(a, ctx=mxt.cpu(), dtype=dtype)
        # gelqf: A = L Q, Q's rows orthonormal, equal up to row signs
        jl, jq = _ref("gelqf", [jnp.asarray(a)], {})
        tl, tq = tnd.linalg.gelqf(ta)
        tl, tq = tl.asnumpy(), tq.asnumpy()
        _close(tl @ tq, a, tol, "gelqf L Q")
        sign = onp.sign(onp.diagonal(tl, axis1=-2, axis2=-1))[..., None]
        jsign = onp.sign(onp.diagonal(onp.asarray(jl), axis1=-2,
                                      axis2=-1))[..., None]
        _close(tq * sign, onp.asarray(jq) * jsign, tol, "gelqf Q")
        # svd: (u, s, vh)
        ju, js, jvh = _ref("svd", [jnp.asarray(a)], {})
        tu, ts, tvh = (x.asnumpy() for x in tnd.linalg.svd(ta))
        _close(ts, onp.asarray(js), tol, "singular values")
        _close((tu * ts[..., None, :]) @ tvh, a, tol, "svd u s vh")
        _close(_fix_rows(tvh), _fix_rows(onp.asarray(jvh)), tol, "svd vh")
        # syevd: A = Uᵀ diag(L) U
        jU, jL = _ref("syevd", [jnp.asarray(s)], {})
        tU, tL = (x.asnumpy() for x in tnd.linalg.syevd(
            tnd.array(s, ctx=mxt.cpu(), dtype=dtype)))
        _close(tL, onp.asarray(jL), tol, "eigenvalues")
        _close(onp.swapaxes(tU, -1, -2) @ (tL[..., None] * tU), s, tol,
               "syevd reconstruction")
        _close(_fix_rows(tU), _fix_rows(onp.asarray(jU)), tol * 10,
               "eigenvectors")


def test_linalg_flat_aliases_are_the_namespace_functions():
    for name in tnd.linalg.__all__:
        assert getattr(tnd, "linalg_" + name) is getattr(tnd.linalg, name)
        assert hasattr(jnd, "linalg_" + name)


def test_trsm_rightside_departs_by_reading_the_lower_triangle():
    """MXNet solves X op(A) = alpha B with the triangle ``lower`` names;
    the JAX package's right side reads the other triangle of A."""
    rng = onp.random.RandomState(5)
    a = (rng.randn(4, 4) + 4 * onp.eye(4)).astype("float64")
    b = rng.randn(3, 4)
    for transpose in (False, True):
        op_a = onp.tril(a).T if transpose else onp.tril(a)
        want = 1.5 * b @ onp.linalg.inv(op_a)
        got = tnd.linalg.trsm(tnd.array(a, ctx=mxt.cpu(), dtype="float64"),
                              tnd.array(b, ctx=mxt.cpu(), dtype="float64"),
                              alpha=1.5, transpose=transpose,
                              rightside=True).asnumpy()
        _close(got, want, 1e-10, "trsm right side")


def test_trmm_departs_by_reading_one_triangle():
    rng = onp.random.RandomState(6)
    a, b = rng.randn(4, 4), rng.randn(4, 3)
    for lower in (True, False):
        tri = onp.tril(a) if lower else onp.triu(a)
        got = tnd.linalg.trmm(tnd.array(a, ctx=mxt.cpu(), dtype="float64"),
                              tnd.array(b, ctx=mxt.cpu(), dtype="float64"),
                              lower=lower).asnumpy()
        _close(got, tri @ b, 1e-12, "trmm")


def test_gemm_departs_by_honouring_axis():
    """``axis`` is the axis of the matrix rows (MXNet's la_op): rows on
    axis 0 of (rows, batch, cols) arrays."""
    rng = onp.random.RandomState(7)
    a, b, c = rng.randn(3, 2, 4), rng.randn(4, 2, 5), rng.randn(3, 2, 5)
    want = onp.einsum("ibk,kbj->ibj", a, b) * 0.5 + 2.0 * c
    arr = lambda v: tnd.array(v, ctx=mxt.cpu(), dtype="float64")  # noqa
    got = tnd.linalg.gemm(arr(a), arr(b), arr(c), alpha=0.5, beta=2.0,
                          axis=0).asnumpy()
    _close(got, want, 1e-12, "gemm axis=0")
    got2 = tnd.linalg.gemm2(arr(a), arr(b), alpha=0.5, axis=0).asnumpy()
    _close(got2, want - 2.0 * c, 1e-12, "gemm2 axis=0")
    assert torch.equal(tnd.linalg.gemm2(torch.eye(2), torch.ones(2, 2)),
                       torch.ones(2, 2))
