"""The rest of ``mx.nd`` against the JAX package's, on the CPU: the loss
layers (``SoftmaxOutput``, the regression outputs), the nn-style operators,
the index and shape operators, sampling, interop, ``nd.sparse`` and the
namespaces' surface.

Values are float32 from a numpy seed, within 1e-5 of the largest value of
the reference's output (index outputs exact). Gradients are held against
``jax.vjp`` of the reference's operator within the same tolerance; the
loss layers' gradients are their own (MXNet's), independent of the head
gradient. Sampling is checked by distribution (the two packages' random
streams differ): the empirical frequencies of 20,000 draws within 0.02 of
the probabilities (about five standard errors), the mean within 5 % for
the negative binomials, and ``get_prob``'s log-probabilities exactly the
log of the probabilities of the samples drawn.

Where the port departs on purpose, a test says so (``*_departs_*``) and
holds it to MXNet: ``SoftmaxOutput``'s ``multi_output``,
``preserve_shape``, ``smooth_alpha`` and "valid" normalisation without
``use_ignore``, the regression outputs' ``1 / num_output``, and
``load_frombuffer`` reading the MXNet list format.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import nd as tnd

TOL = 1e-5


def _close(got, want, what="", tol=TOL):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(onp.abs(got - want).max()) / scale if got.size else 0.0
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _datas(out):
    if isinstance(out, (list, tuple)):
        return [_datas(o) for o in out]
    return out._data


def _tarr(a):
    return tnd.array(a, ctx=mxt.cpu(), dtype=onp.asarray(a).dtype.name)


def _check(jfn, tfn, arrays, diff=(), seed=3):
    """Forward values, and for the arrays at ``diff`` the gradients of
    <op(arrays), cotangent> (``jax.vjp`` against the port's autograd)."""
    jin = [jnp.asarray(a) for a in arrays]
    jf = lambda *xs: _datas(jfn(*[JNDArray(x) for x in xs]))  # noqa: E731
    want, vjp = jax.vjp(jf, *jin)
    tin = [_tarr(a) for a in arrays]
    for i in diff:
        tin[i].attach_grad()
    with tautograd.record():
        got = tfn(*tin)
    wl = want if isinstance(want, (list, tuple)) else [want]
    gl = got if isinstance(got, (list, tuple)) else [got]
    for g, w in zip(gl, wl):
        _close(g.asnumpy(), onp.asarray(w), "forward")
    if not diff:
        return
    rng = onp.random.RandomState(seed)
    cot = [onp.asarray(rng.randn(*onp.shape(w)), "float32") for w in wl]
    with tautograd.record():
        gl = tfn(*tin)
        gl = gl if isinstance(gl, (list, tuple)) else [gl]
        total = sum((g * _tarr(c)).sum() for g, c in zip(gl, cot))
    total.backward()
    jg = vjp(cot if isinstance(want, (list, tuple)) else cot[0])
    for i in diff:
        _close(tin[i].grad.asnumpy(), onp.asarray(jg[i]), "gradient %d" % i)


RNG = onp.random.RandomState(0)
X4 = RNG.randn(2, 3, 6, 7).astype("float32")
Y4 = RNG.randn(2, 3, 6, 7).astype("float32")

CASES = {
    "L2Normalization_instance": (lambda m: lambda x: m.L2Normalization(x),
                                 [X4], (0,)),
    "L2Normalization_channel": (lambda m: lambda x: m.L2Normalization(
        x, mode="channel"), [X4], (0,)),
    "L2Normalization_spatial": (lambda m: lambda x: m.L2Normalization(
        x, eps=1e-3, mode="spatial"), [X4], (0,)),
    "LRN": (lambda m: lambda x: m.LRN(x, alpha=1e-2, nsize=3), [X4], (0,)),
    "UpSampling": (lambda m: lambda x: m.UpSampling(x, scale=2), [X4], (0,)),
    "BilinearResize2D_up": (lambda m: lambda x: m.BilinearResize2D(
        x, height=9, width=14), [X4], (0,)),
    "Correlation": (lambda m: lambda a, b: m.Correlation(
        a, b, kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
        [X4, Y4], (0, 1)),
    "Correlation_abs": (lambda m: lambda a, b: m.Correlation(
        a, b, max_displacement=1, stride1=2, is_multiply=False),
        [X4, Y4], (0, 1)),
    "Crop": (lambda m: lambda x: m.Crop(x, offset=(1, 2), h_w=(3, 4)),
             [X4], (0,)),
    "Crop_like": (lambda m: lambda x, y: m.Crop(x, y, center_crop=True),
                  [X4, X4[:, :, :4, :3]], (0,)),
    "im2col": (lambda m: lambda x: m.im2col(x, (3, 2), stride=(2, 1),
                                            dilate=(1, 2), pad=(1, 1)),
               [X4], (0,)),
    "col2im": (lambda m: lambda c: m.col2im(c, (6, 7), (3, 2), stride=(2, 1),
                                            dilate=(1, 2), pad=(1, 1)),
               [RNG.randn(2, 18, 21).astype("float32")], (0,)),
    "im2col_1d": (lambda m: lambda x: m.im2col(x, (3,), stride=(2,),
                                               pad=(1,)),
                  [X4[:, :, 0]], (0,)),
    "softmin": (lambda m: lambda x: m.softmin(x, axis=1), [X4], (0,)),
    "SoftmaxActivation": (lambda m: lambda x: m.SoftmaxActivation(
        x, mode="channel"), [X4], (0,)),
    "softmax_cross_entropy": (lambda m: lambda x, y: m.softmax_cross_entropy(
        x, y), [X4[:, 0, 0], onp.array([2, 5], "float32")], (0,)),
    "argmax_channel": (lambda m: lambda x: m.argmax_channel(x), [X4], ()),
    "unravel_index": (lambda m: lambda x: m.unravel_index(x, shape=(3, 4, 5)),
                      [onp.array([0, 7, 59, 23], "float32")], ()),
    "ravel_multi_index": (lambda m: lambda x: m.ravel_multi_index(
        x, shape=(3, 4)), [onp.array([[0, 2, 5], [3, 1, -1]], "float32")],
        ()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nd_operator(name):
    make, arrays, diff = CASES[name]
    _check(make(jnd), make(tnd), arrays, diff)


def test_bilinear_resize_down():
    """A downscale filters with JAX's antialiasing triangle kernel (torch's
    antialiased bilinear): within 2e-3 of the largest value."""
    want = jnd.BilinearResize2D(jnd.array(X4), height=3, width=4).asnumpy()
    got = tnd.BilinearResize2D(_tarr(X4), height=3, width=4).asnumpy()
    _close(got, want, "downscale", 2e-3)


def test_meshgrid_histogram_onehot():
    a, b = onp.arange(3, dtype="float32"), onp.arange(4, dtype="float32")
    for idx in ("xy", "ij"):
        for g, w in zip(tnd.meshgrid(_tarr(a), _tarr(b), indexing=idx),
                        jnd.meshgrid(jnd.array(a), jnd.array(b),
                                     indexing=idx)):
            onp.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    x = RNG.randn(50).astype("float32")
    for kw in (dict(bins=7), dict(bins=5, range=(-1.0, 1.0))):
        (gc, ge), (wc, we) = tnd.histogram(_tarr(x), **kw), \
            jnd.histogram(jnd.array(x), **kw)
        onp.testing.assert_array_equal(gc.asnumpy(), wc.asnumpy())
        _close(ge.asnumpy(), we.asnumpy(), "edges")
    edges = onp.array([-2, -0.5, 0, 3], "float32")
    gc, _ = tnd.histogram(_tarr(x), bins=_tarr(edges))
    wc, _ = jnd.histogram(jnd.array(x), bins=jnd.array(edges))
    onp.testing.assert_array_equal(gc.asnumpy(), wc.asnumpy())
    ids = onp.array([1, 0, 3], "float32")
    out_t = tnd.zeros((3, 4), ctx=mxt.cpu())
    ptr = out_t._data.data_ptr()
    tnd.onehot_encode(_tarr(ids), out_t)
    want = jnd.onehot_encode(jnd.array(ids), jnd.zeros((3, 4)))
    onp.testing.assert_array_equal(out_t.asnumpy(), want.asnumpy())
    assert out_t._data.data_ptr() == ptr


# ------------------------------------------------------------ loss layers

def _softmax_output_grads(pkg, x, lbl, kw):
    nd = jnd if pkg is mx else tnd
    ag = mx.autograd if pkg is mx else tautograd
    xa = jnd.array(x) if pkg is mx else _tarr(x)
    xa.attach_grad()
    with ag.record():
        out = nd.SoftmaxOutput(xa, jnd.array(lbl) if pkg is mx
                               else _tarr(lbl), **kw)
    out.backward(jnd.array(onp.full(out.shape, 3.0, "float32"))
                 if pkg is mx else _tarr(onp.full(out.shape, 3.0,
                                                  "float32")))
    return out.asnumpy(), xa.grad.asnumpy()


@pytest.mark.parametrize("kw", [
    {}, dict(grad_scale=0.5), dict(use_ignore=True, ignore_label=2),
    dict(use_ignore=True, ignore_label=2, normalization="valid"),
    dict(normalization="batch", grad_scale=2.0)])
def test_softmax_output_loss_layer_backward(kw):
    x = RNG.randn(5, 4).astype("float32")
    lbl = onp.array([0, 2, 3, 2, 1], "float32")
    (jo, jg), (to, tg) = (_softmax_output_grads(p, x, lbl, kw)
                          for p in (mx, mxt))
    _close(to, jo, "softmax")
    _close(tg, jg, "loss-layer gradient")


def test_softmax_output_departs_on_mxnets_keywords():
    """multi_output: softmax over axis 1; preserve_shape: the last axis;
    default over all but the first; smooth_alpha spreads alpha over the
    other classes; out_grad multiplies the head gradient; "valid" counts
    the labels that are not ignore_label even without use_ignore."""
    x = RNG.randn(2, 3, 4).astype("float32")
    lbl = onp.array([[0, 2, 1, 1], [2, 2, 0, 1]], "float32")
    t = torch.tensor(x)
    out, g = _softmax_output_grads(mxt, x, lbl, dict(multi_output=True))
    p = torch.softmax(t, 1)
    hot = torch.nn.functional.one_hot(torch.tensor(lbl).long(), 3) \
        .permute(0, 2, 1).float()
    _close(out, p.numpy(), "multi_output")
    _close(g, (p - hot).numpy(), "multi_output gradient")
    out, _ = _softmax_output_grads(mxt, x, lbl[:, :3], dict(
        preserve_shape=True))
    _close(out, torch.softmax(t, -1).numpy(), "preserve_shape")
    out, _ = _softmax_output_grads(mxt, x, lbl[:, 0], {})
    _close(out, torch.softmax(t.reshape(2, -1), 1).reshape(2, 3, 4).numpy(),
           "flattened")
    x2 = RNG.randn(3, 4).astype("float32")
    l2 = onp.array([0, 3, 1], "float32")
    p2 = torch.softmax(torch.tensor(x2), 1)
    hot2 = torch.nn.functional.one_hot(torch.tensor(l2).long(), 4).float()
    _, g = _softmax_output_grads(mxt, x2, l2, dict(smooth_alpha=0.3))
    _close(g, (p2 - (0.7 * hot2 + 0.1 * (1 - hot2))).numpy(), "smooth")
    _, g = _softmax_output_grads(mxt, x2, l2, dict(out_grad=True))
    _close(g, 3.0 * (p2 - hot2).numpy(), "out_grad")
    _, g = _softmax_output_grads(mxt, x2, l2, dict(normalization="valid",
                                                   ignore_label=3))
    _close(g, ((p2 - hot2) / 2).numpy(), "valid without use_ignore")


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "LogisticRegressionOutput",
                                "MAERegressionOutput"])
def test_regression_outputs(op):
    x = RNG.randn(6, 1).astype("float32")
    y = RNG.randn(6).astype("float32")
    res = []
    for pkg, nd, ag, arr in ((mx, jnd, mx.autograd, jnd.array),
                             (mxt, tnd, tautograd, _tarr)):
        xa = arr(x)
        xa.attach_grad()
        with ag.record():
            out = getattr(nd, op)(xa, arr(y), grad_scale=0.7)
        out.backward()
        res.append((out.asnumpy(), xa.grad.asnumpy()))
    _close(res[1][0], res[0][0], op)
    _close(res[1][1], res[0][1], op + " gradient")


def test_regression_output_departs_by_dividing_by_num_output():
    x = RNG.randn(4, 3).astype("float32")
    y = RNG.randn(4, 3).astype("float32")
    xa = _tarr(x)
    xa.attach_grad()
    with tautograd.record():
        out = tnd.LinearRegressionOutput(xa, _tarr(y), grad_scale=0.6)
    out.backward()
    _close(xa.grad.asnumpy(), 0.6 / 3 * (x - y), "1 / num_output")


# ------------------------------------------------------------- sampling

def test_multinomial_frequencies_and_log_probabilities():
    p = onp.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], "float32")
    mxt.nd.random.seed(3)
    draws, logp = tnd.random.multinomial(_tarr(p), shape=20000,
                                         get_prob=True)
    d = draws.asnumpy()
    assert d.shape == (2, 20000) and d.dtype == onp.int32
    for r in range(2):
        freq = onp.bincount(d[r], minlength=3) / d.shape[1]
        assert onp.abs(freq - p[r]).max() < 0.02, (r, freq)
    _close(logp.asnumpy(), onp.log(p[onp.arange(2)[:, None], d]), "log p")
    jshape = jnd.random.multinomial(jnd.array(p[0])).shape
    assert tnd.random.multinomial(_tarr(p[0])).shape == jshape == ()
    assert tnd.multinomial(_tarr(p)).shape == \
        jnd.multinomial(jnd.array(p)).shape == (2, 1)
    s, lp = tnd.multinomial(_tarr(p[0]), shape=5, get_prob=True,
                            dtype="float32")
    assert s.shape == lp.shape == (5,) and s.dtype == onp.float32


@pytest.mark.parametrize("fn,kw,mean", [
    ("negative_binomial", dict(k=3, p=0.4), 3 * 0.6 / 0.4),
    ("generalized_negative_binomial", dict(mu=2.5, alpha=0.5), 2.5)])
def test_negative_binomials_mean(fn, kw, mean):
    mxt.nd.random.seed(5)
    x = getattr(tnd.random, fn)(shape=(20000,), ctx=mxt.cpu(), **kw)
    assert x.shape == (20000,)
    a = x.asnumpy()
    assert (a >= 0).all() and (a == onp.round(a)).all()
    assert abs(a.mean() - mean) < 0.05 * mean


# ---------------------------------------------------------------- interop

def test_numpy_and_dlpack_interop_and_load_frombuffer(tmp_path):
    a = onp.arange(6, dtype="float32").reshape(2, 3)
    x = tnd.from_numpy(a)
    a[0, 0] = 7.0
    assert x.asnumpy()[0, 0] == 7.0          # zero copy
    assert tnd.from_numpy(onp.ones(2)).dtype == onp.float32
    y = tnd.from_dlpack(tnd.to_dlpack_for_read(x))
    _close(y.asnumpy(), a)
    w = tnd.from_dlpack(tnd.to_dlpack_for_write(x))
    w[:] = 1.0
    assert (x.asnumpy() == 1.0).all()
    f = str(tmp_path / "a.params")
    mx.nd.save(f, {"w": mx.nd.array(a), "b": mx.nd.ones((2,))})
    with open(f, "rb") as fh:
        buf = fh.read()
    got = tnd.load_frombuffer(buf)
    assert set(got) == {"w", "b"}
    _close(got["w"].asnumpy(), a)


def test_custom_and_imdecode_raise_naming_their_items():
    with pytest.raises(NotImplementedError, match="item 6"):
        tnd.Custom(_tarr(X4), op_type="x")
    # imdecode came with image.py: the reference's pixels
    png = mx.recordio.pack_img(mx.recordio.IRHeader(0, 0.0, 0, 0),
                               (X4[0].transpose(1, 2, 0) * 40 + 100)
                               .astype("uint8"), img_fmt=".png")[24:]
    assert onp.array_equal(tnd.imdecode(png).asnumpy(),
                           jnd.imdecode(png).asnumpy())


def test_aliases():
    assert tnd.BatchNorm_v1 is tnd.CuDNNBatchNorm is tnd.BatchNorm
    assert tnd.Convolution_v1 is tnd.Convolution
    assert tnd.Pooling_v1 is tnd.Pooling
    assert tnd.ctc_loss is tnd.CTCLoss
    x = _tarr(X4)
    assert tnd.shuffle(x).shape == x.shape


# ----------------------------------------------------------------- sparse

def test_sparse_storage_round_trips_and_ops():
    rng = onp.random.RandomState(4)
    dense = rng.randn(6, 4).astype("float32")
    dense[[1, 4]] = 0
    dense[dense < -0.8] = 0
    t, j = _tarr(dense), jnd.array(dense)
    for stype in ("row_sparse", "csr"):
        ts, js = tnd.cast_storage(t, stype), jnd.cast_storage(j, stype)
        assert ts.stype == js.stype == stype and ts.shape == js.shape
        for part in ("data", "indices") + (("indptr",) if stype == "csr"
                                           else ()):
            onp.testing.assert_array_equal(getattr(ts, part).asnumpy(),
                                           getattr(js, part).asnumpy())
        onp.testing.assert_array_equal(ts.tostype("default").asnumpy(),
                                       dense)
        onp.testing.assert_array_equal(ts.asnumpy(), dense)
    rs = t.tostype("row_sparse")
    kept = rs.retain(_tarr(onp.array([0, 2, 4, 5], "int32")))
    want = jnd.sparse.retain(j.tostype("row_sparse"),
                             jnd.array(onp.array([0, 2, 4, 5], "int32")))
    onp.testing.assert_array_equal(kept.asnumpy(), want.asnumpy())
    onp.testing.assert_array_equal((rs + rs).asnumpy(), 2 * dense)
    _close((rs * 3.0).asnumpy(), 3 * dense)
    csr = t.tostype("csr")
    rhs = rng.randn(4, 3).astype("float32")
    rhs_t = rng.randn(6, 3).astype("float32")
    for tr, r in ((False, rhs), (True, rhs_t)):
        got = tnd.sparse.dot(csr, _tarr(r), transpose_a=tr).asnumpy()
        want = jnd.sparse.dot(j.tostype("csr"), jnd.array(r),
                              transpose_a=tr).asnumpy()
        _close(got, want, "sparse dot")
    onp.testing.assert_array_equal(csr[2].asnumpy(), dense[2])
    for op in ("add", "subtract", "multiply", "divide"):
        got = getattr(tnd.sparse, op)(csr, _tarr(dense + 2)).asnumpy()
        want = getattr(jnd.sparse, op)(j.tostype("csr"),
                                       jnd.array(dense + 2)).asnumpy()
        _close(got, want, op)
    made = tnd.sparse.csr_matrix(
        (_tarr(onp.array([1.0, 2.0], "float32")),
         onp.array([0, 2], "int32"), onp.array([0, 1, 2], "int32")),
        shape=(2, 3))
    onp.testing.assert_array_equal(made.asnumpy(), [[1, 0, 0], [0, 0, 2]])
    z = tnd.sparse.zeros("row_sparse", (3, 2), ctx=mxt.cpu())
    onp.testing.assert_array_equal(z.asnumpy(), onp.zeros((3, 2)))
    tok = onp.array([[1, 3], [3, 0]], "int32")
    og = rng.randn(2, 2, 5).astype("float32")
    g = tnd.sparse.embedding_backward(_tarr(tok), _tarr(og), 6)
    w = jnd.sparse.embedding_backward(jnd.array(tok), jnd.array(og), 6)
    _close(g.asnumpy(), w.asnumpy(), "embedding backward")
    x = mxt.test_utils.rand_ndarray((5, 3), "csr", density=0.4,
                                    ctx=mxt.cpu())
    assert x.stype == "csr"
    v = _tarr(dense)
    v.attach_grad(stype="row_sparse")
    assert v.grad.stype == "default"


# ---------------------------------------------------------------- surface

NAMESPACES = ["", "random", "linalg", "sparse", "contrib"]


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))}


@pytest.mark.parametrize("ns", NAMESPACES)
def test_namespace_covers_the_references_names(ns):
    """Every public name of the JAX package's namespace (its imported
    modules and helpers such as ``jnp`` aside) exists in the port's."""
    jm = getattr(jnd, ns) if ns else jnd
    tm = getattr(tnd, ns) if ns else tnd
    names = set(getattr(jm, "__all__", [])) | {
        n for n in _public(jm) if callable(getattr(jm, n))
        and getattr(getattr(jm, n), "__module__", "").startswith(
            "incubator_mxnet_tpu")
        and not (ns and inspect.isclass(getattr(jm, n))
                 and getattr(jm, n).__module__ != jm.__name__)}
    missing = sorted(n for n in names if not hasattr(tm, n))
    assert missing == []


NEW_OPS = [
    ("", n) for n in (
        "SoftmaxOutput", "LinearRegressionOutput", "LogisticRegressionOutput",
        "MAERegressionOutput", "L2Normalization", "LRN", "UpSampling",
        "BilinearResize2D", "Correlation", "Crop", "im2col", "col2im",
        "softmin", "SoftmaxActivation", "softmax_cross_entropy",
        "argmax_channel", "meshgrid", "histogram", "unravel_index",
        "ravel_multi_index", "onehot_encode", "shuffle", "multinomial",
        "from_numpy", "from_dlpack", "to_dlpack_for_read",
        "to_dlpack_for_write", "load_frombuffer", "cast_storage", "CTCLoss",
        "Custom", "imdecode")] + [
    ("", n) for n in tnd.optimizer_ops.__all__] + [
    ("linalg", n) for n in tnd.linalg.__all__] + [
    ("sparse", n) for n in ("row_sparse_array", "csr_matrix", "array",
                            "zeros", "dot", "retain", "embedding_backward")
] + [("random", n) for n in ("multinomial", "negative_binomial",
                             "generalized_negative_binomial")] + [
    ("contrib", n) for n in (
        "foreach", "while_loop", "cond", "hawkesll", "getnnz", "edge_id",
        "dgl_csr_neighbor_uniform_sample",
        "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
        "dgl_graph_compact", "dgl_adjacency")]


@pytest.mark.parametrize("ns,name", NEW_OPS)
def test_new_op_swallows_no_reference_keyword(ns, name):
    """Each keyword the reference's operator names is one the port's names
    too: none falls into a ``**kw``."""
    jf = getattr(getattr(jnd, ns) if ns else jnd, name)
    tf = getattr(getattr(tnd, ns) if ns else tnd, name)
    named = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)
    want = [p for p, v in inspect.signature(jf).parameters.items()
            if v.kind in named]
    got = inspect.signature(tf).parameters
    assert [p for p in want if p not in got or got[p].kind not in named] \
        == []
