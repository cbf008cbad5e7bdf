"""The port's ``nd`` operators against the JAX package's, on the CPU.

Each test feeds the same numpy inputs, made from a seed, to
``incubator_mxnet_tpu.nd`` and to ``incubator_mxnet_tpu_torch.nd``:

- ``Embedding``: ids in range, wrapped negatives and ids out of range, as
  ``jnp.take`` (mode "fill") takes them: exact, NaN in the same places,
  fp32 and bf16; the gradient into the weight against ``jax.vjp`` of the
  reference within 1e-6 (fp32 sums of the same terms, maybe in another
  order);
- ``softmax(length=)``: within 1e-6 in fp32;
- ``LeakyReLU``: GELU within 1e-6; every other act_type, whose keywords
  (``slope``...) the reference honours, raises.

Keywords of the other audited operators that the reference ignores
(``LayerNorm``'s ``output_mean_var``, ``Dropout``'s ``mode``,
``log_softmax``'s ``length``) stay ignored; the rest work or raise.

The ``NDArray`` class, exact against the JAX package's: MXNet's reshape
codes, a slice being a copy (a write into it never shows in the parent),
the dtype rules of ``nd.array`` and of mixed-type arithmetic, the basic
methods, ``take``/``gather_nd``/``batch_take``/``one_hot``/``pick``/
``scatter_nd`` on ids out of range, and the default context raising
without CUDA. The operator families are swept in
``test_torch_ndarray_sweep.py``.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray.ndarray import NDArray

from incubator_mxnet_tpu_torch import nd as tnd

TOL = dict(atol=1e-6, rtol=1e-6)
V, U = 11, 5
# in range, wrapped negatives ([-V, 0)) and out of range on both sides
IDS = onp.array([[0, 3, V - 1, -1, -V, V],
                 [V + 7, -V - 1, 2, 2, -3, 10 ** 6]], dtype="int32")


def _weight(seed=0):
    return onp.random.RandomState(seed).randn(V, U).astype("float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_matches_jnp_take(dtype):
    w = _weight()
    ref = jnd.Embedding(jnd.array(IDS, dtype="int32"),
                        jnd.array(w).astype(dtype)).asnumpy()
    out = tnd.Embedding(torch.from_numpy(IDS),
                        torch.from_numpy(w).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 6, U)
    got = out.float().numpy()
    onp.testing.assert_array_equal(onp.isnan(got), onp.isnan(
        ref.astype("float32")))
    onp.testing.assert_array_equal(got, ref.astype("float32"))
    assert onp.isnan(got).all(axis=-1).sum() == 4


def test_embedding_fills_an_integer_weight_as_jnp_take():
    w = onp.arange(V * U, dtype="int32").reshape(V, U)
    ref = jnd.Embedding(jnd.array(IDS, dtype="int32"),
                        jnd.array(w, dtype="int32")).asnumpy()
    out = tnd.Embedding(torch.from_numpy(IDS), torch.from_numpy(w))
    assert out.dtype == torch.int32
    onp.testing.assert_array_equal(out.numpy(), ref)


def test_embedding_gradient_matches_jax_vjp():
    w = _weight(1)
    cot = onp.random.RandomState(2).randn(*IDS.shape, U).astype("float32")
    _, vjp = jax.vjp(lambda wj: jnd.Embedding(
        jnd.array(IDS, dtype="int32"), NDArray(wj))._data, jnp.asarray(w))
    ref = onp.asarray(vjp(jnp.asarray(cot))[0])
    wt = torch.from_numpy(w).requires_grad_()
    tnd.Embedding(torch.from_numpy(IDS), wt).backward(torch.from_numpy(cot))
    # the ids out of range read rows 0 and V - 1 (clamped) and must add
    # nothing to them
    onp.testing.assert_allclose(wt.grad.numpy(), ref, **TOL)


def test_embedding_in_range_is_the_gather_it_was():
    """Ids in range give bit for bit the rows and gradient of a plain
    F.embedding, the route the port took before ids out of range were
    taken as the reference takes them."""
    ids = torch.from_numpy(onp.random.RandomState(3).randint(0, V, (4, 9)))
    w1 = torch.from_numpy(_weight(4)).requires_grad_()
    w2 = w1.detach().clone().requires_grad_()
    out1, out2 = tnd.Embedding(ids, w1), F.embedding(ids, w2)
    assert torch.equal(out1, out2)
    cot = torch.from_numpy(
        onp.random.RandomState(5).randn(4, 9, U).astype("float32"))
    out1.backward(cot)
    out2.backward(cot)
    assert torch.equal(w1.grad, w2.grad)


def _lengths(shape, hi, seed):
    return onp.random.RandomState(seed).randint(0, hi + 1, shape) \
        .astype("int32")


@pytest.mark.parametrize("axis,temperature", [(-1, None), (1, None),
                                              (-1, 2.5), (1, 0.5)])
def test_softmax_length_matches_the_reference(axis, temperature):
    """2-D data, so axis 1 is the last axis, where the reference builds its
    mask; lengths from 0 (the whole row masked: 0) to the full row."""
    x = onp.random.RandomState(6).randn(6, 7).astype("float32")
    ln = onp.array([0, 1, 3, 7, 5, 2], dtype="int32")
    ref = jnd.softmax(jnd.array(x), axis=axis, temperature=temperature,
                      length=jnd.array(ln, dtype="int32")).asnumpy()
    out = tnd.softmax(torch.from_numpy(x), axis=axis,
                      temperature=temperature, length=torch.from_numpy(ln))
    onp.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (out.numpy()[onp.arange(7) >= ln[:, None]] == 0).all()


def test_softmax_length_on_an_inner_axis():
    """length masks along ``axis`` (shape (2, 3): the data's without axis
    1). The reference builds its mask along the last axis whatever
    ``axis`` is, so here the oracle is a loop over rows in numpy."""
    x = onp.random.RandomState(7).randn(2, 4, 3).astype("float32")
    ln = _lengths((2, 3), 4, 8)
    out = tnd.softmax(torch.from_numpy(x), axis=1, temperature=2.0,
                      length=torch.from_numpy(ln)).numpy()
    want = onp.zeros_like(x)
    for b in range(2):
        for j in range(3):
            k = ln[b, j]
            e = onp.exp(x[b, :k, j] / 2.0 - (x[b, :k, j] / 2.0).max(initial=0))
            want[b, :k, j] = e / e.sum() if k else e
    onp.testing.assert_allclose(out, want, **TOL)


def test_softmax_length_gradient_matches_the_reference():
    x = onp.random.RandomState(9).randn(4, 6).astype("float32")
    ln = onp.array([6, 2, 0, 4], dtype="int32")
    cot = onp.random.RandomState(10).randn(4, 6).astype("float32")
    _, vjp = jax.vjp(lambda xj: jnd.softmax(
        NDArray(xj), length=jnd.array(ln, dtype="int32"))._data,
        jnp.asarray(x))
    ref = onp.asarray(vjp(jnp.asarray(cot))[0])
    xt = torch.from_numpy(x).requires_grad_()
    tnd.softmax(xt, length=torch.from_numpy(ln)).backward(
        torch.from_numpy(cot))
    onp.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)


@pytest.mark.parametrize("kw", [{}, dict(slope=0.1, gamma=None)])
def test_leaky_relu_gelu_matches_the_reference(kw):
    """GELU ignores the other act_types' keywords, in both packages."""
    x = onp.random.RandomState(11).randn(3, 4, 5).astype("float32")
    ref = jnd.LeakyReLU(jnd.array(x), act_type="gelu", **kw).asnumpy()
    out = tnd.LeakyReLU(torch.from_numpy(x), act_type="gelu", **kw)
    onp.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("act_type,kw", [
    ("leaky", dict(slope=0.1)), ("elu", dict(slope=0.7)), ("selu", {}),
    ("prelu", dict(gamma=[0.3, -0.2, 0.6])),
    ("rrelu", dict(lower_bound=0.2, upper_bound=0.5))])
def test_leaky_relu_raises_for_an_act_type_it_does_not_port(act_type, kw):
    """The reference honours these act_types and their keywords, and so
    does the port now (it raised for them before they were ported): equal
    to the JAX package's within TOL, never GELU, ``slope`` and the bounds
    taken; an act_type neither package has still raises."""
    x = onp.random.RandomState(13).randn(2, 3).astype("float32")
    gamma = kw.pop("gamma", None)
    ref = jnd.LeakyReLU(jnd.array(x), None if gamma is None else
                        jnd.array(gamma), act_type=act_type, **kw).asnumpy()
    out = tnd.LeakyReLU(torch.from_numpy(x), None if gamma is None else
                        torch.tensor(gamma), act_type=act_type, **kw)
    onp.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert not onp.allclose(ref, jnd.LeakyReLU(
        jnd.array(x), act_type="gelu").asnumpy())
    with pytest.raises(ValueError, match="unsupported act_type"):
        tnd.LeakyReLU(torch.from_numpy(x), act_type=act_type + "x")


@pytest.mark.parametrize("op", [
    lambda m, x: m.LeakyReLU(x, act_type="swish"),
    lambda m, x: m.Activation(x, act_type="gelu")])
def test_an_operator_raises_where_the_reference_raises(op):
    x = onp.ones((2, 3), "float32")
    with pytest.raises((ValueError, KeyError)):
        op(jnd, jnd.array(x))
    with pytest.raises(ValueError, match="unsupported act_type"):
        op(tnd, torch.from_numpy(x))


@pytest.mark.parametrize("name,kw", [
    ("layer_norm", dict(output_mean_var=True)),
    ("log_softmax", dict(length=[1, 2])),
    ("dropout", dict(mode="always"))])
def test_keywords_the_reference_ignores_are_ignored(name, kw):
    x = onp.random.RandomState(12).randn(2, 3).astype("float32")
    g, b = onp.full(3, 1.5, "float32"), onp.full(3, 0.25, "float32")
    if name == "layer_norm":
        ref = jnd.LayerNorm(jnd.array(x), jnd.array(g), jnd.array(b), **kw)
        out = tnd.LayerNorm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b), **kw)
    elif name == "log_softmax":
        ref = jnd.log_softmax(jnd.array(x), **kw)
        out = tnd.log_softmax(torch.from_numpy(x), **kw)
    else:   # outside training both are the identity, whatever the mode
        ref = jnd.Dropout(jnd.array(x), 0.5, **kw)
        out = tnd.Dropout(torch.from_numpy(x), 0.5, **kw)
    onp.testing.assert_allclose(out.numpy(), ref.asnumpy(), **TOL)


def test_dropout_takes_the_references_positional_order():
    x = torch.ones(2, 3)
    from incubator_mxnet_tpu_torch import autograd
    with autograd.record():
        out = tnd.Dropout(x, 0.5, "training", (1,),
                          generator=torch.Generator().manual_seed(0))
    # axes=(1,) shares one mask value along axis 1
    assert (out == out[:, :1]).all()


@pytest.mark.cuda
def test_embedding_out_of_range_on_the_card_leaves_the_context_usable():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w = torch.from_numpy(_weight())
    want = tnd.Embedding(torch.from_numpy(IDS), w)
    got = tnd.Embedding(torch.from_numpy(IDS).cuda(), w.cuda())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, equal_nan=True, atol=0,
                               rtol=0)
    assert float((torch.ones(3, device="cuda") * 2).sum()) == 6.0


# ---------------------------------------------------------------- NDArray
# The NDArray class against the JAX package's: the same numpy inputs
# through both, results exact (no arithmetic beyond the JAX package's).


def _t(x, **kw):
    from incubator_mxnet_tpu_torch import cpu
    return tnd.array(x, ctx=cpu(), **kw)


@pytest.mark.parametrize("shape,code", [
    ((2, 3, 4), (0, -1)), ((2, 3, 4), (-2,)), ((2, 3, 4), (-3, 4)),
    ((2, 3, 4), (2, -4, 3, 1, 4)), ((2, 3, 4), (0, -4, -1, 1, 0)),
    ((6, 4), (-4, 2, 3, -2)), ((2, 3, 4), (4, 0, -1))])
def test_reshape_codes_match_the_reference(shape, code):
    x = onp.arange(int(onp.prod(shape)), dtype="float32").reshape(shape)
    ref = jnd.array(x).reshape(code)
    got = _t(x).reshape(code)
    assert got.shape == ref.shape
    onp.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    assert tnd.reshape(_t(x), shape=code).shape == ref.shape


def test_a_write_into_a_slice_does_not_show_in_the_parent():
    x = _t(onp.arange(6, dtype="float32").reshape(2, 3))
    row = x[1]
    row[:] = 0
    part = x[:, 1:]
    part += 100
    onp.testing.assert_array_equal(x.asnumpy(), [[0, 1, 2], [3, 4, 5]])
    x[0, 2] = -1
    onp.testing.assert_array_equal(row.asnumpy(), [0, 0, 0])
    assert x.asnumpy()[0, 2] == -1
    b = tnd.broadcast_to(_t([[1.0, 2.0]]), (3, 2))
    b += 1                            # a broadcast view: rebinds, no error
    onp.testing.assert_array_equal(b.asnumpy(), [[2, 3]] * 3)
    y = x.copy()
    y[:] = 7
    assert x.asnumpy()[1, 1] == 4
    n = x.asnumpy()
    n[:] = 9
    assert x.asnumpy()[1, 1] == 4


_DERIVED = {
    "reshape": lambda nd, x: x.reshape(-1),
    "reshape_code": lambda nd, x: nd.reshape(x, shape=(0, -1)),
    "transpose": lambda nd, x: x.T,
    "expand_dims": lambda nd, x: x.expand_dims(0),
    "squeeze": lambda nd, x: x.expand_dims(1).squeeze(1),
    "broadcast_to": lambda nd, x: nd.broadcast_to(x.expand_dims(0),
                                                  (2, 2, 3)),
    "flatten": lambda nd, x: nd.flatten(x),
    "astype": lambda nd, x: x.astype("float32"),
    "cast": lambda nd, x: nd.cast(x, "float32"),
    "make_loss": lambda nd, x: nd.make_loss(x, grad_scale=2.0),
    "identity": lambda nd, x: nd.identity(x),
    "BlockGrad": lambda nd, x: nd.BlockGrad(x),
    "detach": lambda nd, x: x.detach(),
    "add_n": lambda nd, x: nd.add_n(x),
    "split": lambda nd, x: nd.split(x, 3, axis=1)[1],
    "slice_axis": lambda nd, x: nd.slice_axis(x, 1, 0, 2),
}


@pytest.mark.parametrize("name", sorted(_DERIVED))
def test_a_derived_array_does_not_share_memory_with_its_source(name):
    """As JAX arrays, every NDArray is an array of its own: a write into
    the source does not show in an array derived from it, nor the other
    way round (torch returns views or the input itself for these)."""
    x0 = onp.arange(6, dtype="float32").reshape(2, 3)
    res = []
    for nd, x in ((jnd, jnd.array(x0)), (tnd, _t(x0))):
        y = _DERIVED[name](nd, x)
        before = y.asnumpy()
        x += 1
        x[0, 0] = -5.0
        after_source_write = y.asnumpy()
        y[:] = 0
        res.append((before, after_source_write, x.asnumpy()))
    (jb, ja, jx), (tb, ta, tx) = res
    onp.testing.assert_array_equal(tb, jb)
    onp.testing.assert_array_equal(ta, jb)
    onp.testing.assert_array_equal(ta, ja)
    onp.testing.assert_array_equal(tx, jx)


def test_make_loss_of_scale_one_is_its_input_as_in_the_reference():
    j = jnd.array(onp.ones((2, 3), "float32"))
    assert jnd.make_loss(j) is j
    x = _t(onp.ones((2, 3), "float32"))
    assert tnd.make_loss(x) is x
    t = torch.ones(3)
    assert tnd.make_loss(t) is t
    onp.testing.assert_array_equal(tnd.make_loss(x, grad_scale=0.5)
                                   .asnumpy(), onp.full((2, 3), 0.5))


def test_dtype_rules_match_the_reference():
    cases = [[1, 2, 3], [1.5, 2.5], onp.arange(3, dtype="float64"),
             onp.arange(3, dtype="int64"), onp.arange(3, dtype="int32"),
             onp.arange(3, dtype="uint8"), onp.array([True, False]), 2.5]
    for c in cases:
        ref, got = jnd.array(c), _t(c)
        assert got.dtype == ref.dtype, (c, got.dtype, ref.dtype)
        assert got.dtype == onp.dtype(str(ref.dtype))
    b = _t([1.0, 2.0]).astype("bfloat16")
    assert b.dtype == "bfloat16" and b.dtype == jnd.array([1.0]).astype(
        "bfloat16").dtype.name
    assert b.asnumpy().dtype == onp.float32            # no ml_dtypes needed
    i = _t(onp.arange(3, dtype="int32"))
    f16 = _t([1.0]).astype("float16")
    for got, ref in ((i + 2.5, jnd.array(onp.arange(3, dtype="int32")) + 2.5),
                     (i * 2, jnd.array(onp.arange(3, dtype="int32")) * 2),
                     (i / i, jnd.array(onp.arange(3, dtype="int32"))
                      / jnd.array(onp.arange(3, dtype="int32"))),
                     (b + _t([1.0]), jnd.array([1.0, 2.0]).astype("bfloat16")
                      + jnd.array([1.0])),
                     (b + f16, jnd.array([1.0, 2.0]).astype("bfloat16")
                      + jnd.array([1.0]).astype("float16")),
                     (i == 1, jnd.array(onp.arange(3, dtype="int32")) == 1),
                     (tnd.greater(i, 1.5), jnd.greater(
                         jnd.array(onp.arange(3, dtype="int32")), 1.5))):
        assert str(got.dtype) == str(ref.dtype), (got.dtype, ref.dtype)
        onp.testing.assert_array_equal(got.asnumpy(),
                                       ref.asnumpy().astype("float32")
                                       if str(ref.dtype) == "bfloat16"
                                       else ref.asnumpy())


def test_basics_match_the_reference():
    x = onp.arange(6, dtype="float32").reshape(2, 3)
    ref, got = jnd.array(x), _t(x)
    assert (got.shape, got.size, got.ndim, len(got)) == \
        (ref.shape, ref.size, ref.ndim, len(ref))
    assert got.stype == "default" and hash(got) == id(got)
    assert float(got[1, 2]) == float(ref[1, 2]) == 5.0
    assert got[1, 2].asscalar() == 5.0 and got.sum().item() == 15.0
    onp.testing.assert_array_equal(got.T.asnumpy(), ref.T.asnumpy())
    onp.testing.assert_array_equal((-got).abs().asnumpy(), x)
    onp.testing.assert_array_equal((2 - got).asnumpy(), (2 - ref).asnumpy())
    onp.testing.assert_array_equal((x + got).asnumpy(), 2 * x)
    onp.testing.assert_array_equal(got.sum(axis=1, keepdims=True).asnumpy(),
                                   ref.sum(axis=1, keepdims=True).asnumpy())
    onp.testing.assert_array_equal(got.argmax(axis=1).asnumpy(),
                                   ref.argmax(axis=1).asnumpy())
    assert got.argmax(axis=1).dtype == onp.float32
    onp.testing.assert_array_equal(
        got[_t([1.0, 0.0])].asnumpy(), x[[1, 0]])
    from incubator_mxnet_tpu_torch import cpu
    assert got.context == cpu() and got.as_in_context(cpu()) is got
    c = got.copyto(cpu())
    c[:] = 0
    assert got.asnumpy().sum() == 15.0
    got.copyto(c)
    onp.testing.assert_array_equal(c.asnumpy(), x)
    import pickle
    back = pickle.loads(pickle.dumps(got.astype("bfloat16")))
    assert back.dtype == "bfloat16"
    onp.testing.assert_array_equal(back.asnumpy(), x)
    assert "NDArray 2x3 @cpu(0)" in repr(got)


def test_ops_take_tensors_and_give_tensors_back():
    """Tensors pass _apply straight through: the layers' hot path."""
    x = torch.arange(6.0).reshape(2, 3)
    out = tnd.relu(tnd.reshape(x, (3, 2)))
    assert type(out) is torch.Tensor
    assert isinstance(tnd.reshape(_t(x.numpy()), (3, 2)), tnd.NDArray)
    mixed = tnd.add(_t(x.numpy()), x)
    assert isinstance(mixed, tnd.NDArray)


def test_the_default_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default context resolves")
    for make in (lambda: tnd.array([1.0]), lambda: tnd.zeros((2,)),
                 lambda: tnd.arange(3), lambda: tnd.random.normal(shape=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    from incubator_mxnet_tpu_torch import cpu
    with cpu():
        assert tnd.ones((2,)).context == cpu()


@pytest.mark.parametrize("mode", ["clip", "wrap", "fill"])
def test_take_out_of_range_follows_the_reference(mode):
    w = onp.arange(12, dtype="float32").reshape(4, 3)
    ids = onp.array([0, 3, -1, -4, 4, 9, -5], dtype="int32")
    ref = jnd.take(jnd.array(w), jnd.array(ids), mode=mode).asnumpy()
    got = tnd.take(_t(w), _t(ids), mode=mode).asnumpy()
    onp.testing.assert_array_equal(got, ref)


def test_indexing_ops_out_of_range_follow_the_reference():
    x = onp.arange(12, dtype="float32").reshape(4, 3)
    ids = onp.array([[-1, 5, 0], [2, -7, 9]], dtype="int32")
    for name, args in (("gather_nd", (x, ids)),
                       ("batch_take", (x, onp.array([0, -1, 3, -9],
                                                    "int32"))),
                       ("one_hot", (onp.array([-1, 2, 5], "int32"), 3)),
                       ("pick", (x, onp.array([0, 7, -2, 1], "int32")))):
        ref = getattr(jnd, name)(*[jnd.array(a) if isinstance(a, onp.ndarray)
                                   else a for a in args]).asnumpy()
        got = getattr(tnd, name)(*[_t(a) if isinstance(a, onp.ndarray)
                                   else a for a in args]).asnumpy()
        onp.testing.assert_array_equal(got, ref, err_msg=name)
    upd = onp.array([1.0, 2.0, 3.0, 4.0], "float32")
    sids = onp.array([[1, -1, 7, -9], [0, 0, 0, 0]], "int32")
    ref = jnd.scatter_nd(jnd.array(upd), jnd.array(sids), shape=(4, 2))
    got = tnd.scatter_nd(_t(upd), _t(sids), shape=(4, 2))
    onp.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())


@pytest.mark.cuda
def test_indexing_out_of_range_on_the_card_leaves_the_context_usable():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from incubator_mxnet_tpu_torch import cpu, gpu
    w = onp.arange(12, dtype="float32").reshape(4, 3)
    ids = onp.array([0, 3, -1, -4, 4, 9, -5], dtype="int32")
    for mode in ("clip", "wrap", "fill"):
        want = tnd.take(tnd.array(w, ctx=cpu()), tnd.array(ids, ctx=cpu()),
                        mode=mode).asnumpy()
        got = tnd.take(tnd.array(w, ctx=gpu(0)), tnd.array(ids, ctx=gpu(0)),
                       mode=mode).asnumpy()
        onp.testing.assert_array_equal(got, want)
    bt = tnd.batch_take(tnd.array(w, ctx=gpu(0)), tnd.array(
        onp.array([0, 9, -7, 12], "int32"), ctx=gpu(0))).asnumpy()
    assert bt[0] == 0.0 and onp.isnan(bt[1:]).all()
    torch.cuda.synchronize()
    assert float((torch.ones(3, device="cuda") * 2).sum()) == 6.0
