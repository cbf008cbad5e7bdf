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
    ("prelu", {}), ("rrelu", dict(lower_bound=0.2, upper_bound=0.5))])
def test_leaky_relu_raises_for_an_act_type_it_does_not_port(act_type, kw):
    """The reference honours these (and their keywords): the port must
    raise, never answer with GELU or ignore ``slope``."""
    x = onp.random.RandomState(13).randn(2, 3).astype("float32")
    with pytest.raises(ValueError, match="unsupported act_type"):
        tnd.LeakyReLU(torch.from_numpy(x), act_type=act_type, **kw)


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
