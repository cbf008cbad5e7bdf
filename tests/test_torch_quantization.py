"""``contrib.quantization`` and the ``nd.contrib`` quantized family of the
port against the JAX package's, on the CPU.

Exact (bit for bit, or the same integers): ``quantize``, ``dequantize``,
``requantize``, the calibrations and the entropy threshold; the int32
accumulators of the int8 Dense and convolution (``torch._int_mm`` over an
im2col) against ``lax.dot_general``/``lax.conv_general_dilated`` with
``preferred_element_type=int32``; the int8 convolution's rescaled,
biased, relu'd and requantized outputs; the 15 ``nd.contrib`` entries; and
``quantize_net``'s derived int8 weights, weight scales and folded biases
on a small net with every pass (a Conv-BN-ReLU chain, a max-pool between
groups, a ``BottleneckV1``, a group after it, a Dense head). Its
activation scales come from each package's own fp32 forward, so they agree
within 1e-5 relative, and its int8 logits within 1e-2 relative Frobenius
of the reference's with equal argmax. ``MXTPU_INT8_SIM=1`` runs the
reference's QDQ route, held within one int8 code (its fp32 products are
each library's). The reference's ``QuantizedDense`` contracts axis 1 (a
fault, ROADMAP §3): the port contracts the last axis, as MXNet and the
reference's own ``quantized_fully_connected`` do.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax import lax

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu_torch.contrib import quantization as tq

CPU = mxt.cpu()


def _t(a, dtype=None):
    a = onp.asarray(a)
    return mxt.nd.array(a, ctx=CPU, dtype=dtype or a.dtype.name)


def _j(a, dtype=None):
    a = onp.asarray(a)
    return mx.nd.array(a, dtype=dtype or a.dtype.name)


def _same(got, want, what=""):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    onp.testing.assert_array_equal(got, want, err_msg=what)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else x


# ------------------------------------------------------------ the scalars
@pytest.mark.parametrize("rng_given", [True, False])
def test_quantize_dequantize_requantize_exact(rng_given):
    x = onp.random.RandomState(0).randn(4, 37).astype("float32") * 3
    lo, hi = (-2.5, 4.0) if rng_given else (None, None)
    jr = jq.quantize(_j(x), lo, hi)
    tr = tq.quantize(_t(x), lo, hi)
    for g, w in zip(_host(tr), _host(jr)):
        _same(g, w, "quantize")
    _same(tq.dequantize(tr[0], tr[1], tr[2]).asnumpy(),
          jq.dequantize(jr[0], jr[1], jr[2]).asnumpy(), "dequantize int8")
    acc = onp.random.RandomState(1).randint(-2 ** 30, 2 ** 30, (3, 5)) \
        .astype("int32")
    _same(tq.dequantize(_t(acc), -3.0, 7.0).asnumpy(),
          jq.dequantize(_j(acc), -3.0, 7.0).asnumpy(), "dequantize int32")
    for g, w in zip(_host(tq.requantize(_t(acc), -3.0, 7.0, -1.0, 2.0)),
                    _host(jq.requantize(_j(acc), -3.0, 7.0, -1.0, 2.0))):
        _same(g, w, "requantize")


def test_bf16_quantize_rounds_the_scale_as_the_reference():
    x = onp.random.RandomState(2).randn(64).astype("float32")
    jx = mx.nd.array(x).astype("bfloat16")
    tx = _t(x).astype("bfloat16")
    _same(tq.quantize(tx, -1.7, 2.3)[0].asnumpy(),
          jq.quantize(jx, -1.7, 2.3)[0].asnumpy(), "bf16 quantize")


def test_calibrations_exact():
    rng = onp.random.RandomState(3)
    acts = [rng.randn(2, 50).astype("float32") * s for s in (1.0, 4.0)]
    assert tq.calib_minmax([_t(a) for a in acts]) == \
        jq.calib_minmax([_j(a) for a in acts])
    assert tq.calib_entropy([_t(a) for a in acts], num_bins=801) == \
        jq.calib_entropy([_j(a) for a in acts], num_bins=801)
    hist, edges = onp.histogram(onp.abs(rng.randn(5000)), bins=1001)
    assert tq._entropy_threshold(hist, edges) == \
        jq._entropy_threshold(hist, edges)


# ------------------------------------------------------- the accumulators
def _ints(rng, *shape):
    return rng.randint(-127, 128, shape).astype("int8")


@pytest.mark.parametrize("m,k,n", [(2, 6, 8), (33, 147, 10), (5, 64, 3)])
def test_dense_accumulators_exact(m, k, n):
    rng = onp.random.RandomState(m)
    x, w = _ints(rng, m, k), _ints(rng, n, k)
    want = lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    got = tq._int8_dense_acc(torch.from_numpy(x), torch.from_numpy(w))
    _same(got.numpy(), onp.asarray(want))


_CONVS = [  # (x shape, w shape, stride, pad, dilate, groups)
    ((2, 3, 9, 9), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ((2, 8, 6, 6), (4, 8, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((2, 8, 7, 7), (16, 8, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    ((1, 8, 8, 8), (8, 4, 3, 3), (1, 1), (2, 2), (2, 2), 2),
]


@pytest.mark.parametrize("case", _CONVS, ids=range(len(_CONVS)))
def test_conv_accumulators_exact(case):
    xs, ws, stride, pad, dil, groups = case
    rng = onp.random.RandomState(sum(xs))
    x, w = _ints(rng, *xs), _ints(rng, *ws)
    dn = lax.conv_dimension_numbers(xs, ws, ("NCHW", "OIHW", "NCHW"))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, [(p, p) for p in pad],
        rhs_dilation=dil, dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32)
    got = tq._int8_conv_acc(torch.from_numpy(x), torch.from_numpy(w),
                            stride, pad, dil, groups)
    _same(got.contiguous().numpy(), onp.asarray(want))


@pytest.mark.parametrize("int8_in,act,emit", [(False, None, None),
                                              (False, "relu", 0.05),
                                              (True, "relu", None)])
def test_int8_conv_apply_exact(int8_in, act, emit):
    rng = onp.random.RandomState(4)
    x = rng.randn(2, 4, 8, 8).astype("float32")
    if int8_in:
        x = _ints(rng, 2, 4, 8, 8)
    wq = _ints(rng, 6, 4, 3, 3)
    b = rng.randn(6).astype("float32")
    kw = {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
          "dilate": (1, 1), "num_group": 1}
    want = jq._int8_conv_apply(_j(x), _j(wq), _j(b), kw, 0.03, 0.002,
                               act_type=act, emit_scale=emit,
                               fp_dtype="float32")
    got = tq._int8_conv_apply(_t(x), _t(wq), _t(b), kw, 0.03, 0.002,
                              act_type=act, emit_scale=emit,
                              fp_dtype="float32")
    _same(got.asnumpy(), want.asnumpy())


# ------------------------------------------------- the nd.contrib entries
def _contrib_cases():
    rng = onp.random.RandomState(5)
    d = rng.randn(2, 4, 6, 6).astype("float32")
    return {
        "x": d, "q": _ints(rng, 2, 4, 6, 6), "q2": _ints(rng, 2, 4, 6, 6),
        "fw": _ints(rng, 5, 144), "cw": _ints(rng, 3, 4, 3, 3),
        "bq": _ints(rng, 5), "cb": _ints(rng, 3),
        "table": _ints(rng, 10, 4), "ids": rng.randint(0, 10, (3, 2)),
        "g": onp.abs(rng.randn(4)).astype("float32") + 0.5,
        "b": rng.randn(4).astype("float32"),
        "mm": rng.randn(4).astype("float32"),
        "mv": onp.abs(rng.randn(4)).astype("float32") + 0.5,
        "hist": onp.histogram(onp.abs(rng.randn(4000)), bins=801),
    }


def _rng(nd, v):
    a = onp.asarray([v], "float32")
    return _t(a) if nd is mxt.nd else _j(a)


_CONTRIB = {
    "quantize": lambda nd, c, A: c.quantize(A("x"), _rng(nd, -2.0),
                                            _rng(nd, 3.0)),
    "quantize_v2": lambda nd, c, A: c.quantize_v2(A("x")),
    "dequantize": lambda nd, c, A: c.dequantize(A("q"), _rng(nd, -2.0),
                                                _rng(nd, 3.0)),
    "requantize": lambda nd, c, A: c.requantize(
        c.quantized_fully_connected(A("q"), A("fw"), None, -2.0, 3.0, -1.0,
                                    1.0, no_bias=True, num_hidden=5)[0]
        .astype("int32"), -1e4, 1e4, -10.0, 10.0),
    "calibrate_entropy": lambda nd, c, A: c.calibrate_entropy(
        A("hist0"), A("hist1")),
    "quantized_fully_connected": lambda nd, c, A:
        c.quantized_fully_connected(A("q"), A("fw"), A("bq"), -2.0, 3.0,
                                    -1.0, 1.0, -0.5, 0.5, num_hidden=5),
    "quantized_conv": lambda nd, c, A: c.quantized_conv(
        A("q"), A("cw"), A("cb"), -2.0, 3.0, -1.0, 1.0, -0.5, 0.5,
        kernel=(3, 3), pad=(1, 1), num_filter=3),
    "quantized_pooling_max": lambda nd, c, A: c.quantized_pooling(
        A("q"), -2.0, 3.0, kernel=(2, 2), pool_type="max"),
    "quantized_pooling_avg": lambda nd, c, A: c.quantized_pooling(
        A("q"), -2.0, 3.0, kernel=(3, 3), stride=(2, 2), pool_type="avg"),
    "quantized_act": lambda nd, c, A: c.quantized_act(A("q"), -2.0, 3.0),
    "quantized_flatten": lambda nd, c, A: c.quantized_flatten(A("q"), -2.0,
                                                              3.0),
    "quantized_concat": lambda nd, c, A: c.quantized_concat(
        A("q"), A("q2"), -2.0, -1.0, 3.0, 1.5, dim=1),
    "quantized_elemwise_add": lambda nd, c, A: c.quantized_elemwise_add(
        A("q"), A("q2"), -2.0, 3.0, -1.0, 1.5),
    "quantized_elemwise_mul": lambda nd, c, A: c.quantized_elemwise_mul(
        A("q"), A("q2"), -2.0, 3.0, -1.0, 1.5),
    "quantized_embedding": lambda nd, c, A: c.quantized_embedding(
        A("ids"), A("table"), -1.0, 1.0, input_dim=10, output_dim=4),
    "quantized_batch_norm": lambda nd, c, A: c.quantized_batch_norm(
        A("q"), A("g"), A("b"), A("mm"), A("mv"), -2.0, 3.0,
        min_calib_range=-4.0, max_calib_range=4.0),
}


def _contrib_both(name):
    cases = _contrib_cases()
    h, e = cases.pop("hist")
    cases["hist0"], cases["hist1"] = h.astype("float32"), \
        e.astype("float32")

    def jA(k):
        return _j(cases[k])

    def tA(k):
        return _t(cases[k])
    want = _CONTRIB[name](mx.nd, mx.nd.contrib, jA)
    got = _CONTRIB[name](mxt.nd, mxt.nd.contrib, tA)
    return _host(got), _host(want)


@pytest.mark.parametrize("name", sorted(_CONTRIB))
def test_contrib_entry_exact(name):
    got, want = _contrib_both(name)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert g == w, name
        else:
            _same(onp.asarray(g), onp.asarray(w), name)


@pytest.mark.parametrize("name", ["quantized_fully_connected",
                                  "quantized_conv"])
def test_int8_sim_route_matches_the_references(name, monkeypatch):
    monkeypatch.setenv("MXTPU_INT8_SIM", "1")
    got, want = _contrib_both(name)
    q_g, q_w = onp.asarray(got[0], "int32"), onp.asarray(want[0], "int32")
    assert q_g.shape == q_w.shape
    assert int(onp.abs(q_g - q_w).max()) <= 1
    onp.testing.assert_allclose(onp.asarray(got[1:], "float64"),
                                onp.asarray(want[1:], "float64"),
                                rtol=1e-5)


# ------------------------------------------------------- quantize_net
def _small_net(pkg):
    nn = pkg.gluon.nn
    zoo = pkg.gluon.model_zoo.vision
    net = nn.HybridSequential(prefix="q_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.MaxPool2D(2, 2),
                zoo.BottleneckV1(16, 1, downsample=True, in_channels=8),
                nn.Conv2D(8, 1, in_channels=16), nn.BatchNorm(in_channels=8),
                nn.Activation("relu"),
                nn.MaxPool2D(2, 2),
                nn.Dense(10, in_units=8 * 8 * 8))
    return net


def _bn_stats(net, rng):
    for name, p in sorted(net._collect_params_with_prefix().items()):
        if name.endswith("running_mean"):
            p.set_data(mx.nd.array(rng.randn(*p.shape).astype("float32")
                                   * 0.1))
        elif name.endswith("running_var") or name.endswith("gamma"):
            p.set_data(mx.nd.array(onp.abs(rng.randn(*p.shape))
                                   .astype("float32") + 0.5))
        elif name.endswith("beta"):
            p.set_data(mx.nd.array(rng.randn(*p.shape).astype("float32")
                                   * 0.1))


def _quantized_blocks(net, children):
    out = []

    def walk(b):
        for c in children(b).values():
            if c is None:
                continue
            if type(c).__name__.startswith("_Quantized"):
                out.append(c)
            walk(c)
    walk(net)
    return out


@pytest.fixture(scope="module")
def nets():
    rng = onp.random.RandomState(6)
    x = rng.randn(4, 3, 32, 32).astype("float32")
    jnet = _small_net(mx)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))              # the deferred shapes
    _bn_stats(jnet, rng)
    tnet = _small_net(mxt)
    tnet.initialize(mxt.init.Xavier(), ctx=CPU)
    tnet(_t(x))
    mxt.convert.from_jax_params(tnet, jnet)
    fp_logits = jnet(mx.nd.array(x)).asnumpy()
    jq.quantize_net(jnet, calib_data=[(mx.nd.array(x),)],
                    num_calib_batches=1)
    tq.quantize_net(tnet, calib_data=[(_t(x),)], num_calib_batches=1)
    return jnet, tnet, x, fp_logits


def _same_scale(got, want, what):
    """An activation scale is a calibrated fp32 maximum over 127. Where
    that maximum comes out of the float net's deeper layers it differs in
    its last bits, because XLA's and torch's CPU kernels sum in different
    orders (the float logits differ by up to 4.8e-7): on this net by at
    most 2 fp32 ulps of the maximum (1.32e-7 relative), and elsewhere not
    at all."""
    g, w = (int(onp.float32(v * 127.0).view(onp.int32)) for v in (got, want))
    assert abs(g - w) <= 2, (what, got, want)


def test_quantize_net_derived_weights_exact(nets):
    jnet, tnet, _, _ = nets
    jb = _quantized_blocks(jnet, lambda b: b._children)
    tb = _quantized_blocks(tnet, lambda b: b._modules)
    assert [type(b).__name__ for b in tb] == [type(b).__name__ for b in jb]
    kinds = {type(b).__name__ for b in tb}
    assert kinds == {"_QuantizedConvGroup", "_QuantizedResidualBlock",
                     "_QuantizedDenseBlock"}
    for j, t in zip(jb, tb):
        name = type(j).__name__
        if name == "_QuantizedConvGroup":
            _same(t._wq.asnumpy(), j._wq.asnumpy(), "group int8 weight")
            _same(t._bias.asnumpy(), j._bias.asnumpy(), "group bias")
            assert t._ws == j._ws
        if name == "_QuantizedDenseBlock":
            _same(t._inner._wq.asnumpy(), j._inner._wq.asnumpy(),
                  "dense int8 weight")
            assert t._inner._ws == (max(
                abs(float(j._inner._wmin.asnumpy()[0])),
                abs(float(j._inner._wmax.asnumpy()[0]))) / 127.0 or 1.0)
            _same_scale(t._inner._xs, max(
                abs(j._inner._cmin), abs(j._inner._cmax)) / 127.0, name)
        if name != "_QuantizedDenseBlock":
            _same_scale(t._in_scale, j._in_scale, name + " in")
            _same_scale(t._out_scale, j._out_scale, name + " out")
            assert t.emit_int8 == j.emit_int8, name
    assert any(b.emit_int8 for b in tb)


def test_quantize_net_logits_against_the_reference(nets):
    jnet, tnet, x, fp_logits = nets
    want = jnet(mx.nd.array(x)).asnumpy()
    got = tnet(_t(x)).asnumpy()
    assert onp.isfinite(got).all()
    rel = onp.linalg.norm(got - want) / onp.linalg.norm(want)
    assert rel <= 1e-2, rel
    assert (got.argmax(1) == want.argmax(1)).all()
    # and the int8 net stays near the float net it came from
    assert onp.linalg.norm(got - fp_logits) / onp.linalg.norm(
        fp_logits) <= 0.1


def test_legacy_qdq_route_matches_the_references(monkeypatch):
    """fold_bn=False: per-block Dense and Conv2D swaps; under
    ``MXTPU_INT8_SIM=1`` the conv is the QDQ route in both packages."""
    monkeypatch.setenv("MXTPU_INT8_SIM", "1")
    rng = onp.random.RandomState(8)
    nets = []
    for pkg in (mx, mxt):
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, padding=1, in_channels=3,
                          activation="relu"),
                nn.Dense(5, in_units=4 * 8 * 8))
        nets.append(net)
    nets[0].initialize(mx.init.Xavier())
    nets[1].initialize(mxt.init.Xavier(), ctx=CPU)
    mxt.convert.from_jax_params(nets[1], nets[0])
    x = rng.randn(2, 3, 8, 8).astype("float32")
    jq.quantize_net(nets[0], calib_data=[mx.nd.array(x)], fold_bn=False)
    tq.quantize_net(nets[1], calib_data=[_t(x)], fold_bn=False)
    want = nets[0](mx.nd.array(x)).asnumpy()
    got = nets[1](_t(x)).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-4,
                                atol=1e-4 * onp.abs(want).max())


def test_quantized_dense_contracts_the_last_axis():
    """The reference's QuantizedDense contracts axis 1: a TypeError at
    (2, 5, 6) (and a silent wrong answer at (2, 6, 6)); the port's agrees
    with nd.contrib.quantized_fully_connected and the float Dense."""
    rng = onp.random.RandomState(9)
    x = rng.randn(2, 5, 6).astype("float32")
    jd = mx.gluon.nn.Dense(8, flatten=False, in_units=6)
    jd.initialize(mx.init.Xavier())
    td = mxt.gluon.nn.Dense(8, flatten=False, in_units=6)
    td.initialize(ctx=CPU)
    mxt.convert.from_jax_params(td, jd)
    jqd = jq.quantize_net(jd, calib_data=[mx.nd.array(x)])
    with pytest.raises(TypeError):
        jqd(mx.nd.array(x))
    tqd = tq.quantize_net(td, calib_data=[_t(x)])
    got = tqd(_t(x)).asnumpy()
    fp = td(_t(x)).asnumpy()
    assert got.shape == (2, 5, 8)
    inner = tqd._inner
    ref = mxt.nd.contrib.quantized_fully_connected(
        tq.quantize(_t(x), inner._cmin, inner._cmax)[0], inner._wq, None,
        inner._cmin, inner._cmax, inner._wmin, inner._wmax, no_bias=True,
        num_hidden=8, flatten=False)
    deq = tq.dequantize(*ref).asnumpy()
    bias = td.bias.data().asnumpy()
    onp.testing.assert_allclose(got - bias, deq,
                                atol=2 * abs(ref[2].asnumpy()[0]) / 127)
    onp.testing.assert_allclose(got, fp, atol=0.05 * onp.abs(fp).max())


def test_quantized_net_forward_reads_nothing_from_the_device(nets,
                                                             monkeypatch):
    """A quantized forward never reads a device value on the host (what a
    captured EvalStep needs): ``asnumpy``/``item`` are refused during it."""
    _, tnet, x, _ = nets
    xt = _t(x)._data

    def refuse(*a, **k):
        raise AssertionError("host read inside the int8 forward")
    monkeypatch.setattr(mxt.nd.NDArray, "asnumpy", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    out = tnet(xt)
    assert isinstance(out, torch.Tensor) and out.shape == (4, 10)


def test_pooling_takes_int8_codes_exactly():
    q = _ints(onp.random.RandomState(10), 2, 3, 6, 6)
    got = mxt.nd.Pooling(_t(q), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max")
    want = mx.nd.Pooling(_j(q), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="max")
    _same(got.asnumpy(), want.asnumpy())


def test_jax_is_the_reference_here():
    assert jax.default_backend() == "cpu"
