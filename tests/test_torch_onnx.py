"""``contrib.onnx`` of the port against the JAX package's, on the CPU.

- The same ``Symbol`` and parameters exported by both packages give the
  same bytes (LeNet with BatchNorm and both FullyConnected forms, the
  transformer encoder, the fused-RNN stacks of ``tests/test_onnx.py``).
- A file either package writes is read by the other: the imported graph's
  forward within 1e-5 of the original's (of its largest value).
- The reference's own ONNX tests (``tests/test_onnx.py``) run against the
  port as they stand, with the package's name swapped.
"""
import inspect
import pathlib

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu.contrib import onnx as jonnx
from incubator_mxnet_tpu.symbol import symbol as jsymm
from incubator_mxnet_tpu_torch.contrib import onnx as tonnx
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm

import test_onnx as jt

TOL = 1e-5
_TESTS = pathlib.Path(__file__).parent


def _port_namespace():
    src = (_TESTS / "test_onnx.py").read_text().replace(
        "incubator_mxnet_tpu", "incubator_mxnet_tpu_torch")
    ns = {"__name__": "port_test_onnx"}
    exec(compile(src, "port/test_onnx.py", "exec"), ns)
    return ns


PT = _port_namespace()


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _close(got, want, what):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()), 1e-30)
    err = float(onp.abs(got - want).max()) / scale
    assert err <= TOL, "%s: %.3g of the largest value" % (what, err)


def _lenet(pkg, ns):
    sym = ns["_lenet_sym"]()
    shape = (2, 1, 28, 28)
    rng = onp.random.RandomState(0)
    ex = sym.simple_bind(data=shape)
    host = {}
    for name, arr in ex.arg_dict.items():
        if name != "data":
            host[name] = (rng.randn(*arr.shape) * 0.1).astype("float32")
    for name, arr in ex.aux_dict.items():
        host[name] = (onp.abs(rng.randn(*arr.shape)) + 0.5).astype(
            "float32") if "var" in name else \
            (rng.randn(*arr.shape) * 0.1).astype("float32")
    return sym, host, [shape], {"data": rng.randn(*shape).astype("float32")}


def _encoder(pkg, ns):
    U, V = 16, 50
    sym = ns["_encoder_sym"](U=U, V=V)
    shape = (2, 5)
    rng = onp.random.RandomState(0)
    ex = sym.simple_bind(tokens=shape, embed_w=(V, U), ln1_g=(U,),
                         ln1_b=(U,), ln2_g=(U,), ln2_b=(U,))
    host = {}
    for name, arr in ex.arg_dict.items():
        if name != "tokens":
            host[name] = (rng.randn(*arr.shape) * 0.1).astype("float32")
    toks = rng.randint(0, V, shape).astype("float32")
    return sym, host, [shape], {"tokens": toks}


def _rnn(pkg, ns):
    T, N, I, H, L = 4, 3, 6, 5, 2
    sym = pkg.sym
    data, p, h0, c0 = (sym.var("data"), sym.var("rnn_params"),
                       sym.var("h0"), sym.var("c0"))
    out = sym.RNN(data, p, h0, c0, state_size=H, num_layers=L, mode="lstm",
                  bidirectional=True, name="rnn0")
    from incubator_mxnet_tpu.ndarray.rnn_op import rnn_param_size
    rng = onp.random.RandomState(3)
    n = rnn_param_size("lstm", I, H, L, True)
    host = {"rnn_params": (rng.randn(n) * 0.3).astype("float32")}
    shapes = [(T, N, I), (2 * L, N, H), (2 * L, N, H)]
    feeds = {"data": rng.randn(T, N, I).astype("float32"),
             "h0": (rng.randn(2 * L, N, H) * 0.1).astype("float32"),
             "c0": (rng.randn(2 * L, N, H) * 0.1).astype("float32")}
    return out, host, shapes, feeds


_GRAPHS = {"lenet": _lenet, "encoder": _encoder, "rnn": _rnn}


def _build(kind):
    """(symbol, params, feeds) in the JAX package and in the port, from
    the same numpy values."""
    jsym, host, shapes, feeds = _GRAPHS[kind](mx, vars(jt))
    with mxt.cpu():
        tsym, _, _, _ = _GRAPHS[kind](mxt, PT)
        tparams = {k: mxt.nd.array(v) for k, v in host.items()}
    jparams = {k: mx.nd.array(v) for k, v in host.items()}
    return (jsym, jparams), (tsym, tparams), shapes, feeds


def _eval(pkg, sym, params, feeds):
    binds = dict(params)
    binds.update({k: pkg.nd.array(v) for k, v in feeds.items()})
    return sym.eval(**binds)[0].asnumpy()


@pytest.mark.parametrize("kind", list(_GRAPHS))
def test_export_bytes_equal_the_references(kind, tmp_path):
    (jsym, jp), (tsym, tp), shapes, _ = _build(kind)
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jonnx.export_model(jsym, jp, shapes if len(shapes) > 1 else shapes[0],
                       onnx_file_path=jpath)
    with mxt.cpu():
        tonnx.export_model(tsym, tp, shapes if len(shapes) > 1
                           else shapes[0], onnx_file_path=tpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


@pytest.mark.parametrize("kind", list(_GRAPHS))
def test_files_cross_read_both_ways(kind, tmp_path):
    (jsym, jp), (tsym, tp), shapes, feeds = _build(kind)
    arg = shapes if len(shapes) > 1 else shapes[0]
    jpath, tpath = str(tmp_path / "j.onnx"), str(tmp_path / "t.onnx")
    jonnx.export_model(jsym, jp, arg, onnx_file_path=jpath)
    with mxt.cpu():
        tonnx.export_model(tsym, tp, arg, onnx_file_path=tpath)
        want_t = _eval(mxt, tsym, tp, feeds)
        # the port reads the JAX package's file
        s2, a2, x2 = tonnx.import_model(jpath)
        got = _eval(mxt, s2, {**a2, **x2}, feeds)
    want_j = _eval(mx, jsym, jp, feeds)
    _close(got, want_j, "port reads the JAX file")
    # the JAX package reads the port's file
    s3, a3, x3 = jonnx.import_model(tpath)
    _close(_eval(mx, s3, {**a3, **x3}, feeds), want_t,
           "JAX package reads the port file")


def test_metadata_of_either_file(tmp_path):
    (jsym, jp), (tsym, tp), shapes, _ = _build("lenet")
    path = str(tmp_path / "t.onnx")
    with mxt.cpu():
        tonnx.export_model(tsym, tp, shapes[0], onnx_file_path=path)
    assert tonnx.get_model_metadata(path) == jonnx.get_model_metadata(path)


_REF_TESTS = [n for n in PT if n.startswith("test_")]


@pytest.mark.parametrize("name", _REF_TESTS)
def test_reference_onnx_tests_hold(name, tmp_path):
    fn = PT[name]
    with mxt.cpu():
        if "tmp_path" in inspect.signature(fn).parameters:
            fn(tmp_path)
        else:
            fn()
