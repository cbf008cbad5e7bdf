"""The port's embedded-interpreter C ABI (``libmxtpu_predict``, built from
``incubator_mxnet_tpu_torch/native/src/c_predict_api.cc``) against the JAX
package's, on the CPU.

Both libraries are loaded into this process over ``ctypes`` (each finds
the live interpreter and imports its own package's ``_*_embed`` modules);
every call of the port's runs under ``MXTPU_CAPI_CONTEXT``, ``cpu`` here.
The same MLP weights give the JAX package's predictions; the same eager
operators, gradients and graph training steps give its values (fp32,
1e-5). A fresh process with ``JAX_PLATFORMS=cpu`` predicts through the
port's library without loading JAX or the JAX package. The JAX package's
own ``test_c_api_ext.py`` runs against the port (its
``test_cpp_package.py``, the C++ clients, runs in test_torch_native.py).
"""
import ctypes as c
import inspect
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.contrib import serving as jserving
from incubator_mxnet_tpu.native import lib as jlib

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.contrib import serving as tserving
from incubator_mxnet_tpu_torch.native import lib as tlib

from test_torch_interop import _port_tests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


def _load(so):
    lib = c.CDLL(so)
    lib.MXTPUPredGetLastError.restype = c.c_char_p
    return lib


@pytest.fixture(scope="module")
def libs():
    try:
        return {"jax": _load(jlib.build_predict()),
                "port": _load(tlib.build_predict())}
    except Exception as e:     # no g++ or no Python headers here
        pytest.skip("cannot build libmxtpu_predict.so: %s" % e)


@pytest.fixture(autouse=True)
def _capi_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MXTPU_CAPI_CONTEXT", "cpu")


class _Abi:
    """The flat C ABI of one library, as a C caller drives it."""

    def __init__(self, lib):
        self.lib = lib

    def ok(self, rc):
        assert rc == 0, self.lib.MXTPUPredGetLastError().decode()

    def nd(self, a):
        a = onp.ascontiguousarray(a, "float32")
        h = c.c_void_p()
        self.ok(self.lib.MXTPUNDCreate(
            b"float32", (c.c_int64 * a.ndim)(*a.shape), a.ndim,
            a.ctypes.data_as(c.c_void_p), c.c_int64(a.nbytes), c.byref(h)))
        return h

    def numpy(self, h):
        shape, ndim = (c.c_int64 * 8)(), c.c_int()
        self.ok(self.lib.MXTPUNDGetShape(h, shape, 8, c.byref(ndim)))
        out = onp.empty(tuple(shape[:ndim.value]), "float32")
        n = c.c_int64()
        self.ok(self.lib.MXTPUNDGetData(h, out.ctypes.data_as(c.c_void_p),
                                        c.c_int64(out.nbytes), c.byref(n)))
        assert n.value == out.nbytes
        return out

    def set(self, h, a):
        a = onp.ascontiguousarray(a, "float32")
        self.ok(self.lib.MXTPUNDSetData(h, b"float32",
                                        a.ctypes.data_as(c.c_void_p),
                                        c.c_int64(a.nbytes)))

    def invoke(self, op, handles, **attrs):
        outs, n = (c.c_void_p * 4)(), c.c_int()
        self.ok(self.lib.MXTPUImperativeInvoke(
            op.encode(), (c.c_void_p * len(handles))(*handles), len(handles),
            json.dumps(attrs).encode(), outs, 4, c.byref(n)))
        return [c.c_void_p(outs[i]) for i in range(n.value)]

    def grad(self, h):
        g = c.c_void_p()
        self.ok(self.lib.MXTPUNDGetGrad(h, c.byref(g)))
        return self.numpy(g)

    def op(self, name, attrs, node, **inputs):
        s = c.c_void_p()
        self.ok(self.lib.MXTPUSymbolCreateAtomic(
            name.encode(), json.dumps(attrs).encode(), c.byref(s)))
        keys = (c.c_char_p * len(inputs))(*[k.encode() for k in inputs])
        args = (c.c_void_p * len(inputs))(*inputs.values())
        self.ok(self.lib.MXTPUSymbolCompose(s, node.encode(), len(inputs),
                                            keys, args))
        return s

    def var(self, name):
        s = c.c_void_p()
        self.ok(self.lib.MXTPUSymbolCreateVariable(name.encode(),
                                                   c.byref(s)))
        return s

    def arg(self, ex, name, grad=False):
        h = c.c_void_p()
        fn = self.lib.MXTPUExecutorArgGrad if grad else \
            self.lib.MXTPUExecutorArg
        self.ok(fn(ex, name.encode(), c.byref(h)))
        return h


def _mlps():
    """The JAX package's MLP and the port's with its weights."""
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    tnet = mxt.gluon.nn.HybridSequential()
    tnet.add(mxt.gluon.nn.Dense(16, activation="relu", in_units=8),
             mxt.gluon.nn.Dense(4, in_units=16))
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    return jnet, tnet


def _predict(abi, path, x, out_shape):
    lib = abi.lib
    lib.MXTPUPredCreate.argtypes = [c.c_char_p, c.POINTER(c.c_void_p)]
    h = c.c_void_p()
    abi.ok(lib.MXTPUPredCreate(path.encode(), c.byref(h)))
    dtypes = []
    for fn in (lib.MXTPUPredGetInputDType, lib.MXTPUPredGetOutputDType):
        buf = c.create_string_buffer(32)
        abi.ok(fn(h, 0, buf, 32))
        dtypes.append(buf.value.decode())
    raw = x.tobytes()
    abi.ok(lib.MXTPUPredSetInput(h, 0, raw, c.c_int64(len(raw))))
    abi.ok(lib.MXTPUPredForward(h))
    n = int(onp.prod(out_shape)) * (2 if dtypes[1] == "bfloat16" else 4)
    out = c.create_string_buffer(n)
    assert lib.MXTPUPredGetOutput(h, 0, out, c.c_int64(n - 1)) == -1
    assert b"size mismatch" in lib.MXTPUPredGetLastError()
    abi.ok(lib.MXTPUPredGetOutput(h, 0, out, c.c_int64(n)))
    abi.ok(lib.MXTPUPredFree(h))
    return dtypes, out.raw


def test_predict_abi_matches_the_references_predict(libs, tmp_path):
    jnet, tnet = _mlps()
    x = onp.random.RandomState(3).randn(2, 8).astype("float32")
    jpath, tpath = str(tmp_path / "j.mxtpu"), str(tmp_path / "t.mxtpu")
    jserving.export_model(jnet, mx.nd.array(x), jpath)
    tserving.export_model(tnet, torch.from_numpy(x), tpath)
    want = jserving.load(jpath).predict(mx.nd.array(x)).asnumpy()
    got = {}
    for tag, path in (("jax", jpath), ("port", tpath)):
        dtypes, raw = _predict(_Abi(libs[tag]), path, x, (2, 4))
        assert dtypes == ["float32", "float32"]
        got[tag] = onp.frombuffer(raw, "float32").reshape(2, 4)
    onp.testing.assert_allclose(got["port"], want, **TOL)
    onp.testing.assert_allclose(got["jax"], want, **TOL)
    h = c.c_void_p()
    assert libs["port"].MXTPUPredCreate(str(tmp_path / "none").encode(),
                                        c.byref(h)) == -1
    assert b"MXTPUPredCreate" in libs["port"].MXTPUPredGetLastError()


def test_predict_abi_bfloat16_crosses_as_raw_words(libs, tmp_path):
    """A bf16 program with int32 ids: the dtype names are the JAX
    package's, and the output's bytes are predict's 16-bit words."""
    names = {}
    ids = onp.arange(12, dtype="int32").reshape(2, 6) % 10
    for tag, pkg, serving in (("jax", mx, jserving), ("port", mxt, tserving)):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Embedding(10, 8), pkg.gluon.nn.Dense(
            3, flatten=False, in_units=8))
        net.initialize(**({"ctx": mxt.cpu()} if pkg is mxt else {}))
        net.cast("bfloat16")
        path = str(tmp_path / (tag + ".mxtpu"))
        if pkg is mxt:
            model = serving.export_model(net, torch.from_numpy(ids), path)
            want = model.predict(torch.from_numpy(ids))._data
        else:
            serving.export_model(net, pkg.nd.array(ids, dtype="int32"), path)
        names[tag], raw = _predict(_Abi(libs[tag]), path, ids, (2, 6, 3))
    assert names["port"] == names["jax"] == ["int32", "bfloat16"]
    assert want.dtype == torch.bfloat16
    assert raw == want.contiguous().view(torch.int16).numpy().tobytes()


def test_invoke_abi_ops_and_gradients_match_the_reference(libs):
    rng = onp.random.RandomState(4)
    x, w = rng.randn(3, 5), rng.randn(4, 5)
    got = {}
    for tag in ("jax", "port"):
        abi = _Abi(libs[tag])
        hx, hw = abi.nd(x), abi.nd(w)
        vals = [abi.numpy(abi.invoke("softmax", [hx], axis=-1)[0]),
                abi.numpy(abi.invoke("linalg.gemm2", [hx, hw],
                                     transpose_b=True)[0])]
        for h in (hx, hw):
            abi.ok(libs[tag].MXTPUNDAttachGrad(h))
        abi.ok(libs[tag].MXTPUAutogradRecordBegin())
        (fc,) = abi.invoke("FullyConnected", [hx, hw], num_hidden=4,
                           no_bias=True)
        (act,) = abi.invoke("tanh", [fc])
        (loss,) = abi.invoke("sum", [act])
        abi.ok(libs[tag].MXTPUAutogradRecordEnd())
        abi.ok(libs[tag].MXTPUNDBackward(loss))
        vals += [abi.numpy(act), abi.grad(hx), abi.grad(hw)]
        got[tag] = vals
    for g, r in zip(got["port"], got["jax"]):
        onp.testing.assert_allclose(g, r, **TOL)


def test_graph_abi_mlp_steps_match_the_reference(libs):
    """train_mlp.cc's graph through both libraries: compose (the layer
    weights made by the ops), simple_bind, three SGD steps written back
    through MXTPUNDSetData; outputs, gradients and weights agree."""
    rng = onp.random.RandomState(5)
    B, D, H = 6, 4, 8
    init = {"fc1_weight": rng.randn(H, D) * 0.4, "fc1_bias": rng.randn(H),
            "fc2_weight": rng.randn(1, H) * 0.4, "fc2_bias": rng.randn(1)}
    x, y = rng.randn(B, D), rng.randn(B, 1)
    got = {}
    for tag in ("jax", "port"):
        abi = _Abi(libs[tag])
        data, label = abi.var("data"), abi.var("y")
        fc1 = abi.op("FullyConnected", {"num_hidden": H}, "fc1", data=data)
        act = abi.op("Activation", {"act_type": "relu"}, "relu1", data=fc1)
        fc2 = abi.op("FullyConnected", {"num_hidden": 1}, "fc2", data=act)
        out = abi.op("LinearRegressionOutput", {}, "lro", data=fc2,
                     label=label)
        need = c.c_int64()
        abi.ok(libs[tag].MXTPUSymbolListArguments(out, None, 0,
                                                  c.byref(need)))
        buf = c.create_string_buffer(need.value)
        abi.ok(libs[tag].MXTPUSymbolListArguments(out, buf, need.value,
                                                  c.byref(need)))
        assert set(json.loads(buf.value)) == {"data", "y", *init}
        shapes = {"data": [B, D], "y": [B, 1],
                  **{k: list(v.shape) for k, v in init.items()}}
        ex = c.c_void_p()
        abi.ok(libs[tag].MXTPUExecutorSimpleBind(
            out, json.dumps(shapes).encode(), b"write", c.byref(ex)))
        for k, v in init.items():
            abi.set(abi.arg(ex, k), v)
        hx, hy = abi.nd(x), abi.nd(y)
        names = (c.c_char_p * 2)(b"data", b"y")
        vals = []
        for _ in range(3):
            abi.ok(libs[tag].MXTPUExecutorForward(
                ex, 1, 2, names, (c.c_void_p * 2)(hx, hy)))
            abi.ok(libs[tag].MXTPUExecutorBackward(ex, 0, None))
            o = c.c_void_p()
            abi.ok(libs[tag].MXTPUExecutorOutput(ex, 0, c.byref(o)))
            vals.append(abi.numpy(o))
            for k in init:
                w = abi.arg(ex, k)
                g = abi.numpy(abi.arg(ex, k, grad=True))
                vals.append(g)
                abi.set(w, abi.numpy(w) - 0.1 * g / B)
        vals += [abi.numpy(abi.arg(ex, k)) for k in init]
        got[tag] = vals
    for g, r in zip(got["port"], got["jax"]):
        onp.testing.assert_allclose(g, r, **TOL)


_NO_JAX = r"""
import ctypes as c, sys
import torch
import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.contrib import serving
from incubator_mxnet_tpu_torch.native import lib
net = mxt.gluon.nn.Dense(3, in_units=4)
net.initialize(ctx=mxt.cpu())
x = torch.ones(2, 4)
want = serving.export_model(net, x, sys.argv[1]).predict(x).asnumpy()
so = c.CDLL(lib.build_predict())
so.MXTPUPredGetLastError.restype = c.c_char_p
h = c.c_void_p()
assert so.MXTPUPredCreate(sys.argv[1].encode(), c.byref(h)) == 0
raw = x.numpy().tobytes()
assert so.MXTPUPredSetInput(h, 0, raw, c.c_int64(len(raw))) == 0
assert so.MXTPUPredForward(h) == 0, so.MXTPUPredGetLastError()
out = c.create_string_buffer(24)
assert so.MXTPUPredGetOutput(h, 0, out, c.c_int64(24)) == 0
import numpy
assert (numpy.frombuffer(out.raw, "float32").reshape(2, 3) == want).all()
bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
             or n == "incubator_mxnet_tpu"
             or n.startswith("incubator_mxnet_tpu."))
print(bad)
"""


def test_port_predict_abi_loads_neither_jax_nor_the_jax_package(libs,
                                                               tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MXTPU_CAPI_CONTEXT="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _NO_JAX,
                        str(tmp_path / "m.mxtpu")], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "[]", r.stdout


_EXT = sorted(_port_tests("test_c_api_ext.py"))


@pytest.mark.parametrize("test", _EXT)
def test_reference_capi_ext_tests_hold(test, libs, tmp_path):
    """The JAX package's test_c_api_ext.py (the kvstore, NDArray file,
    symbol JSON and attribute, profiler and load_lib calls of the extended
    tier, in process), every name of the JAX package read as the
    port's."""
    fn = _port_tests("test_c_api_ext.py", lambda k: k == test)[test]
    given = {"lib": libs["port"], "tmp_path": tmp_path}
    with mxt.cpu():
        fn(*[given[p] for p in inspect.signature(fn).parameters])
