"""The port's ``visualization`` (``mx.viz``), ``engine`` and ``util``
against the JAX package's, on the CPU:

- ``plot_network``'s DOT source is equal byte for byte (a LeNet with
  BatchNorm, an unrolled LSTM LM); ``print_summary`` prints the same
  table and total on nets without BatchNorm. With BatchNorm it departs on
  purpose (``*_departs_*``): MXNet counts ``gamma`` and ``beta``; the JAX
  package also counts ``moving_mean``/``moving_var``, which are arguments
  there and auxiliary states here;
- ``engine.bulk``/``set_bulk_size`` and the initial size; the ``util``
  flags, scopes, decorators, ``getenv``/``setenv`` and ``inspect_tensor``'s
  stats and ``.npy`` file.
"""
import contextlib
import io
import threading

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _mlp(pkg):
    S = pkg.sym
    n = S.FullyConnected(S.var("data"), num_hidden=16, name="fc1")
    n = S.Activation(n, act_type="relu", name="relu1")
    n = S.FullyConnected(n, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(n, name="softmax")


def _convnet(pkg, bn):
    S = pkg.sym
    n = S.Convolution(S.var("data"), kernel=(3, 3), num_filter=6,
                      name="conv1")
    if bn:
        n = S.BatchNorm(n, fix_gamma=False, name="bn1")
    n = S.Activation(n, act_type="relu", name="relu1")
    n = S.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    n = S.FullyConnected(S.Flatten(n, name="flat"), num_hidden=10,
                         name="fc1")
    return S.SoftmaxOutput(n, name="softmax")


def _lstm_lm(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(8, prefix="lstm_l0_"))
    S = pkg.sym
    embed = S.Embedding(S.var("data"), input_dim=20, output_dim=8,
                        name="embed")
    out, _ = stack.unroll(3, embed, merge_outputs=True)
    pred = S.FullyConnected(S.reshape(out, shape=(-1, 8)), num_hidden=20,
                            name="pred")
    return S.SoftmaxOutput(pred, S.reshape(S.var("softmax_label"),
                                           shape=(-1,)), name="softmax")


NETS = {
    "mlp": (_mlp, {"data": (4, 12)}),
    "convnet": (lambda pkg: _convnet(pkg, False), {"data": (2, 1, 12, 12)}),
    "convnet_bn": (lambda pkg: _convnet(pkg, True), {"data": (2, 1, 12, 12)}),
    "lstm_lm": (_lstm_lm, {"data": (2, 3), "softmax_label": (2, 3)}),
}


def _summary(pkg, name):
    make, shape = NETS[name]
    net = make(pkg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        total = pkg.viz.print_summary(net, shape=shape)
    return total, out.getvalue()


@pytest.mark.parametrize("name", sorted(NETS))
def test_plot_network_is_the_references(name):
    make = NETS[name][0]
    want = mx.viz.plot_network(make(mx), title="net")
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    got = mxt.viz.plot_network(make(mxt), title="net")
    assert got == want and got.startswith("digraph net {")
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    assert mxt.viz.plot_network(make(mxt), hide_weights=False) == \
        mx.viz.plot_network(make(mx), hide_weights=False)


@pytest.mark.parametrize("name", ["mlp", "convnet", "lstm_lm"])
def test_print_summary_is_the_references(name):
    want = _summary(mx, name)
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    got = _summary(mxt, name)
    assert got == want
    assert got[0] > 0 and "Total params: %d" % got[0] in got[1]


def test_print_summary_departs_by_counting_batchnorm_as_mxnet():
    """bn1 over 6 channels: MXNet counts gamma and beta (12); the JAX
    package adds the moving statistics (24)."""
    jtotal, jtext = _summary(mx, "convnet_bn")
    ttotal, ttext = _summary(mxt, "convnet_bn")
    assert jtotal - ttotal == 12
    bn_rows = [[line for line in text.splitlines()
                if line.startswith("bn1 (BatchNorm)")][0]
               for text in (jtext, ttext)]
    assert "24" in bn_rows[0].split()
    assert "12" in bn_rows[1].split() and "24" not in bn_rows[1].split()
    assert [line for line in ttext.splitlines() if "conv1 (" in line] == \
        [line for line in jtext.splitlines() if "conv1 (" in line]


def test_print_summary_without_shapes_is_the_references():
    out = []
    for pkg in (mx, mxt):
        jsymm._NAME_COUNT.clear()
        tsymm._NAME_COUNT.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            total = pkg.viz.print_summary(_mlp(pkg))
        out.append((total, buf.getvalue()))
    assert out[0] == out[1] and out[1][0] == 0


def test_engine_bulk_is_the_references(monkeypatch):
    assert mxt.engine._BULK_SIZE[0] == mx.engine._BULK_SIZE[0] == 15
    for eng in (mx.engine, mxt.engine):
        prev = eng.set_bulk_size(4)
        assert prev == 15 and eng.set_bulk_size(prev) == 4
        with eng.bulk(32):
            assert eng._BULK_SIZE[0] == 32
            with eng.bulk(2):
                assert eng._BULK_SIZE[0] == 2
            assert eng._BULK_SIZE[0] == 32
        assert eng._BULK_SIZE[0] == 15
    monkeypatch.setenv("MXTPU_ENGINE_BULK_SIZE", "7")
    assert mxt.config.get_env("MXTPU_ENGINE_BULK_SIZE") == 7


def test_bulk_changes_no_result():
    x = mxt.nd.array(onp.arange(6.0, dtype="float32"), ctx=mxt.cpu())
    want = ((x * 2.0) + 1.0).asnumpy()
    with mxt.engine.bulk(64):
        got = ((x * 2.0) + 1.0).asnumpy()
    onp.testing.assert_array_equal(got, want)


def _flags(u):
    seen = [(u.is_np_shape(), u.is_np_array())]
    u.set_np()
    seen.append((u.is_np_shape(), u.is_np_array()))
    u.reset_np()
    seen.append((u.is_np_shape(), u.is_np_array()))
    with u.np_shape(True):
        seen.append((u.is_np_shape(), u.is_np_array()))
        with u.np_array(True):
            seen.append((u.is_np_shape(), u.is_np_array()))
    seen.append((u.is_np_shape(), u.is_np_array()))

    @u.use_np
    def both():
        return u.is_np_shape(), u.is_np_array()

    @u.np_array()
    def array_only():
        return u.is_np_shape(), u.is_np_array()
    seen += [both(), array_only(), (u.is_np_shape(), u.is_np_array())]
    seen.append(u.set_np_shape(True))
    seen.append(u.set_np_shape(False))
    other = []
    u.set_np()
    t = threading.Thread(target=lambda: other.append(u.is_np_array()))
    t.start()
    t.join()
    u.reset_np()
    return seen, other


def test_util_flags_and_scopes_are_the_references():
    assert _flags(mxt.util) == _flags(mx.util)
    assert _flags(mxt.util)[1] == [False]       # thread-local
    for name in ("is_np_array", "set_np", "reset_np", "np_shape",
                 "np_array"):
        assert getattr(mxt, name) is getattr(mxt.util, name)


def test_getenv_setenv_are_the_references(monkeypatch):
    monkeypatch.delenv("MXT_UTIL_PROBE", raising=False)
    assert mxt.util.getenv("MXT_UTIL_PROBE") is None
    mxt.util.setenv("MXT_UTIL_PROBE", "on")
    assert mxt.util.getenv("MXT_UTIL_PROBE") == mx.util.getenv(
        "MXT_UTIL_PROBE") == "on"
    monkeypatch.delenv("MXT_UTIL_PROBE")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_inspect_tensor_is_the_references(tmp_path, dtype):
    a = onp.random.RandomState(4).randn(5, 7).astype(dtype)
    if dtype == "float32":
        a[0, 0], a[1, 1] = onp.nan, onp.inf
    want = mx.util.inspect_tensor(mx.nd.array(a, dtype=dtype), tag="w",
                                  dump_dir=str(tmp_path / "j"), logger=False)
    got = mxt.util.inspect_tensor(mxt.nd.array(a, dtype=dtype, ctx=mxt.cpu()),
                                  tag="w", dump_dir=str(tmp_path / "t"),
                                  logger=False)
    assert repr(sorted(got.items())) == repr(sorted(want.items()))  # NaN std
    assert (got["nan_count"], got["inf_count"]) == \
        ((1, 1) if dtype == "float32" else (0, 0))
    onp.testing.assert_array_equal(onp.load(tmp_path / "t" / "w.npy"),
                                   onp.load(tmp_path / "j" / "w.npy"))
    import torch
    got = mxt.util.inspect_tensor(torch.from_numpy(a), logger=False)
    want = mx.util.inspect_tensor(a, logger=False)
    assert repr(sorted(got.items())) == repr(sorted(want.items()))
