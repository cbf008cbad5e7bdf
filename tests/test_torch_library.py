"""``library``, ``subgraph`` and ``runtime`` of the port against the JAX
package's, on the CPU.

``library.register_op`` with a gradient (a ``torch.autograd.Function``
behind ``nd._apply``) gives the JAX package's forward and custom backward;
``library.load`` reads a ``.py`` plugin. ``subgraph.partition`` of a
conv/BN/relu graph gives the JAX package's subgraph nodes, outputs and
gradients (fp32, 1e-5), and a partitioned graph binds from its data's
shape alone (the parameters' shape rules cross subgraph nodes).
``runtime.Features`` has the JAX package's keys.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm

CPU = mxt.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _arr(pkg, a):
    return pkg.nd.array(a, ctx=CPU) if pkg is mxt else pkg.nd.array(a)


# ================================================================ library

def _scaled_sin(pkg):
    """f(x, y) = x·sin(y) with a custom (straight-through) gradient: the
    backward gives (g·2, g·x), not autodiff's."""
    def fn(x, y):
        return x * pkg.nd.sin(y)

    def grad(inputs, g):
        x, _ = inputs
        return [g * 2.0, g * x]
    return fn, grad


def test_register_op_with_gradient_is_the_references():
    rng = onp.random.RandomState(1)
    x, y = rng.randn(3, 4), rng.randn(3, 4)
    got = {}
    for pkg in (mx, mxt):
        op = pkg.library.register_op("lib_scaled_sin", *_scaled_sin(pkg))
        try:
            a, b = _arr(pkg, x), _arr(pkg, y)
            a.attach_grad()
            b.attach_grad()
            with pkg.autograd.record():
                out = pkg.nd.lib_scaled_sin(a, b)
                loss = (out * out).sum()
            loss.backward()
            assert pkg.nd.lib_scaled_sin is op
            assert hasattr(pkg.sym, "lib_scaled_sin")
            got[pkg] = [out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]
        finally:
            pkg.library.unregister_op("lib_scaled_sin")
        assert not hasattr(pkg.nd, "lib_scaled_sin")
        assert not hasattr(pkg.sym, "lib_scaled_sin")
    out = x * onp.sin(y)
    onp.testing.assert_allclose(got[mxt][0], out, **TOL)
    onp.testing.assert_allclose(got[mxt][1], 2 * out * 2.0, **TOL)
    onp.testing.assert_allclose(got[mxt][2], 2 * out * x, **TOL)
    for g, r in zip(got[mxt], got[mx]):
        onp.testing.assert_allclose(g, r, **TOL)


def test_register_op_in_a_symbol_and_shadowing_a_builtin():
    fn, grad = _scaled_sin(mxt)
    mxt.library.register_op("lib_scaled_sin", fn, grad)
    try:
        s = mxt.sym.lib_scaled_sin(mxt.sym.var("x"), mxt.sym.var("y"))
        v = onp.full((2, 2), 0.5, "float32")
        (out,) = s.eval(x=_arr(mxt, v), y=_arr(mxt, v))
        onp.testing.assert_allclose(out.asnumpy(), v * onp.sin(v), **TOL)
    finally:
        mxt.library.unregister_op("lib_scaled_sin")
    builtin = mxt.nd.relu
    mxt.library.register_op("relu", lambda x: x * 0.0)
    assert mxt.nd.relu is not builtin
    mxt.library.unregister_op("relu")
    assert mxt.nd.relu is builtin and mxt.sym.relu is not None
    with pytest.raises(ValueError, match="builtin"):
        mxt.library.unregister_op("relu")


def test_load_a_plugin_with_a_gradient(tmp_path):
    plugin = tmp_path / "lib_cube.py"
    plugin.write_text(
        "from incubator_mxnet_tpu_torch import library\n"
        "library.register_op('lib_cube', lambda x: x * x * x,\n"
        "                    gradient=lambda ins, g: [g * 3 * ins[0] * "
        "ins[0]])\n")
    mod = mxt.library.load(str(plugin))
    assert mod.__name__ == "lib_cube"
    try:
        a = _arr(mxt, [1.0, -2.0])
        a.attach_grad()
        with mxt.autograd.record():
            y = mxt.nd.lib_cube(a)
        y.backward()
        onp.testing.assert_allclose(y.asnumpy(), [1.0, -8.0])
        onp.testing.assert_allclose(a.grad.asnumpy(), [3.0, 12.0])
    finally:
        mxt.library.unregister_op("lib_cube")
    with pytest.raises(ValueError, match="not found"):
        mxt.library.load(str(tmp_path / "none.py"))
    with pytest.raises(ValueError, match="unsupported"):
        mxt.library.load(str(plugin.with_suffix(".py").parent))


# =============================================================== subgraph

def _chain_backend(pkg):
    class _ConvChain(pkg.subgraph.SubgraphProperty):
        name = "lib_conv_chain"

        def __init__(self):
            self.nodes = []

        def match(self, node):
            return node._op_name in ("Convolution", "BatchNorm",
                                     "Activation")

        def create_subgraph_op(self, fn, nodes):
            self.nodes.append([n._op_name for n in nodes])
            return fn
    pkg.subgraph.register_backend("lib_conv_chain", _ConvChain)
    return _ConvChain


def _convnet(pkg):
    S = pkg.sym
    n = S.var("data")
    for i in range(2):
        n = S.Convolution(n, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="c%d" % i)
        n = S.BatchNorm(n, fix_gamma=False, name="bn%d" % i)
        n = S.Activation(n, act_type="relu", name="r%d" % i)
        if i == 0:
            n = S.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max")
    n = S.FullyConnected(S.Flatten(n), num_hidden=5, name="fc")
    return S.SoftmaxOutput(n, name="softmax")


X = onp.random.RandomState(0).randn(4, 3, 8, 8).astype("float32")
Y = onp.array([0, 3, 1, 4], "float32")


def _bound(pkg, sym, params):
    # the JAX package's subgraph node hands its parameters the shape rule
    # of the node's first input, not of their own operator's data: it is
    # given every shape (ROADMAP §3, reference faults)
    kw = {"ctx": CPU} if pkg is mxt else \
        {k: v.shape for k, v in params.items()}
    ex = sym.simple_bind(data=X.shape, softmax_label=Y.shape, **kw)
    aux = getattr(ex, "aux_dict", {})
    ex.copy_params_from(
        {k: _arr(pkg, v) for k, v in params.items() if k not in aux},
        {k: _arr(pkg, v) for k, v in params.items() if k in aux} or None)
    out = ex.forward(is_train=True, data=_arr(pkg, X),
                     softmax_label=_arr(pkg, Y))[0].asnumpy()
    ex.backward()
    return out, {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if k not in ("data", "softmax_label")}


def test_partition_is_the_references():
    """Both chains become one subgraph node each (the JAX package's
    grouping), and the partitioned graphs give the unpartitioned outputs
    and gradients in both packages; the port's equal the JAX package's."""
    backends = {pkg: _chain_backend(pkg) for pkg in (mx, mxt)}
    ex = _convnet(mxt).simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    rng = onp.random.RandomState(3)
    params = {k: (rng.rand(*v.shape) + 0.5 if k.endswith("moving_var")
                  else rng.randn(*v.shape) * 0.3).astype("float32")
              for k, v in sorted({**ex.arg_dict, **ex.aux_dict}.items())
              if k not in ("data", "softmax_label")}
    got = {}
    for pkg in (mx, mxt):
        net = _convnet(pkg)
        prop = backends[pkg]()
        part = pkg.subgraph.partition(net, prop)
        ops = [s._op_name for s in part.get_internals() if not s.is_var]
        assert ops.count("_subgraph_lib_conv_chain") == 2, ops
        assert not {"Convolution", "BatchNorm", "Activation"} & set(ops)
        chain = ["Convolution", "BatchNorm", "Activation"]
        # the port hands a subgraph's members over in graph order
        assert [n if pkg is mxt else sorted(n) for n in prop.nodes] == \
            [chain if pkg is mxt else sorted(chain)] * 2
        assert sorted(part.list_inputs()) == sorted(net.list_inputs())
        plain = _bound(pkg, net, params)
        fused = _bound(pkg, part, params)
        onp.testing.assert_allclose(fused[0], plain[0], **TOL)
        for k in plain[1]:
            onp.testing.assert_allclose(fused[1][k], plain[1][k], **TOL)
        got[pkg] = fused
    onp.testing.assert_allclose(got[mxt][0], got[mx][0], **TOL)
    scale = max(float(onp.abs(g).max()) for g in got[mx][1].values())
    for k, g in got[mxt][1].items():      # held to the largest gradient
        assert float(onp.abs(g - got[mx][1][k]).max()) / scale <= 1e-5, k


def test_partitioned_graph_binds_and_trains_through_module():
    """simple_bind of a partitioned graph from the data's shape alone (the
    conv and BN parameters take their shapes inside the subgraph nodes),
    and Module.fit over it."""
    _chain_backend(mxt)
    part = _convnet(mxt).optimize_for("lib_conv_chain")
    args, outs, aux = part.infer_shape(data=X.shape, softmax_label=Y.shape)
    named = dict(zip(part.list_arguments(), args))
    assert named["c1_weight"] == (4, 4, 3, 3) and named["bn1_gamma"] == (4,)
    assert named["fc_weight"] == (5, 64) and outs == [(4, 5)]
    assert aux == [(4,)] * 4
    mod = mxt.mod.Module(part, context=CPU)
    it = mxt.io.NDArrayIter(X, Y, batch_size=2)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    assert onp.isfinite(mod.get_outputs()[0].asnumpy()).all()
    assert part.get_backend_symbol("lib_conv_chain").list_inputs() == \
        part.list_inputs()


# ================================================================ runtime

def test_features_have_the_references_keys():
    import torch
    ref, port = mx.runtime.Features(), mxt.runtime.Features()
    assert set(port) == set(ref)
    assert [f.name for f in mxt.runtime.feature_list()] == list(port)
    for key in ("TPU", "XLA", "PALLAS"):
        assert not port.is_enabled(key)
    assert port.is_enabled("cuda") == torch.cuda.is_available()
    assert port.is_enabled("CUDNN") == torch.backends.cudnn.is_available()
    assert port.is_enabled("NATIVE_RECORDIO") == \
        mxt.native.lib.available()
    assert repr(port["BF16"]) == "[✔ BF16]"
    with pytest.raises(RuntimeError, match="unknown"):
        port.is_enabled("SPARSE_DOT")
