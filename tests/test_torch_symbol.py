"""The port's symbolic API (``mx.sym``, ``Executor``) against the JAX
package's, on the CPU.

- Name parity: every public ``nd`` callable of the port outside the
  exclusion table has a ``mx.sym`` mirror, the exclusion table is the JAX
  package's, and every public name of the JAX package's ``mx.sym`` (and of
  its ``linalg``/``random``/``sparse`` namespaces) is in the port's.
- Execution parity (``tests/test_sym_parity.py`` on the port): each entry
  of the port's sweep table built as a Symbol, bound with ``simple_bind``
  and run through ``Executor.forward`` equals the eager ``nd`` result
  within 1e-6 (float32).
- Compose, ``infer_shape`` and graph JSON: the same graph gives the same
  argument, output and auxiliary names, the same output shapes, and the
  same JSON bytes in both packages (auto-name counters reset); JSON written
  by either package loads in the other and gives the same outputs within
  1e-5 of the largest value.
- ``Executor``: forward outputs and the updated BatchNorm moving
  statistics against the JAX Executor's on the same parameters and data,
  within 1e-5 of the largest value, and the gradient of every argument
  within 1e-5 of the network's largest gradient; ``"add"``
  requests sum two backwards; symbolic ``foreach``/``while_loop``/``cond``.
- Departures, held to MXNet (``*_departs_*``): BatchNorm's moving
  statistics are auxiliary states, not arguments; ``infer_shape`` infers
  the parameter variables' shapes from the data.
- Aliasing: a fed array and a ``copy_params_from`` source stay the
  caller's; the bound buffers never change identity.
"""
import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm
from incubator_mxnet_tpu.symbol import _SYM_EXCLUDE as J_EXCLUDE

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.base import public_op_names
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm
from incubator_mxnet_tpu_torch.symbol import _SYM_EXCLUDE
from incubator_mxnet_tpu_torch.test_utils import (_norm_outputs,
                                                  _sweep_table, sweep_inputs)

TOL = 1e-5
CPU = mxt.cpu()


def _close(got, want, what="", tol=TOL):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(onp.abs(got - want).max()) / scale if got.size else 0.0
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _tarr(a):
    return mxt.nd.array(a, ctx=CPU)


# ============================================================ name parity

def test_sym_name_parity():
    eligible = public_op_names(mxt.nd, exclude=_SYM_EXCLUDE)
    missing = [n for n in eligible if not hasattr(mxt.sym, n)]
    assert not missing, missing
    assert _SYM_EXCLUDE == J_EXCLUDE
    stale = [n for n in _SYM_EXCLUDE if not hasattr(mxt.nd, n)]
    assert not stale, stale
    ref = [n for n in dir(mx.sym) if not n.startswith("_")]
    assert not [n for n in ref if not hasattr(mxt.sym, n)]
    for ns in ("linalg", "random", "sparse"):
        # the JAX package's sym.linalg also wraps the NDArray class that its
        # nd.linalg imports: a class, not an operator
        names = [n for n in vars(getattr(mx.sym, ns))
                 if not n.startswith("_") and n != "NDArray"]
        assert not [n for n in names
                    if not hasattr(getattr(mxt.sym, ns), n)], ns


def test_sym_namespace_is_wide():
    names = [n for n in dir(mxt.sym) if not n.startswith("_")]
    assert len(names) >= 260, len(names)


def test_sym_exclusion_reasons_documented():
    for name, reason in _SYM_EXCLUDE.items():
        assert isinstance(reason, str) and len(reason) > 5, (name, reason)


def _sym_entries():
    rows = []
    for entry in _sweep_table():
        name, fn, specs, opts = entry if len(entry) == 4 else (*entry, {})
        if opts.get("sym", True):
            rows.append((name, fn, specs, opts))
    return rows


_ENTRIES = _sym_entries()


@pytest.mark.parametrize("entry", _ENTRIES, ids=[e[0] for e in _ENTRIES])
def test_sym_execution_parity(entry):
    """Each table op as a Symbol graph through simple_bind and
    Executor.forward, against the eager nd result."""
    _, fn, specs, opts = entry
    nd = mxt.nd
    inputs = sweep_inputs(specs, seed=0)
    if opts.get("seed"):
        nd.random.seed(0)
    with CPU:
        ref = _norm_outputs(fn(nd, *[_tarr(x) for x in inputs]))
    names = ["in%d" % i for i in range(len(specs))]
    s = fn(mxt.sym, *[mxt.sym.var(n) for n in names])
    if isinstance(s, (list, tuple)):
        s = mxt.sym.Group(list(s))
    ex = s.simple_bind(CPU, **{n: tuple(x.shape)
                               for n, x in zip(names, inputs)})
    if opts.get("seed"):
        nd.random.seed(0)
    outs = ex.forward(**{n: _tarr(x) for n, x in zip(names, inputs)})
    flat = []
    for o in outs:
        flat.extend(_norm_outputs(o))
    assert len(flat) == len(ref), (len(flat), len(ref))
    for a, b in zip(flat, ref):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ============================================================ graphs

def _net(pkg, split=True):
    S = pkg.sym
    d = S.var("data")
    n = S.Convolution(d, kernel=(3, 3), num_filter=4, pad=(1, 1))
    n = S.BatchNorm(n, fix_gamma=False)
    n = S.Activation(n, act_type="relu")
    if split:
        n = S.concat(n * 0.5, S.slice_axis(n, axis=1, begin=0, end=2),
                     dim=1)
    n = S.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max")
    n = S.Flatten(n)
    n = S.FullyConnected(n, num_hidden=5)
    n = (n * 2.0 + 1.0) / 3.0 - S.ones_like(n) * 0.5
    return S.SoftmaxOutput(n, name="softmax")


def _params(shapes, seed=3):
    rng = onp.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("moving_var"):
            out[name] = (rng.rand(*shapes[name]) + 0.5).astype("float32")
        else:
            out[name] = (rng.randn(*shapes[name]) * 0.3).astype("float32")
    return out


X = onp.random.RandomState(0).randn(4, 3, 6, 6).astype("float32")
Y = onp.array([0, 3, 1, 4], "float32")


def test_compose_names_and_outputs_are_the_references():
    j, t = _net(mx), _net(mxt)
    assert t.list_inputs() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert [s.name for s in t.get_internals()] == \
        [s.name for s in j.get_internals()]
    grp_j = mx.sym.Group([j, mx.sym.var("extra")])
    grp_t = mxt.sym.Group([t, mxt.sym.var("extra")])
    assert grp_t.list_outputs() == grp_j.list_outputs()
    v_j = mx.sym.var("w", lr_mult=0.5, wd_mult=2)
    v_t = mxt.sym.var("w", lr_mult=0.5, wd_mult=2)
    assert (v_t + 1).attr_dict() == (v_j + 1).attr_dict()


def test_list_arguments_departs_by_listing_aux_states_apart():
    """MXNet lists BatchNorm's moving statistics as auxiliary states; the
    JAX package lists them among the arguments and has no auxiliary
    states."""
    j, t = _net(mx), _net(mxt)
    aux = ["batchnorm0_moving_mean", "batchnorm0_moving_var"]
    assert all(a in j.list_arguments() for a in aux)
    assert j.list_auxiliary_states() == []
    assert t.list_auxiliary_states() == aux
    assert t.list_arguments() == [a for a in j.list_arguments()
                                  if a not in aux]


def test_infer_shape_is_the_references():
    j, t = _net(mx), _net(mxt)
    ex = t.simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    shapes = {k: v.shape for k, v in
              list(ex.arg_dict.items()) + list(ex.aux_dict.items())}
    ja, jo, _ = j.infer_shape(**shapes)
    ta, to, tx = t.infer_shape(**shapes)
    assert to == jo == [(4, 5)]
    assert dict(zip(t.list_arguments(), ta)) == \
        {k: v for k, v in zip(j.list_arguments(), ja)
         if k in t.list_arguments()}
    assert tx == [(4,), (4,)]


def test_infer_shape_departs_by_inferring_parameter_shapes():
    """MXNet infers a layer's parameter shapes from the data's; the JAX
    package returns Nones unless every argument's shape is given."""
    j, t = _net(mx), _net(mxt)
    assert j.infer_shape(data=X.shape, softmax_label=Y.shape) == \
        (None, None, None)
    args, outs, aux = t.infer_shape(data=X.shape, softmax_label=Y.shape)
    got = dict(zip(t.list_arguments(), args))
    assert got["convolution0_weight"] == (4, 3, 3, 3)
    assert got["fullyconnected0_weight"] == (5, 54)
    assert outs == [(4, 5)] and aux == [(4,), (4,)]
    assert t.infer_shape(softmax_label=Y.shape) == (None, None, None)


def test_json_is_the_references_byte_for_byte():
    assert _net(mxt).tojson() == _net(mx).tojson()
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    a, b = mx.sym.var("a"), mxt.sym.var("a")
    assert mxt.sym.Group([b * 2, b - 1]).tojson() == \
        mx.sym.Group([a * 2, a - 1]).tojson()


def _bind_pair(jsym, tsym, params, train=False):
    jex = jsym.simple_bind(data=X.shape, softmax_label=Y.shape)
    jex.copy_params_from({k: mx.nd.array(v) for k, v in params.items()})
    tex = tsym.simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    aux = {k: v for k, v in params.items() if k in tex.aux_dict}
    tex.copy_params_from({k: v for k, v in params.items() if k not in aux},
                         aux)
    jo = jex.forward(is_train=train, data=mx.nd.array(X),
                     softmax_label=mx.nd.array(Y))
    to = tex.forward(is_train=train, data=_tarr(X), softmax_label=_tarr(Y))
    return jex, tex, jo, to


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_written_by_either_package_loads_in_the_other(tmp_path, writer):
    f = str(tmp_path / "net-symbol.json")
    (_net(mx) if writer == "jax" else _net(mxt)).save(f)
    jsym, tsym = mx.sym.load(f), mxt.sym.load(f)
    assert tsym.list_auxiliary_states() == ["batchnorm0_moving_mean",
                                            "batchnorm0_moving_var"]
    ex = tsym.simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    params = _params({k: v.shape for k, v in
                      list(ex.arg_dict.items()) + list(ex.aux_dict.items())})
    _, _, jo, to = _bind_pair(jsym, tsym, params)
    _close(to[0].asnumpy(), jo[0].asnumpy(), "loaded forward")


def test_executor_forward_and_gradients_are_the_references():
    jsym, tsym = _net(mx), _net(mxt)
    ex = tsym.simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    params = _params({k: v.shape for k, v in
                      list(ex.arg_dict.items()) + list(ex.aux_dict.items())})
    jex, tex, jo, to = _bind_pair(jsym, tsym, params, train=True)
    _close(to[0].asnumpy(), jo[0].asnumpy(), "forward")
    jex.backward()
    tex.backward()
    assert "softmax_label" not in tex.grad_dict
    # the conv bias before batch norm has a gradient of zero up to
    # rounding: every gradient is held within 1e-5 of the network's largest
    scale = max(float(onp.abs(g.asnumpy()).max())
                for g in jex.grad_dict.values())
    for k, g in tex.grad_dict.items():
        want = jex.grad_dict[k].asnumpy()
        err = float(onp.abs(g.asnumpy() - want).max()) / scale
        assert err <= TOL, (k, err)
    for k, v in tex.aux_dict.items():
        _close(v.asnumpy(), jex.arg_dict[k].asnumpy(), k)


def test_executor_add_request_sums_two_backwards():
    t = _net(mxt, split=False)
    ex = t.simple_bind(CPU, grad_req="add", data=X.shape,
                       softmax_label=Y.shape)
    params = _params({k: v.shape for k, v in ex.arg_dict.items()})
    ex.copy_params_from(params)
    ex.forward(is_train=True, data=X, softmax_label=Y)
    ex.backward()
    once = ex.grad_dict["fullyconnected0_weight"].asnumpy().copy()
    ex.forward(is_train=True, data=X, softmax_label=Y)
    ex.backward()
    _close(ex.grad_dict["fullyconnected0_weight"].asnumpy(), 2 * once, "add")


def test_executor_buffers_are_never_the_callers():
    """Feeding copies into the bound buffer and copy_params_from copies
    in: writing the caller's arrays afterwards changes nothing bound."""
    t = _net(mxt, split=False)
    ex = t.simple_bind(CPU, data=X.shape, softmax_label=Y.shape)
    buf = ex.arg_dict["data"]
    fed = _tarr(X)
    ex.forward(data=fed, softmax_label=_tarr(Y))
    fed[:] = 7.0
    assert ex.arg_dict["data"] is buf
    onp.testing.assert_array_equal(buf.asnumpy(), X)
    src = _tarr(onp.ones((5, 36), "float32"))
    ex.copy_params_from({"fullyconnected0_weight": src})
    src[:] = -1.0
    assert float(ex.arg_dict["fullyconnected0_weight"].asnumpy().min()) == 1.0


def test_bind_with_given_arrays_uses_them():
    a, b = mxt.sym.var("a"), mxt.sym.var("b")
    c = a * b + 1
    arrs = {"a": _tarr(onp.full((2, 2), 2.0, "float32")),
            "b": _tarr(onp.full((2, 2), 3.0, "float32"))}
    grads = {"a": _tarr(onp.zeros((2, 2), "float32")),
             "b": _tarr(onp.zeros((2, 2), "float32"))}
    ex = c.bind(CPU, args=arrs, args_grad=grads)
    assert ex.arg_dict["a"] is arrs["a"]
    out = ex.forward(is_train=True)
    ex.backward(_tarr(onp.ones((2, 2), "float32")))
    assert out[0].asnumpy().tolist() == [[7.0, 7.0]] * 2
    assert grads["a"].asnumpy().tolist() == [[3.0, 3.0]] * 2
    jc = mx.sym.var("a") * mx.sym.var("b") + 1
    assert jc.eval(a=mx.nd.array(onp.full((2, 2), 2.0)),
                   b=mx.nd.array(onp.full((2, 2), 3.0)))[0].asnumpy() \
        .tolist() == c.eval(a=arrs["a"], b=arrs["b"])[0].asnumpy().tolist()


def _cf_graphs(pkg):
    S = pkg.sym
    x = S.var("x")
    w = S.var("w")

    def body(d, states):
        h = states[0] * 0.5 + d * w
        return h * 2.0, [h]

    outs, states = S.contrib.foreach(body, x, [S.zeros_like(x[0])])
    loop_out, loop_vars = S.contrib.while_loop(
        lambda i, s: i < 3.0, lambda i, s: (s * 1.0, [i + 1.0, s + i]),
        [S.var("i"), S.var("s")], max_iterations=5)
    c = S.contrib.cond(S.var("p"), lambda: w * 3.0, lambda: w - 3.0)
    return S.Group([outs, states[0], loop_vars[1], c])


def test_symbolic_control_flow_is_the_references():
    rng = onp.random.RandomState(5)
    feed = {"x": rng.randn(3, 2).astype("float32"),
            "w": rng.randn(2).astype("float32"),
            "i": onp.zeros((1,), "float32"), "s": onp.ones((1,), "float32"),
            "p": onp.ones((1,), "float32")}
    want = _cf_graphs(mx).eval(**{k: mx.nd.array(v) for k, v in feed.items()})
    got = _cf_graphs(mxt).eval(**{k: _tarr(v) for k, v in feed.items()})
    for g, w in zip(got, want):
        _close(g.asnumpy(), w.asnumpy(), "control flow")


def test_sub_namespaces_build_and_run():
    a = mxt.sym.var("a")
    g = mxt.sym.linalg.gemm2(a, a, transpose_b=True)
    x = onp.random.RandomState(1).randn(3, 3).astype("float32")
    got = g.eval(a=_tarr(x))[0].asnumpy()
    _close(got, x @ x.T, "linalg.gemm2")
    with pytest.raises(NotImplementedError, match="eager"):
        mxt.sym.sparse.cast_storage(a, "csr")
    assert mxt.sym.random.uniform(shape=(2,)).list_arguments() == []
