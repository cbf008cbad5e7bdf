"""The port's Gluon and package surface against the JAX package's, on the
CPU: MXNet's ``hybrid_forward`` idiom, the names the reference exports and
the keywords it takes.

- ``hybrid_forward(self, F, x, **params)``: the case
  ``F.relu(self.fc(x)) + F.ones_like(x).sum()`` with ``fc`` a
  ``Dense(4, in_units=3)`` of ones on ``arange(6).reshape(2, 3)`` gives
  ``[[9] * 4, [18] * 4]`` exactly, eager, hybridized (on the CPU and
  through a CPU stand-in for the captured graphs) and inside
  ``jit.TrainStep`` (eager and through its captured path's stand-in), as
  the JAX package does; gradients, a TrainStep's loss and weights against
  the JAX package's within 1e-6 of the largest value; deferred shapes
  through ``_infer_param_shapes``.
- Every name listed in ROADMAP §3's F2 exists and gives the reference's
  value; every F3 keyword is accepted and does what the reference does.
"""
import io
import contextlib

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch.gluon import _functional

WANT = [[9.0] * 4, [18.0] * 4]


def _net_class(pkg):
    gluon = jgluon if pkg is mx else mxt.gluon

    class Net(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.relu(self.fc(x)) + F.ones_like(x).sum()
    return Net


def _f1_net(pkg):
    net = _net_class(pkg)()
    if pkg is mx:
        net.initialize(mx.init.One())
    else:
        net.initialize(mxt.init.One(), ctx=mxt.cpu())
    return net


def _x(pkg):
    if pkg is mx:
        return mx.nd.arange(6).reshape((2, 3))
    return mxt.nd.arange(6, ctx=mxt.cpu()).reshape((2, 3))


def _rel(got, ref, what="", tol=1e-6):
    got, ref = onp.asarray(got), onp.asarray(ref)
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(got - ref).max()) / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


# ================================================================ F1

def test_hybrid_forward_eager_is_the_references():
    want = _f1_net(mx)(_x(mx)).asnumpy()
    with mxt.cpu():
        got = _f1_net(mxt)(_x(mxt))
    assert isinstance(got, mxt.nd.NDArray)
    assert want.tolist() == WANT and got.asnumpy().tolist() == WANT


def test_hybrid_forward_hybridized_on_the_cpu():
    net = _f1_net(mxt)
    net.hybridize()
    with mxt.cpu():
        for _ in range(3):
            assert net(_x(mxt)).asnumpy().tolist() == WANT
    assert net._captures == 0


class _CpuGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        got = self.fn()
        with torch.no_grad():
            for o, g in zip(self.out, got):
                if o is not None and g is not None:
                    o.copy_(g)


class _Capture:
    """A CPU stand-in for ``jit._GraphCapture``: a capture runs the
    function (nothing it writes persists in this net), a replay runs it
    again into the captured outputs."""

    def __init__(self, device):
        self.pool = None

    def capture(self, fn, pool=None):
        out = fn()
        return _CpuGraph(fn, out), out


def test_hybrid_forward_through_the_captured_path(monkeypatch):
    """The hybridized call's card path on a stand-in: eager at the first
    call, captured at the second, replayed at the third; under
    ``record()`` too, with the gradients of the eager call."""
    monkeypatch.setattr(_functional, "_uses_graphs", lambda device: True)
    monkeypatch.setattr(tjit, "_GraphCapture", _Capture)
    net = _f1_net(mxt)
    net.hybridize()
    with mxt.cpu():
        for _ in range(3):
            assert net(_x(mxt)).asnumpy().tolist() == WANT
        assert net._captures == 1
        grads = []
        for _ in range(3):
            with mxt.autograd.record():
                out = net(_x(mxt))
            out.backward()
            assert out.asnumpy().tolist() == WANT
            grads.append(net.fc.weight.grad().asnumpy())
    assert net._captures == 2
    assert all(onp.array_equal(g, grads[0]) for g in grads)
    assert grads[0].tolist() == [[3.0, 5.0, 7.0]] * 4


def test_hybrid_forward_gradients_are_the_references():
    rng = onp.random.RandomState(0)
    w = rng.randn(4, 3).astype("float32")
    x = rng.randn(5, 3).astype("float32")
    got = {}
    for pkg in (mx, mxt):
        net = _f1_net(pkg)
        net.fc.weight.set_data(w if pkg is mx else mxt.nd.array(
            w, ctx=mxt.cpu()))
        ctx = {} if pkg is mx else dict(ctx=mxt.cpu())
        xs = pkg.nd.array(x, **ctx)
        xs.attach_grad()
        with pkg.autograd.record():
            out = net(xs)
            loss = (out * out).sum()
        loss.backward()
        got[pkg] = (out.asnumpy(), xs.grad.asnumpy(),
                    net.fc.weight.grad().asnumpy(),
                    net.fc.bias.grad().asnumpy())
    for a, b, what in zip(got[mxt], got[mx], ("out", "dx", "dw", "db")):
        _rel(a, b, what)


@pytest.mark.parametrize("captured", [False, True])
def test_hybrid_forward_inside_train_step(monkeypatch, captured):
    """TrainStep over the hybrid_forward net: the first step's forward is
    the case's value exactly; three SGD steps' losses and weights within
    1e-6 of the JAX package's TrainStep; the captured path (stand-in)
    equals the eager one bit for bit."""
    y = onp.full((2, 4), 10.0, "float32")
    jnet = _f1_net(mx)
    jstep = mx.jit.TrainStep(jnet, jgluon.loss.L2Loss(), jgluon.Trainer(
        jnet.collect_params(), "sgd", {"learning_rate": 0.001}))
    want = [jstep(_x(mx), mx.nd.array(y)).asnumpy() for _ in range(3)]
    net = _f1_net(mxt)
    net.hybridize()
    seen, l2 = [], mxt.gluon.loss.L2Loss()

    def loss_fn(out, label):
        seen.append(out.detach().clone())
        return l2(out, label)
    step = tjit.TrainStep(net, loss_fn, mxt.gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.001}))
    x = _x(mxt)
    if captured:
        from test_torch_jit import _cpu_capture
        monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step))
        args = step._prepare((x, mxt.nd.array(y, ctx=mxt.cpu())), 1)
        got = [step._replay(args, 1, 2).numpy() for _ in range(3)]
        assert step.captures == 1
    else:
        got = [step(x, mxt.nd.array(y, ctx=mxt.cpu())).asnumpy()
               for _ in range(3)]
    assert seen[0].tolist() == WANT
    for g, w in zip(got, want):
        _rel(g, w, "loss")
    _rel(net.fc.weight.data().asnumpy(), jnet.fc.weight.data().asnumpy(),
         "weight")
    _rel(net.fc.bias.data().asnumpy(), jnet.fc.bias.data().asnumpy(), "bias")


def _deferred_class(pkg):
    gluon = jgluon if pkg is mx else mxt.gluon

    class Scale(gluon.HybridBlock):
        def __init__(self, infer=True, **kwargs):
            super().__init__(**kwargs)
            self._infer = infer
            self.weight = self.params.get("weight", shape=(0,),
                                          allow_deferred_init=True)

        def _infer_param_shapes(self, x):
            if not self._infer:
                return super()._infer_param_shapes(x)
            self.weight.shape = (x.shape[1],)
            self.weight._finish_deferred_init()

        def hybrid_forward(self, F, x, weight):
            return F.broadcast_mul(x, weight.reshape((1, -1)))
    return Scale


def test_hybrid_forward_infers_deferred_shapes():
    x = onp.arange(6, dtype="float32").reshape(2, 3)
    outs = []
    for pkg in (mx, mxt):
        net = _deferred_class(pkg)()
        if pkg is mx:
            net.initialize(mx.init.Constant(2.0))
            outs.append(net(mx.nd.array(x)).asnumpy())
        else:
            net.initialize(mxt.init.Constant(2.0), ctx=mxt.cpu())
            with mxt.cpu():
                outs.append(net(mxt.nd.array(x, ctx=mxt.cpu())).asnumpy())
        assert tuple(net.weight.shape) == (3,)
    assert onp.array_equal(outs[0], outs[1])
    assert outs[1].tolist() == (x * 2).tolist()


def test_hybrid_forward_without_shape_inference_raises_as_the_reference():
    for pkg, err in ((mx, jgluon.DeferredInitializationError),
                     (mxt, mxt.gluon.DeferredInitializationError)):
        net = _deferred_class(pkg)(infer=False)
        if pkg is mx:
            net.initialize()
            x = mx.nd.ones((2, 3))
        else:
            net.initialize(ctx=mxt.cpu())
            x = mxt.nd.ones((2, 3), ctx=mxt.cpu())
        with pytest.raises(err):
            net(x)


def test_a_hybrid_block_without_a_forward_raises_as_the_reference():
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon

        class Empty(gluon.HybridBlock):
            pass
        with pytest.raises(NotImplementedError, match="hybrid_forward"):
            Empty().forward(None)


# ================================================================ F2

def test_nn_reexports_the_block_classes():
    for name in ("Block", "HybridBlock", "SymbolBlock"):
        assert hasattr(jgluon.nn, name)
        assert getattr(mxt.gluon.nn, name) is getattr(mxt.gluon, name)


def test_top_level_names():
    assert mxt.Optimizer is mxt.optimizer.Optimizer
    assert mxt.AttrScope is mxt.attribute.AttrScope
    assert mxt.NameManager is mxt.name.NameManager
    for name in ("Optimizer", "AttrScope", "NameManager"):
        assert getattr(mx, name).__name__ == getattr(mxt, name).__name__
    assert isinstance(mxt.optimizer.create("sgd"), mxt.Optimizer)
    for name in ("rnn", "profiler", "viz", "visualization", "engine", "util",
                 "is_np_array", "set_np", "reset_np", "np_shape",
                 "np_array"):
        assert hasattr(mx, name) and hasattr(mxt, name), name
    assert mxt.viz is mxt.visualization
    assert mxt.set_np is mxt.util.set_np


def test_models_get_model_is_the_model_zoos():
    assert mxt.models.get_model is mxt.gluon.model_zoo.vision.get_model
    assert mxt.models.SSD is mxt.models.ssd.SSD
    jnet = mx.models.get_model("resnet18_v1", classes=10)
    tnet = mxt.models.get_model("resnet18_v1", classes=10)
    assert type(jnet).__name__ == type(tnet).__name__
    assert sorted(jnet._collect_params_with_prefix()) == \
        sorted(tnet._collect_params_with_prefix())


def test_block_name_and_prefix_are_the_references():
    got = []
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        net = _net_class(pkg)(prefix="model_")
        with net.name_scope():
            extra = gluon.nn.Dense(2, in_units=3)
            seq = gluon.nn.HybridSequential()
        with seq.name_scope():
            inner = gluon.nn.Dense(2)
        a, b = gluon.nn.Dense(4, in_units=3), gluon.nn.Dense(4, in_units=3)
        top = (int(a.name[len("dense"):]), int(b.name[len("dense"):]))
        got.append((net.name, net.prefix, net.fc.name, net.fc.prefix,
                    extra.name, seq.name, inner.prefix,
                    top[1] - top[0], a.prefix == a.name + "_",
                    net.params.prefix))
        assert a.name.startswith("dense")
    assert got[0] == got[1]
    assert got[1][:4] == ("model", "model_", "model_dense0", "model_dense0_")
    assert got[1][4:7] == ("model_dense1", "model_hybridsequential0",
                           "model_hybridsequential0_dense0_")


def test_structural_keys_stay_as_they_were():
    net = _f1_net(mxt)
    assert sorted(net.collect_params().keys()) == ["fc.bias", "fc.weight"]


def test_block_summary_prints_the_references_line():
    printed = []
    for pkg in (mx, mxt):
        net = _net_class(pkg)(prefix="model_")
        if pkg is mx:
            net.initialize(mx.init.One())
        else:
            net.initialize(mxt.init.One(), ctx=mxt.cpu())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                (contextlib.nullcontext() if pkg is mx else mxt.cpu()):
            net.summary(_x(pkg))
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] and "model" in printed[1]


def test_infer_shape_finishes_deferred_parameters():
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(5), gluon.nn.Dense(2))
        if pkg is mx:
            net.initialize()
            net.infer_shape(mx.nd.ones((4, 7)))
        else:
            net.initialize(ctx=mxt.cpu())
            net.infer_shape(mxt.nd.ones((4, 7), ctx=mxt.cpu()))
        shapes = [tuple(p.shape) for p in net.collect_params().values()]
        assert shapes == [(5, 7), (5,), (2, 5), (2,)], (pkg, shapes)


def test_parameter_lists_reset_ctx_and_var():
    p = mxt.gluon.Parameter("w", shape=(2, 3))
    p.initialize(mxt.init.One(), ctx=mxt.cpu())
    assert len(p.list_data()) == 1 and p.list_data()[0] is p.data()
    assert p.list_grad()[0].asnumpy().tolist() == [[0.0] * 3] * 2
    t = p._tensor()
    p.reset_ctx(mxt.cpu())
    assert p._tensor() is t and p.list_ctx() == [mxt.cpu()]
    p.reset_ctx([mxt.cpu(0)])
    q = mxt.gluon.Parameter("q", shape=(0, 3), allow_deferred_init=True)
    q.initialize(ctx=mxt.cpu())
    q.reset_ctx(mxt.cpu())
    q.shape = (2, 3)
    q._finish_deferred_init()
    assert q.list_ctx() == [mxt.cpu()]
    jp = jgluon.Parameter("w", shape=(2, 3))
    jp.initialize(mx.init.One())
    assert len(jp.list_data()) == len(p.list_data())
    v = p.var()
    assert (v.name, v._shape) == ("w", (2, 3)) and v.is_var


def test_parameter_dict_setattr_save_load_reset_ctx_prefix(tmp_path):
    net = _f1_net(mxt)
    params = net.collect_params()
    params.setattr("grad_req", "null")
    assert {p.grad_req for p in params.values()} == {"null"}
    jnet = _f1_net(mx)
    jnet.collect_params().setattr("grad_req", "null")
    assert {p.grad_req for p in jnet.collect_params().values()} == {"null"}
    params.setattr("lr_mult", 0.5)
    assert {p.lr_mult for p in params.values()} == {0.5}
    with torch.no_grad():
        net.fc.weight._tensor().mul_(3.0)
    path = str(tmp_path / "f.params")
    params.save(path, strip_prefix="fc.")
    saved = mx.nd.load(path)                      # the JAX package reads it
    assert sorted(saved) == ["bias", "weight"]
    assert saved["weight"].asnumpy().tolist() == [[3.0] * 3] * 4
    fresh = _f1_net(mxt)
    fresh.collect_params().load(path, restore_prefix="fc.")
    assert fresh.fc.weight.data().asnumpy().tolist() == [[3.0] * 3] * 4
    with pytest.raises(ValueError):
        params.save(path, strip_prefix="nope.")
    with pytest.raises(AssertionError):
        fresh.collect_params().load(path)
    fresh.collect_params().load(path, allow_missing=True, ignore_extra=True)
    fresh.collect_params().reset_ctx(mxt.cpu())
    assert mxt.gluon.ParameterDict("net0_").prefix == "net0_"
    assert jgluon.ParameterDict("net0_").prefix == "net0_"


# ================================================================ F3

def test_embedding_sparse_grad_keeps_a_dense_gradient():
    ids = onp.array([[0, 2], [2, 3]], "float32")
    grads = []
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        emb = gluon.nn.Embedding(4, 3, sparse_grad=True)
        ctx = {} if pkg is mx else dict(ctx=mxt.cpu())
        if pkg is mx:
            emb.initialize(mx.init.One())
        else:
            emb.initialize(mxt.init.One(), ctx=mxt.cpu())
        with pkg.autograd.record():
            out = emb(pkg.nd.array(ids, **ctx))
        out.backward()
        grads.append(emb.weight.grad().asnumpy())
        assert emb.weight.grad().stype == "default"
    assert onp.array_equal(grads[0], grads[1])


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(momentum=0.9, lazy_update=True)),
    ("sgd", dict(lazy_update=False)),
    ("nag", dict(momentum=0.9, lazy_update=True))])
def test_optimizer_lazy_update_is_accepted(opt, kw):
    rng = onp.random.RandomState(1)
    w, g = rng.randn(4, 3).astype("float32"), rng.randn(4, 3) \
        .astype("float32")
    got = []
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        p = gluon.Parameter("w", shape=(4, 3))
        if pkg is mx:
            p.initialize()
            p.set_data(mx.nd.array(w))
        else:
            p.initialize(ctx=mxt.cpu())
            p.set_data(w)
        trainer = gluon.Trainer([p] if pkg is mxt else {"w": p}, opt,
                                dict(learning_rate=0.1, **kw))
        for _ in range(2):
            p.grad()[:] = g if pkg is mx else mxt.nd.array(g, ctx=mxt.cpu())
            trainer.step(1)
        got.append(p.data().asnumpy())
    _rel(got[1], got[0], "weight")
    assert mxt.optimizer.create(opt, **kw).lazy_update == kw["lazy_update"]


def test_parameter_differentiable_and_storage_types():
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        p = gluon.Parameter("w", shape=(2,), differentiable=False,
                            stype="default", grad_stype="row_sparse")
        assert p.grad_req == "null"
        assert gluon.Parameter("v", shape=(2,), stype="row_sparse") \
            .grad_req == "write"


def test_parameter_dict_prefix_and_shared():
    for pkg in (mx, mxt):
        gluon = jgluon if pkg is mx else mxt.gluon
        shared = gluon.ParameterDict()
        w = shared.get("w", shape=(2,))
        d = gluon.ParameterDict(prefix="", shared=shared)
        assert d.get("w", shape=(2,)) is w
        assert d.get("v", shape=(3,)) is not w
        assert gluon.ParameterDict(prefix="p_").prefix == "p_"


def test_steps_and_servable_take_model_id_and_data_axis():
    net = _f1_net(mxt)
    trainer = mxt.gluon.Trainer(net.collect_params(), "sgd")
    loss = mxt.gluon.loss.L2Loss()
    step = tjit.TrainStep(net, loss, trainer, data_axis="dp",
                          model_id="f1")
    assert step.data_axis == "dp" and step._model_id == "f1"
    ev = tjit.EvalStep(net, model_id="f1")
    assert ev._model_id == "f1"
    assert ev(_x(mxt)).asnumpy().tolist() == WANT
    servable = mxt.serving.BlockServable(net, model_id="f1")
    assert servable._model_id == "f1"
    mesh = mxt.parallel.make_mesh({"dp": 2}, devices=[torch.device("cpu")]
                                  * 2)
    try:
        step = tjit.TrainStep(net, loss, trainer, mesh=mesh, data_axis="dp")
        assert step.mesh is mesh and step.data_axis == "dp"
        with pytest.raises(ValueError, match="data_axis 'sp'"):
            tjit.TrainStep(net, loss, trainer, mesh=mesh, data_axis="sp")
    finally:
        mxt.parallel.set_current_mesh(None)


# ====================================================== test_utils, config

def test_simple_forward_and_check_consistency():
    def fn(a, b):
        return a * 2 + b
    x = onp.arange(4, dtype="float32")
    got = mxt.test_utils.simple_forward(fn, ctx=mxt.cpu(), a=x, b=x)
    want = mx.test_utils.simple_forward(fn, a=x, b=x)
    assert onp.array_equal(got, want)
    both = mxt.test_utils.simple_forward(
        lambda a: [a, a + 1], ctx=mxt.cpu(), a=x)
    assert isinstance(both, list) and len(both) == 2
    mxt.test_utils.check_consistency(
        lambda a: mxt.nd.exp(a), [x], ctx_list=[mxt.cpu(), mxt.cpu(0)],
        dtypes=("float32", "float16"), rtol=1e-2, atol=1e-2)
    with pytest.raises(AssertionError):
        mxt.test_utils.check_consistency(
            lambda a: a * (1.5 if a.dtype == onp.float16 else 1.0), [x + 1],
            ctx_list=[mxt.cpu()], dtypes=("float32", "float16"))


def test_config_describe_and_evict_to_bound(monkeypatch):
    text = mxt.config.describe()
    lines = text.splitlines()
    assert lines[0] == mx.config.describe().splitlines()[0]
    assert len(lines) == len(mxt.config.ENV_VARS) + 1
    assert all(name in text for name in mxt.config.ENV_VARS)
    monkeypatch.setenv("MXTPU_EXEC_CACHE_SIZE", "2")
    cache, gone = {}, []
    for k in "abc":
        cache[k] = k.upper()
        mxt.config.evict_to_bound(cache, lambda key, v: gone.append(key))
    assert list(cache) == ["b", "c"] and gone == ["a"]
    cache["b"] = cache.pop("b")                   # a hit moves to the end
    cache["d"] = "D"
    mxt.config.evict_to_bound(cache)
    assert list(cache) == ["b", "d"]


# ======================================================= the symbolic API

SYMBOLIC_NAMESPACES = ["sym", "sym.contrib", "mod", "io", "recordio", "image",
                       "kvstore", "model", "monitor", "executor",
                       "rnn", "rnn.rnn_cell", "rnn.io", "rnn.rnn",
                       "profiler", "viz", "visualization", "engine", "util"]


def _namespace(pkg, path):
    ns = pkg
    for part in path.split("."):
        ns = getattr(ns, part)
    return ns


def _params_of(fn):
    import inspect
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _takes(ref_fn, port_fn):
    """Whether ``port_fn`` takes every parameter ``ref_fn`` names."""
    want, got = _params_of(ref_fn), _params_of(port_fn)
    if want is None or got is None:
        return True
    return set(want) <= set(got) or "kwargs" in got or "kw" in got


@pytest.mark.parametrize("path", SYMBOLIC_NAMESPACES)
def test_symbolic_api_surface_is_the_references(path):
    """Every public name of the JAX package's namespace is in the port's
    (modules it merely imports aside), every class has the reference's
    public methods, and every function and method takes the reference's
    parameters. ``NDArray``, imported by several of these modules, is held
    by the array layer's own tests."""
    import inspect
    import types
    ref, port = _namespace(mx, path), _namespace(mxt, path)
    gaps = []
    for name in dir(ref):
        if name.startswith("_") or name == "NDArray":
            continue
        r = getattr(ref, name)
        if isinstance(r, types.ModuleType):
            continue
        if not hasattr(port, name):
            gaps.append(name)
            continue
        p = getattr(port, name)
        if inspect.isclass(r):
            for m in dir(r):
                if m.startswith("_") and m != "__init__":
                    continue
                if not hasattr(p, m):
                    gaps.append("%s.%s" % (name, m))
                elif callable(getattr(r, m)) and \
                        not _takes(getattr(r, m), getattr(p, m)):
                    gaps.append("%s.%s()" % (name, m))
        elif callable(r) and not _takes(r, p):
            gaps.append(name + "()")
    assert not gaps, gaps


def test_symbolic_api_pieces_waiting_for_other_items_name_them():
    """Nothing of the symbolic API waits any more: item 5's pieces (the
    dist stores, the server role, compression, several contexts) and item
    8's ``optimize_for`` (subgraph.py) are ported; an unregistered backend
    is refused, naming the registered ones."""
    assert isinstance(mxt.kvstore.create("dist_sync"),
                      mxt.kvstore.DistKVStore)
    assert mxt.kvstore.KVStoreServer(None).kvstore is None
    mxt.kvstore.create("local").set_gradient_compression({})

    class _Chain(mxt.subgraph.SubgraphProperty):
        name = "surface_chain"

        def match(self, node):
            return node._op_name in ("relu", "exp")
    mxt.subgraph.register_backend("surface_chain", _Chain)
    x = mxt.sym.var("x")
    part = mxt.sym.tanh(mxt.sym.exp(mxt.sym.relu(x))) \
        .optimize_for("surface_chain")
    assert [s._op_name for s in part.get_internals() if not s.is_var] == \
        ["_subgraph_surface_chain", "tanh"]
    v = mxt.nd.array([[-1.0, 0.5]], ctx=mxt.cpu())
    onp.testing.assert_allclose(part.eval(x=v)[0].asnumpy(),
                                onp.tanh(onp.exp([[0.0, 0.5]])), rtol=1e-6)
    with pytest.raises(ValueError, match="surface_chain"):
        mxt.sym.var("x").optimize_for("dnnl")
    assert len(mxt.mod.Module(mxt.sym.var("x"),
                              context=[mxt.cpu(0), mxt.cpu(1)])._contexts) == 2
    for top in ("sym", "symbol", "mod", "module", "io", "recordio", "image",
                "kv", "kvstore", "model", "save_checkpoint",
                "load_checkpoint", "FeedForward", "Executor", "monitor",
                "Monitor"):
        assert hasattr(mx, top) and hasattr(mxt, top), top
    assert mxt.sym is mxt.symbol and mxt.mod is mxt.module
    assert mxt.kv is mxt.kvstore and mxt.Monitor is mxt.monitor.Monitor


# ============================== serving, generation, aot and telemetry

SERVING_NAMESPACES = ["serving", "serving.batcher", "serving.registry",
                      "serving.server", "serving.accesslog",
                      "serving.resilience", "serving.generate",
                      "serving.metrics", "aot", "ops.kvcache", "telemetry",
                      "telemetry.registry", "telemetry.spans",
                      "telemetry.flightrec", "telemetry.watchdog",
                      "telemetry.faultlab", "telemetry.ringbuf",
                      "telemetry.trace"]


@pytest.mark.parametrize("path", SERVING_NAMESPACES)
def test_serving_surface_is_the_references(path):
    """Every public name of the JAX package's module is in the port's,
    every class has its public methods and every function takes its
    parameters; names the port has not ported raise when used, naming
    their item (``telemetry``'s five modules of item 7 on access,
    held by tests/test_torch_telemetry.py)."""
    import importlib
    import inspect
    import types
    ref, port = (_walk_root(pkg + "." + path)
                 for pkg in ("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch"))
    waiting = getattr(port, "WAITING", ())
    gaps = []
    for name in dir(ref):
        if name.startswith("_") or name in waiting or name == "annotations":
            continue
        r = getattr(ref, name)
        if isinstance(r, types.ModuleType) or (
                name in ("jax", "jnp") or getattr(r, "__module__", "")
                .startswith(("jax", "jaxlib"))):
            continue
        if not hasattr(port, name):
            gaps.append(name)
            continue
        p = getattr(port, name)
        if inspect.isclass(r):
            for m in dir(r):
                if m.startswith("_") and m != "__init__":
                    continue
                if not hasattr(p, m):
                    gaps.append("%s.%s" % (name, m))
                elif callable(getattr(r, m)) and \
                        not _takes(getattr(r, m), getattr(p, m)):
                    gaps.append("%s.%s()" % (name, m))
        elif callable(r) and not _takes(r, p):
            gaps.append(name + "()")
    assert not gaps, gaps


# ====================== F5: the class walk over the rest of the surface

CLASS_WALK_NAMESPACES = [
    "ndarray", "gluon", "gluon.nn", "gluon.rnn", "gluon.loss",
    "gluon.block", "gluon.parameter", "gluon.trainer", "optimizer",
    "initializer", "context", "base", "models", "models.bert", "models.gpt",
    "models.lenet", "models.lm_head", "models.lstm_lm", "models.ssd", "ops",
    "ops.attention", "ops.conv_bwd", "ops.ctc", "ops.deformable",
    "ops.detection", "ops.kvcache", "ops.lm_ce", "ops.multibox",
    "contrib.serving", "telemetry.devstats", "telemetry.profstats",
    "telemetry.numwatch", "telemetry.slo", "telemetry.history",
    "parallel", "parallel.compat", "parallel.mesh", "parallel.data_parallel",
    "parallel.tensor_parallel", "parallel.ring_attention",
    "parallel.ulysses", "parallel.moe", "parallel.pipeline",
    "parallel.pipeline_interleaved", "parallel.gluon_pipeline",
    "serving.sharded", "parallel.dist", "parallel.compression", "kvstore",
    "kvstore.kvstore", "kvstore.kvstore_server", "gluon.contrib",
    "gluon.contrib.nn", "gluon.contrib.cnn", "gluon.contrib.rnn",
    "gluon.contrib.data", "gluon.contrib.estimator", "contrib.svrg",
    "contrib.tensorboard", "numpy", "numpy.random", "numpy.linalg",
    "numpy_extension", "numpy_extension.image", "numpy_extension.random",
    "contrib.quantization", "contrib.onnx", "contrib.onnx_proto",
    "contrib.text", "operator", "torch", "library", "subgraph", "runtime",
    "native.capi"]

#: what the walk leaves out, each with its reason
WALK_EXCEPTIONS = {
    "NDArray": "imported by these modules from the array layer, walked in "
               "'ndarray'",
    "NDArray.grad_buf": "the JAX package's gradient buffer; the port keeps "
                        "a variable's gradient in grad() (_mx_grad on its "
                        "tensor, ROADMAP §3)",
    "ndarray.grad_buf": "mx.np's ndarray is an NDArray: the gradient "
                        "buffer, as NDArray.grad_buf",
    "np_ndarray.grad_buf": "mx.npx's import of mx.np's ndarray: as "
                           "NDArray.grad_buf",
    "Context": "imported from 'context', walked there",
    "current_context": "imported from 'context', walked there",
    "Context.jax_device": "a jax.Device; a port context maps onto "
                          "torch_device",
    "Block.forward()": "a port Block is a torch.nn.Module: forward is the "
                       "subclass's, and nn.Module's own stands in",
    "conv3x3_bwd_legal()": "the port's gate takes the input dtype (bf16 "
                           "and fp16 are both 2 bytes, and K4 routes "
                           "them apart), not the reference's itemsize",
}
#: the JAX package's built-in optimizers name update_rule's first two
#: parameters (w, g); the port's built-ins inherit the base's (weight,
#: grad), the hook's names in both packages: positional callers match
_UPDATE_RULE = "update_rule()"


def _takes_named(ref_fn, port_fn):
    """Whether ``port_fn`` takes every named parameter of ``ref_fn``. A
    reference catch-all (``*args``, ``**kw``) is not asked of the port:
    the port refuses keywords it does not implement rather than swallow
    them (ROADMAP §3 watch list). A port ``**kw`` takes any keyword and
    a port ``*args`` any positional."""
    import inspect
    try:
        want = inspect.signature(ref_fn).parameters.values()
        got = inspect.signature(port_fn).parameters
    except (TypeError, ValueError):
        return True
    kinds = {p.kind for p in got.values()}
    for p in want:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or p.name in got:
            continue
        if p.VAR_KEYWORD in kinds:
            continue
        if p.kind == p.POSITIONAL_OR_KEYWORD and p.VAR_POSITIONAL in kinds:
            continue
        return False
    return True


def _walk_root(dotted):
    """A module, or a namespace object of one (``numpy.random`` is mx.np's
    ``random`` object, not a module)."""
    import importlib
    try:
        return importlib.import_module(dotted)
    except ImportError:
        parent, attr = dotted.rsplit(".", 1)
        return getattr(importlib.import_module(parent), attr)


@pytest.mark.parametrize("path", CLASS_WALK_NAMESPACES)
def test_class_walk_surface_is_the_references(path):
    """F5: every public name of the JAX package's module is in the port's,
    every class has the reference's public methods, and every function
    and method takes the reference's named parameters, but for
    ``WALK_EXCEPTIONS`` (each with its reason) and the built-in
    optimizers' ``update_rule`` parameter names."""
    import importlib
    import inspect
    import types
    ref, port = (_walk_root(pkg + "." + path)
                 for pkg in ("incubator_mxnet_tpu", "incubator_mxnet_tpu_torch"))
    gaps = []

    def gap(name):
        if name not in WALK_EXCEPTIONS and not (
                name.endswith("." + _UPDATE_RULE) and path == "optimizer"):
            gaps.append(name)
    for name in dir(ref):
        if name.startswith("_") or name == "annotations":
            continue
        r = getattr(ref, name)
        if isinstance(r, types.ModuleType) or getattr(
                r, "__module__", "").startswith(("jax", "jaxlib", "numpy")):
            continue
        if not hasattr(port, name):
            gap(name)
            continue
        p = getattr(port, name)
        if inspect.isclass(r):
            for m in dir(r):
                if m.startswith("_") and m != "__init__":
                    continue
                if not hasattr(p, m):
                    gap("%s.%s" % (name, m))
                elif callable(getattr(r, m)) and \
                        not _takes_named(getattr(r, m), getattr(p, m)):
                    gap("%s.%s()" % (name, m))
        elif callable(r) and not _takes_named(r, p):
            gap(name + "()")
    assert not gaps, gaps


def test_walk_exceptions_are_still_needed():
    """Each named exception still names a real difference: a repaired
    one must leave the table."""
    assert not hasattr(mxt.nd.NDArray, "grad_buf")
    assert not hasattr(mxt.np.ndarray, "grad_buf")
    assert hasattr(mx.np.ndarray, "grad_buf")
    assert not hasattr(mxt.Context, "jax_device")
    import inspect
    from incubator_mxnet_tpu.ops import conv_bwd as jconv
    from incubator_mxnet_tpu_torch.ops import conv_bwd as tconv
    assert "itemsize" in inspect.signature(jconv.conv3x3_bwd_legal).parameters
    assert "itemsize" not in \
        inspect.signature(tconv.conv3x3_bwd_legal).parameters


# -------------------------------------------- F5a–F5f against the reference
def _f5a_optimizer(pkg):
    class Plain(pkg.optimizer.Optimizer):
        def create_state(self, index, weight):
            return None

        def update_rule(self, weight, grad, state, lr, wd, t):
            return weight - lr * grad, state
    return Plain


def test_f5a_a_user_update_rule_trains_through_trainer_as_the_reference():
    """ROADMAP §3 F5a's input: Dense(1, in_units=2, no bias) of ones, x =
    ones(1, 2), loss sum, learning_rate 0.5, one Trainer.step(1): the
    reference gives [[0.5, 0.5]], exactly."""
    got = {}
    for pkg, ctx in ((mx, None), (mxt, mxt.cpu())):
        net = pkg.gluon.nn.Dense(1, in_units=2, use_bias=False)
        kw = {"ctx": ctx} if ctx is not None else {}
        net.initialize(pkg.init.One(), **kw)
        tr = pkg.gluon.Trainer(net.collect_params(),
                               _f5a_optimizer(pkg)(learning_rate=0.5))
        x = pkg.nd.ones((1, 2), **kw)
        with pkg.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(1)
        got[pkg.__name__] = net.weight.data().asnumpy()
    assert onp.array_equal(got["incubator_mxnet_tpu"], [[0.5, 0.5]])
    assert onp.array_equal(got["incubator_mxnet_tpu_torch"],
                           got["incubator_mxnet_tpu"])


def test_f5a_update_rule_through_the_update_ops_and_a_captured_step(
        monkeypatch):
    """The same rule through ``Optimizer.update`` (the update ops' path,
    with a state tensor written in place) and through ``TrainStep``, eager
    and through the CPU stand-in of its CUDA graph: a rule of torch ops
    captures, and each agrees with the reference's ``update``."""
    from test_torch_aot import CpuCapture

    class Momentum(mxt.optimizer.Optimizer):
        def create_state(self, index, weight):
            return torch.zeros_like(weight)

        def update_rule(self, weight, grad, state, lr, wd, t):
            mom = 0.9 * state - lr * grad
            return weight + mom, mom

    class JMomentum(mx.optimizer.Optimizer):
        def create_state(self, index, weight):
            return mx.nd.zeros(weight.shape)

        def update_rule(self, weight, grad, state, lr, wd, t):
            mom = 0.9 * state._data - lr * grad
            return weight + mom, mx.nd.NDArray(mom)
    w0 = onp.arange(4, dtype="float32").reshape(2, 2)
    g = onp.full((2, 2), 0.5, "float32")
    jopt, topt = JMomentum(learning_rate=0.1), Momentum(learning_rate=0.1)
    jw, tw = mx.nd.array(w0), torch.tensor(w0)
    jst, tst = jopt.create_state(0, jw), topt.create_state(0, tw)
    for _ in range(2):
        jst = jopt.update(0, jw, mx.nd.array(g), jst)
        topt.update(0, tw, torch.tensor(g), tst)
    assert onp.allclose(tw.numpy(), jw.asnumpy(), rtol=0, atol=1e-6)
    assert onp.allclose(tst.numpy(), jst.asnumpy(), rtol=0, atol=1e-6)

    def step_weights(graphs):
        net = mxt.gluon.nn.Dense(2, in_units=2, use_bias=False)
        net.initialize(mxt.init.Constant(0.5), ctx=mxt.cpu())
        tr = mxt.gluon.Trainer(net.collect_params(),
                               Momentum(learning_rate=0.1))
        step = tjit.TrainStep(net, lambda out, y: ((out - y) ** 2).sum(),
                              tr)
        x = torch.tensor(w0)
        for _ in range(3):
            step(x, torch.zeros(2, 2))
        return net.weight.data().asnumpy()
    eager = step_weights(False)
    monkeypatch.setattr(tjit, "_uses_graphs", lambda device: True)
    monkeypatch.setattr(tjit, "_GraphCapture", CpuCapture)
    assert onp.array_equal(step_weights(True), eager)


@pytest.mark.parametrize("name", ["Zero", "One", "Constant", "Uniform",
                                  "Normal", "Orthogonal", "Xavier",
                                  "MSRAPrelu", "LSTMBias"])
def test_f5b_initializer_dumps_and_init_weight_by_name(name):
    """F5b: ``dumps()`` gives the reference's string on every class (the
    ROADMAP input ``Xavier(magnitude=2)`` among them) and
    ``init_weight_by_name`` dispatches as ``__call__``."""
    kw = {"Xavier": {"magnitude": 2}, "Constant": {"value": 0.25},
          "Orthogonal": {"scale": 1.0}}.get(name, {})
    port, ref = getattr(mxt.init, name)(**kw), getattr(mx.init, name)(**kw)
    assert port.dumps() == ref.dumps()
    if name == "Xavier":
        assert port.dumps() == ('["xavier", {"rnd_type": "uniform", '
                                '"factor_type": "avg", "magnitude": 2}]')
    arr = torch.full((4,), 7.0)
    port.init_weight_by_name("fc_bias", arr)
    assert torch.equal(arr, torch.zeros(4))
    port.init_weight_by_name("bn_gamma", arr)
    assert torch.equal(arr, torch.ones(4))


def test_f5c_context_device_typeid_and_empty_cache():
    """F5c: cpu().device_typeid is 1 and empty_cache() returns None, as
    the reference; gpu() is 2 (the card's path frees the caching
    allocator's idle blocks)."""
    assert mxt.cpu().device_typeid == mx.cpu().device_typeid == 1
    assert mxt.gpu(0).device_typeid == mx.gpu(0).device_typeid
    assert mxt.cpu().empty_cache() is None and mx.cpu().empty_cache() is None


def test_f5d_parameterdict_initialize_verbose(caplog):
    """F5d: ``verbose=True`` initializes the same parameters as without
    it, and logs each one with its initializer."""
    import logging
    nets = []
    for verbose in (False, True):
        net = mxt.gluon.nn.Dense(3, in_units=2)
        with caplog.at_level(logging.INFO):
            net.collect_params().initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                                            verbose=verbose)
        nets.append(net)
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert torch.equal(a._tensor(), b._tensor())
    assert "xavier" in caplog.text
    ref = jgluon.nn.Dense(3, in_units=2)
    ref.collect_params().initialize(mx.init.Xavier(), verbose=True)


def test_f5e_registry_alias_and_keys():
    """F5e: ``alias`` registers a class under extra names, ``create`` of an
    alias builds it, and ``keys`` lists the names, as the reference's."""
    got = []
    for base in (mxt.base, mx.base):
        reg = base.Registry("x")

        @reg.alias("y", "z")
        class Thing:
            pass
        assert isinstance(reg.create("y"), Thing)
        assert "z" in reg
        got.append(sorted(reg.keys()))
    assert got[0] == got[1] == ["thing", "y", "z"]


def test_f5f_ndarray_constructor_takes_any_array_and_a_context():
    """F5f: ``nd.NDArray(numpy.ones(3), ctx=cpu())`` is an NDArray on
    cpu(0), float32 as the reference's; a tensor is wrapped without a
    copy."""
    a = mxt.nd.NDArray(onp.ones(3), ctx=mxt.cpu())
    r = mx.nd.NDArray(onp.ones(3), ctx=mx.cpu())
    assert a.context == mxt.cpu(0) and str(a.dtype) == str(r.dtype)
    assert onp.array_equal(a.asnumpy(), r.asnumpy())
    t = torch.ones(2)
    assert mxt.nd.NDArray(t)._data is t
    assert mxt.nd.NDArray([1, 2], ctx=mxt.cpu()).dtype == \
        mx.nd.NDArray(onp.array([1, 2], "float32")).dtype


def test_f5f_tile_keywords_are_accepted_and_checked():
    """F5f: flash_attention's block_q/block_k and conv3x3_bwd's
    block_n/interpret are the reference's TPU knobs: a valid tile changes
    nothing (Hopper's tiles are the kernels' own), an impossible one
    raises (a departure logged in ROADMAP §3), and interpret (None or a
    bool) changes nothing: CPU tensors take the plain version, CUDA
    tensors launch K4 either way (test_torch_conv_bwd.py)."""
    from incubator_mxnet_tpu_torch.ops import attention, conv_bwd
    rng = onp.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(1, 2, 64, 64).astype("float32"))
               for _ in range(3))
    base = attention.flash_attention(q, k, v, causal=True)
    tiled = attention.flash_attention(q, k, v, causal=True, block_q=128,
                                      block_k=64)
    assert torch.equal(base, tiled)
    assert attention.flash_attention_legal(q.shape, block_q=64)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="block_q"):
            attention.flash_attention(q, k, v, block_q=bad)
        with pytest.raises(ValueError, match="block_k"):
            attention.flash_attention_lse(q, k, v, block_k=bad)
    x = torch.tensor(rng.randn(1, 4, 4, 8).astype("float32"))
    dy = torch.tensor(rng.randn(1, 4, 4, 8).astype("float32"))
    w = torch.tensor(rng.randn(3, 3, 8, 8).astype("float32"))
    plain = conv_bwd.conv3x3_bwd(x, dy, w)
    for kw in ({"block_n": 2}, {"interpret": True},
               {"block_n": 1, "interpret": False}):
        got = conv_bwd.conv3x3_bwd(x, dy, w, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="block_n"):
        conv_bwd.conv3x3_bwd(x, dy, w, block_n=0)
    with pytest.raises(ValueError, match="interpret"):
        conv_bwd.conv3x3_bwd(x, dy, w, interpret="yes")
