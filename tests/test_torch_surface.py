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
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tjit.TrainStep(net, loss, trainer, mesh=object(), data_axis="dp")


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
    monkeypatch.setenv("MXTPU_AOT_CACHE_SIZE", "2")
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
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.kvstore.create("dist_sync")
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.kvstore.KVStoreServer(None)
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.kvstore.create("local").set_gradient_compression({})
    with pytest.raises(NotImplementedError, match="item 8"):
        mxt.sym.var("x").optimize_for("dnnl")
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.mod.Module(mxt.sym.var("x"), context=[mxt.cpu(0), mxt.cpu(1)])
    for top in ("sym", "symbol", "mod", "module", "io", "recordio", "image",
                "kv", "kvstore", "model", "save_checkpoint",
                "load_checkpoint", "FeedForward", "Executor", "monitor",
                "Monitor"):
        assert hasattr(mx, top) and hasattr(mxt, top), top
    assert mxt.sym is mxt.symbol and mxt.mod is mxt.module
    assert mxt.kv is mxt.kvstore and mxt.Monitor is mxt.monitor.Monitor
