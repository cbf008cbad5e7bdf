"""The port's Module trainers, checkpoints, kvstore, monitor and the pieces
that waited for them, against the JAX package's, on the CPU.

- ``Module.fit``: a LeNet-sized symbolic net (conv, batch norm, pooling,
  two fully connected layers, SoftmaxOutput) from the same parameters
  through three SGD-momentum steps (lr 0.1, momentum 0.9, wd 1e-4,
  ``rescale_grad`` 1/batch by default) in both packages: the per-step
  cross-entropy, the weights and the moving statistics within 1e-5 of the
  largest value (float32 summation order); one step's gradients and the
  momenta of the optimizer states file within 1e-4 of the largest
  gradient or momentum (the conv bias before batch norm has a zero
  gradient up to rounding, and the conv weight's gradient differs by
  ~2.4e-5 between the packages' float32 reduction orders). The states
  file of either package loads in the other; an inference bind gives the
  label zeros of the batch.
- Checkpoints: ``save_checkpoint`` right after setting the same parameters
  writes the same ``-symbol.json`` and ``.params`` bytes in both packages;
  a checkpoint written by either loads in the other (``Module.load``,
  ``load_checkpoint``, ``SymbolBlock.imports``) and gives the same
  outputs within 1e-5; ``do_checkpoint``/``module_checkpoint``.
- ``BucketingModule`` (``Embedding`` → mean → ``FullyConnected`` →
  ``SoftmaxOutput``, two bucket keys) and ``FeedForward`` against the JAX
  package's over three steps, within 1e-5; ``SequentialModule`` against
  the JAX package's ``Module`` over the whole chain. Departures, held to
  MXNet (``*_departs_*``): the buckets hold one parameter set (the same
  tensors), MXNet's sharing; ``SequentialModule`` passes the gradient back
  to its first module, whose gradients the JAX package leaves at zero.
- The local kvstore's push/pull/updater against the JAX package's; the
  ``dist*`` stores raise naming ROADMAP item 5; ``Monitor`` stats.
- Aliasing, one test per site where an in-place tensor could carry a write
  across (the JAX package shares buffers there because its arrays are
  immutable): kvstore ``pull`` and ``push``, ``Module.init_params`` /
  ``set_params``, the executor's feed, and the monitor's queued outputs.
"""
import filecmp
import logging
import os
import pickle

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm

TOL = 1e-5
STATE_TOL = 1e-4
CPU = mxt.cpu()
BATCH = 8


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


def _pkg_ctx(pkg):
    return mx.cpu() if pkg is mx else CPU


def _arr(pkg, a):
    return mx.nd.array(a) if pkg is mx else mxt.nd.array(a, ctx=CPU)


def lenet(pkg):
    S = pkg.sym
    d = S.var("data")
    n = S.Convolution(d, kernel=(3, 3), num_filter=6, name="conv1")
    n = S.BatchNorm(n, fix_gamma=False, name="bn1")
    n = S.Activation(n, act_type="relu", name="relu1")
    n = S.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    n = S.Flatten(n, name="flat")
    n = S.FullyConnected(n, num_hidden=16, name="fc1")
    n = S.Activation(n, act_type="tanh", name="tanh1")
    n = S.FullyConnected(n, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(n, name="softmax")


RNG = onp.random.RandomState(0)
X = RNG.rand(3 * BATCH, 1, 12, 12).astype("float32")
Y = RNG.randint(0, 10, 3 * BATCH).astype("float32")


def _lenet_params():
    """The same parameters for both packages (moving statistics too)."""
    t = lenet(mxt)
    ex = t.simple_bind(CPU, data=(BATCH, 1, 12, 12), softmax_label=(BATCH,))
    tsymm._NAME_COUNT.clear()
    rng = onp.random.RandomState(1)
    arg, aux = {}, {}
    for k, v in sorted(ex.arg_dict.items()):
        if k not in ("data", "softmax_label"):
            arg[k] = (rng.randn(*v.shape) * 0.2).astype("float32")
    for k, v in sorted(ex.aux_dict.items()):
        aux[k] = (rng.rand(*v.shape) + 0.5).astype("float32") \
            if k.endswith("var") else rng.randn(*v.shape).astype("float32")
    return arg, aux


def _fit(pkg, tmp_path, epochs=1, **fit_kw):
    arg, aux = _lenet_params()
    it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH)
    mod = pkg.mod.Module(lenet(pkg), context=_pkg_ctx(pkg))
    losses = []

    def record(param):
        p = mod.get_outputs()[0].asnumpy()
        lbl = Y[param.nbatch * BATCH:(param.nbatch + 1) * BATCH].astype(int)
        losses.append(float(-onp.log(p[onp.arange(BATCH), lbl]).mean()))

    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={k: _arr(pkg, v) for k, v in arg.items()},
            aux_params={k: _arr(pkg, v) for k, v in aux.items()},
            batch_end_callback=record, **fit_kw)
    states = str(tmp_path / ("%s.states" % pkg.__name__))
    mod.save_optimizer_states(states)
    return mod, losses, states


def test_module_fit_is_the_references(tmp_path):
    jmod, jl, jst = _fit(mx, tmp_path)
    tmod, tl, tst = _fit(mxt, tmp_path)
    assert len(tl) == len(jl) == 3
    _close(tl, jl, "losses")
    ja, jx = jmod.get_params()
    ta, tx = tmod.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ta:
        _close(ta[k].asnumpy(), ja[k].asnumpy(), k)
    for k in tx:
        _close(tx[k].asnumpy(), jx[k].asnumpy(), k)
    with open(jst, "rb") as f:
        js = pickle.load(f)
    with open(tst, "rb") as f:
        ts = pickle.load(f)
    assert sorted(js) == sorted(ts) == list(range(len(ta)))
    # the conv bias before batch norm has a zero gradient up to rounding:
    # each momentum is held within STATE_TOL of the largest of all momenta
    scale = max(float(onp.abs(v).max()) for v in js.values())
    for k in js:
        err = float(onp.abs(ts[k] - js[k]).max()) / scale
        assert err <= STATE_TOL, ("momentum %d" % k, err)


def test_module_loads_the_references_optimizer_states(tmp_path):
    """The JAX package's states file, loaded by the port, continues
    training as the JAX package does."""
    jmod, _, jst = _fit(mx, tmp_path)
    tmod, _, _ = _fit(mxt, tmp_path)
    tmod.load_optimizer_states(jst)
    it_j = mx.io.NDArrayIter(X[:BATCH], Y[:BATCH], batch_size=BATCH)
    it_t = mxt.io.NDArrayIter(X[:BATCH], Y[:BATCH], batch_size=BATCH)
    ja, jx = jmod.get_params()
    tmod.set_params({k: mxt.nd.array(v.asnumpy(), ctx=CPU)
                     for k, v in ja.items()},
                    {k: mxt.nd.array(v.asnumpy(), ctx=CPU)
                     for k, v in jx.items()})
    for mod, it in ((jmod, it_j), (tmod, it_t)):
        mod.forward_backward(next(iter(it)))
        mod.update()
    for k, v in tmod.get_params()[0].items():
        _close(v.asnumpy(), jmod.get_params()[0][k].asnumpy(), k)


def test_module_load_restores_the_optimizer_states(tmp_path):
    prefix = str(tmp_path / "lenet")
    tmod, _, states = _fit(mxt, tmp_path)
    tmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    back = mxt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=CPU)
    it = mxt.io.NDArrayIter(X, Y, batch_size=BATCH)
    back.bind(it.provide_data, it.provide_label)
    back.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    assert sorted(back._updater_states) == sorted(tmod._updater_states)
    for k, v in tmod._updater_states.items():
        assert torch.equal(back._updater_states[k], v)
    with open(states, "rb") as a, open(prefix + "-0001.states", "rb") as b:
        assert a.read() == b.read()


def test_module_defaults_to_the_card_and_refuses_several_contexts():
    sym = lenet(mxt)
    with CPU:
        assert mxt.mod.Module(sym)._context == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mxt.mod.Module(sym)
    else:
        assert mxt.mod.Module(sym)._context == mxt.gpu(0)
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.mod.Module(sym, context=[CPU, mxt.cpu(1)])


def _bound(pkg, arg, aux, for_training=True):
    mod = pkg.mod.Module(lenet(pkg), context=_pkg_ctx(pkg))
    it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label, for_training=for_training)
    mod.init_params(arg_params={k: _arr(pkg, v) for k, v in arg.items()},
                    aux_params={k: _arr(pkg, v) for k, v in aux.items()})
    return mod, it


def test_module_backward_gradients_are_the_references():
    """One Module.forward_backward from the same parameters: every
    gradient within STATE_TOL of the network's largest (the conv bias
    before batch norm is zero up to rounding; the conv weight's gradient
    sums 800 products through batch norm's backward in each package's
    float32 order, 2.4e-5 apart)."""
    arg, aux = _lenet_params()
    grads = []
    for pkg in (mx, mxt):
        mod, it = _bound(pkg, arg, aux)
        mod.forward_backward(next(iter(it)))
        grads.append({k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
                      if k in arg})
    assert sorted(grads[1]) == sorted(arg)
    scale = max(float(onp.abs(v).max()) for v in grads[0].values())
    for k, v in grads[1].items():
        assert float(onp.abs(v - grads[0][k]).max()) / scale <= STATE_TOL, k


def test_inference_bind_gives_the_label_zeros_of_the_batch():
    arg, aux = _lenet_params()
    outs = []
    for pkg in (mx, mxt):
        mod = pkg.mod.Module(lenet(pkg), context=_pkg_ctx(pkg))
        it = pkg.io.NDArrayIter(X, None, batch_size=BATCH)
        mod.bind(it.provide_data, None, for_training=False)
        mod.set_params({k: _arr(pkg, v) for k, v in arg.items()},
                       {k: _arr(pkg, v) for k, v in aux.items()})
        assert mod._exec.arg_dict["softmax_label"].shape == (BATCH,)
        outs.append(mod.predict(it).asnumpy())
    _close(outs[1], outs[0], "inference predict")


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    arg, aux = _lenet_params()
    for pkg in (mx, mxt):
        mod, _ = _bound(pkg, arg, aux)
        mod.save_checkpoint(str(tmp_path / pkg.__name__), 3)
    for suffix in ("-symbol.json", "-0003.params"):
        assert filecmp.cmp(str(tmp_path / ("incubator_mxnet_tpu" + suffix)),
                           str(tmp_path / ("incubator_mxnet_tpu_torch"
                                           + suffix)), shallow=False), suffix


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(tmp_path, writer):
    prefix = str(tmp_path / "lenet")
    wpkg, rpkg = (mx, mxt) if writer == "jax" else (mxt, mx)
    wmod, _, _ = _fit(wpkg, tmp_path)
    wmod.save_checkpoint(prefix, 1)
    want = wmod.predict(wpkg.io.NDArrayIter(X, Y, batch_size=BATCH))
    rmod = rpkg.mod.Module.load(prefix, 1, context=_pkg_ctx(rpkg))
    it = rpkg.io.NDArrayIter(X, Y, batch_size=BATCH)
    rmod.bind(it.provide_data, it.provide_label, for_training=False)
    got = rmod.predict(it)
    _close(got.asnumpy(), want.asnumpy(), "predict")
    sym, arg, aux = rpkg.load_checkpoint(prefix, 1)
    assert sorted(aux) == ["bn1_moving_mean", "bn1_moving_var"]
    assert "fc1_weight" in arg and "bn1_moving_mean" not in arg


def test_symbol_block_imports_equals_module_predict(tmp_path):
    prefix = str(tmp_path / "lenet")
    tmod, _, _ = _fit(mxt, tmp_path)
    tmod.save_checkpoint(prefix, 1)
    want = tmod.predict(mxt.io.NDArrayIter(X, None, batch_size=BATCH))
    # the label is an input of the graph (SoftmaxOutput ignores it outside
    # training), not a parameter in the file
    names = ["data", "softmax_label"]
    blk = mxt.gluon.SymbolBlock.imports(prefix + "-symbol.json", names,
                                        prefix + "-0001.params", ctx=CPU)
    lbl = onp.zeros(len(X), "float32")
    with mxt.autograd.predict_mode():
        got = blk(mxt.nd.array(X, ctx=CPU), mxt.nd.array(lbl, ctx=CPU))
    _close(got.asnumpy(), want.asnumpy(), "SymbolBlock")
    jblk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", names,
                                        prefix + "-0001.params")
    _close(got.asnumpy(), jblk(mx.nd.array(X), mx.nd.array(lbl)).asnumpy(),
           "JAX SymbolBlock")
    assert blk.bn1_moving_mean.grad_req == "null"
    assert blk.fc1_weight.grad_req == "write"


def test_symbol_block_infers_deferred_shapes_and_trains():
    d = mxt.sym.var("data")
    out = mxt.sym.FullyConnected(d, num_hidden=3, name="fc")
    blk = mxt.gluon.SymbolBlock(out, d)
    blk.initialize(mxt.init.One(), ctx=CPU)
    x = mxt.nd.array(onp.ones((2, 4), "float32"), ctx=CPU)
    with mxt.autograd.record():
        y = blk(x)
    y.backward()
    assert y.asnumpy().tolist() == [[4.0] * 3] * 2
    assert blk.fc_weight.grad().asnumpy().tolist() == [[2.0] * 4] * 3
    p = mxt.gluon.Parameter("w", shape=(2, 3))
    v, jv = p.var(), mx.gluon.Parameter("w", shape=(2, 3)).var()
    assert v.name == jv.name == "w" and v._shape == jv._shape == (2, 3)


def test_callbacks_write_checkpoints_the_reference_reads(tmp_path):
    arg, aux = _lenet_params()
    mod, _ = _bound(mxt, arg, aux)
    mxt.callback.module_checkpoint(mod, str(tmp_path / "m"), period=2)(1)
    ta, tx = mod.get_params()
    mxt.callback.do_checkpoint(str(tmp_path / "d"))(0, mod.symbol, ta, tx)
    for prefix, epoch in (("m", 2), ("d", 1)):
        sym, jarg, jaux = mx.load_checkpoint(str(tmp_path / prefix), epoch)
        assert sorted(sym.list_arguments()) == sorted(
            mod.symbol.list_inputs())
        for k, v in arg.items():
            onp.testing.assert_array_equal(jarg[k].asnumpy(), v)
        for k, v in aux.items():
            onp.testing.assert_array_equal(jaux[k].asnumpy(), v)


# ========================================================== other modules

def _bucket_sym_gen(pkg):
    def sym_gen(seq_len):
        S = pkg.sym
        d = S.var("data")
        e = S.Embedding(d, input_dim=20, output_dim=6, name="embed")
        m = S.mean(e, axis=1)
        fc = S.FullyConnected(m, num_hidden=4, name="fc")
        return S.SoftmaxOutput(fc, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def _bucketing(pkg, keys=(5, 7, 5)):
    rng = onp.random.RandomState(2)
    bm = pkg.mod.BucketingModule(_bucket_sym_gen(pkg), default_bucket_key=5,
                                 context=_pkg_ctx(pkg))
    desc = pkg.io.DataDesc
    bm.bind([desc("data", (4, 5))], [desc("softmax_label", (4,))])
    w_rng = onp.random.RandomState(3)
    bm.init_params(arg_params={
        "embed_weight": _arr(pkg, w_rng.randn(20, 6).astype("float32")),
        "fc_weight": _arr(pkg, w_rng.randn(4, 6).astype("float32")),
        "fc_bias": _arr(pkg, onp.zeros(4, "float32"))})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.5})
    outs = []
    for key in keys:
        data = rng.randint(0, 20, (4, key)).astype("float32")
        label = rng.randint(0, 4, 4).astype("float32")
        batch = pkg.io.DataBatch(
            [_arr(pkg, data)], [_arr(pkg, label)], bucket_key=key,
            provide_data=[desc("data", (4, key))],
            provide_label=[desc("softmax_label", (4,))])
        bm.forward(batch, is_train=True)
        bm.backward()
        bm.update()
        outs.append(bm.get_outputs()[0].asnumpy())
    return bm, outs


def test_bucketing_module_is_the_references():
    jbm, jouts = _bucketing(mx)
    tbm, touts = _bucketing(mxt)
    for g, w in zip(touts, jouts):
        _close(g, w, "outputs")
    ja, _ = jbm.get_params()
    for k, v in tbm.get_params()[0].items():
        _close(v.asnumpy(), ja[k].asnumpy(), k)


def test_bucketing_module_departs_by_sharing_one_parameter_set():
    """MXNet's buckets bind on the default bucket's memory: one set of
    parameter tensors, gradients and optimizer states (the JAX package
    copies the parameters at each switch and keeps states per bucket)."""
    tbm, _ = _bucketing(mxt)
    a, b = tbm._buckets[5], tbm._buckets[7]
    for name in ("embed_weight", "fc_weight", "fc_bias"):
        assert a._exec.arg_dict[name] is b._exec.arg_dict[name]
        assert a._exec.grad_dict[name] is b._exec.grad_dict[name]
    assert a._updater_states is b._updater_states
    assert a._optimizer is b._optimizer


SEQ_RNG = onp.random.RandomState(4)
SEQ_X = SEQ_RNG.randn(12, 5).astype("float32")
SEQ_Y = SEQ_RNG.randint(0, 3, 12).astype("float32")


def _seq_params(pkg):
    w = onp.random.RandomState(5)
    return {"fc1_weight": _arr(pkg, w.randn(8, 5).astype("float32")),
            "fc1_bias": _arr(pkg, w.randn(8).astype("float32")),
            "fc2_weight": _arr(pkg, w.randn(3, 8).astype("float32")),
            "fc2_bias": _arr(pkg, w.randn(3).astype("float32"))}


def _seq_parts(pkg):
    S = pkg.sym
    m1 = S.Activation(S.FullyConnected(S.var("data"), num_hidden=8,
                                       name="fc1"), act_type="relu")
    m2 = S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=3,
                                          name="fc2"), name="softmax")
    return m1, m2


def _train3(pkg, mod, steps=3):
    """Three SGD steps (lr 0.2); the outputs and the first step's
    gradients."""
    it = pkg.io.NDArrayIter(SEQ_X, SEQ_Y, batch_size=4)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_seq_params(pkg))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2})
    outs, grads = [], None
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.backward()
        if grads is None:
            execs = [m._exec for m in getattr(mod, "_modules", [mod])]
            grads = {k: v.asnumpy().copy() for ex in execs
                     for k, v in ex.grad_dict.items() if k != "data"}
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs, grads


def _sequential(pkg):
    m1, m2 = _seq_parts(pkg)
    ctx = _pkg_ctx(pkg)
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(m1, label_names=None, context=ctx))
    seq.add(pkg.mod.Module(m2, context=ctx), take_labels=True)
    return _train3(pkg, seq)


def _whole(pkg):
    S = pkg.sym
    n = S.Activation(S.FullyConnected(S.var("data"), num_hidden=8,
                                      name="fc1"), act_type="relu")
    n = S.SoftmaxOutput(S.FullyConnected(n, num_hidden=3, name="fc2"),
                        name="softmax")
    return _train3(pkg, pkg.mod.Module(n, context=_pkg_ctx(pkg)))


def test_sequential_module_equals_the_references_module_of_the_chain():
    """The chain of two modules trains as one Module over the whole graph,
    the JAX package's Module being the oracle (its SequentialModule
    departs below)."""
    jmod, jouts, _ = _whole(mx)
    tseq, touts, _ = _sequential(mxt)
    assert len(touts) == 3
    for g, w in zip(touts, jouts):
        _close(g, w, "outputs")
    ja, _ = jmod.get_params()
    for k, v in tseq.get_params()[0].items():
        _close(v.asnumpy(), ja[k].asnumpy(), k)


def test_sequential_module_departs_by_passing_gradients_back():
    """MXNet's SequentialModule passes the second module's input gradient
    back as the first module's head gradient; the JAX package's leaves the
    first module's gradients at zero. The port's equal the chain rule's."""
    _, _, jgrads = _sequential(mx)
    _, _, tgrads = _sequential(mxt)
    p = {k: v.asnumpy() for k, v in _seq_params(mxt).items()}
    x, y = SEQ_X[:4], SEQ_Y[:4].astype(int)
    h = x @ p["fc1_weight"].T + p["fc1_bias"]
    z = onp.maximum(h, 0) @ p["fc2_weight"].T + p["fc2_bias"]
    e = onp.exp(z - z.max(1, keepdims=True))
    dz = e / e.sum(1, keepdims=True) - onp.eye(3)[y]
    dh = (dz @ p["fc2_weight"]) * (h > 0)
    assert not jgrads["fc1_weight"].any()
    _close(tgrads["fc1_weight"], dh.T @ x, "fc1_weight")
    _close(tgrads["fc1_bias"], dh.sum(0), "fc1_bias")
    _close(tgrads["fc2_weight"], jgrads["fc2_weight"], "fc2_weight")


def test_feed_forward_is_the_references(tmp_path):
    arg, aux = _lenet_params()
    preds = []
    for pkg in (mx, mxt):
        onp.random.seed(7)
        ff = pkg.FeedForward(
            lenet(pkg), ctx=_pkg_ctx(pkg), num_epoch=1, numpy_batch_size=BATCH,
            learning_rate=0.05,
            arg_params={k: _arr(pkg, v) for k, v in arg.items()},
            aux_params={k: _arr(pkg, v) for k, v in aux.items()})
        ff.fit(X, Y)
        preds.append(ff.predict(X))
        ff.save(str(tmp_path / pkg.__name__))
    _close(preds[1], preds[0], "FeedForward.predict")
    back = mxt.FeedForward.load(str(tmp_path / "incubator_mxnet_tpu"), 1,
                                ctx=CPU, numpy_batch_size=BATCH)
    _close(back.predict(X), preds[0], "FeedForward.load")


# ================================================================ kvstore

def _kv_run(pkg):
    kv = pkg.kv.create("local")
    shape = (2, 3)
    kv.init(3, _arr(pkg, onp.ones(shape, "float32")))
    kv.push(3, [_arr(pkg, onp.full(shape, v, "float32")) for v in (1, 2)])
    out = _arr(pkg, onp.zeros(shape, "float32"))
    kv.pull(3, out=out)
    first = out.asnumpy().copy()
    kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1))
    kv.push(3, _arr(pkg, onp.full(shape, 4.0, "float32")))
    kv.pull(3, out=out)
    return kv, first, out.asnumpy()


def test_local_kvstore_is_the_references():
    _, jf, js = _kv_run(mx)
    kv, tf, ts = _kv_run(mxt)
    onp.testing.assert_array_equal(tf, jf)
    _close(ts, js, "updated")
    assert kv.type == "local" and kv.rank == 0 and kv.num_workers == 1
    assert mxt.kv.create("device").type == "device"
    for name in ("dist_sync", "dist_async", "dist_device_sync"):
        with pytest.raises(NotImplementedError, match="item 5"):
            mxt.kv.create(name)
    with pytest.raises(NotImplementedError, match="item 5"):
        mxt.kvstore.KVStoreServer(kv)


def test_kvstore_pull_and_push_share_no_buffer():
    """pull copies the stored value into ``out``; a write into ``out``
    afterwards must not reach the store. push stores a copy: a write into
    the pushed array afterwards must not reach it either."""
    kv = mxt.kv.create("local")
    kv.init("w", mxt.nd.array(onp.ones((2,), "float32"), ctx=CPU))
    out = mxt.nd.array(onp.zeros((2,), "float32"), ctx=CPU)
    kv.pull("w", out=out)
    out[:] = 9.0
    again = mxt.nd.array(onp.zeros((2,), "float32"), ctx=CPU)
    kv.pull("w", out=again)
    assert again.asnumpy().tolist() == [1.0, 1.0]
    pushed = mxt.nd.array(onp.full((2,), 3.0, "float32"), ctx=CPU)
    kv.push("w", pushed)
    pushed[:] = -5.0
    kv.pull("w", out=again)
    assert again.asnumpy().tolist() == [3.0, 3.0]


# ============================================================ aliasing

def test_module_parameters_never_alias_the_callers():
    """init_params and set_params copy the given arrays in: writing them
    afterwards changes nothing in the module."""
    arg, aux = _lenet_params()
    given = {k: mxt.nd.array(v, ctx=CPU) for k, v in arg.items()}
    mod = mxt.mod.Module(lenet(mxt), context=CPU)
    it = mxt.io.NDArrayIter(X, Y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=given,
                    aux_params={k: mxt.nd.array(v, ctx=CPU)
                                for k, v in aux.items()})
    given["fc1_weight"][:] = 0.0
    onp.testing.assert_array_equal(
        mod._exec.arg_dict["fc1_weight"].asnumpy(), arg["fc1_weight"])
    got, _ = mod.get_params()
    got["fc1_weight"][:] = 5.0
    onp.testing.assert_array_equal(
        mod._exec.arg_dict["fc1_weight"].asnumpy(), arg["fc1_weight"])
    mod.set_params(got, {})
    got["fc1_weight"][:] = 7.0
    assert float(mod._exec.arg_dict["fc1_weight"].asnumpy().max()) == 5.0


def test_module_feed_never_aliases_the_batch():
    arg, aux = _lenet_params()
    mod, it = _bound(mxt, arg, aux)
    batch = next(iter(it))
    mod.forward(batch, is_train=False)
    first = mod.get_outputs()[0].asnumpy().copy()
    batch.data[0][:] = 0.0
    mod.forward(mxt.io.DataBatch([mxt.nd.array(X[:BATCH], ctx=CPU)],
                                 [mxt.nd.array(Y[:BATCH], ctx=CPU)]),
                is_train=False)
    onp.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), first)


def test_monitor_reads_each_steps_own_values():
    """The monitor's stats are those of the step it was activated on,
    from a copy queued then, not of a later step."""
    arg, aux = _lenet_params()
    stats = []
    for pkg in (mx, mxt):
        mod, it = _bound(pkg, arg, aux)
        mon = pkg.monitor.Monitor(1, pattern=".*")
        mod.install_monitor(mon) if pkg is mxt else mon.install_exec(mod._exec)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        got = []
        for batch in it:
            mon.tic()
            mod.forward_backward(batch)
            mod.update()
            got.append([float(v.asnumpy() if hasattr(v, "asnumpy") else v)
                        for _, _, v in mon.toc()])
        stats.append(got)
    _close(stats[1], stats[0], "monitor stats")
    block = mxt.gluon.nn.Dense(2, in_units=3)
    block.initialize(mxt.init.One(), ctx=CPU)
    mon = mxt.monitor.Monitor(1)
    mon.install(block)
    mon.tic()
    x = mxt.nd.array(onp.ones((1, 3), "float32"), ctx=CPU)
    y = block(x)
    y[:] = 100.0
    (_, _, v), = mon.toc()
    _close(v.asnumpy(), onp.float32(3.0), "queued copy")


def test_fit_logs_speed_and_checkpoints_each_epoch(tmp_path, caplog):
    prefix = str(tmp_path / "fit")
    with caplog.at_level(logging.INFO):
        mod, losses, _ = _fit(mxt, tmp_path, epochs=2,
                              epoch_end_callback=mxt.callback.do_checkpoint(
                                  prefix))
    assert os.path.exists(prefix + "-0001.params")
    assert os.path.exists(prefix + "-0002.params")
    assert any("Train-accuracy" in r.getMessage() for r in caplog.records)
    score = mod.score(mxt.io.NDArrayIter(X, Y, batch_size=BATCH), "acc")
    assert score[0][0] == "accuracy" and 0.0 <= score[0][1] <= 1.0
