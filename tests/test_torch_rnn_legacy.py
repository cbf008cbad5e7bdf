"""The port's legacy symbolic RNN API (``mx.rnn``) against the JAX
package's, on the CPU, the same inputs from numpy seeds and the same
parameters carried across as numpy:

- every cell (``RNNCell`` tanh and relu, ``LSTMCell``, ``GRUCell``,
  ``SequentialRNNCell``, ``BidirectionalCell``, ``FusedRNNCell`` plain and
  bidirectional, ``DropoutCell``, ``ZoneoutCell``, ``ResidualCell``)
  unrolled for T = 5: outputs, states and the gradients of every argument
  (the data too) within 1e-5 of the largest value, in fp32. ``LSTMCell``
  runs every combination of NTC/TNC, ``merge_outputs`` True/False and
  ``begin_state`` ``like=``/``func=``; the other cells two of them.
  Dropout and zoneout run at 0, and at 1, where inverted dropout divides
  by 1 - p = 0 in both packages: every output is NaN in both;
- the graph JSON of an unrolled stack is equal byte for byte, and the
  JSON of each package loads in the other and gives the same outputs;
- ``encode_sentences`` and ``BucketSentenceIter``: equal vocabularies,
  batches, labels, ``bucket_key``s and ``provide_data`` under the same
  seeds (and with an explicit generator, the same batches again);
- the bucketing LM of ``tests/test_rnn_legacy.py`` (V 12, E 8, H 10,
  buckets [3, 5]) through ``BucketingModule``, two epochs from the same
  initial parameters: per-batch losses and final parameters within 1e-5.
  SGD without momentum: the JAX package keeps optimizer states per bucket
  where MXNet, and the port, keep one set (``test_torch_module.py``);
- RNN checkpoints written by either package load in the other.
"""
import random

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.symbol import symbol as jsymm

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.symbol import symbol as tsymm

CPU = mxt.cpu()
TOL = 1e-5
T, N, C = 5, 3, 6


@pytest.fixture(autouse=True)
def _fresh_names():
    jsymm._NAME_COUNT.clear()
    tsymm._NAME_COUNT.clear()
    yield


def _close(got, want, what="", tol=TOL):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(onp.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(onp.abs(got - want).max()) / scale if got.size else 0.0
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _arr(pkg, a):
    return mx.nd.array(a) if pkg is mx else mxt.nd.array(a, ctx=CPU)


def _stack(rnn, *cells):
    s = rnn.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


CELLS = {
    "rnn_tanh": lambda r: r.RNNCell(C, prefix="r_"),
    "rnn_relu": lambda r: r.RNNCell(C, activation="relu", prefix="r_"),
    "lstm": lambda r: r.LSTMCell(C, prefix="l_"),
    "gru": lambda r: r.GRUCell(C, prefix="g_"),
    "sequential": lambda r: _stack(r, r.LSTMCell(C, prefix="s0_"),
                                   r.GRUCell(C, prefix="s1_")),
    "bidirectional": lambda r: r.BidirectionalCell(
        r.LSTMCell(4, prefix="fw_"), r.GRUCell(4, prefix="bw_")),
    "fused_lstm": lambda r: r.FusedRNNCell(C, num_layers=2, mode="lstm",
                                           prefix="f_"),
    "fused_bi_gru": lambda r: r.FusedRNNCell(4, num_layers=2, mode="gru",
                                             bidirectional=True,
                                             dropout=0.0, prefix="fb_"),
    "dropout": lambda r: _stack(r, r.LSTMCell(C, prefix="d0_"),
                                r.DropoutCell(0.0),
                                r.LSTMCell(C, prefix="d1_")),
    "zoneout": lambda r: r.ZoneoutCell(r.GRUCell(C, prefix="z_"),
                                       zoneout_outputs=0.0),
    "residual": lambda r: r.ResidualCell(r.LSTMCell(C, prefix="res_")),
}

# (layout, merge_outputs, begin_state)
ALL_WAYS = [(lay, merge, begin) for lay in ("NTC", "TNC")
            for merge in (True, False) for begin in ("like", "func")]
CASES = [("lstm",) + w for w in ALL_WAYS] + \
    [(name,) + w for name in CELLS if name != "lstm"
     for w in (("NTC", True, "like"), ("TNC", False, "func"))]


def _unrolled(pkg, make, layout, merge, begin):
    """The unrolled cell's outputs and states as one Group."""
    cell = make(pkg.rnn)
    states = None
    if begin == "func":
        states = cell.begin_state(func=pkg.sym.zeros, batch_size=N)
    outputs, st = cell.unroll(T, pkg.sym.var("data"), begin_state=states,
                              layout=layout, merge_outputs=merge)
    outs = [outputs] if merge else list(outputs)
    return pkg.sym.Group(outs + list(st))


def _values(group, layout, seed=0):
    """The data and parameters of ``group`` (a port Group) from numpy."""
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    arg_shapes, _, _ = group.infer_shape(data=shape)
    rng = onp.random.RandomState(seed)
    return {name: rng.uniform(-0.5, 0.5, s).astype("float32")
            for name, s in zip(group.list_arguments(), arg_shapes)}


def _run(pkg, group, values, train=True, seed=1):
    """(outputs, gradients of every argument) of ``group`` over
    ``values``, the heads seeded with numpy gradients."""
    args = {k: _arr(pkg, v) for k, v in values.items()}
    exe = group.bind(mx.cpu() if pkg is mx else CPU, args=args)
    outs = exe.forward(is_train=train)
    rng = onp.random.RandomState(seed)
    ograds = [rng.randn(*o.shape).astype("float32") for o in outs]
    exe.backward([_arr(pkg, g) for g in ograds])
    return ([o.asnumpy() for o in outs],
            {k: v.asnumpy() for k, v in exe.grad_dict.items()})


@pytest.mark.parametrize("name,layout,merge,begin", CASES)
def test_cell_unroll_is_the_references(name, layout, merge, begin):
    jg = _unrolled(mx, CELLS[name], layout, merge, begin)
    tg = _unrolled(mxt, CELLS[name], layout, merge, begin)
    assert tg.list_arguments() == jg.list_arguments()
    values = _values(tg, layout)
    jouts, jgrads = _run(mx, jg, values)
    touts, tgrads = _run(mxt, tg, values)
    assert len(touts) == len(jouts)
    for i, (g, w) in enumerate(zip(touts, jouts)):
        _close(g, w, "%s output %d" % (name, i))
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        _close(tgrads[k], jgrads[k], "%s gradient of %s" % (name, k))


@pytest.mark.parametrize("name", ["dropout_one", "zoneout_one"])
def test_dropout_and_zoneout_at_one_are_nan_in_both(name):
    make = {"dropout_one": lambda r: _stack(r, r.LSTMCell(C, prefix="d0_"),
                                            r.DropoutCell(1.0)),
            "zoneout_one": lambda r: r.ZoneoutCell(
                r.GRUCell(C, prefix="z_"), zoneout_outputs=1.0)}[name]
    jg = _unrolled(mx, make, "NTC", True, "like")
    tg = _unrolled(mxt, make, "NTC", True, "like")
    values = _values(tg, "NTC")
    jout = _run(mx, jg, values)[0][0]
    tout = _run(mxt, tg, values)[0][0]
    assert onp.isnan(jout).all() and onp.isnan(tout).all()


def test_cells_at_zero_and_in_inference_equal_the_plain_cell():
    """Dropout 0 and zoneout 0 add no operator; an inference forward of
    a DropoutCell(0.5) stack equals the stack without it."""
    values = None
    outs = []
    for cells in (lambda r: _stack(r, r.LSTMCell(C, prefix="d0_"),
                                   r.DropoutCell(0.5),
                                   r.LSTMCell(C, prefix="d1_")),
                  lambda r: _stack(r, r.LSTMCell(C, prefix="d0_"),
                                   r.LSTMCell(C, prefix="d1_"))):
        g = _unrolled(mxt, cells, "NTC", True, "like")
        values = values or _values(g, "NTC")
        exe = g.bind(CPU, args={k: _arr(mxt, v) for k, v in values.items()},
                     grad_req="null")
        outs.append(exe.forward(is_train=False)[0].asnumpy())
    onp.testing.assert_array_equal(outs[0], outs[1])


def _lm_symbol(pkg, seq_len=T, layers=2):
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(layers):
        stack.add(pkg.rnn.LSTMCell(C, prefix="lstm_l%d_" % i))
    S = pkg.sym
    embed = S.Embedding(S.var("data"), input_dim=12, output_dim=C,
                        name="embed")
    outputs, _ = stack.unroll(seq_len, embed, merge_outputs=True)
    pred = S.FullyConnected(S.reshape(outputs, shape=(-1, C)),
                            num_hidden=12, name="pred")
    label = S.reshape(S.var("softmax_label"), shape=(-1,))
    return S.SoftmaxOutput(pred, label, name="softmax"), stack


def _lm_values(sym):
    arg_shapes, _, _ = sym.infer_shape(data=(N, T), softmax_label=(N, T))
    rng = onp.random.RandomState(3)
    values = {name: rng.uniform(-0.5, 0.5, s).astype("float32")
              for name, s in zip(sym.list_arguments(), arg_shapes)}
    values["data"] = rng.randint(0, 12, (N, T)).astype("float32")
    values["softmax_label"] = rng.randint(0, 12, (N, T)).astype("float32")
    return values


def _forward(pkg, sym, values):
    exe = sym.bind(mx.cpu() if pkg is mx else CPU,
                   args={k: _arr(pkg, v) for k, v in values.items()},
                   grad_req="null")
    return exe.forward(is_train=False)[0].asnumpy()


def test_unrolled_graph_json_is_the_references_and_loads_in_both():
    jsym, _ = _lm_symbol(mx)
    tsym, _ = _lm_symbol(mxt)
    assert tsym.tojson() == jsym.tojson()
    assert '"op": "_begin_state"' in tsym.tojson()
    values = _lm_values(tsym)
    want = _forward(mx, jsym, values)
    _close(_forward(mxt, tsym, values), want, "port forward")
    _close(_forward(mx, mx.sym.load_json(tsym.tojson()), values), want,
           "port JSON in the JAX package")
    back = mxt.sym.load_json(jsym.tojson())
    assert back.tojson() == jsym.tojson()
    _close(_forward(mxt, back, values), want, "JAX JSON in the port")


def test_begin_state_follows_the_data_not_the_context():
    """``_begin_state`` makes its zeros on the data's device and in its
    dtype, on meta tensors during inference too."""
    from incubator_mxnet_tpu_torch.rnn.rnn_cell import _begin_state_op
    for device in ("cpu", "meta"):
        d = mxt.nd.NDArray(torch.ones((3, 7), dtype=torch.float64,
                                      device=device))
        z = _begin_state_op(d, num_hidden=4)
        assert z.shape == (3, 4) and z._data.device.type == device
        assert z._data.dtype == torch.float64
    t = _begin_state_op(torch.ones(2, 5), num_hidden=3)
    assert isinstance(t, torch.Tensor) and t.shape == (2, 3)


SENTS = [["a", "b", "c"], ["a", "c"], ["b", "c", "a", "c"], ["c", "b"],
         ["a", "b", "c", "a"], ["b", "b"], ["c", "a", "b"], ["a", "a", "c"],
         ["b", "c", "c", "a", "b"], ["c"], ["a", "b"], ["c", "c", "b", "a"]]


def _batches(pkg, generator=None, seed=5, layout="NT", epochs=2):
    coded, vocab = pkg.rnn.encode_sentences(SENTS, start_label=1,
                                            invalid_label=0)
    random.seed(seed)
    onp.random.seed(seed)
    kw = {} if generator is None else {"generator": generator}
    it = pkg.rnn.BucketSentenceIter(coded, batch_size=2, buckets=[2, 3, 5],
                                    invalid_label=0, layout=layout, **kw)
    got = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            # copied at once: on the CPU the JAX package's batches share
            # the iterator's bucket arrays, which the next reset shuffles
            # in place (the port's are copies)
            got.append((b.bucket_key, b.data[0].asnumpy().copy(),
                        b.label[0].asnumpy().copy(),
                        tuple(b.provide_data[0].shape),
                        b.provide_data[0].name, b.provide_label[0].name))
    return vocab, it.provide_data, got


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_encode_sentences_and_bucket_iter_are_the_references(layout):
    jv, jpd, jb = _batches(mx, layout=layout)
    tv, tpd, tb = _batches(mxt, layout=layout)
    assert tv == jv
    assert [tuple(d.shape) for d in tpd] == [tuple(d.shape) for d in jpd]
    assert [d.name for d in tpd] == [d.name for d in jpd]
    assert len(tb) == len(jb) > 4
    for (tk, td, tl, tps, tn, tln), (jk, jd, jl, jps, jn, jln) in zip(tb, jb):
        assert (tk, tps, tn, tln) == (jk, jps, jn, jln)
        onp.testing.assert_array_equal(td, jd)
        onp.testing.assert_array_equal(tl, jl)


def test_bucket_iter_takes_an_explicit_generator():
    """Batches on the host, as CPU NDArrays; one generator seed gives the
    same batches whatever the global seeds are."""
    a = _batches(mxt, generator=onp.random.RandomState(9), seed=1)[2]
    b = _batches(mxt, generator=onp.random.RandomState(9), seed=2)[2]
    assert [x[0] for x in a] == [x[0] for x in b]
    for x, y in zip(a, b):
        onp.testing.assert_array_equal(x[1], y[1])
    coded, _ = mxt.rnn.encode_sentences(SENTS, start_label=1, invalid_label=0)
    it = mxt.rnn.BucketSentenceIter(coded, 2, buckets=[2, 3, 5],
                                    invalid_label=0)
    assert next(iter(it)).data[0].context == CPU


V, E, H = 12, 8, 10


def _lm_corpus():
    rng = onp.random.RandomState(0)
    return [rng.randint(1, V, size=rng.choice([3, 5])).tolist()
            for _ in range(40)]


def _bucketing_lm(pkg, init):
    """test_rnn_legacy.py's bucketing LM, two epochs of SGD from ``init``:
    (per-batch losses, final parameters)."""
    random.seed(7)
    onp.random.seed(7)
    it = pkg.rnn.BucketSentenceIter(_lm_corpus(), batch_size=4,
                                    buckets=[3, 5], invalid_label=0)
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(H, prefix="lm_l0_"))

    def sym_gen(seq_len):
        S = pkg.sym
        embed = S.Embedding(S.var("data"), input_dim=V, output_dim=E,
                            name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, embed, merge_outputs=True)
        pred = S.FullyConnected(S.reshape(outputs, shape=(-1, H)),
                                num_hidden=V, name="pred")
        lab = S.reshape(S.var("softmax_label"), shape=(-1,))
        return S.SoftmaxOutput(data=pred, label=lab, name="softmax"), \
            ("data",), ("softmax_label",)

    bm = pkg.mod.BucketingModule(sym_gen, default_bucket_key=5,
                                 context=mx.cpu() if pkg is mx else CPU)
    bm.bind(it.provide_data, it.provide_label)
    bm.init_params(arg_params={k: _arr(pkg, v) for k, v in init.items()})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.5})
    losses = []
    for _ in range(2):
        it.reset()
        for batch in it:
            bm.forward(batch)
            p = bm.get_outputs()[0].asnumpy()
            lbl = batch.label[0].asnumpy().ravel().astype(int)
            losses.append(float(-onp.log(p[onp.arange(len(lbl)), lbl])
                                .mean()))
            bm.backward()
            bm.update()
    arg, _ = bm.get_params()
    return losses, {k: v.asnumpy() for k, v in arg.items()}, stack, \
        sym_gen(5)[0]


def _lm_init():
    rng = onp.random.RandomState(11)
    shapes = {"embed_weight": (V, E), "lm_l0_i2h_weight": (4 * H, E),
              "lm_l0_i2h_bias": (4 * H,), "lm_l0_h2h_weight": (4 * H, H),
              "lm_l0_h2h_bias": (4 * H,), "pred_weight": (V, H),
              "pred_bias": (V,)}
    return {k: rng.uniform(-0.3, 0.3, s).astype("float32")
            for k, s in shapes.items()}


def test_bucketing_lm_is_the_references(tmp_path):
    init = _lm_init()
    jl, jp, jstack, jsym = _bucketing_lm(mx, init)
    tl, tp, tstack, tsym = _bucketing_lm(mxt, init)
    assert len(tl) == len(jl) > 10
    _close(tl, jl, "per-batch losses")
    assert set(tp) == set(jp) == set(init)
    for k in jp:
        _close(tp[k], jp[k], k)
    half = len(tl) // 2
    assert sum(tl[half:]) < sum(tl[:half])      # the second epoch learned

    # checkpoints cross both ways
    tprefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    mxt.rnn.save_rnn_checkpoint(tstack, tprefix, 2, tsym,
                                {k: _arr(mxt, v) for k, v in tp.items()}, {})
    mx.rnn.save_rnn_checkpoint(jstack, jprefix, 2, jsym,
                               {k: _arr(mx, v) for k, v in jp.items()}, {})
    for pkg, stack, prefix, want in ((mx, jstack, tprefix, tp),
                                     (mxt, tstack, jprefix, jp)):
        sym, arg, aux = pkg.rnn.load_rnn_checkpoint(stack, prefix, 2)
        assert aux == {} and set(arg) == set(want)
        for k, v in arg.items():
            _close(v.asnumpy(), want[k], "checkpoint " + k)
        values = {k: v.asnumpy() for k, v in arg.items()}
        rng = onp.random.RandomState(2)
        values["data"] = rng.randint(1, V, (4, 5)).astype("float32")
        values["softmax_label"] = rng.randint(1, V, (4, 5)).astype("float32")
        other = mxt if pkg is mx else mx
        _close(_forward(pkg, sym, values),
               _forward(other, (tsym if other is mxt else jsym), values),
               "checkpointed symbol's forward")


def test_do_rnn_checkpoint_writes_every_period(tmp_path):
    sym, stack = _lm_symbol(mxt)
    cb = mxt.rnn.do_rnn_checkpoint(stack, str(tmp_path / "lm"), period=2)
    arg = {"w": mxt.nd.array(onp.ones(3, "float32"), ctx=CPU)}
    for epoch in range(4):
        cb(epoch, sym, arg, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "lm-0002.params", "lm-0004.params", "lm-symbol.json"]
    _, got, _ = mx.rnn.load_rnn_checkpoint(stack, str(tmp_path / "lm"), 4)
    onp.testing.assert_array_equal(got["w"].asnumpy(), onp.ones(3))
