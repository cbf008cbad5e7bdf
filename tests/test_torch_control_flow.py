"""``nd.contrib``'s control flow, ``hawkesll`` and the operators on CSR
storage against the JAX package's, on the CPU.

``foreach``, ``while_loop`` and ``cond`` run eagerly (the reference's
eager branch) and traced: the port inside ``plain()`` (a TrainStep's body,
a hybridized forward), the reference inside ``jax.jit``. Outputs and final
states within 1e-5 of the reference's largest value; gradients of the
eager loops to a closed-over weight and the inputs against the reference's
autograd. Traced ``while_loop`` runs exactly ``max_iterations`` steps with
the rows past the stop zeros. An LSTM cell unrolled by ``foreach`` inside
``jit.TrainStep`` equals the same cell trained eagerly. ``hawkesll``'s
log-likelihood, state and gradients within 1e-5; ``getnnz``, ``edge_id``
and the ``dgl_*`` samplers equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray
from incubator_mxnet_tpu.ndarray import contrib as jcontrib

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.gluon import _functional
from incubator_mxnet_tpu_torch.ndarray import contrib as tcontrib


def _rel(got, ref, what="", tol=1e-5):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _arr(a):
    return tnd.array(a, ctx=mxt.cpu())


RNG = onp.random.RandomState(0)
SEQ = RNG.randn(5, 2, 3).astype("float32")
W = RNG.randn(3, 3).astype("float32") * 0.5
S0 = RNG.randn(2, 3).astype("float32")


def _rnn_body(nd, w):
    def body(x, states):
        h = nd.tanh(nd.dot(x, w) + states[0])
        return h * 2, [h]
    return body


def _loop_body(nd):
    def cond(i, s):
        return i < 3.5

    def func(i, s):
        s2 = s * 1.5 + i
        return [s2, s2.sum()], [i + 1, s2]
    return cond, func


def test_foreach_eager_values_and_gradients():
    res = {}
    for pkg, nd, ag, arr in ((mx, jnd, mx.autograd, jnd.array),
                             (mxt, tnd, tautograd, _arr)):
        seq, w, s0 = arr(SEQ), arr(W), arr(S0)
        for v in (seq, w, s0):
            v.attach_grad()
        c = nd.contrib if pkg is mxt else jnd.contrib
        with ag.record():
            outs, states = c.foreach(_rnn_body(nd, w), seq, [s0])
            loss = (outs * outs).sum() + states[0].sum()
        loss.backward()
        res[pkg] = [outs.asnumpy(), states[0].asnumpy(), seq.grad.asnumpy(),
                    w.grad.asnumpy(), s0.grad.asnumpy()]
    for a, b in zip(res[mxt], res[mx]):
        _rel(a, b)


def test_foreach_traced_equals_the_references_scan():
    def jf(seq, w, s0):
        outs, st = jcontrib.foreach(_rnn_body(jnd, JNDArray(w)),
                                    JNDArray(seq), [JNDArray(s0)])
        return outs._data, st[0]._data
    want = jax.jit(jf)(jnp.asarray(SEQ), jnp.asarray(W), jnp.asarray(S0))
    with _functional.plain():
        outs, st = tcontrib.foreach(_rnn_body(tnd, _arr(W)), _arr(SEQ),
                                    [_arr(S0)])
    _rel(outs.asnumpy(), want[0])
    _rel(st[0].asnumpy(), want[1])


def test_while_loop_eager_and_traced():
    s0 = RNG.randn(2).astype("float32")
    # eager: the steps that run (4: i = 0, 1, 2, 3)
    jouts, jvars = jcontrib.while_loop(*_loop_body(jnd),
                                       [jnd.array([0.0]), jnd.array(s0)],
                                       max_iterations=6)
    touts, tvars = tcontrib.while_loop(*_loop_body(tnd),
                                       [_arr([0.0]), _arr(s0)],
                                       max_iterations=6)
    assert touts[0].shape == jouts[0].shape == (4, 2)
    for a, b in zip(touts + tvars, jouts + jvars):
        _rel(a.asnumpy(), b.asnumpy())

    # traced: exactly max_iterations rows, zeros past the stop
    def jf(i, s):
        outs, vs = jcontrib.while_loop(*_loop_body(jnd),
                                       [JNDArray(i), JNDArray(s)],
                                       max_iterations=6)
        return [o._data for o in outs] + [v._data for v in vs]
    want = jax.jit(jf)(jnp.asarray([0.0]), jnp.asarray(s0))
    with _functional.plain():
        touts, tvars = tcontrib.while_loop(*_loop_body(tnd),
                                           [_arr([0.0]), _arr(s0)],
                                           max_iterations=6)
    got = [o.asnumpy() for o in touts + tvars]
    assert got[0].shape == (6, 2) and (got[0][4:] == 0).all()
    for a, b in zip(got, want):
        _rel(a, onp.asarray(b))
    with _functional.plain(), pytest.raises(ValueError, match="max_iter"):
        tcontrib.while_loop(*_loop_body(tnd), [_arr([0.0]), _arr(s0)])


def test_while_loop_traced_gradient_equals_eager():
    s0 = RNG.randn(2).astype("float32")
    grads = []
    for traced in (False, True):
        s = _arr(s0)
        s.attach_grad()
        with tautograd.record():
            if traced:
                with _functional.plain():
                    outs, vs = tcontrib.while_loop(
                        *_loop_body(tnd), [_arr([0.0]), s], max_iterations=6)
            else:
                outs, vs = tcontrib.while_loop(
                    *_loop_body(tnd), [_arr([0.0]), s], max_iterations=6)
            loss = outs[0].sum() + vs[1].sum() * 2
        loss.backward()
        grads.append(s.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def test_cond_eager_and_traced():
    x = RNG.randn(3).astype("float32")
    for p in (1.0, 0.0):
        want = jcontrib.cond(jnd.array([p]), lambda: jnd.array(x) * 2,
                             lambda: jnd.array(x) - 1).asnumpy()
        got = tcontrib.cond(_arr([p]), lambda: _arr(x) * 2,
                            lambda: _arr(x) - 1).asnumpy()
        _rel(got, want)
        with _functional.plain():
            got = tcontrib.cond(_arr([p]),
                                lambda: [_arr(x) * 2, _arr(x).sum()],
                                lambda: [_arr(x) - 1, _arr(x).max()])
        _rel(got[0].asnumpy(), want)
        _rel(got[1].asnumpy(), x.sum() if p else x.max())


def test_foreach_lstm_cell_inside_train_step_equals_eager():
    """An LSTM cell unrolled by ``foreach`` in a block's forward: three SGD
    steps through ``jit.TrainStep`` (traced: inside ``plain()``) and
    through record / backward / ``Trainer.step`` (eager) give the same
    losses and weights."""
    g = mxt.gluon

    class Unrolled(g.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = g.rnn.LSTMCell(4, input_size=3)
            self.out = g.nn.Dense(2, in_units=4)

        def forward(self, x):
            n = x.shape[1]
            begin = [torch.zeros(n, 4), torch.zeros(n, 4)]

            def body(xt, states):
                return self.cell(xt, states)
            outs, _ = tcontrib.foreach(body, x, begin)
            return self.out(outs[-1])

    results = []
    x = RNG.randn(5, 3, 3).astype("float32")
    y = onp.array([0, 1, 1], "float32")
    for traced in (False, True):
        torch.manual_seed(0)
        net = Unrolled()
        net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                       generator=torch.Generator().manual_seed(1))
        trainer = g.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5})
        loss_fn = g.loss.SoftmaxCrossEntropyLoss()
        losses = []
        step = mxt.jit.TrainStep(net, loss_fn, trainer) if traced else None
        for _ in range(3):
            if traced:
                losses.append(step(x, y, batch_size=3).asnumpy())
            else:
                with tautograd.record():
                    loss = loss_fn(net(_arr(x)), _arr(y))
                loss.backward()
                trainer.step(3)
                losses.append(loss.asnumpy())
        results.append((losses, mxt.to_numpy_params(net)))
    for a, b in zip(results[1][0], results[0][0]):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for k, v in results[0][1].items():
        onp.testing.assert_allclose(results[1][1][k], v, rtol=1e-5,
                                    atol=1e-6)


def test_hawkesll_and_gradients():
    rng = onp.random.RandomState(3)
    n, k, t = 3, 2, 6
    arrays = [rng.rand(n, k).astype("float32") + 0.2,
              rng.rand(k).astype("float32") * 0.5,
              rng.rand(k).astype("float32") + 0.5,
              rng.rand(n, k).astype("float32"),
              rng.rand(n, t).astype("float32") + 0.1,
              rng.randint(0, k, (n, t)).astype("float32"),
              onp.array([6, 4, 1], "float32"),
              onp.array([5.0, 4.0, 3.0], "float32")]

    def jf(*xs):
        out = jcontrib.hawkesll(*[JNDArray(x) for x in xs])
        return [o._data for o in out]
    want, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(a) for a in arrays])
    tin = [_arr(a) for a in arrays]
    for i in range(3):
        tin[i].attach_grad()
    with tautograd.record():
        ll, st = tcontrib.hawkesll(*tin)
        total = ll.sum() + (st * 2).sum()
    total.backward()
    _rel(ll.asnumpy(), want[0], "loglik")
    _rel(st.asnumpy(), want[1], "state")
    jg = vjp([jnp.ones(n), jnp.full((n, k), 2.0)])
    for i in range(3):
        _rel(tin[i].grad.asnumpy(), jg[i], "gradient %d" % i)


def _graph():
    dense = onp.array([[0, 1, 0, 2, 0], [3, 0, 0, 0, 4], [0, 5, 6, 0, 0],
                       [7, 0, 0, 0, 8], [0, 0, 9, 1, 0]], "float32")
    return jnd.array(dense).tostype("csr"), _arr(dense).tostype("csr")


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if hasattr(want, "stype") and want.stype == "csr":
        for part in ("data", "indices", "indptr"):
            onp.testing.assert_array_equal(getattr(got, part).asnumpy(),
                                           getattr(want, part).asnumpy())
        assert got.shape == want.shape
        return
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_csr_contrib_operators():
    jg, tg = _graph()
    _same(tcontrib.getnnz(tg), jcontrib.getnnz(jg))
    _same(tcontrib.getnnz(tg, axis=0), jcontrib.getnnz(jg, axis=0))
    u, v = onp.array([0, 1, 4, 2], "float32"), onp.array([3, 1, 3, 2],
                                                          "float32")
    _same(tcontrib.edge_id(tg, _arr(u), _arr(v)),
          jcontrib.edge_id(jg, jnd.array(u), jnd.array(v)))
    seeds = onp.array([0, 2], "float32")
    kw = dict(num_hops=2, num_neighbor=1, max_num_vertices=4, seed=3)
    _same(tcontrib.dgl_csr_neighbor_uniform_sample(tg, _arr(seeds), **kw),
          jcontrib.dgl_csr_neighbor_uniform_sample(jg, jnd.array(seeds),
                                                   **kw))
    prob = onp.array([0.1, 0.5, 0.1, 0.2, 0.1], "float32")
    _same(tcontrib.dgl_csr_neighbor_non_uniform_sample(
        tg, _arr(prob), _arr(seeds), **kw),
        jcontrib.dgl_csr_neighbor_non_uniform_sample(
            jg, jnd.array(prob), jnd.array(seeds), **kw))
    vids = onp.array([0, 1, 3], "float32")
    _same(tcontrib.dgl_subgraph(tg, _arr(vids), return_mapping=True),
          jcontrib.dgl_subgraph(jg, jnd.array(vids), return_mapping=True))
    _same(tcontrib.dgl_graph_compact(tg, tg, graph_sizes=[3, 4]),
          jcontrib.dgl_graph_compact(jg, jg, graph_sizes=[3, 4]))
    _same(tcontrib.dgl_adjacency(tg), jcontrib.dgl_adjacency(jg))
