"""The port's ``gluon.contrib`` against the JAX package's, on the CPU.

Blocks and cells run the same numpy-seeded inputs and weights (carried by
``from_jax_params``) through both packages in training mode under
``record()``: the output (for cells the unrolled outputs and final
states), the input's gradient and every parameter's gradient of a seeded
linear function of the output agree within 1e-5 of the largest value
(float32 summation orders). ``VariationalDropoutCell`` draws its masks from
each package's own generator, which never match: it is held to the
reference with dropout off and with the same masks injected, and on its
own to one mask a sequence. ``Estimator.fit`` with its handlers gives the
JAX package's parameters after its batches, within 1e-5. The datasets read
the same local corpus; without one the port raises (ROADMAP §3).
"""
import os

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import contrib as jcontrib

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.gluon import contrib as tcontrib

TOL = 1e-5
CPU = {"ctx": mxt.cpu()}


def _rel(got, ref, what="", tol=TOL):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _pair(make, x):
    """(JAX block, port block) made by ``make(contrib, gluon)``, their
    deferred shapes set by a first call on ``x``, the JAX one's weights
    seeded uniform in (-0.5, 0.5) and copied into the port's."""
    jnet = make(jcontrib, mx.gluon)
    jnet.initialize()
    jnet(jnd.array(x))
    rng = onp.random.RandomState(2)
    for p in jnet.collect_params().values():
        p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype("float32"))
    tnet = make(tcontrib, mxt.gluon)
    tnet.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        tnet(tnd.array(x, **CPU))
    mxt.from_jax_params(tnet, {k: p.data() for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def _grads_agree(jnet, tnet):
    for k, p in jnet._collect_params_with_prefix().items():
        tp = tnet._collect_params_with_prefix()[k]
        if p.grad_req != "null":
            _rel(tp.grad().asnumpy(), p.grad().asnumpy(), k)


def _block_run(net, m, ag, x, **ctx):
    xa = m.array(x, **ctx)
    xa.attach_grad()
    with ag.record():
        out = net(xa)
        c = onp.random.RandomState(99).uniform(-1, 1, out.shape)
        s = (out * m.array(c.astype("float32"), **ctx)).sum()
    s.backward()
    return out.asnumpy(), xa.grad.asnumpy()


BLOCKS = {
    "HybridConcurrent": (lambda c, g: _concurrent(c, g), (2, 5)),
    "Identity": (lambda c, g: c.nn.Identity(), (2, 5)),
    "PixelShuffle1D": (lambda c, g: c.nn.PixelShuffle1D(2), (2, 4, 3)),
    "PixelShuffle2D": (lambda c, g: c.nn.PixelShuffle2D((2, 3)),
                       (1, 12, 2, 3)),
    "PixelShuffle3D": (lambda c, g: c.nn.PixelShuffle3D(2), (1, 16, 2, 2, 1)),
    "DeformableConvolution": (
        lambda c, g: c.cnn.DeformableConvolution(
            4, kernel_size=(3, 3), padding=(1, 1), in_channels=3),
        (2, 3, 5, 5)),
    "ModulatedDeformableConvolution": (
        lambda c, g: c.cnn.ModulatedDeformableConvolution(
            4, kernel_size=(3, 3), strides=(2, 2), padding=(1, 1),
            num_deformable_group=1, activation="relu"),
        (1, 2, 6, 6)),
}


def _concurrent(c, g):
    net = c.nn.HybridConcurrent(axis=-1)
    net.add(g.nn.Dense(4, in_units=5), g.nn.Dense(3, in_units=5))
    return net


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_the_reference(name):
    make, shape = BLOCKS[name]
    x = onp.random.RandomState(1).uniform(-1, 1, shape).astype("float32")
    jnet, tnet = _pair(make, x)
    want = _block_run(jnet, jnd, jautograd, x)
    got = _block_run(tnet, tnd, tautograd, x, **CPU)
    assert got[0].shape == want[0].shape
    _rel(got[0], want[0], "output")
    _rel(got[1], want[1], "input gradient")
    _grads_agree(jnet, tnet)


def test_sparse_embedding_and_sync_batch_norm():
    """SparseEmbedding is an Embedding child with sparse_grad (rows and
    their gradient as the reference's); SyncBatchNorm is gluon.nn's."""
    assert tcontrib.nn.SyncBatchNorm is mxt.gluon.nn.SyncBatchNorm
    assert tcontrib.nn.Concurrent is tcontrib.nn.HybridConcurrent
    ids = onp.array([[1, 4, 4], [0, 9, 2]], "float32")
    outs = []
    for m, c, kw in ((jnd, jcontrib, {}), (tnd, tcontrib, CPU)):
        net = c.nn.SparseEmbedding(10, 4)
        net.initialize(**({"ctx": mxt.cpu()} if kw else {}))
        w = onp.random.RandomState(5).randn(10, 4).astype("float32")
        net[0].weight.set_data(m.array(w, **kw))
        with (jautograd if m is jnd else tautograd).record():
            out = net(m.array(ids, **kw))
            s = (out * out).sum()
        s.backward()
        outs.append((out.asnumpy(), net[0].weight.grad().asnumpy()))
    _rel(outs[1][0], outs[0][0], "rows")
    _rel(outs[1][1], outs[0][1], "gradient")


CELLS = {
    "Conv1DRNNCell": (lambda c: c.rnn.Conv1DRNNCell((2, 6), 3, 3, 3),
                      (2, 2, 6)),
    "Conv2DRNNCell": (lambda c: c.rnn.Conv2DRNNCell(
        (2, 4, 4), 2, (3, 3), (3, 3), i2h_pad=(1, 1), activation="relu"),
        (1, 2, 4, 4)),
    "Conv3DRNNCell": (lambda c: c.rnn.Conv3DRNNCell(
        (1, 3, 3, 3), 2, 1, 3), (1, 1, 3, 3, 3)),
    "Conv1DLSTMCell": (lambda c: c.rnn.Conv1DLSTMCell(
        (2, 5), 2, 3, 3, i2h_pad=1), (2, 2, 5)),
    "Conv2DLSTMCell": (lambda c: c.rnn.Conv2DLSTMCell(
        (1, 4, 3), 2, (3, 1), (1, 3), i2h_dilate=(1, 1)), (1, 1, 4, 3)),
    "Conv3DLSTMCell": (lambda c: c.rnn.Conv3DLSTMCell(
        (1, 2, 3, 3), 2, 1, 1), (1, 1, 2, 3, 3)),
    "Conv1DGRUCell": (lambda c: c.rnn.Conv1DGRUCell((3, 4), 2, 1, 3),
                      (2, 3, 4)),
    "Conv2DGRUCell": (lambda c: c.rnn.Conv2DGRUCell(
        (2, 3, 3), 2, (3, 3), (3, 3), i2h_pad=(1, 1)), (1, 2, 3, 3)),
    "Conv3DGRUCell": (lambda c: c.rnn.Conv3DGRUCell(
        (1, 2, 2, 2), 2, 1, 1, h2h_dilate=2), (1, 1, 2, 2, 2)),
    "LSTMPCell": (lambda c: c.rnn.LSTMPCell(5, 3, input_size=4), (2, 4)),
}
STEPS = 2


def _cell_run(cell, m, ag, xs, **kw):
    """Unrolled outputs (stacked), final states and the inputs' gradients
    of ``cell`` over the steps ``xs`` in training mode."""
    arrs = [m.array(x, **kw) for x in xs]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        outs, states = cell.unroll(len(arrs), arrs, layout="TNC",
                                   merge_outputs=False)
        total = None
        rng = onp.random.RandomState(7)
        for o in list(outs) + list(states):
            c = m.array(rng.uniform(-1, 1, o.shape).astype("float32"), **kw)
            term = (o * c).sum()
            total = term if total is None else total + term
    total.backward()
    return ([o.asnumpy() for o in outs], [s.asnumpy() for s in states],
            [a.grad.asnumpy() for a in arrs])


def _cell_pair(make, xs):
    jcell = make(jcontrib)
    jcell.initialize()
    jcell.unroll(len(xs), [jnd.array(x) for x in xs], layout="TNC")
    rng = onp.random.RandomState(3)
    for p in jcell.collect_params().values():
        p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype("float32"))
    tcell = make(tcontrib)
    tcell.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        tcell.unroll(len(xs), [tnd.array(x, **CPU) for x in xs],
                     layout="TNC")
    mxt.from_jax_params(tcell, {k: p.data() for k, p in
                                jcell._collect_params_with_prefix().items()})
    return jcell, tcell


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cells_match_the_reference(name):
    make, shape = CELLS[name]
    rng = onp.random.RandomState(1)
    xs = [rng.uniform(-1, 1, shape).astype("float32") for _ in range(STEPS)]
    jcell, tcell = _cell_pair(make, xs)
    want = _cell_run(jcell, jnd, jautograd, xs)
    got = _cell_run(tcell, tnd, tautograd, xs, **CPU)
    for what, g, w in zip(("output", "state", "input gradient"), got, want):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.shape == b.shape, (what, i)
            _rel(a, b, "%s %d" % (what, i))
    _grads_agree(jcell, tcell)
    assert tcell.state_info(2)[0]["shape"] == jcell.state_info(2)[0]["shape"]


def test_conv_cell_refuses_an_even_state_kernel():
    with pytest.raises(ValueError, match="odd"):
        tcontrib.rnn.Conv2DRNNCell((1, 4, 4), 2, 3, 2)


def _vd(c, g, rates):
    return c.rnn.VariationalDropoutCell(g.rnn.LSTMCell(3, input_size=2),
                                        *rates)


@pytest.mark.parametrize("rates", [(0.0, 0.0, 0.0), (0.5, 0.3, 0.4)])
def test_variational_dropout_cell_matches_with_the_same_masks(rates):
    """Dropout off, or the same masks injected in both packages (their
    generators differ): the same outputs, states and gradients."""
    rng = onp.random.RandomState(1)
    xs = [rng.uniform(-1, 1, (2, 2)).astype("float32") for _ in range(3)]
    jcell, tcell = _cell_pair(lambda c: _vd(
        c, mx.gluon if c is jcontrib else mxt.gluon, rates), xs)
    masks = {}
    for name, shape, rate in (("_mask_in", (2, 2), rates[0]),
                              ("_mask_state", (2, 3), rates[1]),
                              ("_mask_out", (2, 3), rates[2])):
        if rate:
            keep = 1 - rate
            masks[name] = (rng.uniform(size=shape) < keep).astype(
                "float32") / onp.float32(keep)

    def injected(cell, m, kw):
        """The masks set now and again at each reset (the port's unroll
        resets, as MXNet's does; the JAX package's keeps the masks)."""
        real = cell.reset

        def reset():
            real()
            for k, v in masks.items():
                setattr(cell, k, m.array(v, **kw))
        cell.reset = reset
        reset()
        return cell
    want = _cell_run(injected(jcell, jnd, {}), jnd, jautograd, xs)
    got = _cell_run(injected(tcell, tnd, CPU), tnd, tautograd, xs, **CPU)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _rel(a, b, "variational dropout")
    _grads_agree(jcell, tcell)


def test_variational_dropout_mask_is_constant_over_time():
    """In training the port draws one input mask a sequence: every step of
    an all-ones input sees the same mask (zeros or 1/keep), and a reset
    draws a new one; outside training nothing is dropped."""
    cell = tcontrib.rnn.VariationalDropoutCell(
        tcontrib.rnn.LSTMPCell(4, 3, input_size=64), drop_inputs=0.5)
    cell.initialize(ctx=mxt.cpu())
    seen = []
    base = cell.base_cell.forward

    def spy(inputs, states):
        seen.append(getattr(inputs, "_data", inputs).detach().numpy().copy())
        return base(inputs, states)
    cell.base_cell.forward = spy
    ones = [tnd.ones((8, 64), **CPU) for _ in range(4)]
    with tautograd.record():
        cell.unroll(4, ones, layout="TNC")
    assert all(onp.array_equal(s, seen[0]) for s in seen[1:])
    assert set(onp.unique(seen[0])) <= {0.0, 2.0} and 0 < seen[0].mean() < 2
    first = seen[0]
    seen.clear()
    with tautograd.record():
        cell.unroll(4, ones, layout="TNC")
    assert not onp.array_equal(seen[0], first)
    seen.clear()
    cell.unroll(2, ones[:2], layout="TNC")
    assert all(onp.array_equal(s, onp.ones((8, 64))) for s in seen)


@pytest.mark.parametrize("length,interval,rollover", [
    (10, 3, True), (10, 3, False), (7, 7, True), (9, 1, False)])
def test_interval_sampler_is_the_references(length, interval, rollover):
    want = jcontrib.data.IntervalSampler(length, interval, rollover)
    got = tcontrib.data.IntervalSampler(length, interval, rollover)
    assert list(got) == list(want) and len(got) == len(want)


@pytest.mark.parametrize("cls", ["WikiText2", "WikiText103"])
def test_wikitext_reads_a_local_corpus_and_never_makes_one(cls, tmp_path):
    words = " ".join("w%d" % (i * 7 % 23) for i in range(300))
    (tmp_path / "wiki.valid.tokens").write_text(words, encoding="utf-8")
    ref = getattr(jcontrib.data, cls)(root=str(tmp_path), segment="valid",
                                      seq_len=9)
    got = getattr(tcontrib.data, cls)(root=str(tmp_path), segment="valid",
                                      seq_len=9)
    assert len(got) == len(ref) and got.vocab == ref.vocab
    for i in (0, len(ref) - 1):
        onp.testing.assert_array_equal(got[i][0], ref[i][0])
        onp.testing.assert_array_equal(got[i][1], ref[i][1])
    with pytest.raises(FileNotFoundError, match="never downloaded"):
        getattr(tcontrib.data, cls)(root=str(tmp_path), segment="train")


def _estimator_run(pkg, c, tmp, kw):
    """Estimator.fit of a Dense net over 3 batches x 2 epochs with the
    handlers; (weights, evaluate's accuracy, checkpoint files)."""
    net = pkg.gluon.nn.Dense(3, in_units=4)
    net.initialize(**({"ctx": mxt.cpu()} if kw else {}))
    rng = onp.random.RandomState(4)
    net.weight.set_data(pkg.nd.array(
        rng.uniform(-0.5, 0.5, (3, 4)).astype("float32"), **kw))
    net.bias.set_data(pkg.nd.zeros((3,), **kw))
    batches = [(pkg.nd.array(rng.randn(4, 4).astype("float32"), **kw),
                pkg.nd.array(rng.randint(0, 3, 4).astype("float32"), **kw))
               for _ in range(3)]
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
    est = c.estimator.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=pkg.metric.Accuracy(), trainer=trainer)
    validated = []
    handlers = [c.estimator.LoggingHandler(log_interval=2,
                                           metrics=est.train_metrics),
                c.estimator.CheckpointHandler(str(tmp), "m"),
                c.estimator.ValidationHandler(
                    batches[:1], lambda val_data: validated.append(1)),
                c.estimator.EarlyStoppingHandler(est.train_loss_metric,
                                                 patience=5)]
    est.fit(batches, epochs=2, event_handlers=handlers)
    acc = est.evaluate(batches)[0].get()[1]
    return (net.weight.data().asnumpy(), net.bias.data().asnumpy(), acc,
            sorted(os.listdir(str(tmp))), len(validated))


def test_estimator_fit_is_the_references(tmp_path):
    want = _estimator_run(mx, jcontrib, tmp_path / "j", {})
    got = _estimator_run(mxt, tcontrib, tmp_path / "t", CPU)
    _rel(got[0], want[0], "weight")
    _rel(got[1], want[1], "bias")
    assert got[2] == want[2] and got[3] == want[3] == \
        ["m-epoch1.params", "m-epoch2.params"] and got[4] == want[4] == 2
    net = mxt.gluon.nn.Dense(3, in_units=4)
    net.load_parameters(str(tmp_path / "t" / "m-epoch2.params"),
                        ctx=mxt.cpu())
    _rel(net.weight.data().asnumpy(), want[0], "checkpoint")


def test_estimator_stops_at_max_batch_and_on_a_handler():
    stop = tcontrib.estimator.StoppingHandler(max_batch=2)
    stop.train_begin(None)
    assert not stop.batch_end(None) and stop.batch_end(None)
    flat = type("Flat", (), {"get": lambda self: ("loss", 1.0)})()
    early = tcontrib.estimator.EarlyStoppingHandler(flat, patience=1)
    assert not early.epoch_end(None) and early.epoch_end(None)
