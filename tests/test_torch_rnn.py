"""The port's recurrent path against the JAX package, on the CPU: ``nd.RNN``
(the packed layout, all four modes, one and two directions), the fused
``gluon.rnn`` layers (TNC and NTC), every cell and ``unroll``, and the
LSTM language model (forward, gradients and three SGD steps), each on the
same numpy-seeded inputs and weights. Tolerance: within 1e-5 of the
largest value of what is compared (float32 summation orders).

Two faults of the JAX package are shown here, with the port taking
MXNet's behaviour (ROADMAP.md §3):

1. its fused layers keep their weights out of the structural names, so a
   ``.params`` file it writes for an LSTM LM has no LSTM weights; the port
   registers them as ``lstm.l0_i2h_weight`` …;
2. its fused layers draw the inter-layer dropout mask inside the function
   that autograd replays, so the gradient is taken under another mask than
   the forward's; ``nd.RNN`` (drawing its keys first) is right, and the
   port's layer equals it under one injected mask.

And, found by these tests: ``unroll`` with ``valid_length`` returns the
final step's states in the JAX package, where MXNet returns each
sequence's states at its last valid step, as the port does.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import rnn as jrnn
from incubator_mxnet_tpu.models.lstm_lm import LSTMLanguageModel as JLM

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.gluon import _functional
from incubator_mxnet_tpu_torch.gluon import rnn as trnn
from incubator_mxnet_tpu_torch.ndarray import rnn_op as trnn_op

T, N, I, H, L = 5, 3, 4, 6, 2
MODES = ["rnn_relu", "rnn_tanh", "lstm", "gru"]
TOL = 1e-5


def _rel(got, ref, what="", tol=TOL):
    ref = onp.asarray(ref, dtype="float64")
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got, dtype="float64") - ref).max()) \
        / scale
    assert err <= tol, "%s: %.3g of the largest value" % (what, err)


def _jax_grads(jnet):
    """Structural name → gradient of a JAX block, its fused layers' list
    parameters under MXNet's names (as ``convert.jax_arrays`` names
    their values)."""
    out = {k: p.grad().asnumpy() for k, p in
           jnet._collect_params_with_prefix().items()
           if p.grad_req != "null"}

    def walk(block, prefix):
        if hasattr(block, "_i2h"):
            for kind, params in (("i2h_weight", block._i2h),
                                 ("h2h_weight", block._h2h),
                                 ("i2h_bias", block._i2hb),
                                 ("h2h_bias", block._h2hb)):
                for idx, p in enumerate(params):
                    layer, d = divmod(idx, block._dir)
                    out["%s%s%d_%s" % (prefix, "lr"[d], layer, kind)] = \
                        p.grad().asnumpy()
        for name, child in block._children.items():
            walk(child, prefix + name + ".")
    walk(jnet, "")
    return out


def _port_grads(tnet):
    return {k: p.grad().asnumpy() for k, p in
            tnet._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _randomize(jnet, seed):
    """Every parameter of the JAX block uniform in (-0.5, 0.5), biases
    included."""
    rng = onp.random.RandomState(seed)
    for p in jnet.collect_params().values():
        p.set_data(rng.uniform(-0.5, 0.5, p.shape).astype("float32"))


def _objective(outs):
    """sum(out²) + the sum of every other output: a gradient that reaches
    every output."""
    s = (outs[0] * outs[0]).sum()
    for o in outs[1:]:
        s = s + o.sum()
    return s


# ----------------------------------------------------------------- nd.RNN

def _rnn_arrays(mode, bidir, seed=0):
    rng = onp.random.RandomState(seed)
    d = 2 if bidir else 1
    n = jnd.rnn_param_size(mode, I, H, L, bidir)
    assert tnd.rnn_param_size(mode, I, H, L, bidir) == n
    arrays = [rng.uniform(-1, 1, (T, N, I)), rng.uniform(-0.5, 0.5, (n,)),
              rng.uniform(-1, 1, (L * d, N, H))]
    if mode == "lstm":
        arrays.append(rng.uniform(-1, 1, (L * d, N, H)))
    return [a.astype("float32") for a in arrays]


def _run_nd_rnn(m, ag, arrays, mode, bidir, **ctx):
    arrs = [m.array(a, **ctx) for a in arrays]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        outs = m.RNN(*arrs, state_size=H, num_layers=L, mode=mode,
                     bidirectional=bidir, state_outputs=True)
        s = _objective(outs)
    s.backward()
    return [o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrs]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_nd_rnn_matches_the_reference_packed_layout(mode, bidir):
    """Outputs, last states and the gradients of data, the packed vector
    and the states."""
    arrays = _rnn_arrays(mode, bidir)
    want_out, want_grads = _run_nd_rnn(jnd, jautograd, arrays, mode, bidir)
    got_out, got_grads = _run_nd_rnn(tnd, tautograd, arrays, mode, bidir,
                                     ctx=mxt.cpu())
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape
        _rel(g, w, "output %d" % i)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        _rel(g, w, "gradient of input %d" % i)


def test_nd_rnn_without_states_and_outputs_only():
    """Absent states are zeros, and without ``state_outputs`` the output
    alone comes back, as in the reference."""
    x = onp.random.RandomState(3).uniform(-1, 1, (T, N, I)) \
        .astype("float32")
    p = onp.random.RandomState(4).uniform(
        -0.5, 0.5, jnd.rnn_param_size("lstm", I, H, 1)).astype("float32")
    want = jnd.RNN(jnd.array(x), jnd.array(p), None, state_size=H,
                   mode="lstm").asnumpy()
    got = tnd.RNN(tnd.array(x, ctx=mxt.cpu()), tnd.array(p, ctx=mxt.cpu()),
                  None, state_size=H, mode="lstm")
    assert isinstance(got, mxt.nd.NDArray)
    _rel(got.asnumpy(), want, "output")


# ----------------------------------------------------------- fused layers

def _layer(m, kind, layout, bidir, **kw):
    if kind.startswith("rnn"):
        return m.RNN(H, L, activation=kind[4:], layout=layout,
                     bidirectional=bidir, input_size=I, **kw)
    return {"lstm": m.LSTM, "gru": m.GRU}[kind](
        H, L, layout=layout, bidirectional=bidir, input_size=I, **kw)


def _run_layer(net, m, ag, x, states, **ctx):
    xa = m.array(x, **ctx)
    sa = [m.array(s, **ctx) for s in states]
    for a in [xa] + sa:
        a.attach_grad()
    with ag.record():
        out, new = net(xa, sa)
        s = _objective([out] + list(new))
    s.backward()
    return ([out.asnumpy()] + [a.asnumpy() for a in new],
            [xa.grad.asnumpy()] + [a.grad.asnumpy() for a in sa])


@pytest.mark.parametrize("layout,bidir", [("TNC", False), ("NTC", True)])
@pytest.mark.parametrize("kind", MODES)
def test_rnn_layers_match_the_reference(kind, layout, bidir):
    """The same weights (carried by ``from_jax_params`` from the JAX
    layer's lists): outputs, states, and the gradients of the inputs, the
    states and every weight."""
    jnet = _layer(jrnn, kind, layout, bidir)
    jnet.initialize()
    _randomize(jnet, 5)
    tnet = _layer(trnn, kind, layout, bidir)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)        # strict: every weight lands
    rng = onp.random.RandomState(6)
    x = rng.uniform(-1, 1, (T, N, I) if layout == "TNC" else (N, T, I)) \
        .astype("float32")
    d = 2 if bidir else 1
    states = [rng.uniform(-1, 1, (L * d, N, H)).astype("float32")
              for _ in range(2 if kind == "lstm" else 1)]
    want_out, want_in = _run_layer(jnet, jnd, jautograd, x, states)
    got_out, got_in = _run_layer(tnet, tnd, tautograd, x, states,
                                 ctx=mxt.cpu())
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape
        _rel(g, w, "output %d" % i)
    for i, (g, w) in enumerate(zip(got_in, want_in)):
        _rel(g, w, "gradient of input %d" % i)
    want = _jax_grads(jnet)
    got = _port_grads(tnet)
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k], k)


def test_layer_without_states_returns_the_output_alone():
    jnet = _layer(jrnn, "gru", "NTC", False)
    jnet.initialize()
    _randomize(jnet, 7)
    tnet = _layer(trnn, "gru", "NTC", False)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    x = onp.random.RandomState(8).uniform(-1, 1, (N, T, I)) \
        .astype("float32")
    got = tnet(tnd.array(x, ctx=mxt.cpu()))
    assert isinstance(got, mxt.nd.NDArray)
    _rel(got.asnumpy(), jnet(jnd.array(x)).asnumpy(), "output")
    info = tnet.state_info(N)
    assert [i["shape"] for i in info] == [(L, N, H)]
    with mxt.cpu():
        assert [s.shape for s in tnet.begin_state(N)] == [(L, N, H)]


def test_deferred_input_size_takes_the_first_input():
    net = trnn.LSTM(H, 2, bidirectional=True)
    net.initialize(ctx=mxt.cpu())
    assert net.l0_i2h_weight.shape == (4 * H, 0)
    out = net(torch.zeros(T, N, 7))
    assert out.shape == (T, N, 2 * H)
    assert net.l0_i2h_weight.shape == (4 * H, 7)
    assert net.r0_i2h_weight.shape == (4 * H, 7)
    assert net.l1_i2h_weight.shape == (4 * H, 2 * H)


# ------------------------------------------------------------------ cells

def _seq(m, *cells):
    s = m.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


CELLS = {
    "rnn_tanh": lambda m: m.RNNCell(H, input_size=I),
    "rnn_relu": lambda m: m.RNNCell(H, activation="relu", input_size=I),
    "lstm": lambda m: m.LSTMCell(H, input_size=I),
    "gru": lambda m: m.GRUCell(H, input_size=I),
    "sequential": lambda m: _seq(m, m.LSTMCell(H, input_size=I),
                                 m.DropoutCell(0.5),
                                 m.GRUCell(H, input_size=H)),
    "residual": lambda m: m.ResidualCell(m.GRUCell(I, input_size=I)),
    "zoneout": lambda m: m.ZoneoutCell(m.LSTMCell(H, input_size=I), 0.5,
                                       0.5),
}


def _run_unroll(cell, m, ag, x, states, **ctx):
    """unroll over NTC ``x`` (merged outputs) in predict mode under
    record(): outputs, states and the gradients of the inputs."""
    xa = m.array(x, **ctx)
    sa = [m.array(s, **ctx) for s in states]
    for a in [xa] + sa:
        a.attach_grad()
    with ag.record(train_mode=False):
        out, new = cell.unroll(T, xa, sa, layout="NTC", merge_outputs=True)
        s = _objective([out] + list(new))
    s.backward()
    return ([out.asnumpy()] + [a.asnumpy() for a in new],
            [xa.grad.asnumpy()] + [a.grad.asnumpy() for a in sa])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cells_unroll_as_the_reference(name):
    """Every cell (dropout and zoneout in predict mode, where they pass
    their inputs through) over five steps: outputs, states and the
    gradients of inputs, states and weights."""
    jcell = CELLS[name](jrnn)
    jcell.initialize()
    _randomize(jcell, 9)
    tcell = CELLS[name](trnn)
    tcell.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tcell, {k: p.data() for k, p in
                                jcell._collect_params_with_prefix().items()})
    rng = onp.random.RandomState(10)
    x = rng.uniform(-1, 1, (N, T, I)).astype("float32")
    states = [rng.uniform(-1, 1, info["shape"]).astype("float32")
              for info in jcell.state_info(N)]
    assert [i["shape"] for i in tcell.state_info(N)] == \
        [i["shape"] for i in jcell.state_info(N)]
    want_out, want_in = _run_unroll(jcell, jnd, jautograd, x, states)
    got_out, got_in = _run_unroll(tcell, tnd, tautograd, x, states,
                                  ctx=mxt.cpu())
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape
        _rel(g, w, "output %d" % i)
    for i, (g, w) in enumerate(zip(got_in, want_in)):
        _rel(g, w, "gradient of input %d" % i)
    want = {k: p.grad().asnumpy() for k, p in
            jcell._collect_params_with_prefix().items()}
    got = _port_grads(tcell)
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k], k)


def test_cells_step_by_step_and_begin_state():
    """One call is one step; begin_state gives zeros of state_info's
    shapes; the step list form of unroll equals the array form."""
    tcell = trnn.LSTMCell(H, input_size=I)
    tcell.initialize(ctx=mxt.cpu())
    with mxt.cpu():
        states = tcell.begin_state(N)
    assert [s.shape for s in states] == [(N, H), (N, H)]
    assert all(float(abs(s).sum().asscalar()) == 0 for s in states)
    x = tnd.array(onp.random.RandomState(11).uniform(
        -1, 1, (N, T, I)).astype("float32"), ctx=mxt.cpu())
    merged, _ = tcell.unroll(T, x, states, merge_outputs=True)
    steps, _ = tcell.unroll(T, [x[:, t] for t in range(T)], states)
    assert isinstance(steps, list) and len(steps) == T
    for t in range(T):
        assert onp.array_equal(steps[t].asnumpy(), merged[:, t].asnumpy())
    out, new = tcell(x[:, 0], states)
    assert onp.array_equal(out.asnumpy(), steps[0].asnumpy())
    with pytest.raises(NotImplementedError):
        trnn.BidirectionalCell(trnn.GRUCell(H), trnn.GRUCell(H))(
            x[:, 0], states)


VALID = onp.array([5, 2, 3], dtype="float32")


def test_unroll_with_valid_length_masks_and_keeps_last_valid_states():
    """Outputs past each sequence's length are zeros, equal to the
    reference's. The states are each sequence's at its last valid step,
    as MXNet returns them (``rnn_cell.py:unroll``): equal to the JAX
    package's unroll cut to that length. The JAX package returns the last
    step's states instead (a fault, ROADMAP.md §3)."""
    jcell = jrnn.LSTMCell(H, input_size=I)
    jcell.initialize()
    _randomize(jcell, 12)
    tcell = trnn.LSTMCell(H, input_size=I)
    tcell.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tcell, {k: p.data() for k, p in
                                jcell._collect_params_with_prefix().items()})
    rng = onp.random.RandomState(13)
    x = rng.uniform(-1, 1, (N, T, I)).astype("float32")
    states = [rng.uniform(-1, 1, (N, H)).astype("float32") for _ in "hc"]
    jout, jst = jcell.unroll(T, jnd.array(x), [jnd.array(s) for s in states],
                             valid_length=jnd.array(VALID))
    tout, tst = tcell.unroll(T, tnd.array(x, ctx=mxt.cpu()),
                             [tnd.array(s, ctx=mxt.cpu()) for s in states],
                             valid_length=tnd.array(VALID, ctx=mxt.cpu()))
    _rel(tout.asnumpy(), jout.asnumpy(), "masked outputs")
    assert onp.all(tout.asnumpy()[1, 2:] == 0)
    want = onp.zeros((2, N, H), "float32")
    for b, n in enumerate(VALID.astype(int)):
        _, cut = jcell.unroll(int(n), jnd.array(x[:, :n]),
                              [jnd.array(s) for s in states])
        for k in range(2):
            want[k, b] = cut[k].asnumpy()[b]
    for k in range(2):
        _rel(tst[k].asnumpy(), want[k], "state %d at the last valid step" % k)
    assert not onp.allclose(jst[0].asnumpy()[1], want[0, 1], atol=1e-3)


def test_bidirectional_cell_unrolls_as_the_reference():
    """Outputs of a BidirectionalCell (LSTM left, GRU right) equal the
    reference's, with and without valid_length; its states too without."""
    def make(m):
        return m.BidirectionalCell(m.LSTMCell(H, input_size=I),
                                   m.GRUCell(H, input_size=I))
    jcell = make(jrnn)
    jcell.initialize()
    _randomize(jcell, 14)
    tcell = make(trnn)
    tcell.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tcell, {k: p.data() for k, p in
                                jcell._collect_params_with_prefix().items()})
    rng = onp.random.RandomState(15)
    x = rng.uniform(-1, 1, (N, T, I)).astype("float32")
    states = [rng.uniform(-1, 1, (N, H)).astype("float32") for _ in range(3)]
    for valid in (None, VALID):
        kw = {} if valid is None else dict(valid_length=valid)
        jout, jst = jcell.unroll(T, jnd.array(x),
                                 [jnd.array(s) for s in states],
                                 **{k: jnd.array(v) for k, v in kw.items()})
        tout, tst = tcell.unroll(
            T, tnd.array(x, ctx=mxt.cpu()),
            [tnd.array(s, ctx=mxt.cpu()) for s in states],
            **{k: tnd.array(v, ctx=mxt.cpu()) for k, v in kw.items()})
        assert tout.shape == (N, T, 2 * H)
        _rel(tout.asnumpy(), jout.asnumpy(), "outputs %s" % (valid,))
        if valid is None:
            for k, (g, w) in enumerate(zip(tst, jst)):
                _rel(g.asnumpy(), w.asnumpy(), "state %d" % k)


# ------------------------------------------------------------- LSTM LM

LM = dict(vocab_size=50, embed_size=8, hidden_size=8, num_layers=2)


def _lm_pair(dropout=0.0):
    jmodel = JLM(dropout=dropout, **LM)
    jmodel.initialize(mx.init.Uniform(0.1))
    _randomize(jmodel, 16)
    tmodel = mxt.models.LSTMLanguageModel(dropout=dropout, **LM)
    tmodel.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tmodel, jmodel)      # strict: nothing left over
    return jmodel, tmodel


def _lm_batch(seed=17, t=6, n=4):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, LM["vocab_size"], (t, n)).astype("int32"),
            rng.randint(0, LM["vocab_size"], (t, n)).astype("int32"))


def _lm_round(model, m, ag, loss_fn, trainer, x, y, states, **ctx):
    """One word-LM training step: record → model → loss → backward →
    trainer.step; returns (logits, new states, loss) as numpy."""
    xs = m.array(x, **ctx)
    ys = m.array(y.reshape(-1), **ctx)
    st = [m.array(s, **ctx) for s in states]
    with ag.record():
        out, new = model(xs, st)
        loss = loss_fn(out.reshape((-1, LM["vocab_size"])), ys)
    loss.backward()
    trainer.step(x.shape[1])
    return (out.asnumpy(), [s.asnumpy() for s in new], loss.asnumpy())


def test_lstm_lm_forward_gradients_and_three_sgd_steps():
    """LSTMLanguageModel(50, 8, 8, 2) without dropout, weights carried by
    from_jax_params from the JAX model (LSTM weights from its lists):
    logits, states, loss and every gradient of the first step, then every
    weight after three SGD steps (lr 0.5), within 1e-5 of the largest."""
    jmodel, tmodel = _lm_pair()
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jgluon.Trainer(jmodel.collect_params(), "sgd",
                         {"learning_rate": 0.5})
    ttr = mxt.gluon.Trainer(tmodel.collect_params(), "sgd",
                            {"learning_rate": 0.5})
    rng = onp.random.RandomState(18)
    states = [rng.uniform(-1, 1, (L, 4, LM["hidden_size"]))
              .astype("float32") for _ in "hc"]
    for step in range(3):
        x, y = _lm_batch(19 + step)
        want = _lm_round(jmodel, jnd, jautograd, jloss, jtr, x, y, states)
        got = _lm_round(tmodel, tnd, tautograd, tloss, ttr, x, y, states,
                        ctx=mxt.cpu())
        if step == 0:
            _rel(got[0], want[0], "logits")
            for k in range(2):
                _rel(got[1][k], want[1][k], "state %d" % k)
            _rel(got[2], want[2], "loss")
            jg, tg = _jax_grads(jmodel), _port_grads(tmodel)
            assert set(jg) == set(tg) and len(tg) == 11
            for k in jg:
                _rel(tg[k], jg[k], "gradient of " + k)
        states = want[1]
    want = mxt.convert.jax_arrays(jmodel)
    got = mxt.to_numpy_params(tmodel)
    assert set(got) == set(want)
    for k in want:
        _rel(got[k], want[k].asnumpy(), "%s after three steps" % k)


def test_lstm_lm_weights_keep_their_structural_names(tmp_path):
    """Fault 1 of the JAX package: its structural names (what
    save_parameters writes and from_jax_params reads) leave the LSTM's
    eight weights out. The port's hold all eleven under MXNet's names, and
    its .params file round-trips them."""
    jmodel, tmodel = _lm_pair()
    assert sorted(jmodel._collect_params_with_prefix()) == [
        "decoder.bias", "decoder.weight", "embedding.weight"]
    names = sorted(tmodel._collect_params_with_prefix())
    assert len(names) == 11 and "lstm.l0_i2h_weight" in names \
        and "lstm.l1_h2h_bias" in names
    assert sorted(mxt.convert.jax_arrays(jmodel)) == names
    path = str(tmp_path / "lm.params")
    tmodel.save_parameters(path)
    assert sorted(mxt.nd.load(path)) == names
    fresh = mxt.models.LSTMLanguageModel(dropout=0.0, **LM)
    fresh.load_parameters(path, ctx=mxt.cpu())
    for k, v in mxt.to_numpy_params(fresh).items():
        assert onp.array_equal(v, mxt.to_numpy_params(tmodel)[k]), k


def _inject(monkeypatch, mask):
    """Both packages' inter-layer dropout masks become ``mask``."""
    monkeypatch.setattr(trnn_op, "_dropout_mask",
                        lambda shape, keep, device: torch.from_numpy(mask))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))


def test_rnn_dropout_mask_fault_and_the_port_with_injected_masks(
        monkeypatch):
    """Fault 2: the JAX package's LSTM layer draws its inter-layer mask
    inside the function its autograd replays. From one seed its forward
    equals nd.RNN's (which draws its keys first, and so differentiates the
    forward's mask), and its gradients do not. The port's layer draws the
    mask once, in the forward: under one injected mask it equals nd.RNN
    of the JAX package in the output and every gradient."""
    jnet = jrnn.LSTM(H, L, dropout=0.5, input_size=I)
    jnet.initialize()
    _randomize(jnet, 20)
    flat = onp.concatenate([p.data().asnumpy().reshape(-1) for p in (
        jnet._i2h[0], jnet._h2h[0], jnet._i2h[1], jnet._h2h[1],
        jnet._i2hb[0], jnet._h2hb[0], jnet._i2hb[1], jnet._h2hb[1])])
    rng = onp.random.RandomState(21)
    x = rng.uniform(-1, 1, (T, N, I)).astype("float32")

    def jax_layer():
        xa = jnd.array(x)
        xa.attach_grad()
        with jautograd.record():
            out = jnet(xa)
            s = (out * out).sum()
        s.backward()
        return out.asnumpy(), xa.grad.asnumpy()

    def jax_op():
        xa, pa = jnd.array(x), jnd.array(flat)
        xa.attach_grad()
        with jautograd.record():
            out = jnd.RNN(xa, pa, None, state_size=H, num_layers=L,
                          mode="lstm", p=0.5)
            s = (out * out).sum()
        s.backward()
        return out.asnumpy(), xa.grad.asnumpy()

    mx.random.seed(7)
    layer_out, layer_grad = jax_layer()
    mx.random.seed(7)
    op_out, op_grad = jax_op()
    _rel(layer_out, op_out, "same seed, same forward mask")
    assert not onp.allclose(layer_grad, op_grad, rtol=1e-3, atol=1e-4)

    mask = onp.random.RandomState(22).uniform(size=(T, N, H)) < 0.5
    _inject(monkeypatch, mask)
    want_out, want_grad = jax_op()
    tnet = trnn.LSTM(H, L, dropout=0.5, input_size=I)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    xa = tnd.array(x, ctx=mxt.cpu())
    xa.attach_grad()
    with tautograd.record():
        out = tnet(xa)
        s = (out * out).sum()
    s.backward()
    _rel(out.asnumpy(), want_out, "output under the injected mask")
    _rel(xa.grad.asnumpy(), want_grad, "gradient under the injected mask")


def test_port_dropout_masks_are_fresh_each_call_and_off_in_predict():
    """Inter-layer dropout draws from nd.random's generator: a reseed
    repeats the draw, two calls differ, predict mode drops nothing."""
    net = trnn.LSTM(H, L, dropout=0.5, input_size=I)
    net.initialize(ctx=mxt.cpu())
    x = tnd.array(onp.random.RandomState(23).uniform(
        -1, 1, (T, N, I)).astype("float32"), ctx=mxt.cpu())
    with tautograd.train_mode():
        mxt.random.seed(3)
        a = net(x).asnumpy()
        b = net(x).asnumpy()
        mxt.random.seed(3)
        c = net(x).asnumpy()
    assert onp.array_equal(a, c) and not onp.array_equal(a, b)
    p1, p2 = net(x).asnumpy(), net(x).asnumpy()
    assert onp.array_equal(p1, p2)


# ------------------------------------------- hybridize and TrainStep

class _CpuGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        got = self.fn()
        with torch.no_grad():
            for o, g in zip(self.out, got):
                if o is not None and g is not None:
                    o.copy_(g)


class _StandIn:
    """A CPU stand-in for ``jit._GraphCapture`` (the model has no state a
    forward writes, so a capture just runs the function)."""

    def __init__(self, device):
        self.pool = None

    def capture(self, fn, pool=None):
        out = fn()
        return _CpuGraph(fn, out), out


def test_hybridized_lstm_lm_captures_list_states_as_eager(monkeypatch):
    """The word-LM loop's call, ``model(x, [h, c]) -> (logits, [h, c])``,
    through the captured path (a CPU stand-in for the CUDA graph): nested
    arguments and outputs, equal to the eager model bit for bit over three
    training rounds, and one capture."""
    monkeypatch.setattr(_functional, "_uses_graphs", lambda device: True)
    monkeypatch.setattr(tjit, "_GraphCapture", _StandIn)
    runs = []
    for hybrid in (True, False):
        _, tmodel = _lm_pair()
        if hybrid:
            tmodel.hybridize()
        loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        tr = mxt.gluon.Trainer(tmodel.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        with mxt.cpu():
            states = tmodel.begin_state(4)
        got = []
        for step in range(3):
            x, y = _lm_batch(30 + step)
            out, states, loss = _lm_round(tmodel, tnd, tautograd, loss_fn,
                                          tr, x, y, [s.asnumpy() for s in
                                                     states], ctx=mxt.cpu())
            states = [tnd.array(s, ctx=mxt.cpu()) for s in states]
            got.append((out, loss))
        runs.append((got, mxt.to_numpy_params(tmodel), tmodel))
    (hyb, hw, hmodel), (eag, ew, _) = runs
    for (a, la), (b, lb) in zip(hyb, eag):
        assert onp.array_equal(a, b) and onp.array_equal(la, lb)
    for k in ew:
        assert onp.array_equal(hw[k], ew[k]), k
    assert hmodel._captures == 1


def test_train_step_takes_states_that_carry_a_graph():
    """A TrainStep (n_net_inputs = 3: tokens, h0, c0) given states from a
    recorded forward it did not detach reads them as data: the same loss
    and weights as from the detached states."""
    results = []
    for detach in (True, False):
        _, tmodel = _lm_pair()
        ce = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
        tr = mxt.gluon.Trainer(tmodel.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        step = mxt.jit.TrainStep(
            tmodel, lambda out, y: ce(out[0].reshape((-1, LM["vocab_size"])),
                                      y.reshape(-1)), tr)
        x, y = _lm_batch(40)
        xs = tnd.array(x, ctx=mxt.cpu())
        with mxt.cpu():
            states = tmodel.begin_state(4)
        with tautograd.record():
            _, held = tmodel(xs, states)       # a graph the caller holds
        if detach:
            held = [s.detach() for s in held]
        assert detach or held[0]._data.requires_grad
        losses = [step(xs, held[0], held[1], tnd.array(y, ctx=mxt.cpu()),
                       n_net_inputs=3, batch_size=4).asnumpy()
                  for _ in range(2)]
        results.append((losses, mxt.to_numpy_params(tmodel)))
    (la, wa), (lb, wb) = results
    for a, b in zip(la, lb):
        assert onp.array_equal(a, b)
    for k in wa:
        assert onp.array_equal(wa[k], wb[k]), k
