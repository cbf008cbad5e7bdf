"""``HybridBlock.hybridize`` of the port, on the CPU.

On the CPU a hybridized block runs its eager forward: bit for bit the same
outputs and gradients as without ``hybridize``, and within 1e-6 (of the
largest value) of the JAX package's hybridized block (a jitted program),
for a small net of Dense, BatchNorm and Dropout at 0: the forward in
training mode under ``record()``, the loss's gradients and the running
statistics.

The card's path (a forward graph per signature and, under ``record()``,
a backward graph) is exercised through a CPU stand-in for
``jit._GraphCapture``, as ``tests/test_torch_jit.py`` does for
``TrainStep``: a "capture" runs the function and undoes what it wrote (a
capture runs nothing), a "replay" runs it again into the captured output
buffers. So the signature key, the LRU bound, the rebinding checks
(``cast``, ``set_data``, ``load_parameters``), the second capture for a
call whose backward is pending, the launch accounting and a failed
capture are checked here, and the captured path equals the eager one bit
for bit. ``chip_smoke.py`` holds real graphs against eager on the card.
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch.gluon import _functional
from incubator_mxnet_tpu_torch.ops import _kernels


def _net(pkg, dropout=0.0):
    nn = (jgluon if pkg == "jax" else mxt.gluon).nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8))
    net.add(nn.BatchNorm(in_channels=16))
    net.add(nn.Dropout(dropout))
    net.add(nn.Dense(4, in_units=16))
    return net


def _batch(n=16, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, 8).astype("float32"),
            rng.randint(0, 4, n).astype("float32"))


def _port_net(seed=0, dropout=0.0):
    net = _net("torch", dropout)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net


def _rel(got, ref, what=""):
    scale = max(float(onp.abs(ref).max()), 1e-30)
    err = float(onp.abs(onp.asarray(got) - onp.asarray(ref)).max()) / scale
    assert err <= 1e-6, "%s: %.3g of the largest value" % (what, err)


def _train_round(net, x, y, loss_fn, nd):
    """One recorded forward in training mode, the loss's backward; returns
    (output, loss) as numpy."""
    with (mx if nd is mx.nd else mxt).autograd.record():
        out = net(nd.array(x))
        loss = loss_fn(out, nd.array(y))
    loss.backward()
    return out.asnumpy(), loss.asnumpy()


def test_hybridized_cpu_net_matches_jax_hybridized_and_itself():
    x, y = _batch()
    jnet = _net("jax")
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet.hybridize()
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    nets = []
    for hybrid in (True, False):
        tnet = _port_net()
        mxt.from_jax_params(tnet, weights, strict=True)
        if hybrid:
            tnet.hybridize()
        nets.append(tnet)
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    jout, jloss = _train_round(jnet, x, y, jloss_fn, mx.nd)
    runs = []
    with mxt.cpu():
        for tnet in nets:
            out, loss = _train_round(tnet, x, y, tloss_fn, mxt.nd)
            runs.append((out, loss, {
                k: (p.grad().asnumpy() if p.grad_req != "null" else
                    p.data().asnumpy())
                for k, p in tnet._collect_params_with_prefix().items()}))
    (out_h, loss_h, g_h), (out_e, loss_e, g_e) = runs
    assert onp.array_equal(out_h, out_e) and onp.array_equal(loss_h, loss_e)
    for k in g_h:
        assert onp.array_equal(g_h[k], g_e[k]), k
    _rel(out_h, jout, "output")
    _rel(loss_h, jloss, "loss")
    for k, p in jnet._collect_params_with_prefix().items():
        ref = p.grad().asnumpy() if p.grad_req != "null" else \
            p.data().asnumpy()
        _rel(g_h[k], ref, k)
    assert nets[0]._captures == 0 and not nets[0]._graphs


# ---------------------------------------- the card's path, on a stand-in

class _CpuGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        """Run the function again into the captured outputs; its launches
        are counted by the block, per replay."""
        with _kernels.collecting():
            got = self.fn()
        with torch.no_grad():
            for o, g in zip(self.out, got):
                if o is not None and g is not None:
                    o.copy_(g)


def _stand_in(block, fail=None):
    """A stand-in for ``jit._GraphCapture``: a capture runs ``fn`` and
    restores the block's parameters and the generator (a capture runs
    nothing). With ``fail`` set, the capture raises as torch's does on an
    operation it cannot hold."""
    class Capture:
        def __init__(self, device):
            self.pool = None

        def capture(self, fn, pool=None):
            if fail is not None:
                raise RuntimeError(fail)
            saved = [p._tensor().detach().clone()
                     for p in block.collect_params().values()]
            rng = torch.get_rng_state()
            out = fn()
            with torch.no_grad():     # what the forward wrote (BatchNorm)
                for p, s in zip(block.collect_params().values(), saved):
                    if not torch.equal(p._tensor(), s):
                        p._tensor().copy_(s)
            torch.set_rng_state(rng)
            return _CpuGraph(fn, out), out
    return Capture


@pytest.fixture
def graphs(monkeypatch):
    """Route hybridized CPU blocks through the captured path with the
    stand-in bound to the block given."""
    monkeypatch.setattr(_functional, "_uses_graphs", lambda device: True)

    def bind(block, fail=None):
        monkeypatch.setattr(tjit, "_GraphCapture", _stand_in(block, fail))
    return bind


def _probe_net():
    """The small net with a probe "kernel" counted once per forward."""
    net = _port_net()
    base = net.forward

    def forward(x):
        _kernels.count("probe_kernel")
        return base(x)
    net.forward = forward
    return net


def test_captured_path_equals_eager_bit_for_bit(graphs):
    """Three training rounds (record, loss, backward, Trainer.step) with
    the captured path and without, same weights: outputs, gradients,
    running statistics and weights equal bit for bit; one capture of the
    training signature (forward and backward graphs) at its second call;
    the probe counted once per call, the capture's own count taken
    out."""
    x, y = _batch()
    loss_fn = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for hybrid in (True, False):
        net = _probe_net()
        if hybrid:
            graphs(net)
            net.hybridize()
        trainer = mxt.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.01})
        _kernels.reset_launches()
        outs = []
        with mxt.cpu():
            for _ in range(3):
                outs.append(_train_round(net, x, y, loss_fn, mxt.nd))
                trainer.step(x.shape[0])
        assert _kernels.LAUNCHES["probe_kernel"] == 3
        runs.append((outs, mxt.to_numpy_params(net), net))
    (oa, pa, na), (ob, pb, _) = runs
    for (a_out, a_loss), (b_out, b_loss) in zip(oa, ob):
        assert onp.array_equal(a_out, b_out)
        assert onp.array_equal(a_loss, b_loss)
    for k in pa:
        assert onp.array_equal(pa[k], pb[k]), k
    assert na._captures == 1 and len(na._graphs) == 1
    inst = next(iter(na._graphs.values())).instances[0]
    assert inst.fwd is not None and inst.bwd is not None


def test_signature_keys_lru_and_rebinding(graphs, monkeypatch):
    """A signature is (training, recording, shapes/dtypes/grad needs),
    run eagerly at its first call and captured at its second: predict
    mode, a new batch size and a recording call each capture once;
    ``Trainer.step`` keeps the graphs; ``set_data``, ``cast`` and
    ``load_parameters`` capture again; past MXTPU_EXEC_CACHE_SIZE (the
    JAX package's bound of a hybridized block's cache) the least recently
    used signature goes."""
    x, _ = _batch()
    net = _port_net()
    graphs(net)
    net.hybridize()
    monkeypatch.setenv("MXTPU_EXEC_CACHE_SIZE", "3")
    xt = torch.from_numpy(x)
    with mxt.cpu():
        with mxt.autograd.pause():
            net(xt)                     # eager: the signature is seen
            assert net._captures == 0
            net(xt)                     # captured, replayed
            net(xt)
            assert net._captures == 1
            net(xt[:4])
            net(xt[:4])
            assert net._captures == 2
            with mxt.autograd.train_mode():
                net(xt)
                net(xt)
            assert net._captures == 3 and len(net._graphs) == 3
        for _ in range(2):
            with mxt.autograd.record():
                out = net(xt)
            out.sum().backward()
        assert net._captures == 4 and len(net._graphs) == 3
        keys = [k[:2] for k in net._graphs]
        assert keys == [(False, False), (True, False), (True, True)]
        trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        trainer.step(1)
        with mxt.autograd.record():
            net(xt).sum().backward()
        assert net._captures == 4
        w = net[0].weight
        w.set_data(onp.ones(w.shape, "float32"))
        with mxt.autograd.record():
            net(xt).sum().backward()
        assert net._captures == 5
        net.cast("float64")
        net.cast("float32")
        with mxt.autograd.record():
            net(xt).sum().backward()
        assert net._captures == 6


def test_load_parameters_captures_again(graphs, tmp_path):
    x, _ = _batch()
    net = _port_net()
    graphs(net)
    net.hybridize()
    xt = torch.from_numpy(x)
    fname = str(tmp_path / "net.params")
    with mxt.cpu(), mxt.autograd.pause():
        first = net(xt).detach().clone()
        net.save_parameters(fname)
        net(xt)
        assert net._captures == 1
        other = _port_net(seed=3)
        other.save_parameters(fname + "2")
        net.load_parameters(fname + "2")
        changed = net(xt)
        assert net._captures == 2
        assert not torch.equal(changed, first)
        net.load_parameters(fname)
        assert torch.equal(net(xt), first)


def test_a_pending_backward_takes_a_second_capture(graphs):
    """Recorded calls before their backward (a shared net, as in a siamese
    loss): the third cannot overwrite the activations of the second (the
    first capture's replay), so it takes a second capture; the gradients
    equal the eager ones."""
    x, _ = _batch()
    x2 = x[::-1].copy()
    grads = []
    for hybrid in (True, False):
        net = _port_net()
        if hybrid:
            graphs(net)
            net.hybridize()
        with mxt.cpu():
            with mxt.autograd.record():
                a = net(mxt.nd.array(x))      # eager
                b = net(mxt.nd.array(x2))     # captured, replayed
                c = net(mxt.nd.array(x))      # b's backward pending
                loss = (a * a).sum() + (b * 3).sum() + (c * b).sum()
            loss.backward()
        grads.append({k: p.grad().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()
                      if p.grad_req != "null"})
        if hybrid:
            entry = list(net._graphs.values())[-1]
            assert len(entry.instances) == 2
    for k in grads[0]:
        assert onp.array_equal(grads[0][k], grads[1][k]), k


def test_a_failed_capture_raises_naming_the_block(graphs):
    x, _ = _batch()
    net = _port_net()
    graphs(net, fail="operation not permitted when stream is capturing")
    net.hybridize()
    with mxt.cpu():
        net(torch.from_numpy(x))               # eager: nothing captured
        with pytest.raises(RuntimeError) as info:
            net(torch.from_numpy(x))
    msg = str(info.value)
    assert "hybridized HybridSequential: capturing the forward" in msg
    assert "not permitted when stream is capturing" in msg
    assert net._captures == 0 and not net._graphs


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_runs_a_hybridized_net_plainly(graphs, remat):
    """Inside a TrainStep (which captures the whole step itself), its
    rematerialised forward's recomputation (on autograd's thread) and an
    EvalStep a hybridized net runs its plain forward: no capture of its
    own, and the same losses as the net without hybridize."""
    x, y = _batch()
    losses = []
    for hybrid in (True, False):
        net = _port_net()
        if hybrid:
            graphs(net)
            net.hybridize()
        trainer = mxt.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        step = tjit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                              trainer, remat=remat)
        losses.append([step(x, y).asnumpy() for _ in range(2)])
        losses[-1].append(tjit.EvalStep(net)(x).asnumpy())
        assert net._captures == 0
    for a, b in zip(*losses):
        assert onp.array_equal(a, b)


def test_hybridize_off_and_export(tmp_path):
    """``export`` after a call takes that call's signature (as the JAX
    package's ``_last_input_avals``): the parameters, the manifest and
    the ``.mxtpu`` artifact, whose program equals the eager forward."""
    net = _port_net()
    net.hybridize()
    net.hybridize(False)
    assert not net._active
    x, _ = _batch(4)
    ref = net(mxt.nd.array(x, ctx=mxt.cpu())).asnumpy()
    path = str(tmp_path / "x")
    net.export(path)
    served = mxt.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"])
    assert onp.array_equal(served(mxt.nd.array(x, ctx=mxt.cpu())).asnumpy(),
                           ref)


class _Partial(mxt.gluon.HybridBlock):
    """A net with a parameter its forward never reads."""

    def __init__(self):
        super().__init__()
        self.body = _port_net()
        self.unused = mxt.gluon.Parameter("unused", shape=(3,))
        self.unused.initialize(ctx=mxt.cpu())

    def forward(self, x):
        return self.body(x)


def test_a_parameter_the_backward_does_not_reach(graphs):
    """The captured backward gives no gradient to a parameter the forward
    does not read, and leaves it out of the replay, as an eager backward
    does: its grad() stays zeros, the others equal the eager ones, and
    clip_global_norm takes every grad()."""
    x, y = _batch()
    got = []
    for hybrid in (True, False):
        net = _Partial()
        if hybrid:
            graphs(net)
            net.hybridize()
        with mxt.cpu():
            for _ in range(3):
                _train_round(net, x, y,
                             mxt.gluon.loss.SoftmaxCrossEntropyLoss(), mxt.nd)
        named = {k: p.grad() for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        grads = list(named.values())
        norm = mxt.gluon.utils.clip_global_norm(grads, 1e9)
        got.append(({k: g.asnumpy() for k, g in named.items()}, norm))
        if hybrid:
            inst = next(iter(net._graphs.values())).instances[0]
            assert all(t is not net.unused._tensor() for t in inst.reached)
            assert len(inst.reached) == len(grads) - 1
    (ga, na), (gb, nb) = got
    assert na == nb
    for k in ga:
        assert onp.array_equal(ga[k], gb[k]), k
    assert not ga["unused"].any()
