"""The port's SPMD runtime, data and tensor parallelism against the JAX
package's, on the CPU.

The port's meshes name the CPU device once per position (``[cpu] * 8``),
the counterpart of the JAX package's 8 forced host devices. Held: the mesh
and its specs; the collectives and the rendezvous deadline (a missing
participant raises within its deadline, never hangs); ``make_mesh`` with
no devices and no CUDA raises; ``DataParallelTrainStep`` against the JAX
package's (and against one device, with batch norm taking its statistics
over the global batch: rtol 1e-4, atol 1e-5); ``TrainStep(zero=True)``
against the JAX package's and against ``zero=False`` (rtol 2e-3 on
losses, 2e-2 on parameters) with each state in 8 slices;
``ColParallelDense``/``RowParallelDense`` and ``SyncBatchNorm`` against
the JAX package's; a capture site counts only its own thread's
``shard_map`` calls.
"""
import threading
import time

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jpar

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import compat

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset_meshes():
    yield
    tpar.set_current_mesh(None)
    jpar.set_current_mesh(None)


# ------------------------------------------------------------------ mesh
def test_make_mesh_shapes_and_specs():
    mesh = tpar.make_mesh({"dp": 2, "tp": 4}, devices=CPU8)
    assert dict(mesh.shape) == {"dp": 2, "tp": 4}
    assert tpar.current_mesh() is mesh
    assert tpar.make_mesh({"dp": -1}, devices=CPU8).shape["dp"] == 8
    with pytest.raises(ValueError, match="do not cover"):
        tpar.make_mesh({"dp": 3}, devices=CPU8)
    P = tpar.mesh.P
    assert P("tp", None) == ("tp", None) and P() == ()
    assert tpar.replicated(mesh).spec == P()
    assert tpar.shard_spec(mesh, "dp", None).spec == P("dp", None)
    inner = tpar.make_mesh({"sp": 2}, devices=CPU8[:2])
    with mesh:
        assert tpar.current_mesh() is mesh
    assert tpar.current_mesh() is inner
    assert tpar.HAVE_SHARD_MAP and compat.require_shard_map() is \
        tpar.shard_map


def test_make_mesh_without_devices_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is visible: the default devices exist")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mxt.serving.serving_mesh(1)


# ----------------------------------------------------------- collectives
def test_collectives_and_static_axis_index():
    mesh = tpar.make_mesh({"dp": 2, "tp": 4}, devices=CPU8)
    P = tpar.mesh.P
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(8, 3)

    def body(xs):
        assert isinstance(compat.axis_index("tp"), int)
        assert compat.axis_size(("dp", "tp")) == 8
        s = compat.psum(xs, "tp")
        r = compat.ppermute(xs, "tp", [(j, (j + 1) % 4) for j in range(4)])
        g = compat.psum(xs, ("dp", "tp"))
        a = compat.all_to_all(xs.repeat(1, 4), "tp", split_axis=1,
                              concat_axis=0)
        return s, r, g, a
    s, r, g, a = tpar.shard_map(body, mesh, in_specs=P(("dp", "tp")),
                                out_specs=(P(), P(("dp", "tp")), P(),
                                           P("dp")))(x)
    rows = x.reshape(2, 4, 3)
    assert torch.equal(s, rows[0].sum(0, keepdim=True))
    assert torch.equal(r, torch.roll(rows, 1, dims=1).reshape(8, 3))
    assert torch.equal(g, x.sum(0, keepdim=True))
    # all_to_all: position t of row d gets chunk t of every member
    want = torch.cat([rows[d, :, :].repeat(1, 4)[:, 0:3]
                      for d in range(2)])
    assert torch.equal(a, want)


def test_collectives_differentiate_across_threads():
    """One backward over the joined output reaches every position's input
    (psum's transpose is psum), with no collective in the backward."""
    mesh = tpar.make_mesh({"sp": 8}, devices=CPU8)
    P = tpar.mesh.P
    x = torch.randn(8, 5, requires_grad=True)
    w = torch.arange(8.0).reshape(8, 1)

    def body(xs, ws):
        return compat.psum(xs * ws, "sp")
    out = tpar.shard_map(body, mesh, in_specs=(P("sp"), P("sp")),
                         out_specs=P())(x, w)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, w.expand(8, 5))


def test_rendezvous_missing_participant_raises_within_deadline():
    """A position that skips a collective leaves its peers waiting: they
    raise RendezvousTimeout within the deadline instead of hanging."""
    mesh = tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    P = tpar.mesh.P

    def body(xs):
        if compat.axis_index("sp") == 3:
            return xs
        return compat.psum(xs, "sp")
    t0 = time.monotonic()
    with pytest.raises(compat.RendezvousTimeout, match="waited"):
        tpar.shard_map(body, mesh, in_specs=P("sp"), out_specs=P("sp"),
                       timeout=0.5)(torch.zeros(4, 2))
    assert time.monotonic() - t0 < 10.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shard_map-")]


def test_failing_position_fails_its_peers_at_once():
    mesh = tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    P = tpar.mesh.P

    def body(xs):
        if compat.axis_index("sp") == 1:
            raise KeyError("position 1")
        return compat.psum(xs, "sp")
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="position 1"):
        tpar.shard_map(body, mesh, in_specs=P("sp"), out_specs=P("sp"),
                       timeout=60.0)(torch.zeros(4, 2))
    assert time.monotonic() - t0 < 10.0


def test_shard_threads_carry_the_callers_thread_state():
    """Grad mode, the port's record/training state and the kernel-launch
    collector are entered in each shard thread as the caller had them."""
    from incubator_mxnet_tpu_torch.ops import _kernels
    mesh = tpar.make_mesh({"sp": 4}, devices=CPU8[:4])
    P = tpar.mesh.P
    seen = []

    def body(xs):
        seen.append((torch.is_grad_enabled(), mxt.autograd.is_training(),
                     threading.current_thread().name))
        _kernels.count("probe")
        return xs
    with _kernels.collecting() as counts:
        with mxt.autograd.record(train_mode=True):
            tpar.shard_map(body, mesh, in_specs=P("sp"),
                           out_specs=P("sp"))(torch.zeros(4, 2))
        with torch.no_grad():
            tpar.shard_map(body, mesh, in_specs=P("sp"),
                           out_specs=P("sp"))(torch.zeros(4, 2))
    assert counts == {"probe": 8}
    assert sorted(s[:2] for s in seen) == [(False, False)] * 4 + \
        [(True, True)] * 4
    assert len({s[2] for s in seen}) >= 4


class _Gate(mxt.gluon.HybridBlock):
    """A Dense whose first forward lets another thread run while it
    waits (bounded)."""

    def __init__(self):
        super().__init__()
        self.dense = mxt.gluon.nn.Dense(4, in_units=8)
        self.started, self.done = threading.Event(), threading.Event()
        self.armed = True

    def forward(self, x):
        if self.armed:
            self.armed = False
            self.started.set()
            assert self.done.wait(30), "the serving thread did not finish"
        return self.dense(x)


@pytest.mark.parametrize("site", ["eval", "train", "hybridize"])
def test_shard_map_on_another_thread_leaves_a_first_call_capturable(
        site, monkeypatch):
    """While a block's first call runs (the run a capture site watches for
    shard_map: a BlockServable's bucket build through EvalStep, a
    TrainStep's first step, a hybridized forward), a MeshServable serves
    a batch on another thread. Only the calls of a site's own thread and
    its positions count (``compat.tracking``): the block's signature is
    captured all the same, through the CPU stand-ins for the graph."""
    import test_torch_aot
    import test_torch_hybridize
    import test_torch_jit
    from incubator_mxnet_tpu_torch.gluon import _functional
    tp = mxt.gluon.nn.HybridSequential()
    tp.add(tpar.ColParallelDense(12, in_units=8))
    tp.initialize(ctx=mxt.cpu())
    mesh_sv = mxt.serving.MeshServable(tp, tp=2, devices=CPU8)
    net = _Gate()
    net.initialize(ctx=mxt.cpu())
    X, y = _data(4)
    served = []

    def serve():
        if net.started.wait(30):
            served.append(compat.tracking(
                lambda: mesh_sv.predict_batch(X))[0])
        net.done.set()
    server = threading.Thread(target=serve)
    server.start()
    try:
        if site == "eval":
            monkeypatch.setattr(mxt.jit, "_uses_graphs", lambda d: True)
            monkeypatch.setattr(mxt.jit, "_GraphCapture",
                                test_torch_aot.CpuCapture)
            block_sv = mxt.serving.BlockServable(net)
            block_sv.predict_batch(X)
            (step,) = block_sv._steps.values()
            assert step.captures == 1
            block_sv.release()
        elif site == "train":
            step = mxt.jit.TrainStep(net, mxt.gluon.loss.L2Loss(),
                                     mxt.gluon.Trainer(net.collect_params(),
                                                       "sgd"))
            monkeypatch.setattr(mxt.jit, "_GraphCapture",
                                test_torch_jit._cpu_capture(step))
            step._replay(step._prepare((X, X[:, :4]), 1), 1, 4)
            assert step.captures == 1 and not step._uncaptured
        else:
            monkeypatch.setattr(_functional, "_uses_graphs", lambda d: True)
            monkeypatch.setattr(mxt.jit, "_GraphCapture",
                                test_torch_hybridize._stand_in(net))
            net.hybridize()
            for _ in range(2):
                net(torch.from_numpy(X))
            assert net._captures == 1
            assert not any(e.eager for e in net._graphs.values())
    finally:
        net.done.set()
        server.join(30)
    assert served and served[0] >= 1


# ------------------------------------------------------- data parallel
def _jax_mlp(seed, bn=False):
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, activation="relu", in_units=8))
    if bn:
        net.add(jgluon.nn.BatchNorm(in_channels=16))
    net.add(jgluon.nn.Dense(4, in_units=16))
    mx.random.seed(seed)
    net.initialize(mx.init.Xavier())
    return net


def _port_like(jnet, bn=False):
    net = mxt.gluon.nn.HybridSequential()
    net.add(mxt.gluon.nn.Dense(16, activation="relu", in_units=8))
    if bn:
        net.add(mxt.gluon.nn.BatchNorm(in_channels=16))
    net.add(mxt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(net, jnet)
    return net


def _data(n=16, seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randn(n, 8).astype("float32"),
            rng.randint(0, 4, n).astype("float32"))


@pytest.mark.parametrize("bn", [False, True])
def test_data_parallel_step_matches_jax_and_one_device(bn):
    """Three SGD steps: the port's DataParallelTrainStep over dp = 8
    against the JAX package's over its 8 devices and against the port's
    TrainStep on one device; with BatchNorm the statistics (and the
    running statistics) are the global batch's."""
    X, y = _data()
    jnet = _jax_mlp(3, bn)
    tnet, tnet1 = _port_like(jnet, bn), _port_like(jnet, bn)
    jmesh = jpar.make_mesh({"dp": 8})
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jstep = jpar.DataParallelTrainStep(
        jnet, jloss, jgluon.Trainer(jnet.collect_params(), "sgd",
                                    {"learning_rate": 0.1}), mesh=jmesh)
    tmesh = tpar.make_mesh({"dp": 8}, devices=CPU8)
    tloss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    tstep = tpar.DataParallelTrainStep(
        tnet, tloss, mxt.gluon.Trainer(tnet.collect_params(), "sgd",
                                       {"learning_rate": 0.1}), mesh=tmesh)
    one = mxt.jit.TrainStep(tnet1, tloss, mxt.gluon.Trainer(
        tnet1.collect_params(), "sgd", {"learning_rate": 0.1}))
    for _ in range(3):
        lj = jstep(jnd.array(X), jnd.array(y)).asnumpy()
        lt = tstep(X, y).asnumpy()
        l1 = one(X, y).asnumpy()
        onp.testing.assert_allclose(lt, lj, **TOL)
        onp.testing.assert_allclose(lt, l1, **TOL)
    jp = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet._collect_params_with_prefix().items():
        onp.testing.assert_allclose(p.data().asnumpy(), jp[k], **TOL)
    for p, p1 in zip(tnet.collect_params().values(),
                     tnet1.collect_params().values()):
        onp.testing.assert_allclose(p.data().asnumpy(), p1.data().asnumpy(),
                                    **TOL)


def test_data_parallel_step_needs_a_mesh_and_a_per_sample_loss():
    net = _port_like(_jax_mlp(1))
    tr = mxt.gluon.Trainer(net.collect_params(), "sgd")
    loss = mxt.gluon.loss.SoftmaxCrossEntropyLoss()
    with pytest.raises(ValueError, match="needs a mesh"):
        tpar.DataParallelTrainStep(net, loss, tr)
    mesh = tpar.make_mesh({"dp": 8}, devices=CPU8)
    with pytest.raises(ValueError, match="data_axis 'x'"):
        mxt.jit.TrainStep(net, loss, tr, mesh=mesh, data_axis="x")
    with pytest.raises(NotImplementedError, match="remat under a mesh"):
        mxt.jit.TrainStep(net, loss, tr, mesh=mesh, remat=True)
    step = mxt.jit.TrainStep(net, lambda out, y: loss(out, y).mean(), tr,
                             mesh=mesh)
    X, y = _data()
    with pytest.raises(ValueError, match="per-sample loss"):
        step(X, y)


def test_zero1_states_in_slices_and_the_trajectory_of_zero_false():
    """The JAX package's test_zero1_optimizer_state_sharding: fp16 weights,
    Adam with multi_precision (fp32 masters in the state), 3 steps over
    dp = 8 with and without zero; zero=True's losses and parameters held
    against the JAX package's TrainStep(mesh, zero=True) over its 8
    devices from the same weights and against the port's zero=False; each
    state of a row-divisible parameter is held in 8 slices of an eighth
    each, and save_states gathers them."""
    from incubator_mxnet_tpu import jit as jjit
    X, y = _data()
    X = X.astype("float16")
    jnet = _jax_mlp(7)
    mesh = tpar.make_mesh({"dp": 8}, devices=CPU8)

    def run(zero):
        net = _port_like(jnet)
        net.cast("float16")
        tr = mxt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2,
                                "multi_precision": True})
        step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 tr, mesh=mesh, zero=zero)
        losses = [float(step(X, y).asnumpy().mean()) for _ in range(3)]
        return net, tr, losses
    net0, tr0, l0 = run(False)
    net1, tr1, l1 = run(True)
    jref = _jax_mlp(7)
    jref.cast("float16")
    jstep = jjit.TrainStep(
        jref, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jgluon.Trainer(jref.collect_params(), "adam",
                       {"learning_rate": 1e-2, "multi_precision": True}),
        mesh=jpar.make_mesh({"dp": 8}), zero=True)
    lj = [float(jstep(jnd.array(X), jnd.array(y)).mean().asnumpy())
          for _ in range(3)]
    onp.testing.assert_allclose(l1, lj, rtol=2e-3, atol=1e-4)
    onp.testing.assert_allclose(l1, l0, rtol=2e-3, atol=1e-4)
    jp = {k: p.data().asnumpy().astype("float32")
          for k, p in jref._collect_params_with_prefix().items()}
    for k, p in net1._collect_params_with_prefix().items():
        onp.testing.assert_allclose(p.data().asnumpy().astype("float32"),
                                    jp[k], rtol=2e-2, atol=1e-3)
    for p0, p1 in zip(net0.collect_params().values(),
                      net1.collect_params().values()):
        onp.testing.assert_allclose(p1.data().asnumpy().astype("float32"),
                                    p0.data().asnumpy().astype("float32"),
                                    rtol=2e-2, atol=1e-3)
    from incubator_mxnet_tpu_torch.parallel.data_parallel import (
        ShardedState, _leaves)
    sharded = 0
    for p, st in zip(tr1._params, tr1._states):
        for leaf in _leaves(st):
            if isinstance(leaf, ShardedState):
                sharded += 1
                assert len(leaf.slices) == 8
                assert all(s.numel() * 8 == p._tensor().numel()
                           for s in leaf.slices)
    assert sharded >= 4
    for st0, st1 in zip(tr0._states, tr1._states):
        for a, b in zip(_leaves(st0), _leaves(st1)):
            b = b.gather() if isinstance(b, ShardedState) else b
            onp.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-2,
                                        atol=1e-3)


def test_zero1_refuses_whole_weight_optimizers():
    net = _port_like(_jax_mlp(2))
    mesh = tpar.make_mesh({"dp": 8}, devices=CPU8)
    tr = mxt.gluon.Trainer(net.collect_params(), "lamb")
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             tr, mesh=mesh, zero=True)
    X, y = _data()
    with pytest.raises(NotImplementedError, match="LAMB"):
        step(X, y)


def test_zero1_save_states_round_trips(tmp_path):
    X, y = _data()
    net = _port_like(_jax_mlp(4))
    mesh = tpar.make_mesh({"dp": 8}, devices=CPU8)
    tr = mxt.gluon.Trainer(net.collect_params(), "adam")
    step = mxt.jit.TrainStep(net, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             tr, mesh=mesh, zero=True)
    step(X, y)
    f = str(tmp_path / "states")
    tr.save_states(f)
    from incubator_mxnet_tpu_torch.parallel.data_parallel import gathered
    want = [gathered(s) for s in tr._states]
    tr2 = mxt.gluon.Trainer(net.collect_params(), "adam")
    tr2.load_states(f)
    for a, b in zip(want, tr2._states):
        for x, z in zip(a, b):
            assert torch.equal(x, z)


# ----------------------------------------------------- tensor parallel
def test_col_and_row_parallel_dense_match_jax():
    """The Megatron MLP (ColParallelDense then RowParallelDense) over a
    dp x tp mesh: the port's per-shard forward against the JAX package's
    forward of the same weights, and one DataParallelTrainStep on the 2-D
    mesh against the JAX package's."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jpar.ColParallelDense(32, activation="relu", in_units=8),
             jpar.RowParallelDense(4, in_units=32))
    mx.random.seed(5)
    jnet.initialize(mx.init.Xavier())
    tnet = mxt.gluon.nn.HybridSequential()
    tnet.add(tpar.ColParallelDense(32, activation="relu", in_units=8),
             tpar.RowParallelDense(4, in_units=32))
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    P = tpar.mesh.P
    assert tnet[0].weight.sharding == P("tp", None)
    assert tnet[0].bias.sharding == P("tp")
    assert tnet[1].weight.sharding == P(None, "tp")
    X, y = _data(8, seed=5)
    ref = jnet(jnd.array(X)).asnumpy()
    tmesh = tpar.make_mesh({"dp": 2, "tp": 4}, devices=CPU8)
    got = tnet(torch.tensor(X)).detach().numpy()
    onp.testing.assert_allclose(got, ref, **TOL)
    jmesh = jpar.make_mesh({"dp": 2, "tp": 4})
    jl = jpar.DataParallelTrainStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1}),
        mesh=jmesh)(jnd.array(X), jnd.array(y)).asnumpy()
    tl = tpar.DataParallelTrainStep(
        tnet, mxt.gluon.loss.SoftmaxCrossEntropyLoss(),
        mxt.gluon.Trainer(tnet.collect_params(), "sgd",
                          {"learning_rate": 0.1}),
        mesh=tmesh)(X, y).asnumpy()
    onp.testing.assert_allclose(tl, jl, **TOL)
    jp = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet._collect_params_with_prefix().items():
        onp.testing.assert_allclose(p.data().asnumpy(), jp[k], **TOL)


def test_tensor_parallel_dense_splits_only_over_a_mesh_axis():
    """Without a mesh holding the axis (or with one position on it) the
    layer runs its plain forward; column parallel output is the gathered
    per-shard slices: bit for bit the concatenation of the same per-shard
    products (``F.linear`` of each shard's rows of W and b), and within
    one fp32 rounding of the unsplit product (a CPU BLAS does not promise
    the same bits across output widths)."""
    layer = tpar.ColParallelDense(16, in_units=8, flatten=False)
    layer.initialize(ctx=mxt.cpu())
    x = torch.randn(3, 5, 8)
    plain = layer(x).detach()
    with tpar.make_mesh({"dp": 8}, devices=CPU8):
        assert torch.equal(layer(x).detach(), plain)
    with tpar.make_mesh({"tp": 4}, devices=CPU8[:4]):
        split = layer(x).detach()
    w, b = layer.weight.data()._data, layer.bias.data()._data
    shards = torch.cat([torch.nn.functional.linear(x, ws, bs) for ws, bs in
                        zip(w.chunk(4, dim=0), b.chunk(4))], dim=-1)
    assert torch.equal(split, shards)
    torch.testing.assert_close(split, plain, rtol=1e-6, atol=1e-6)


def test_shard_params_rules():
    P = tpar.mesh.P
    net = mxt.gluon.nn.Dense(16, in_units=4)
    net.initialize(ctx=mxt.cpu())
    tpar.shard_params(net, [("weight", P("tp", None))])
    assert net.weight.sharding == P("tp", None)
    assert net.bias.sharding is None


def test_sync_batch_norm_across_devices_is_global_batch_norm():
    """SyncBatchNorm(num_devices=8) and nd.contrib.SyncBatchNorm(ndev=8)
    no longer raise: inside a dp step they take the global batch's
    statistics, as BatchNorm does; outside one they are BatchNorm."""
    x = onp.random.RandomState(9).randn(16, 4).astype("float32")
    mesh = tpar.make_mesh({"dp": 8}, devices=CPU8)
    P = tpar.mesh.P
    outs = []
    for cls in (mxt.gluon.nn.BatchNorm, mxt.gluon.nn.SyncBatchNorm):
        kw = {"num_devices": 8} if cls is mxt.gluon.nn.SyncBatchNorm else {}
        bn = cls(in_channels=4, **kw)
        bn.initialize(ctx=mxt.cpu())
        with mxt.autograd.record(train_mode=True):
            whole = bn(torch.tensor(x)).detach()
            split = tpar.shard_map(bn, mesh, in_specs=P("dp"),
                                   out_specs=P("dp"),
                                   batch_axes=("dp",))(torch.tensor(x))
        onp.testing.assert_allclose(split.detach().numpy(), whole.numpy(),
                                    **TOL)
        outs.append((whole, bn.running_mean.data().asnumpy().copy()))
    assert torch.equal(outs[0][0], outs[1][0])
    onp.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)
    g, b = torch.ones(4), torch.zeros(4)
    rm, rv = torch.zeros(4), torch.ones(4)
    with mxt.autograd.train_mode():
        got = mxt.nd.contrib.SyncBatchNorm(torch.tensor(x), g, b, rm, rv,
                                           ndev=8)
    assert got.shape == (16, 4)


def test_rendezvous_and_global_batch_norm_under_thread_stress():
    """Sixteen positions (more than the cores) with a short switch
    interval: 40 rounds of collectives give exact sums and shifts, and a
    batch norm over a dp = 16 split normalises every position by the
    global batch's statistics and updates its running statistics once (the
    position at index 0 writes them while its peers still use the
    shift)."""
    import sys
    mesh = tpar.make_mesh({"sp": 16}, devices=[torch.device("cpu")] * 16)
    P = tpar.mesh.P
    x = torch.arange(16.0).reshape(16, 1)

    def body(xs):
        total = xs
        for i in range(40):
            total = compat.psum(total, "sp") / 16 + xs
            xs = compat.ppermute(xs, "sp", [(j, (j + 1) % 16)
                                            for j in range(16)])
        return total, xs
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        total, rolled = tpar.shard_map(body, mesh, in_specs=P("sp"),
                                       out_specs=(P("sp"), P("sp")),
                                       timeout=60.0)(x)
        bn, one = (mxt.gluon.nn.BatchNorm(in_channels=3) for _ in range(2))
        for b in (bn, one):
            b.initialize(ctx=mxt.cpu())
        data = torch.tensor(onp.random.RandomState(11).randn(32, 3)
                            .astype("float32")) * 3 + 1
        outs = []
        with mxt.autograd.record(train_mode=True):
            for _ in range(3):
                outs.append((tpar.shard_map(
                    bn, mesh, in_specs=P("sp"), out_specs=P("sp"),
                    batch_axes=("sp",), timeout=60.0)(data), one(data)))
    finally:
        sys.setswitchinterval(interval)
    for got, want in outs:
        onp.testing.assert_allclose(got.detach().numpy(),
                                    want.detach().numpy(), rtol=1e-5,
                                    atol=1e-5)
    want, xs = x.clone(), x.clone()
    for _ in range(40):                 # the same rounds on one thread
        want = want.sum(0, keepdim=True).expand(16, 1) / 16 + xs
        xs = torch.roll(xs, 1, dims=0)
    assert torch.equal(rolled, xs)
    onp.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-6)
    for name in ("running_mean", "running_var"):
        onp.testing.assert_allclose(
            getattr(bn, name).data().asnumpy(),
            getattr(one, name).data().asnumpy(), rtol=1e-5, atol=1e-6)
