"""Several processes: the port's ``parallel.dist``, ``GradientCompression``,
the dist kvstores, the server role and ``Trainer(kvstore="dist_*")``,
against the JAX package on the CPU.

The multi-process test starts this file itself as the worker, through the
JAX package's own launcher (``tools/launch.py -n 3``, left as it is): each
worker imports the port only (never JAX), which starts a gloo process
group from the launcher's environment, runs the matrix that
``tests/dist_worker.py`` runs for the JAX package, and prints one
``RESULT`` line a check. The parent holds the lines to every closed form
``tests/dist_worker.py`` asserts (push/pull 1+2+3, compression [0.5, -0.5,
-1.0, 0], the dist_async average, the uneven budget of 1, bitwise-equal
parameter digests across ranks) and the dist_sync SGD weights to the JAX
package's ``LocalKVStore`` fed the same sum (added in rank order, as both
packages add the gathered values), within one float32 ulp. A second run
of two workers has one die before its push: the other's collective must
raise within the group's timeout, not hang. Every run is bounded by a
``subprocess`` timeout.

Tolerances: compression exact (the same float32 arithmetic); the stores
and the Trainer against the JAX package 1e-6 relative (SGD's multiply-add
order); every digest across ranks bit for bit.
"""
import hashlib
import os
import re
import socket
import subprocess
import sys

import numpy as onp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NWORKERS = 3
WORKER_TIMEOUT_S = 120


def _digest(a):
    return hashlib.sha256(onp.ascontiguousarray(a)).hexdigest()


# ======================================================= the worker side
def _worker():
    """One rank of the matrix (runs in a process tools/launch.py made)."""
    sys.path.insert(0, REPO)
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.parallel import dist
    cpu = mx.cpu()

    def say(check, *rest):
        # one write a line: the workers share one pipe, and a write of
        # less than PIPE_BUF bytes is not interleaved with another's
        os.write(1, ("RESULT %s %d %s\n" % (
            check, rank, " ".join(map(str, rest)))).encode())

    assert dist.is_initialized() and dist.backend() == "gloo"
    kv = mx.kv.create("dist_sync")
    rank, nworkers = kv.rank, kv.num_workers
    assert nworkers == int(os.environ["MXTPU_NUM_PROC"]) == dist.num_workers()
    assert rank == dist.rank() == int(os.environ["MXTPU_PROC_ID"])

    def arr(a):
        return nd.array(onp.asarray(a, dtype="float32"), ctx=cpu)

    # 1. init broadcasts rank 0's value; push sums over the processes
    kv.init("a", arr(onp.full(4, 100.0 if rank == 0 else 0.0)))
    out = arr(onp.zeros(4))
    kv.pull("a", out=out)
    first = out.asnumpy().copy()
    kv.push("a", arr(onp.full(4, rank + 1.0)))
    kv.pull("a", out=out)
    say("pushpull", first[0], out.asnumpy()[0])

    # 2. dist_sync SGD: worker-dependent gradients, one sum everywhere
    kv2 = mx.kv.create("dist_sync")
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    kv2.init(0, arr(onp.random.RandomState(7).randn(8, 4)))
    for step in range(3):
        kv2.push(0, arr(onp.full((8, 4), 0.01 * (rank + 1) * (step + 1))))
    w = arr(onp.zeros((8, 4)))
    kv2.pull(0, out=w)
    say("params", _digest(w.asnumpy()), w.asnumpy().tobytes().hex())

    # 2b. compression before the sum
    kv3 = mx.kv.create("dist_sync")
    kv3.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv3.init("c", arr(onp.zeros(4)))
    kv3.push("c", arr([0.6, -0.7, 0.2, 0.0] if rank == 0 else
                      [0.4, 0.0, -0.9, 0.1]))
    outc = arr(onp.zeros(4))
    kv3.pull("c", out=outc)
    say("compress", ",".join(repr(float(v)) for v in outc.asnumpy()))

    # 2c. dist_async: diverged after one local push, averaged after two,
    # again after a forced sync
    kva = mx.kv.create("dist_async")
    kva._staleness = 2
    kva.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    kva.init(0, arr(onp.random.RandomState(11).randn(4, 2)))
    wa = arr(onp.zeros((4, 2)))
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.pull(0, out=wa)
    say("async_diverged", _digest(wa.asnumpy()))
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.pull(0, out=wa)
    say("async_synced", _digest(wa.asnumpy()),
        wa.asnumpy().tobytes().hex())
    kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.sync()
    kva.pull(0, out=wa)
    say("async_forced", _digest(wa.asnumpy()))

    # 2d. uneven shards: rank 0 plans 5 pushes, the others 3
    planned = 5 if rank == 0 else 3
    budget = kva.begin_epoch(planned)
    for _ in range(planned):
        kva.push(0, arr(onp.full((4, 2), rank + 1.0)))
    kva.sync()
    kva.pull(0, out=wa)
    say("async_uneven", _digest(wa.asnumpy()), budget)

    # 2e. Module updating on the store: different data on every worker
    sym = mx.sym
    net = sym.LinearRegressionOutput(
        sym.FullyConnected(sym.Variable("data"), num_hidden=1, name="fc"),
        sym.Variable("softmax_label"), name="lro")
    m = mx.mod.Module(net, context=cpu)
    m.bind(data_shapes=[("data", (4, 3))],
           label_shapes=[("softmax_label", (4, 1))])
    m.init_params(arg_params={
        "fc_weight": arr(onp.random.RandomState(5).randn(1, 3)),
        "fc_bias": arr(onp.zeros(1))})
    m.init_optimizer(kvstore=mx.kv.create("dist_sync"), optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1})
    assert m._update_on_kvstore
    batch = mx.io.DataBatch(data=[arr(onp.full((4, 3), rank + 1.0))],
                            label=[arr(onp.full((4, 1), -float(rank)))])
    for _ in range(2):
        m.forward_backward(batch)
        m.update()
    say("module_kv", _digest(m.get_params()[0]["fc_weight"].asnumpy()))

    # 2f. row_sparse values, sync and async
    from incubator_mxnet_tpu_torch.ndarray import sparse as sp
    rows_n, cols = 6, 3
    kvr = mx.kv.create("dist_sync")
    kvr.init("rs", arr(onp.zeros((rows_n, cols))))
    rows = [rank % rows_n, (rank + 2) % rows_n]
    dense = onp.zeros((rows_n, cols), "float32")
    for r in rows:
        dense[r] = rank + 1
    kvr.push("rs", arr(dense).tostype("row_sparse"))
    outr = arr(onp.zeros((rows_n, cols)))
    kvr.pull("rs", out=outr)
    rs_out = sp.row_sparse_array(
        (onp.zeros((2, cols), "float32"), onp.array([0, 1])),
        shape=(rows_n, cols), ctx=cpu)
    kvr.row_sparse_pull("rs", out=rs_out, row_ids=nd.array(
        onp.array(rows, dtype="int64"), ctx=cpu))
    got_rows = rs_out.tostype("default").asnumpy()[rows]
    say("rowsparse_sync", outr.asnumpy().tobytes().hex(),
        onp.array_equal(got_rows, outr.asnumpy()[rows]))
    kvar = mx.kv.create("dist_async")
    kvar._staleness = 10 ** 9
    kvar.init("ars", arr(onp.zeros((rows_n, cols))))
    kvar.push("ars", arr(dense).tostype("row_sparse"))
    kvar.sync()
    outa = arr(onp.zeros((rows_n, cols)))
    kvar.pull("ars", out=outa)
    say("rowsparse_async", _digest(outa.asnumpy()))

    # 2g. Trainer(kvstore="dist_sync"): every rank's own batch, the same
    # parameters after two Adam steps, those of one process on all the
    # ranks' batches at the same scale (rescale 1/the local batch)
    def dense_net():
        d = mx.gluon.nn.Dense(3, in_units=4)
        d.initialize(mx.init.Xavier(), ctx=cpu,
                     generator=torch.Generator().manual_seed(3))
        return d

    def batch_of(r):
        return arr(onp.random.RandomState(100 + r).randn(2, 4))

    def trained(d, kvstore, batches):
        tr = mx.gluon.Trainer(d.collect_params(), "adam",
                              {"learning_rate": 0.05}, kvstore=kvstore)
        for _ in range(2):
            with mx.autograd.record():
                loss = sum((d(b) ** 2).sum() for b in batches)
            loss.backward()
            tr.step(2)
        return d.weight.data().asnumpy()
    wt = trained(dense_net(), "dist_sync", [batch_of(rank)])
    one = trained(dense_net(), None, [batch_of(r) for r in range(nworkers)])
    say("trainer", _digest(wt),
        float(onp.abs(wt - one).max() / onp.abs(one).max()))

    kv.barrier()
    say("done")
    return 0


# ================================================ one process, in pytest
def test_init_distributed_is_idempotent_and_a_no_op_alone(monkeypatch):
    """Without the launcher's environment there is no group: rank 0 of 1,
    as the JAX package reports; a second call changes nothing."""
    import incubator_mxnet_tpu.parallel.dist as jdist
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch.parallel import dist
    for name in ("MXTPU_COORD_ADDR", "MXTPU_NUM_PROC", "MXTPU_PROC_ID",
                 "DMLC_NUM_WORKER", "DMLC_RANK", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setitem(dist._STATE, "initialized", False)
    dist.init_distributed()
    dist.init_distributed()
    assert dist.is_initialized() and dist.backend() is None
    assert (dist.rank(), dist.num_workers()) == (jdist.rank(),
                                                 jdist.num_workers()) == (0, 1)
    assert mxt.parallel.rank() == 0 and mxt.parallel.num_workers() == 1


def test_the_new_env_entries_keep_the_references_types_and_defaults():
    """The launcher's, the dist stores' and the server role's knobs are
    the JAX package's; the process group's timeout is the port's own."""
    import incubator_mxnet_tpu.config as jconfig
    import incubator_mxnet_tpu_torch.config as tconfig
    for name in ("MXTPU_COORD_ADDR", "MXTPU_NUM_PROC", "MXTPU_PROC_ID",
                 "MXTPU_ASYNC_STALENESS", "MXTPU_KVSTORE_BIGARRAY_BOUND",
                 "MXTPU_P3_SLICE", "MXTPU_KVSTORE_DEBUG", "MXTPU_ROLE"):
        assert tconfig.ENV_VARS[name][:2] == jconfig.ENV_VARS[name][:2], name
    assert "MXTPU_DIST_TIMEOUT_S" not in jconfig.ENV_VARS
    assert tconfig.ENV_VARS["MXTPU_DIST_TIMEOUT_S"][:2] == (float, 300.0)


def test_backend_rule():
    """gloo for the CPU and for ranks sharing a card; NCCL when every rank
    owns its GPU."""
    import torch
    from incubator_mxnet_tpu_torch.parallel import dist
    assert dist._identity(torch.device("cpu")) == "cpu"
    assert dist.choose_backend(["cpu", "cpu", "cpu"]) == "gloo"
    assert dist.choose_backend(["cuda:a", "cuda:a"]) == "gloo"
    assert dist.choose_backend(["cuda:a", "cpu"]) == "gloo"
    assert dist.choose_backend(["cuda:a", "cuda:b", "cuda:c"]) == "nccl"
    assert dist.choose_backend(["cuda:a"]) == "nccl"


def test_launcher_env_and_its_dmlc_aliases(monkeypatch):
    from incubator_mxnet_tpu_torch.parallel import dist
    for name in ("MXTPU_COORD_ADDR", "MXTPU_NUM_PROC", "MXTPU_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "10.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9000")
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    monkeypatch.setenv("DMLC_RANK", "2")
    assert dist._launcher_env() == ("10.0.0.1:9000", 4, 2)
    monkeypatch.setenv("MXTPU_COORD_ADDR", "127.0.0.1:1234")
    monkeypatch.setenv("MXTPU_NUM_PROC", "3")
    monkeypatch.setenv("MXTPU_PROC_ID", "1")
    assert dist._launcher_env() == ("127.0.0.1:1234", 3, 1)


def test_gradient_compression_is_the_references():
    """Seeded values over several pushes of two keys (the residual carries
    between them): the port's quantized values and residuals equal the JAX
    package's exactly."""
    import torch
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu.parallel import compression as jcomp
    from incubator_mxnet_tpu_torch.parallel import GradientCompression
    rng = onp.random.RandomState(4)
    ref = jcomp.GradientCompression(threshold=0.3)
    port = GradientCompression("2bit", threshold=0.3)
    for _ in range(5):
        for key in ("w", ("b", 1)):
            g = (rng.randn(6, 5) * 0.2).astype("float32")
            want = ref.compress_decompress(jmx.nd.array(g), key).asnumpy()
            got = port.compress_decompress(
                mxt.nd.array(g, ctx=mxt.cpu()), key).asnumpy()
            onp.testing.assert_array_equal(got, want)
            onp.testing.assert_array_equal(
                port._residuals[key].numpy(),
                onp.asarray(ref._residuals[key]))
    raw = port.compress_decompress(torch.ones(3), "t")
    assert isinstance(raw, torch.Tensor)
    assert raw.tolist() == [float(onp.float32(0.3))] * 3
    with pytest.raises(ValueError, match="2bit"):
        GradientCompression("1bit")


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async"])
def test_dist_stores_alone_are_the_references(name):
    """One process, no group: per-device gradient lists through 2-bit
    compression and an SGD updater, against the JAX package's store of the
    same name (its local path there)."""
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as mxt
    rng = onp.random.RandomState(9)
    w0 = rng.randn(4, 3).astype("float32")
    grads = [[(rng.randn(4, 3) * 0.4).astype("float32") for _ in range(2)]
             for _ in range(3)]
    outs = []
    for pkg, kw in ((jmx, {}), (mxt, {"ctx": mxt.cpu()})):
        kv = pkg.kv.create(name)
        assert kv.type == name and kv.rank == 0 and kv.num_workers == 1
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.25})
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.init(0, pkg.nd.array(w0, **kw))
        for gs in grads:
            kv.push(0, [pkg.nd.array(g, **kw) for g in gs], priority=-1)
        out = pkg.nd.zeros((4, 3), **kw)
        kv.pull(0, out=out)
        kv.barrier()
        outs.append(out.asnumpy())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
    if name == "dist_async":
        kv.sync()
        assert kv.begin_epoch(9) == 9 // kv._staleness


def test_compression_refuses_row_sparse_values():
    import incubator_mxnet_tpu_torch as mxt
    kv = mxt.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("r", mxt.nd.zeros((4, 2), ctx=mxt.cpu()))
    g = mxt.nd.array(onp.eye(4, 2, dtype="float32"), ctx=mxt.cpu())
    with pytest.raises(ValueError, match="dense values only"):
        kv.push("r", g.tostype("row_sparse"))
    kv.push("r", g)                 # dense values compress


def test_kvstore_server_role_and_profiler_command(monkeypatch):
    """The server role has nothing to serve: run() returns, its controller
    sets a pickled optimizer on the store, and the module entry runs a
    server for a process whose role is "server"; the profiler command
    drives this process's profiler."""
    import pickle
    import incubator_mxnet_tpu_torch as mxt
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.kvstore import kvstore_server
    kv = mxt.kv.create("dist_sync")
    server = mxt.kvstore.KVStoreServer(kv)
    assert server.run() is None and server._verbose == 0
    server._controller()(0, pickle.dumps(mxt.optimizer.SGD(
        learning_rate=0.2)))
    assert kv._optimizer.lr == 0.2 and kv._updater is not None
    made = []
    monkeypatch.setattr(kvstore_server.KVStoreServer, "run",
                        lambda self: made.append(self))
    monkeypatch.setenv("DMLC_ROLE", "worker")
    kvstore_server._init_kvstore_server_module()
    assert not made
    monkeypatch.setenv("DMLC_ROLE", "server")
    kvstore_server._init_kvstore_server_module()
    assert len(made) == 1
    kv.set_server_profiler_state("run", profile_imperative=False)
    try:
        assert profiler._STATE["running"]
    finally:
        kv.set_server_profiler_state("stop")
    assert not profiler._STATE["running"]


def test_module_fit_keeps_dist_async_epoch_contract():
    """Module.fit over a dist_async store: begin_epoch with the iterator's
    length (0 for one without) at each epoch's start, sync at its end, the
    update in the store."""
    import incubator_mxnet_tpu_torch as mxt
    calls = []

    class Recording(mxt.kv.DistAsyncKVStore):
        def begin_epoch(self, local_steps):
            calls.append(("begin_epoch", local_steps))
            return super().begin_epoch(local_steps)

        def sync(self):
            calls.append(("sync",))
            super().sync()
    S = mxt.sym
    net = S.LinearRegressionOutput(
        S.FullyConnected(S.var("data"), num_hidden=1, name="fc"),
        S.var("lin_reg_label"), name="lro")
    x = onp.random.RandomState(0).randn(12, 3).astype("float32")

    class Sized(mxt.io.NDArrayIter):      # NDArrayIter has no len()
        def __len__(self):
            return 3
    it = Sized(x, x.sum(axis=1), batch_size=4, label_name="lin_reg_label")
    mod = mxt.mod.Module(net, label_names=["lin_reg_label"],
                         context=mxt.cpu())
    store = Recording("dist_async")
    mod.fit(it, num_epoch=2, kvstore=store, optimizer="sgd",
            eval_metric="mse")
    assert mod._update_on_kvstore and mod._kvstore is store
    assert calls == [("begin_epoch", 3), ("sync",)] * 2


def _dense_pair(seed):
    """A JAX package Dense and a port Dense with the same weights."""
    import torch
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as mxt
    tnet = mxt.gluon.nn.Dense(3, in_units=4)
    tnet.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                    generator=torch.Generator().manual_seed(seed))
    jnet = jmx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(tnet._collect_params_with_prefix()[k]
                                .data().asnumpy()))
    return jnet, tnet


@pytest.mark.parametrize("kvstore,update", [("dist_sync", None),
                                            ("dist_async", None),
                                            ("local", True)])
def test_trainer_through_a_store_is_the_references(kvstore, update,
                                                   tmp_path):
    """Trainer(kvstore=...) updating through the store: two Adam steps
    against the JAX package's Trainer over the same store, then states
    files of either package read back through the store."""
    import incubator_mxnet_tpu as jmx
    import incubator_mxnet_tpu_torch as mxt
    jnet, tnet = _dense_pair(1)
    x = onp.random.RandomState(2).randn(5, 4).astype("float32")
    trainers = []
    for pkg, net, kw in ((jmx, jnet, {}), (mxt, tnet, {"ctx": mxt.cpu()})):
        tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.05}, kvstore=kvstore,
                               update_on_kvstore=update)
        for _ in range(2):
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(x, **kw)) ** 2).sum()
            loss.backward()
            tr.step(5)
        trainers.append(tr)
    assert trainers[1]._update_on_kvstore
    for k, p in jnet._collect_params_with_prefix().items():
        onp.testing.assert_allclose(
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            p.data().asnumpy(), rtol=1e-6, atol=1e-7)
    trainers[0].save_states(str(tmp_path / "j.states"))
    trainers[1].save_states(str(tmp_path / "t.states"))
    trainers[1].load_states(str(tmp_path / "j.states"))
    trainers[1].load_states(str(tmp_path / "t.states"))
    assert sorted(trainers[1]._kvstore._updater.states) == [0, 1]
    assert trainers[1].optimizer._index_update_count == {0: 2, 1: 2}


def test_trainer_with_a_dist_store_sums_into_the_gradients():
    """update_on_kvstore=False: the store sums the gradients (one process:
    the gradients themselves) and the update runs locally, as MXNet's
    Trainer does."""
    import incubator_mxnet_tpu_torch as mxt
    _, a = _dense_pair(4)
    _, b = _dense_pair(4)
    x = mxt.nd.array(onp.ones((2, 4), "float32"), ctx=mxt.cpu())
    for net, kv in ((a, None), (b, "dist_sync")):
        tr = mxt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kv,
                               update_on_kvstore=False if kv else None)
        with mxt.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
        assert (tr._kvstore is None) == (kv is None)
    onp.testing.assert_array_equal(a.weight.data().asnumpy(),
                                   b.weight.data().asnumpy())


def _worker_with_a_failed_peer():
    """Two ranks; rank 1 dies before its first push: rank 0's push must
    raise within the group's timeout, never hang."""
    sys.path.insert(0, REPO)
    import incubator_mxnet_tpu_torch as mx
    kv = mx.kv.create("dist_sync")
    kv.init("w", mx.nd.zeros((4,), ctx=mx.cpu()))
    if kv.rank == 1:
        os._exit(3)
    try:
        kv.push("w", mx.nd.ones((4,), ctx=mx.cpu()))
    except Exception as e:      # the failure this case is about
        os.write(1, ("RESULT peer_failed 0 %s\n" % type(e).__name__)
                 .encode())
        os._exit(0)
    os._exit(1)


# ======================================================= the parent side
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _results(out):
    found = {}
    for check, rank, rest in re.findall(
            r"^RESULT (\w+) (\d+) ?(.*)$", out, re.M):
        found.setdefault(check, {})[int(rank)] = rest.split()
    return found


@pytest.fixture(scope="module")
def matrix():
    """The three workers' RESULT lines by check and rank."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, os.path.join(REPO, "tools", "launch.py"),
           "-n", str(NWORKERS), "--coord-addr",
           "127.0.0.1:%d" % _free_port(),
           sys.executable, os.path.abspath(__file__)]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 0, "workers failed:\n%s\n%s" % (
        proc.stdout, proc.stderr[-6000:])
    found = _results(proc.stdout)
    assert set(found.get("done", {})) == set(range(NWORKERS)), proc.stdout
    return found


def test_a_rank_that_dies_makes_its_peer_raise_not_hang():
    """Rank 1 exits before its push; rank 0's collective raises (gloo
    loses its peer) well within the group's timeout of 20 s, and the
    launcher reports rank 1's exit code."""
    import time
    env = dict(os.environ, MXTPU_DIST_TIMEOUT_S="20",
               MXTPU_TEST_DIST_CASE="peer_failure", CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         "2", "--coord-addr", "127.0.0.1:%d" % _free_port(),
         sys.executable, os.path.abspath(__file__)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 3, proc.stdout + proc.stderr[-3000:]
    assert _results(proc.stdout).get("peer_failed", {}).keys() == {0}, \
        proc.stdout + proc.stderr[-3000:]
    assert time.perf_counter() - t0 < WORKER_TIMEOUT_S / 2


def _all_ranks(found, check):
    got = found.get(check, {})
    assert set(got) == set(range(NWORKERS)), (check, found)
    return [got[r] for r in range(NWORKERS)]


def _weights(hexes, shape):
    return onp.frombuffer(bytes.fromhex(hexes), "float32").reshape(shape)


def test_three_processes_hold_every_closed_form(matrix):
    """tests/dist_worker.py's matrix through the port's stores."""
    for first, pushed in _all_ranks(matrix, "pushpull"):
        assert float(first) == 100.0
        assert float(pushed) == sum(r + 1 for r in range(NWORKERS))
    for (vals,) in _all_ranks(matrix, "compress"):
        assert [float(v) for v in vals.split(",")] == \
            [0.5, -0.5, -0.5 * (NWORKERS - 1), 0.0]
    params = _all_ranks(matrix, "params")
    assert len({d for d, _ in params}) == 1, params
    div = _all_ranks(matrix, "async_diverged")
    assert len({d for (d,) in div}) == NWORKERS
    synced = _all_ranks(matrix, "async_synced")
    assert len({d for d, _ in synced}) == 1
    w_init = onp.random.RandomState(11).randn(4, 2).astype("float32")
    want = sum(w_init - 0.2 * (r + 1) for r in range(NWORKERS)) / NWORKERS
    onp.testing.assert_allclose(_weights(synced[0][1], (4, 2)), want,
                                atol=1e-5)
    for check in ("async_forced", "module_kv", "rowsparse_async"):
        assert len({v[0] for v in _all_ranks(matrix, check)}) == 1, check
    uneven = _all_ranks(matrix, "async_uneven")
    assert len({d for d, _ in uneven}) == 1
    assert all(int(b) == 1 for _, b in uneven)
    want_rs = onp.zeros((6, 3), "float32")
    for r in range(NWORKERS):
        for row in (r % 6, (r + 2) % 6):
            want_rs[row] += r + 1
    for hexes, rows_ok in _all_ranks(matrix, "rowsparse_sync"):
        onp.testing.assert_array_equal(_weights(hexes, (6, 3)), want_rs)
        assert rows_ok == "True"
    trainer = _all_ranks(matrix, "trainer")
    assert len({d for d, _ in trainer}) == 1, trainer
    assert max(float(e) for _, e in trainer) <= 1e-5


def test_dist_sync_sums_are_the_jax_packages(matrix):
    """The dist_sync SGD weights of every rank against the JAX package's
    LocalKVStore fed the gradients summed in rank order (within one
    float32 ulp: exact sums, SGD's multiply-add order)."""
    import incubator_mxnet_tpu as jmx
    jkv = jmx.kv.create("local")
    jkv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1))
    jkv.init(0, jmx.nd.array(
        onp.random.RandomState(7).randn(8, 4).astype("float32")))
    for step in range(3):
        g = onp.zeros((8, 4), "float32")
        for r in range(NWORKERS):
            g = g + onp.full((8, 4), 0.01 * (r + 1) * (step + 1), "float32")
        jkv.push(0, jmx.nd.array(g))
    want = jmx.nd.zeros((8, 4))
    jkv.pull(0, out=want)
    for _, hexes in _all_ranks(matrix, "params"):
        onp.testing.assert_allclose(_weights(hexes, (8, 4)), want.asnumpy(),
                                    rtol=1.2e-7, atol=0)


if __name__ == "__main__":
    if os.environ.get("MXTPU_TEST_DIST_CASE") == "peer_failure":
        _worker_with_a_failed_peer()
    sys.exit(_worker())
