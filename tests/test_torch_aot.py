"""The port's AOT cache (incubator_mxnet_tpu_torch/aot.py, the in-memory
half of the JAX package's aot.py) and the captured ``jit.EvalStep``, on
the CPU.

Keys and ``model_id_for`` hold the equalities and inequalities the JAX
package's tests/test_aot.py states; the LRU, its counters and the
single-flight build are the JAX package's. The captured EvalStep runs on
the CPU through a stand-in for ``jit._GraphCapture`` (``CpuCapture``: a
"graph" that runs its body again at each replay), as tests/
test_torch_jit.py does for TrainStep; it holds the captured path to the
eager forward bit for bit, counts captures and launches, binds graphs to
parameter storage (the port's departure from the JAX package, whose
programs take the parameters as inputs) and keeps captures off the
batcher's workers across a prewarmed hot reload. The artifact layer
raises until the next slice. ``CpuCapture`` and the ``cpu_graphs``
fixture are shared with tests/test_torch_generate.py.
"""
import threading
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import aot as jaot

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import aot, gluon
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.serving import ModelRegistry
from incubator_mxnet_tpu_torch.telemetry import spans


class _CpuGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        """Run the body again; its launches are the capture's, which the
        replay adds itself."""
        with _kernels.collecting():
            out = self.fn()
        with torch.no_grad():
            for o, n in zip(self.out, out):
                o.copy_(n)


class CpuCapture:
    """A stand-in for ``jit._GraphCapture`` on the CPU; ``threads`` names
    the threads that captured."""
    threads = []

    def __init__(self, device):
        pass

    def eager(self, fn):
        return fn()

    def capture(self, fn, pool=None):
        CpuCapture.threads.append(threading.current_thread().name)
        out = fn()
        return _CpuGraph(fn, out), out

    @staticmethod
    def upload(dst, host):
        dst.copy_(host)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Route CPU steps through the captured path with ``CpuCapture``."""
    monkeypatch.setattr(tjit, "_uses_graphs", lambda device: True)
    monkeypatch.setattr(tjit, "_GraphCapture", CpuCapture)
    CpuCapture.threads = []
    yield CpuCapture


class _Probe(gluon.HybridBlock):
    """Dense + one counted "launch" a forward."""

    def __init__(self, units, in_units=4):
        super().__init__()
        self.dense = gluon.nn.Dense(units, in_units=in_units)

    def forward(self, x):
        _kernels.count("probe_kernel")
        return self.dense(x)


def _dense(units, in_units=4, probe=False, seed=0):
    net = _Probe(units, in_units) if probe else \
        gluon.nn.Dense(units, in_units=in_units)
    net.initialize(mxt.init.Xavier(), ctx=mxt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net


def _compiles():
    return tjit._COMPILES.value(kind="eval")


# ------------------------------------------------------------- cache keys
def test_cache_key_identity_and_deltas():
    base = aot.cache_key("m1", [((4, 8), "float32")], kind="eval")
    same = aot.cache_key("m1", (((4, 8), "float32"),), kind="eval")
    assert base == same and hash(base) == hash(same)
    assert base != aot.cache_key("m2", [((4, 8), "float32")], kind="eval")
    assert base != aot.cache_key("m1", [((2, 8), "float32")], kind="eval")
    assert base != aot.cache_key("m1", [((4, 8), "bfloat16")], kind="eval")
    assert base != aot.cache_key("m1", [((4, 8), "float32")], kind="train")
    assert base != aot.cache_key("m1", [((4, 8), "float32")], kind="eval",
                                 mesh=((("dp", 8),), 8))
    assert base != aot.cache_key("m1", [((4, 8), "float32")], kind="eval",
                                 extra=(2,))
    # the same arguments give the JAX package's key
    for kw in ({}, {"kind": "decode", "extra": ("tag", 3)},
               {"mesh": ((("dp", 8),), 8)}):
        assert tuple(aot.cache_key("m1", [((4, 8), "float32")], **kw)) == \
            tuple(jaot.cache_key("m1", [((4, 8), "float32")], **kw))
    x = onp.zeros((2, 3), "float32")
    assert aot.input_signature([x]) == jaot.input_signature([x])
    assert aot.input_signature([torch.zeros(2, 3, dtype=torch.int32)]) == \
        (((2, 3), "torch.int32"),)


def test_model_id_structural_sharing_and_deltas():
    a, b = _dense(3), _dense(3, seed=1)
    assert aot.model_id_for(a) == aot.model_id_for(b)   # same architecture
    assert aot.model_id_for(a) != aot.model_id_for(_dense(5))
    assert aot.model_id_for(a) != aot.model_id_for(_dense(3, in_units=5))
    assert aot.model_id_for(a) != aot.model_id_for(a, extra=("train",))
    c, d = _dense(3), _dense(3)
    c._baked = onp.ones(4, "float32")
    d._baked = onp.zeros(4, "float32")
    assert aot.model_id_for(c) != aot.model_id_for(d)
    c._baked, d._baked = torch.ones(4), torch.zeros(4)
    assert aot.model_id_for(c) != aot.model_id_for(d)
    e, f = _dense(3), _dense(3)
    e._calib = {"scale": 0.5}
    f._calib = {"scale": 2.0}
    assert aot.model_id_for(e) != aot.model_id_for(f)
    g = _dense(3)
    g.cast("float64")
    assert aot.model_id_for(g) != aot.model_id_for(a)
    assert aot.model_id_for(a).startswith("g") and \
        len(aot.model_id_for(a)) == 21


# ------------------------------------------------------------------- LRU
def test_lru_eviction_by_last_dispatch_and_counters(monkeypatch):
    monkeypatch.setenv("MXTPU_AOT_CACHE_SIZE", "2")
    cache = aot.AOTCache()
    k = [aot.cache_key("m", [((i, 4), "float32")], kind="eval")
         for i in range(3)]
    ev0 = aot._EVICTIONS.value(kind="eval")
    hits0 = aot._HITS.value(kind="eval")
    cache.insert(k[0], "fn0")
    cache.insert(k[1], "fn1")
    assert cache.lookup(k[0]) is not None   # touch: k0 is now the hot one
    cache.insert(k[2], "fn2")
    assert cache.peek(k[0]) is not None
    assert cache.peek(k[1]) is None
    assert cache.peek(k[2]) is not None
    assert aot._EVICTIONS.value(kind="eval") == ev0 + 1
    assert aot._HITS.value(kind="eval") == hits0 + 1
    assert aot._ENTRIES.value() == 2
    assert [e["input_sig"][0][0][0] for e in cache.snapshot()] == [2, 0]
    assert cache.discard(k[0]) and not cache.discard(k[0])
    assert len(cache) == 1
    cache.clear()
    assert len(cache) == 0 and aot._ENTRIES.value() == 0


def test_single_flight_build():
    cache = aot.AOTCache()
    key = aot.cache_key("sf", [((1,), "float32")], kind="eval")
    builds, barrier = [], threading.Barrier(4)
    misses0 = aot._MISSES.value(kind="eval")

    def build():
        builds.append(1)
        time.sleep(0.05)
        return "fn", None, None
    out = []

    def worker():
        barrier.wait(30)
        out.append(cache.get_or_build(key, build))
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(out) == 4
    assert all(e.fn == "fn" for e in out)
    assert aot._MISSES.value(kind="eval") == misses0 + 1
    with aot.collect_inserts() as fresh:
        cache.insert(aot.cache_key("sf2", [], kind="eval"), "f2")
    assert [e.fn for e in fresh] == ["f2"]


def test_artifact_layer_raises_naming_the_next_slice(monkeypatch):
    key = aot.cache_key("m", [((1,), "float32")], kind="eval")
    for fn, args in ((aot.artifact_path, (key,)),
                     (aot.facts_for_key, (key,)),
                     (aot.program_digest, (b"",))):
        with pytest.raises(NotImplementedError, match="next slice"):
            fn(*args)
    monkeypatch.setenv("MXTPU_AOT_CACHE_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="MXTPU_AOT_CACHE_DIR"):
        aot.AOTCache().get_or_build(key, lambda: ("fn", None, None),
                                    exportable=True)
    for name in jaot.__all__:
        assert hasattr(aot, name), name


# ------------------------------------------------ the captured EvalStep
def test_cpu_evalstep_runs_eagerly_without_cache_entries():
    net = _dense(3)
    n0 = len(aot.CACHE)
    step = tjit.EvalStep(net)
    out = step(onp.ones((2, 4), "float32"))
    assert out.shape == (2, 3) and step.captures == 0
    assert len(aot.CACHE) == n0


def test_captured_evalstep_equals_eager_and_counts(cpu_graphs):
    """One capture for the signature (its call answers with the eager
    run), replays after; bit for bit the eager forward; the launch count
    is one a call, the capture's own taken out; a build counts on the
    compile counter inside an eval:build span."""
    net = _dense(5, probe=True)
    x = onp.random.RandomState(0).randn(3, 4).astype("float32")
    eager = tjit.EvalStep(net)._forward([torch.as_tensor(x)])
    _kernels.reset_launches()
    spans.reset()
    c0 = _compiles()
    step = tjit.EvalStep(net)
    outs = [step(x).asnumpy() for _ in range(4)]
    assert step.captures == 1 and _compiles() == c0 + 1
    assert _kernels.LAUNCHES["probe_kernel"] == 4
    for o in outs:
        assert onp.array_equal(o, eager.numpy())
    names = [s["name"] for s in spans.snapshot()]
    assert names.count("eval:build") == 1 and "eval:compile" in names
    assert names.count("eval:step") == 4
    # the serving call (_run) replays the same graph
    assert onp.array_equal(step._run(x).numpy(), eager.numpy())
    assert step.captures == 1
    # a new signature captures anew
    step(x[:2])
    assert step.captures == 2


def test_graphs_are_bound_to_parameter_storage(cpu_graphs):
    """The departure: a graph reads the parameters it was captured on.
    Two steps over one net share it; a net of the same architecture (the
    same model_id) with other weights gets its own graph and its own
    answer; an in-place write into the bound storage is seen without a
    capture; new storage (cast) captures anew."""
    a, b = _dense(7, seed=1), _dense(7, seed=2)
    assert aot.model_id_for(a) == aot.model_id_for(b)
    x = onp.ones((2, 4), "float32")
    sa, sa2, sb = tjit.EvalStep(a), tjit.EvalStep(a), tjit.EvalStep(b)
    oa = sa(x).asnumpy()
    c0 = _compiles()
    assert onp.array_equal(sa2(x).asnumpy(), oa)     # shared graph
    assert _compiles() == c0 and sa2.captures == 0
    ob = sb(x).asnumpy()                             # its own graph
    assert _compiles() == c0 + 1
    assert not onp.allclose(oa, ob)
    assert onp.array_equal(ob, tjit.EvalStep(b)._forward(
        [torch.as_tensor(x)]).numpy())
    w = a.weight
    w.set_data(onp.zeros(w.shape, "float32"))        # in place
    got = sa(x).asnumpy()
    assert _compiles() == c0 + 1
    assert onp.array_equal(got, onp.broadcast_to(a.bias.data().asnumpy(),
                                                 got.shape))
    a.cast("float64")
    a.cast("float32")                                # new storage
    sa(x)
    assert _compiles() == c0 + 2
    # release lets go of the step's entries: the one sa2 shares stays
    # until sa2 lets go of it too
    keys, shared = set(sa._keys), set(sa2._keys)
    assert len(keys) == 2 and len(shared) == 1 and shared < keys
    sa.release()
    assert keys & set(aot.CACHE.keys()) == shared
    sa2.release()
    assert not keys & set(aot.CACHE.keys())


def test_a_shared_graph_stays_until_its_last_holder_lets_go(cpu_graphs):
    """Two served models over one net share its graphs. Unloading one
    leaves them to the other, which answers on without a capture; the
    graphs leave the cache with the last one."""
    net = _dense(3, seed=5)
    reg = ModelRegistry()
    try:
        reg.load("own-a", net, max_batch_size=2, batch_timeout_ms=2.0,
                 warm_spec=[((4,), "float32")])
        c0 = _compiles()
        reg.load("own-b", net, max_batch_size=2, batch_timeout_ms=2.0,
                 warm_spec=[((4,), "float32")])
        assert _compiles() == c0                    # shared, not captured
        entry = reg._entry("own-b")
        steps = entry.versions[entry.current_version]._steps.values()
        keys = set().union(*(s._keys for s in steps))
        assert len(keys) == 2 and keys <= set(aot.CACHE.keys())
        reg.unload("own-a", drain=True, timeout=30.0)
        assert keys <= set(aot.CACHE.keys())
        want = tjit.EvalStep(net)._forward([torch.ones(1, 4)]).numpy()[0]
        assert onp.array_equal(
            reg.predict("own-b", onp.ones((4,), "float32"),
                        timeout=30.0)[0], want)
        assert _compiles() == c0
        reg.unload("own-b", drain=True, timeout=30.0)
        assert not keys & set(aot.CACHE.keys())
    finally:
        reg.close()


def test_prewarmed_hot_reload_keeps_captures_off_the_workers(cpu_graphs):
    """Under traffic from 4 clients, a hot reload to new weights with a
    warm_spec captures every bucket on the warm thread, smallest first;
    no batcher worker captures after the reload (a bucket not yet warmed
    is served by the old version), no request fails, and the replies
    after it are the new weights'."""
    reg = ModelRegistry()
    v1 = reg.load("hot", _dense(3, seed=1), max_batch_size=4,
                  batch_timeout_ms=2.0, warm_spec=[((4,), "float32")])
    assert reg.metrics("hot").prewarm_count == 3
    assert set(CpuCapture.threads) == {"mxtpu-aot-warm-hot"}
    stop, errors, oks = threading.Event(), [], []

    def client():
        while not stop.is_set():
            try:
                out = reg.predict("hot", onp.ones((4,), "float32"),
                                  timeout=30.0)
                assert out[0].shape == (3,)
                oks.append(1)
            except Exception as e:   # noqa: BLE001 — surfaced after join
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    new = _dense(3, seed=2)
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        mark = len(CpuCapture.threads)
        v2 = reg.load("hot", new)                   # observed signature
        reg.unload("hot", version=v1, drain=True, timeout=30.0)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(30.0)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(oks) > 10 and v2 == v1 + 1
        after = CpuCapture.threads[mark:]
        assert after and set(after) == {"mxtpu-aot-warm-hot"}, after
        warm = [s for s in spans.snapshot() if s["name"] == "aot:warm"
                and s["args"]["model"] == "hot"
                and s["args"]["version"] == v2]
        assert [s["args"]["bucket"] for s in warm] == [1, 2, 4]
        want = tjit.EvalStep(new)._forward(
            [torch.ones(1, 4)]).numpy()[0]
        assert onp.array_equal(
            reg.predict("hot", onp.ones((4,), "float32"))[0], want)
        assert reg.health()["status"] == "healthy"
    finally:
        reg.close()


def test_per_bucket_cut_routes_unwarmed_buckets_to_the_old_version():
    from incubator_mxnet_tpu_torch.serving.registry import _ModelEntry

    class Tag:
        def __init__(self, tag):
            self.tag = tag

        def predict_batch(self, x):
            return (onp.full(x.shape[0], self.tag, "float32"),)
    entry = _ModelEntry("cut", max_batch_size=4, batch_timeout_ms=1.0)
    try:
        entry.install(Tag(1), None)
        v2 = entry.add_version(Tag(2), None)
        entry._warm_state[v2] = (1, {(1, 0)})
        entry.repoint(v2)
        assert entry._dispatch(onp.zeros((1, 2)))[0][0] == 2.0
        assert entry._dispatch(onp.zeros((2, 2)))[0][0] == 1.0
        entry._warm_state.pop(v2)
        assert entry._dispatch(onp.zeros((2, 2)))[0][0] == 2.0
    finally:
        entry.batcher.close()


def test_debug_aot_lists_the_captured_entries(cpu_graphs):
    import json
    import urllib.request
    from incubator_mxnet_tpu_torch.serving import ServingServer
    reg = ModelRegistry()
    reg.load("dbg", _dense(3), max_batch_size=2, batch_timeout_ms=2.0,
             warm_spec=[((4,), "float32")])
    with ServingServer(reg, port=0) as srv:
        with urllib.request.urlopen(srv.url + "/debug/aot",
                                    timeout=30) as r:
            payload = json.loads(r.read())
    mine = [e for e in payload["entries"] if e["kind"] == "eval"
            and e["input_sig"][0][0][1:] == [4]]
    assert {e["input_sig"][0][0][0] for e in mine} >= {1, 2}
    assert all({"model_id", "kind", "input_sig", "source", "idle_s",
                "bound_tensors"} <= set(e) for e in payload["entries"])


def test_captured_evalstep_keeps_nested_outputs(cpu_graphs):
    """A forward that returns nested tuples and lists (an RNN's output and
    its states) comes back in the same structure, captured = eager."""
    class Nested(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = gluon.nn.Dense(3, in_units=4)

        def forward(self, x):
            y = self.dense(x)
            return y, [y * 2, (y + 1,)]
    net = Nested()
    net.initialize(ctx=mxt.cpu(), generator=torch.Generator().manual_seed(4))
    x = onp.ones((2, 4), "float32")
    step = tjit.EvalStep(net)
    want = step._forward([torch.as_tensor(x)])
    for _ in range(2):                      # the capture, then a replay
        got = step._run(x)
        assert isinstance(got, tuple) and isinstance(got[1], list) \
            and isinstance(got[1][1], tuple)
        assert torch.equal(got[0], want[0]) and \
            torch.equal(got[1][0], want[1][0]) and \
            torch.equal(got[1][1][0], want[1][1][0])
    assert step.captures == 1
