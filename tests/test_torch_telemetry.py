"""The port's telemetry core (incubator_mxnet_tpu_torch/telemetry:
registry, ringbuf, trace, spans, flightrec, watchdog, faultlab) against
the JAX package's: the same calls through both give the same Prometheus
text, the same cardinality clamp, the same span tree and flight-recorder
records, the same watchdog report and the same faultlab firing patterns.
The package carries every module of the JAX package's; the five that read
the device or feed SLOs have their own tests (tests/test_torch_devstats.py
and its neighbours).

Module-global state (the span ring, the tape, the armed faults) is reset
around each test that touches it; the watchdog's monitor is stopped in a
``finally``.

A registry serving a net on the CPU (the port's eager ``EvalStep``) gives
the reference's span chain down to ``eval:step`` (names and parent links
exact).
"""
import time
import warnings

import numpy as onp
import pytest

from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.telemetry import faultlab as jfaultlab
from incubator_mxnet_tpu.telemetry import registry as jregistry

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import faultlab, flightrec, spans
from incubator_mxnet_tpu_torch.telemetry import registry as tregistry
from incubator_mxnet_tpu_torch.telemetry import watchdog

BOTH = (jtel, ttel)


def _drive_registry(reg_mod):
    """One fixed sequence of metric operations on a fresh registry."""
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("t_requests_total", "Requests.\nSecond line.",
                    ("model", "code"))
    c.inc(model="bert", code="200")
    c.inc(3, model="bert", code="200")
    c.inc(model='we"ird\\', code="500")
    g = reg.gauge("t_depth", "Queue depth.", ("model",))
    g.set(4, model="bert")
    g.dec(1.5, model="bert")
    g.set_function(lambda: 7, model="gpt")
    h = reg.histogram("t_latency_ms", "Latency.", buckets=(1, 2.5, 10),
                      labelnames=("model",))
    for v in (0.5, 1.0, 2.5, 3.0, 99.0):
        h.observe(v, model="bert")
    reg.counter("t_plain_total", "No labels.").inc(2)
    reg.gauge("t_nan", "NaN gauge.").set(float("nan"))
    return reg, c, g, h


def test_registry_exposition_is_the_references():
    (jr, jc, jg, jh), (tr, tc, tg, th) = [_drive_registry(m.registry)
                                          for m in BOTH]
    assert tr.export_text() == jr.export_text()
    assert tr.samples() == jr.samples() or \
        repr(tr.samples()) == repr(jr.samples())
    assert th.bucket_counts(model="bert") == jh.bucket_counts(model="bert")
    assert tc.series() == jc.series() and tg.series() == jg.series()
    assert th.value(model="bert") == jh.value(model="bert")
    tg.remove_function(None)
    tr.reset()
    jr.reset()
    assert tr.export_text() == jr.export_text()


@pytest.mark.parametrize("mistake", ["type", "labels", "buckets", "name",
                                     "label_name", "negative", "bound"])
def test_registry_refuses_what_the_reference_refuses(mistake):
    for mod in (jregistry, tregistry):
        reg = mod.MetricsRegistry()
        reg.counter("x_total", "x", ("a",))
        reg.histogram("h", "h", buckets=(1, 2))
        g = reg.gauge("g", "g")
        g.set_function(lambda: 1)
        call = {"type": lambda: reg.gauge("x_total", "x", ("a",)),
                "labels": lambda: reg.counter("x_total", "x", ("b",)),
                "buckets": lambda: reg.histogram("h", "h", buckets=(1, 3)),
                "name": lambda: reg.counter("bad name", "x"),
                "label_name": lambda: reg.counter("y", "y", ("1a",)),
                "negative": lambda: reg.get("x_total").inc(-1, a="1"),
                "bound": lambda: g.set(3)}[mistake]
        with pytest.raises(ValueError):
            call()


def test_cardinality_clamp_is_the_references(monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY_MAX_SERIES", "3")
    texts = []
    for mod in (jregistry, tregistry):
        reg = mod.MetricsRegistry()
        c = reg.counter("t_tenant_total", "per tenant", ("tenant",))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(10):
                c.inc(tenant="t%d" % i)
        assert [w.category for w in caught] == [RuntimeWarning]
        assert c.value(tenant=mod.OVERFLOW_LABEL) == 7
        texts.append(reg.export_text())
    assert texts[0] == texts[1]
    assert 'tenant="_other_"' in texts[1]
    assert mxt.config.get_env("MXTPU_TELEMETRY_MAX_SERIES") == 3


def _span_tree(mod_spans, trace_mod):
    mod_spans.reset()
    with trace_mod.request_scope("req-1"):
        with mod_spans.span("http:predict", model="m") as root:
            ctx = mod_spans.current_context()
            with mod_spans.span("inner", k=1):
                pass
            try:
                with mod_spans.span("fails"):
                    raise KeyError("x")
            except KeyError:
                pass
    mod_spans.record_span("serve:queue", 10.0, 5.0, parent=ctx,
                          model="m")
    manual = mod_spans.Span("manual")
    manual.start()
    manual.end(extra=2)
    recs = mod_spans.snapshot()
    ids = {r["span_id"]: r["name"] for r in recs}
    tree = [(r["name"], ids.get(r["parent_id"]), r["request_id"],
             r.get("args")) for r in recs]
    assert root.context().request_id == "req-1"
    assert mod_spans.current_span() is None
    return tree, recs


def test_spans_give_the_references_tree():
    from incubator_mxnet_tpu.telemetry import spans as jspans
    from incubator_mxnet_tpu.telemetry import trace as jtrace
    from incubator_mxnet_tpu_torch.telemetry import trace as ttrace
    jtree, _ = _span_tree(jspans, jtrace)
    ttree, trecs = _span_tree(spans, ttrace)
    assert ttree == jtree
    assert [r["name"] for r in trecs] == ["inner", "fails", "http:predict",
                                          "serve:queue", "manual"]
    assert trecs[1]["args"] == {"error": "KeyError"}
    lines = spans.export_jsonl().splitlines()
    assert len(lines) == 5 and '"inner"' in lines[0]
    # the opt-in histogram bridge
    spans.set_histogram_bridge(True)
    try:
        with spans.span("bridged"):
            pass
    finally:
        spans.set_histogram_bridge(None)
    assert 'mxtpu_span_seconds_count{span="bridged"} 1' in \
        ttel.export_text()
    spans.reset()


def test_flightrec_records_are_the_references(tmp_path):
    from incubator_mxnet_tpu.telemetry import flightrec as jflightrec
    out = []
    for mod in (jflightrec, flightrec):
        mod.reset()
        mod.record("step_begin", step=1)
        mod.record("batch_dispatch", model="m", n=3, bucket=4)
        mod.record("unserializable", obj=object)
        tail = mod.tail(2)
        assert all(mod.event_mono_us(ev) > 0 for ev in tail)
        out.append([{k: v for k, v in ev.items()
                     if k not in ("seq", "ts_us", "mono_us", "thread")}
                    for ev in mod.snapshot()])
        assert len(mod.format_tail(2).splitlines()) == 2
    assert out[0][:2] == out[1][:2]
    path = flightrec.dump(str(tmp_path / "tape.jsonl"))
    assert len(open(path).read().splitlines()) == 3
    flightrec.reset()
    assert flightrec.snapshot() == []


def test_watchdog_reports_a_stall_once_and_rearms():
    flightrec.record("before_stall", where="test")
    watchdog.register("tw:chan", quiet_s=0.05)
    watchdog.start(quiet_s=60.0, poll_s=0.01)
    try:
        c0 = watchdog._STALLS.value(channel="tw:chan")
        deadline = time.monotonic() + 10.0
        while watchdog._STALLS.value(channel="tw:chan") == c0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert watchdog._STALLS.value(channel="tw:chan") == c0 + 1
        report = watchdog.last_report()
        assert report.startswith("=== mxtpu stall report ===")
        assert "stalled channel(s): tw:chan" in report
        assert "--- all-thread stacks ---" in report
        assert "before_stall" in report          # the flight-recorder tail
        time.sleep(0.1)                          # one report an episode
        assert watchdog._STALLS.value(channel="tw:chan") == c0 + 1
        watchdog.heartbeat("tw:chan")            # re-arms
        assert watchdog.channels()["tw:chan"] < 1.0
        assert watchdog.running()
        assert "--- thread" in watchdog.format_stacks()
    finally:
        watchdog.unregister("tw:chan")
        watchdog.stop()
    assert not watchdog.running()


def _pattern(lab, spec, calls=24, site="s"):
    lab.arm(spec)
    out = []
    for _ in range(calls):
        try:
            out.append(lab.fire(site))
        except lab.FaultInjected:
            out.append("raised")
    return out


@pytest.mark.parametrize("spec", [
    "s:exception:stride=3", "s:exception:p=0.5:seed=7",
    "s:exception:p=0.3", "s:exception:stride=1:budget=2",
    "s:nan_poison:stride=2", "s:artifact_corrupt:p=0.25:budget=3"])
def test_faultlab_fires_as_the_reference(spec):
    try:
        want = _pattern(jfaultlab, spec)
        got = _pattern(faultlab, spec)
        assert got == want
        d_j, d_t = jfaultlab.describe(), faultlab.describe()
        assert d_t == d_j
    finally:
        jfaultlab.reset()
        faultlab.reset()


def test_faultlab_spec_errors_kinds_and_telemetry():
    try:
        faultlab.arm("keep:exception:stride=100")
        for bad in ("noentry", "s:badkind", "s:exception:bogus",
                    "s:exception:nokey=1", "s:exception:stride=2:p=0.5"):
            with pytest.raises(ValueError):
                faultlab.arm(bad)
            with pytest.raises(ValueError):
                jfaultlab.parse_spec(bad)
        assert faultlab.describe()["faults"][0]["site"] == "keep"
        faultlab.arm("k:replica_kill;o:kv_oom;w:slow_ms:ms=1")
        with pytest.raises(faultlab.WorkerKilled):
            faultlab.fire("k")
        assert not issubclass(faultlab.WorkerKilled, Exception)
        with pytest.raises(faultlab.KVOomInjected):
            faultlab.fire("o")
        assert faultlab.fire("w") is None
        assert faultlab._FIRED.value(site="k", kind="replica_kill") >= 1
        assert [ev for ev in flightrec.snapshot()
                if ev["event"] == "fault_injected" and ev["site"] == "o"]
        assert faultlab.KINDS == jfaultlab.KINDS
    finally:
        faultlab.reset()
    assert faultlab.armed is False


def test_request_ids_and_telemetry_surface():
    from incubator_mxnet_tpu_torch.telemetry import trace
    rid = trace.new_request_id()
    assert len(rid) == 16 and rid != trace.new_request_id()
    assert ttel.REQUEST_ID_HEADER == jtel.REQUEST_ID_HEADER
    missing = [n for n in jtel.__all__ if not hasattr(ttel, n)]
    assert not missing, missing
    for name in ("devstats", "profstats", "numwatch", "slo", "history"):
        assert name in ttel.__all__ and name in jtel.__all__
        module, ref = getattr(ttel, name), getattr(jtel, name)
        assert [n for n in ref.__all__ if not hasattr(module, n)] == [], name
    with pytest.raises(AttributeError):
        ttel.no_such_module


def test_periodic_flush_writes_the_exposition(tmp_path):
    path = str(tmp_path / "t.prom")
    ttel.counter("t_flush_total", "flushed").inc()
    ttel.start_periodic_flush(path, interval_s=0.05)
    try:
        deadline = time.monotonic() + 10.0
        import os
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        ttel.stop_periodic_flush()
    assert "t_flush_total 1" in open(path).read()
    assert ttel.flush_to_file(path) == path


def test_kvstore_counts_push_and_pull_bytes_as_the_reference():
    """The local kvstore's push/pull byte counters and spans, as the JAX
    package's: the same pushes and pulls give the same byte deltas."""
    import numpy as onp
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu.kvstore import kvstore as jkv
    from incubator_mxnet_tpu_torch.kvstore import kvstore as tkv
    deltas = []
    for pkg, mod, kw in ((mxt, tkv, {"ctx": mxt.cpu()}), (mx, jkv, {})):
        push0 = mod._PUSH_BYTES.value(store="local")
        pull0 = mod._PULL_BYTES.value(store="local")
        kv = pkg.kv.create("local")
        kv.init(3, pkg.nd.zeros((2, 5), **kw))
        kv.push(3, [pkg.nd.ones((2, 5), **kw), pkg.nd.ones((2, 5), **kw)])
        out = pkg.nd.zeros((2, 5), **kw)
        kv.pull(3, out=out)
        assert onp.array_equal(out.asnumpy(), onp.full((2, 5), 2.0))
        deltas.append((mod._PUSH_BYTES.value(store="local") - push0,
                       mod._PULL_BYTES.value(store="local") - pull0))
    assert deltas[0] == deltas[1] == (80, 40)


# ---------------------------------------------------------------- F7
# The training step's and the input pipeline's telemetry, held to the JAX
# package's tests/test_telemetry.py (the io-wait tests and the training
# half of the end-to-end test) and compared registration by registration.
# The port's TrainStep takes its captured path through the CPU stand-in for
# the CUDA graph (tests/test_torch_jit.py's), where a capture is its build.
F7_X = onp.random.RandomState(7).randn(16, 8).astype("float32")
F7_Y = onp.random.RandomState(8).randn(16, 4).astype("float32")
F7_STEPS = 3


def _f7_nets():
    """A Dense(4) of each package with the same parameters."""
    import incubator_mxnet_tpu as mx
    jnet = mx.gluon.nn.Dense(4, in_units=8)
    jnet.initialize(mx.init.Xavier())
    tnet = mxt.gluon.nn.Dense(4, in_units=8)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, jnet)
    return jnet, tnet


def _jax_steps(jnet, n=F7_STEPS):
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import jit as jjit
    trainer = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    step = jjit.TrainStep(jnet, mx.gluon.loss.L2Loss(), trainer)
    return step, [float(step(mx.nd.array(F7_X), mx.nd.array(F7_Y))
                        .asnumpy().mean()) for _ in range(n)]


def _port_steps(tnet, monkeypatch, n=F7_STEPS):
    from test_torch_jit import _cpu_capture
    from incubator_mxnet_tpu_torch import jit as tjit
    trainer = mxt.gluon.Trainer(tnet.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    step = tjit.TrainStep(tnet, mxt.gluon.loss.L2Loss(), trainer)
    monkeypatch.setattr(tjit, "_train_graphs", lambda device: True)
    monkeypatch.setattr(tjit, "_GraphCapture", _cpu_capture(step))
    return step, [float(step(F7_X, F7_Y).asnumpy().mean())
                  for _ in range(n)]


def test_train_step_metrics_are_the_references(monkeypatch):
    """The training half of the JAX package's end-to-end telemetry test:
    N steps add N to mxtpu_train_steps_total and to the step histogram's
    count, the batch to the examples; the capture counts as the train
    compile; the exposition carries them with the reference's types."""
    from incubator_mxnet_tpu import jit as jjit
    from incubator_mxnet_tpu_torch import jit as tjit
    jnet, tnet = _f7_nets()
    losses = []
    for mod, run in ((jjit, lambda: _jax_steps(jnet)),
                     (tjit, lambda: _port_steps(tnet, monkeypatch))):
        steps0, examples0 = mod._STEPS.value(), mod._EXAMPLES.value()
        sum0, count0 = mod._STEP_SECONDS.value()
        compiles0 = mod._COMPILES.value(kind="train")
        step, got = run()
        losses.append(got)
        assert mod._STEPS.value() - steps0 == F7_STEPS
        assert mod._EXAMPLES.value() - examples0 == F7_STEPS * 16
        total, count = mod._STEP_SECONDS.value()
        assert count - count0 == F7_STEPS and total > sum0
        assert mod._COMPILES.value(kind="train") - compiles0 == 1
        del step
    onp.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    text = ttel.export_text()
    assert "# TYPE mxtpu_train_step_seconds histogram" in text
    assert "# TYPE mxtpu_train_steps_total counter" in text
    assert 'mxtpu_jit_compiles_total{kind="train"}' in text


def _prefetched(io_mod):
    return io_mod.PrefetchingIter(io_mod.NDArrayIter(
        onp.random.RandomState(0).randn(32, 4).astype("float32"),
        onp.zeros(32, "float32"), batch_size=8))


def test_io_wait_seconds_counted():
    """tests/test_telemetry.py::test_io_wait_seconds_counted, on the port:
    4 batches through PrefetchingIter add 4 to its batch counter, and the
    wait counter does not go down."""
    from incubator_mxnet_tpu_torch import io as tio
    from incubator_mxnet_tpu_torch.io.io import _IO_BATCHES, _IO_WAIT_SECONDS
    it = _prefetched(tio)
    n0 = _IO_BATCHES.value(iter="PrefetchingIter")
    w0 = _IO_WAIT_SECONDS.value(iter="PrefetchingIter")
    assert len(list(it)) == 4
    assert _IO_BATCHES.value(iter="PrefetchingIter") - n0 == 4
    assert _IO_WAIT_SECONDS.value(iter="PrefetchingIter") >= w0


def test_prefetched_inner_iter_does_not_double_count_wait():
    """tests/test_telemetry.py::test_prefetched_inner_iter_does_not_double_
    count_wait, on the port: an ImageRecordIter driven by PrefetchingIter's
    producer thread counts nothing, also through a ResizeIter between; the
    same object consumed directly afterwards counts again."""
    from incubator_mxnet_tpu_torch import io as tio
    from incubator_mxnet_tpu_torch.io.io import _IO_BATCHES

    class _SlowIter(tio.ImageRecordIter):
        # only the instrumented next(), not the record file
        def __init__(self):
            self.batch_size = 2
            self._n = 0

        def _next_impl(self):
            if self._n >= 3:
                raise StopIteration
            self._n += 1
            return tio.DataBatch([mxt.nd.zeros((2, 1), ctx=mxt.cpu())],
                                 [mxt.nd.zeros((2,), ctx=mxt.cpu())])

        def reset(self):
            self._n = 0

        @property
        def provide_data(self):
            return []

        @property
        def provide_label(self):
            return []

    inner0 = _IO_BATCHES.value(iter="_SlowIter")
    assert len(list(tio.PrefetchingIter(_SlowIter()))) == 3
    assert _IO_BATCHES.value(iter="_SlowIter") == inner0
    slow = _SlowIter()
    it2 = tio.PrefetchingIter(tio.ResizeIter(slow, size=2))
    assert len(list(it2)) == 2
    assert _IO_BATCHES.value(iter="_SlowIter") == inner0
    slow.reset()
    assert len(list(slow)) == 3
    assert _IO_BATCHES.value(iter="_SlowIter") == inner0 + 3


_F7_PREFIXES = ("mxtpu_train_", "mxtpu_io_", "mxtpu_jit_")


def _registrations(tel, run):
    """Run ``run(channels)`` on a reset span ring and flight recorder; its
    metrics (name, type, label names) of the training, io and jit
    families, the metrics whose samples it moved, its span names, flight
    record kinds and the watchdog channels ``run`` saw (a producer
    thread's ident replaced by <ident>)."""
    import re
    tel.spans.reset()
    tel.flightrec.reset()
    before = {(n, tuple(sorted(lab.items()))): v
              for n, _, lab, v in tel.REGISTRY.samples()}
    channels = set()
    run(channels)
    moved = set()
    for n, _, lab, v in tel.REGISTRY.samples():
        if before.get((n, tuple(sorted(lab.items())))) != v:
            moved.add(re.sub(r"_(sum|count)$", "", n)
                      if tel.REGISTRY.get(n) is None else n)

    def described(name):
        m = tel.REGISTRY.get(name)
        return name, m.type_name, tuple(m.labelnames)
    names = re.findall(r"^# TYPE (\S+) ", tel.export_text(), re.M)
    return dict(
        metrics={described(n) for n in names if n.startswith(_F7_PREFIXES)},
        moved={described(n) for n in moved if n.startswith(_F7_PREFIXES)},
        moved_elsewhere={described(n) for n in moved
                         if not n.startswith(_F7_PREFIXES)},
        spans={r["name"] for r in tel.spans.snapshot()},
        flight={e["event"] for e in tel.flightrec.snapshot()},
        channels={re.sub(r"^io_prefetch:[0-9a-f]+$", "io_prefetch:<ident>",
                         c) for c in channels})


def test_training_and_io_registrations_are_the_references(monkeypatch):
    """The registration comparison ROADMAP §3 asks for (F7): one small
    TrainStep (F7_STEPS steps of a Dense with the same parameters) and
    one PrefetchingIter(NDArrayIter(32 x 4, batch_size=8)) in each
    package register the same metric names, types and label sets, move
    the same metrics, emit the same span names and flight-record kinds and
    open the same watchdog channels; the counts are exact and the waits
    not negative."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import io as jio
    from incubator_mxnet_tpu.io import io as jio_mod
    from incubator_mxnet_tpu_torch import io as tio
    from incubator_mxnet_tpu_torch.io import io as tio_mod
    jnet, tnet = _f7_nets()
    got = {}
    for tel, io_mod, io_impl, steps in (
            (jtel, jio, jio_mod, lambda: _jax_steps(jnet)),
            (ttel, tio, tio_mod, lambda: _port_steps(tnet, monkeypatch))):
        def run(channels):
            step, _ = steps()
            channels.update(tel.watchdog.channels())
            it = _prefetched(io_mod)
            b0 = io_impl._IO_BATCHES.value(iter="PrefetchingIter")
            w0 = io_impl._IO_WAIT_SECONDS.value(iter="PrefetchingIter")
            batches = [it.next()]
            channels.update(tel.watchdog.channels())
            batches += list(it)
            assert len(batches) == 4
            assert io_impl._IO_BATCHES.value(iter="PrefetchingIter") \
                - b0 == 4
            assert io_impl._IO_WAIT_SECONDS.value(
                iter="PrefetchingIter") - w0 >= 0
            del step
        got[tel] = _registrations(tel, run)
    want, port = got[jtel], got[ttel]
    assert {"train_step", "io_prefetch:<ident>"} <= want["channels"]
    for key in ("metrics", "moved", "spans", "flight"):
        assert port[key] == want[key], key
    assert port["channels"] == want["channels"]
    # what the JAX step moves beyond these families (its program's device
    # statistics, its aot.CACHE entry) the port registers alike, though
    # its step keeps its own graph table and measures no program
    assert {described for described in want["moved_elsewhere"]
            if ttel.REGISTRY.get(described[0]) is None or (
                ttel.REGISTRY.get(described[0]).type_name,
                tuple(ttel.REGISTRY.get(described[0]).labelnames))
            != described[1:]} == set()


def test_train_step_watchdog_channel_goes_with_the_last_step(monkeypatch):
    """The train_step channel is counted per live stepped instance, as in
    the JAX package: dropping a stepped TrainStep takes one off."""
    import gc
    from incubator_mxnet_tpu_torch import jit as tjit
    _, tnet = _f7_nets()
    gc.collect()                 # earlier tests' dropped steps go first
    live = tjit.TrainStep._hb_live
    step, _ = _port_steps(tnet, monkeypatch, n=1)
    assert tjit.TrainStep._hb_live == live + 1
    assert "train_step" in watchdog.channels()
    monkeypatch.undo()           # the capture stand-in holds the step
    del step
    gc.collect()
    assert tjit.TrainStep._hb_live == live
    if live == 0:
        assert "train_step" not in watchdog.channels()


def _serve_once(serving, span_mod, net):
    """One predict through a ModelRegistry: the span records it left."""
    span_mod.reset()
    reg = serving.ModelRegistry()
    reg.load("m", net, max_batch_size=2, batch_timeout_ms=1.0)
    try:
        reg.predict("m", onp.ones((8,), "float32"))
    finally:
        reg.close()
    return span_mod.snapshot()


def test_eager_eval_step_opens_eval_step_under_serve_dispatch():
    """The eager EvalStep of a CPU net opens eval:step as the reference's
    compiled one does, under the replica's serve:dispatch span: the same
    span names and the same parent links, once a predict (but the
    reference's eval:build and eval:compile: the port compiles nothing on
    the CPU)."""
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu.telemetry import spans as jspans
    from incubator_mxnet_tpu_torch import serving as tserving
    jnet, tnet = _f7_nets()
    chains = []
    for serving, span_mod, net in ((mx.serving, jspans, jnet),
                                   (tserving, spans, tnet)):
        recs = _serve_once(serving, span_mod, net)
        by_id = {r["span_id"]: r["name"] for r in recs}
        chains.append(sorted((r["name"], by_id.get(r["parent_id"]))
                             for r in recs if r["name"] not in (
                                 "eval:build", "eval:compile")))
    assert chains[1] == chains[0]
    assert ("eval:step", "serve:dispatch") in chains[1]
    assert [n for n, _ in chains[1]].count("eval:step") == 1
