"""The port's telemetry core (incubator_mxnet_tpu_torch/telemetry:
registry, ringbuf, trace, spans, flightrec, watchdog, faultlab) against
the JAX package's: the same calls through both give the same Prometheus
text, the same cardinality clamp, the same span tree and flight-recorder
records, the same watchdog report and the same faultlab firing patterns.
The modules that wait for ROADMAP §1 item 7 raise, naming it.

Module-global state (the span ring, the tape, the armed faults) is reset
around each test that touches it; the watchdog's monitor is stopped in a
``finally``.
"""
import time
import warnings

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
    missing = [n for n in jtel.__all__ if n not in ttel.WAITING
               and not hasattr(ttel, n)]
    assert not missing, missing
    for name in ttel.WAITING:
        assert name in jtel.__all__
        with pytest.raises(NotImplementedError, match="item 7"):
            getattr(ttel, name)
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
