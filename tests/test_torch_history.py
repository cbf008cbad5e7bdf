"""telemetry.history on the CPU, against the JAX package's
(incubator_mxnet_tpu/telemetry/history.py; its tests/test_history.py):
the same queue-depth script on an injected clock opens the same
pressure_rising episodes, the same window-MFU script the same mfu_droop
episodes, in both packages; ``_window_mfu`` reads devstats' dispatch
totals under the names the port publishes; the rings fold and query as
the reference's, and the export round-trips.
"""
import json

import pytest

from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.telemetry import flightrec as jflight
from incubator_mxnet_tpu.telemetry import history as jhist

from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import devstats, flightrec, history

PACKAGES = ((ttel, history, flightrec), (jtel, jhist, jflight))


@pytest.fixture(autouse=True)
def _clean():
    for _tel, hist, rec in PACKAGES:
        hist.reset()
        rec.reset()
    yield
    for _tel, hist, _rec in PACKAGES:
        hist.reset()


def _gauges(tel):
    depth = tel.gauge(
        "mxtpu_serving_queue_depth",
        "Requests currently waiting in the model's bounded queue.",
        ("model",))
    cap = tel.gauge(
        "mxtpu_serving_queue_capacity",
        "Aggregate queue capacity of the model (per-replica bound x "
        "replicas) — the saturation line the metric-history "
        "pressure_rising predictor extrapolates "
        "mxtpu_serving_queue_depth toward (telemetry/history.py; "
        "docs/OBSERVABILITY.md).", ("model",))
    return depth, cap


def _events(rec, kind, **match):
    return [e for e in rec.snapshot() if e["event"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def test_pressure_rising_episodes_equal_the_references(monkeypatch):
    monkeypatch.setenv("MXTPU_HISTORY_PRESSURE_HORIZON_S", "30")
    monkeypatch.setenv("MXTPU_HISTORY_SLOPE_WINDOW_S", "5")
    script = ([40.0 + 4.0 * i for i in range(9)]
              + [max(0.0, 80.0 - 20.0 * i) for i in range(5)]
              + [30.0 + 6.0 * i for i in range(8)])
    got = []
    for tel, hist, rec in PACKAGES:
        depth, cap = _gauges(tel)
        cap.set(100.0, model="hp")
        for i, v in enumerate(script):
            depth.set(v, model="hp")
            hist.sample_once(now_s=float(i))
        evs = _events(rec, "pressure_rising", model="hp")
        got.append([(e["capacity"], round(e["slope_per_s"], 9)) for e in evs])
    assert len(got[0]) == 2 and got[0] == got[1]


def test_mfu_droop_episodes_equal_the_references(monkeypatch):
    script = [0.5] * 8 + [0.10] * 3 + [0.5] * 4 + [0.10] * 2
    got = []
    for _tel, hist, rec in PACKAGES:
        it = iter(script)
        monkeypatch.setattr(hist, "_window_mfu", lambda t, it=it: next(it,
                                                                     None))
        for i in range(len(script)):
            hist.sample_once(now_s=float(i))
        got.append([(e["median_mfu"], round(e["window_mfu"], 9))
                    for e in _events(rec, "mfu_droop")])
    assert len(got[0]) == 2 and got[0] == got[1]


def test_window_mfu_reads_the_ports_dispatch_totals():
    """``_window_mfu`` is the FLOPs over the chip-seconds devstats counted
    between two ticks, against its peak: fed by observe_dispatch."""
    history.sample_once(now_s=0.0)
    with devstats.dispatch_context("hist-mfu", 0):
        devstats.observe_dispatch("serve", {"flops": 2e12}, 0.01)
    mfu = history._window_mfu(1.0)
    assert mfu == pytest.approx(2e12 / 0.01 / devstats.peaks()[0])
    devstats.detach_model("hist-mfu")


def test_rings_query_incident_and_export(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_HISTORY_RAW", "4")
    monkeypatch.setenv("MXTPU_HISTORY_COARSE_EVERY", "2")
    depth, _cap = _gauges(ttel)
    for i in range(10):
        depth.set(float(i), model="hq")
        history.sample_once(now_s=100.0 + i)
    q = history.query(series='mxtpu_serving_queue_depth{model="hq"}')
    (entry,) = q["series"].values()
    assert [v for _t, v in entry["raw"]] == [6.0, 7.0, 8.0, 9.0]
    assert entry["coarse"][-1]["max"] == 9.0
    stepped = history.query(series="mxtpu_serving_queue_depth", step=2.0)
    assert stepped["series"]
    flightrec.record("fault_injected", site="batcher.dispatch", model="hq")
    inc = history.incident(before_s=1e9, after_s=60.0)
    assert any(e.get("event") == "fault_injected" for e in inc["timeline"])
    path = str(tmp_path / "hist.jsonl")
    history.export_jsonl(path)
    rows = [json.loads(line) for line in open(path)]
    assert any(r.get("series") == 'mxtpu_serving_queue_depth{model="hq"}'
               for r in rows)


def test_daemon_starts_ticks_and_stops():
    import time
    history.start(interval_s=0.05)
    try:
        deadline = time.monotonic() + 10.0
        while history._TICKS.value() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert history._TICKS.value() >= 2
    finally:
        history.stop()
