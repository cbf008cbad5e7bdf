"""telemetry.devstats on the CPU, against the JAX package's
(incubator_mxnet_tpu/telemetry/devstats.py; its tests/test_devstats.py).

The peak table and its knobs, the per-dispatch MFU arithmetic and its
window counters, the memory sampler with an injected source (pressure
episodes), and the profile capture's single flight are the reference's
contract; the program facts are re-derived for torch: FLOPs counted by
``FlopCounterMode`` (K1 through its operator's formula), peak bytes from
the allocator (0 on the CPU), and ``bytes_accessed`` None (a departure,
ROADMAP §3). The same calls go through both packages where both run on
the CPU; the numbers are exact (the same float arithmetic).
"""
import contextlib
import threading
import time

import pytest
import torch

from incubator_mxnet_tpu.telemetry import devstats as jdev

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import profiler
from incubator_mxnet_tpu_torch.telemetry import devstats, flightrec


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for pkg in (devstats, jdev):
        pkg.reset_peaks()
    yield
    for pkg in (devstats, jdev):
        pkg.stop()
        pkg.set_memory_source(None)
        pkg.reset_peaks()


def test_peak_table_holds_the_h100_and_the_knobs_override(monkeypatch):
    assert devstats.PEAK_TABLE["NVIDIA H100 80GB HBM3"] == (989e12, 3.35e12)
    assert devstats._table_lookup(devstats.PEAK_TABLE,
                                  "NVIDIA H100 80GB HBM3") == (989e12,
                                                               3.35e12)
    # a prefix matches at a word boundary only, as the reference's
    assert devstats._table_lookup(devstats.PEAK_TABLE, "NVIDIA H1000") \
        is None
    # the CPU: the same report-only fallback in both packages
    assert devstats.peaks() == jdev.peaks() == (1e12, 100e9, "fallback")
    for env in ({"MXTPU_DEVICE_PEAK_FLOPS": "5e14"},
                {"MXTPU_DEVICE_PEAK_FLOPS": "5e14",
                 "MXTPU_DEVICE_PEAK_HBM_BPS": "2e12"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        devstats.reset_peaks()
        jdev.reset_peaks()
        assert devstats.peaks() == jdev.peaks(), env
    assert devstats.hbm_capacity() == (None, "unknown") == \
        jdev.hbm_capacity()


def test_observe_dispatch_math_equals_the_references():
    """The same stats and spans through both: the same rolling MFU and
    window counters (bytes accessed None counts as 0, as an empty
    cost analysis does in the reference)."""
    stats = {"flops": 3.0e12, "bytes_accessed": None, "peak_bytes": 1e9,
             "output_bytes": 2e6}
    jstats = dict(stats, bytes_accessed=0.0)
    for pkg, st in ((devstats, stats), (jdev, jstats)):
        with pkg.dispatch_context("m-devstats", 1):
            assert pkg.in_dispatch_context()
            for dur in (0.01, 0.02, 0.015):
                pkg.observe_dispatch("serve", st, dur)
    got = {l["model"]: v for l, v in devstats._MFU.series()
           if l["model"] == "m-devstats"}
    want = {l["model"]: v for l, v in jdev._MFU.series()
            if l["model"] == "m-devstats"}
    assert got == want and got["m-devstats"] > 0
    assert devstats.dispatch_totals()["by_model"]["m-devstats"] == \
        jdev.dispatch_totals()["by_model"]["m-devstats"]
    devstats.detach_model("m-devstats")
    jdev.detach_model("m-devstats")
    assert not [l for l, _v in devstats._MFU.series()
                if l["model"] == "m-devstats"]


def test_program_stats_are_measured_once_at_the_build():
    """``measure`` counts a Dense forward's 2·M·N·K FLOPs and its output
    bytes; ``bytes_accessed`` is None (torch has no cost analysis: the
    departure); ``program_stats`` reads what the build measured, never
    measures, and a program without stats gives None, as an unanalyzable
    one does in the reference."""
    net = mxt.gluon.nn.Dense(5, in_units=3, use_bias=False)
    net.initialize(ctx=mxt.cpu())
    x = torch.ones(4, 3)
    out, stats = devstats.measure(lambda: net(x))
    assert stats == {"flops": 2.0 * 4 * 3 * 5, "bytes_accessed": None,
                     "peak_bytes": 0.0, "output_bytes": 4.0 * 5 * 4}
    assert devstats.program_stats(object()) is None
    assert jdev.program_stats(object()) is None

    class Program:
        stats = {"flops": 1.0}
    assert devstats.program_stats(Program()) == {"flops": 1.0}
    assert devstats.pool_bytes(torch.device("cpu"), (0, 1)) == 0.0
    assert devstats.pool_bytes(torch.device("cuda", 0), None) == 0.0


def test_captured_evalstep_entries_carry_and_publish_their_stats(
        cpu_graphs):
    """An EvalStep's cache entry carries the FLOPs of its eager run; the
    program gauges publish them by bucket and drop them with the entry;
    a replay inside a dispatch context observes one MFU sample."""
    from incubator_mxnet_tpu_torch import aot
    net = mxt.gluon.nn.Dense(5, in_units=3, use_bias=False)
    net.initialize(ctx=mxt.cpu())
    step = tjit.EvalStep(net, model_id="m-stats")
    x = torch.ones(4, 3)
    step(x)
    (key,) = step._keys
    assert aot.CACHE.peek(key).stats["flops"] == 2.0 * 4 * 3 * 5
    assert aot._PROG_FLOPS.value(model="m-stats", kind="eval",
                                 bucket=4) == 2.0 * 4 * 3 * 5
    with devstats.dispatch_context("served-m", 0):
        step(x)
    assert any(l["model"] == "served-m" for l, _v in devstats._MFU.series())
    step.release()
    assert not [l for l, _v in aot._PROG_FLOPS.series()
                if l["model"] == "m-stats"]
    devstats.detach_model("served-m")


def test_sampler_publishes_and_opens_one_pressure_episode():
    """An injected memory source, as the reference's tests inject one:
    the gauges publish during a session only, >90 % of the limit files
    one hbm_pressure event an episode, <85 % re-arms."""
    level = {"used": 10}
    for pkg in (devstats, jdev):
        pkg.set_memory_source(lambda: {"dev0": {
            "bytes_in_use": level["used"], "peak_bytes_in_use": 95,
            "bytes_limit": 100}})
    flightrec.reset()
    devstats.start(poll_s=60.0)
    try:
        for used in (95, 96, 80, 97):
            level["used"] = used
            devstats.sample_now()
        assert devstats.device_memory()["dev0"]["bytes_in_use"] == 97
        assert devstats._MEMORY_BYTES.value(device="dev0",
                                            stat="bytes_limit") == 100
    finally:
        devstats.stop()
    events = [e for e in flightrec.snapshot()
              if e["event"] == "hbm_pressure" and e.get("device") == "dev0"]
    assert len(events) == 2
    assert not [l for l, _v in devstats._MEMORY_BYTES.series()
                if l["device"] == "dev0"]
    # without CUDA and without a source: the host's RSS, report-only
    devstats.set_memory_source(None)
    assert "rss_bytes" in devstats.sample_now()["host"]


def test_profile_capture_is_single_flight_and_exclusive(tmp_path):
    """A capture while another is in flight raises ProfileCaptureBusy (the
    route's 409); so does one while the profiler module's torch.profiler
    trace runs, and that trace cannot start during a capture."""
    entered = threading.Event()
    real = devstats._trace_session

    def session(path):
        entered.set()
        return real(path)
    devstats._trace_session = session
    try:
        t = threading.Thread(target=devstats.capture_profile,
                             args=(0.5, str(tmp_path)))
        t.start()
        assert entered.wait(10.0)
        assert devstats.capture_in_progress()
        with pytest.raises(devstats.ProfileCaptureBusy):
            devstats.capture_profile(0.05, str(tmp_path))
        profiler.set_config(trace_dir=str(tmp_path / "trace"))
        with pytest.raises(devstats.ProfileCaptureBusy):
            profiler.set_state("run")
        assert profiler.state() == "stop"
        t.join(30.0)
    finally:
        devstats._trace_session = real
        profiler.set_config(trace_dir=None)
    assert not devstats.capture_in_progress()
    profiler.set_config(trace_dir=str(tmp_path / "trace"))
    profiler.set_state("run")
    try:
        with pytest.raises(devstats.ProfileCaptureBusy):
            devstats.capture_profile(0.05, str(tmp_path))
    finally:
        profiler.set_state("stop")
        profiler.set_config(trace_dir=None)
    out = devstats.capture_profile(0.05, str(tmp_path))
    assert out["capture_id"].startswith("capture-")
    assert 0.05 <= out["traced_s"] < 30.0
    import os
    assert os.listdir(out["dir"]) == ["capture.trace.json"]


def test_launch_gate_keeps_device_work_out_of_profiler_transitions():
    """An exclusive section (torch.profiler's start or stop) waits for
    the shared section in flight (a serving thread's unit of device work)
    and holds new ones back until it ends; shared sections nest, the
    exclusive thread passes its own, and a thread inside a shared section
    does not wait for itself."""
    gate = devstats._LaunchGate()
    inside, leave = threading.Event(), threading.Event()
    order = []

    def worker():
        with gate.shared():
            with gate.shared():
                inside.set()
                leave.wait(30)
                order.append("unit")

    def transition():
        with gate.exclusive():
            order.append("transition")
            with gate.shared():
                order.append("own unit")
    w = threading.Thread(target=worker)
    w.start()
    assert inside.wait(30)
    t = threading.Thread(target=transition)
    t.start()
    t.join(0.2)
    assert t.is_alive() and order == []
    leave.set()
    t.join(30)
    w.join(30)
    assert order == ["unit", "transition", "own unit"]

    held, go, entered = threading.Event(), threading.Event(), \
        threading.Event()

    def holder():
        with gate.exclusive():
            held.set()
            go.wait(30)

    def late():
        with gate.shared():
            entered.set()
    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(30)
    lt = threading.Thread(target=late)
    lt.start()
    assert not entered.wait(0.2)
    go.set()
    assert entered.wait(30)
    h.join(30)
    lt.join(30)
    with gate.shared():
        with gate.exclusive():
            pass
    assert gate._inside == 0 and gate._owner is None


def test_profile_capture_waits_for_the_batch_in_flight(tmp_path):
    """A batcher worker's batch is a unit of device work: a capture asked
    for while a batch runs starts (and so stops) only once the batch has
    returned, and the batch's reply is untouched."""
    import numpy as onp
    from incubator_mxnet_tpu_torch import serving
    started, release = threading.Event(), threading.Event()

    class Blocking:
        def predict_batch(self, x):
            started.set()
            release.wait(30)
            return (x * 2,)
    devstats.capture_profile(0.01, str(tmp_path))   # its first start is slow
    real, traced = devstats._trace_session, []

    @contextlib.contextmanager
    def session(path):
        with real(path) as span:
            traced.append(time.monotonic())     # the profiler has started
            yield span
    devstats._trace_session = session
    reg = serving.ModelRegistry()
    reg.load("m", Blocking(), max_batch_size=1, batch_timeout_ms=0)
    try:
        req = reg.submit("m", onp.ones(1, "float32"))
        assert started.wait(30)
        out = {}
        t = threading.Thread(target=lambda: out.update(
            devstats.capture_profile(0.05, str(tmp_path))))
        t.start()
        t.join(0.5)
        released = time.monotonic()
        release.set()
        t.join(30)
        assert out["capture_id"].startswith("capture-")
        assert traced and traced[0] >= released
        onp.testing.assert_array_equal(req.result(30)[0], [2.0])
    finally:
        devstats._trace_session = real
        release.set()
        reg.close()


from test_torch_aot import cpu_graphs  # noqa: E402,F401 — a fixture


def test_debug_profile_route_answers_409_while_a_capture_runs():
    """GET /debug/profile is single-flight: 409 while a capture is in
    flight, as the JAX server's; then 200 with the capture's summary."""
    import http.client
    import json
    from incubator_mxnet_tpu_torch import serving

    class Echo:
        def predict_batch(self, x):
            return (x,)
    srv = serving.serve({"m": Echo()}, port=0)
    try:
        def get(path):
            c = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
            c.request("GET", path)
            r = c.getresponse()
            body = json.loads(r.read())
            c.close()
            return r.status, body
        with devstats._capture_lock:
            st, body = get("/debug/profile?seconds=0.05")
        assert st == 409 and "in progress" in body["error"]
        st, body = get("/debug/profile?seconds=0.05")
        assert st == 200 and body["capture_id"].startswith("capture-")
        assert "device_idle_ratio" in body["summary"]
        assert get("/debug/profile?seconds=x")[0] == 400
    finally:
        srv.stop()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_program_peak_leaves_the_process_peak_alone():
    """A capture's ``peak_bytes`` are the bytes its graph's private pool
    holds; the allocator's process-wide peak, which the memory sampler
    and the profiler read, is not reset by it."""
    dev = torch.device("cuda", 0)
    big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    del big
    before = torch.cuda.max_memory_allocated(dev)
    net = mxt.gluon.nn.Dense(256, in_units=256)
    net.initialize(ctx=mxt.gpu(0))
    step = tjit.EvalStep(net)
    x = torch.ones(8, 256, device=dev)
    step(x)
    step(x)
    entry = [e for e in tjit.aot.CACHE.snapshot() if e["kind"] == "eval"][0]
    assert torch.cuda.max_memory_allocated(dev) >= before
    assert entry["stats"]["peak_bytes"] >= 8 * 256 * 4
    step.release()
