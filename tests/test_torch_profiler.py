"""The port's profiler against the JAX package's, on the CPU:

- the same ``nd`` program gives the same number of operator events, with
  the same ``scope`` prefixes, and the port's events are named by the
  public operator (an attribute of ``nd`` or of ``NDArray``: no
  ``<locals>``, no private helper), where the JAX package names its inner
  functions (``op:FullyConnected.<locals>.fn_b``);
- the dump's JSON keys and the aggregate table's header are equal;
  ``record_batch`` gives the same event name and arguments; a backwards
  wall-clock step changes no duration (``tests/test_profiler.py``'s
  monkeypatch); ``set_memory_source``, ``max_events``, ``pause``/
  ``resume`` and ``dumps(reset=True)`` behave as the reference's;
  ``device_memory`` falls back to the host's resident bytes;
- inside a capture (the CPU stand-in for ``jit._GraphCapture`` of
  ``tests/test_torch_jit.py``, which here also says it is capturing, as
  the card's stream would) no operator is recorded, and the captured
  step still equals the eager one; the serving batcher leaves one event
  a dispatched batch; ``trace_dir`` writes a ``torch.profiler`` trace.
"""
import json
import re
import time

import numpy as onp
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import profiler as jprof

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import jit as tjit
from incubator_mxnet_tpu_torch import profiler as tprof

CPU = mxt.cpu()


def _clear(prof):
    prof.set_state("stop")
    prof.set_memory_source(None)
    prof.set_config(filename="profile.json", profile_imperative=True,
                    profile_memory=True, max_events=500_000)
    with prof._LOCK:
        prof._EVENTS.clear()
        prof._AGG.clear()
    prof._STATE["peak_bytes"] = 0


@pytest.fixture(autouse=True)
def _fresh_profilers():
    for prof in (jprof, tprof):
        _clear(prof)
    yield
    for prof in (jprof, tprof):
        _clear(prof)


def _program(pkg):
    """An nd program of the ops the legacy cells and the LM run."""
    prof = jprof if pkg is mx else tprof
    nd = pkg.nd
    x = nd.random.normal(shape=(4, 4))
    w, b = nd.ones((3, 4)), nd.zeros((3,))
    nd.FullyConnected(x, w, b, num_hidden=3)
    nd.dot(x, x.T)
    (x * 2.0 + 1.0).sum()
    nd.relu(x)
    nd.sigmoid(x)
    nd.Embedding(nd.array([0, 1]), w, input_dim=3, output_dim=4)
    x[1:3]
    nd.slice_axis(x, axis=1, begin=0, end=2)
    nd.stack(x, x, axis=0)
    nd.squeeze(nd.expand_dims(x, 0), axis=0)
    nd.concat(x, x, dim=1)
    x.reshape((16,))
    nd.Activation(x, act_type="tanh")
    with prof.scope("phase:"):
        nd.minimum(x, x)
        nd.ones_like(x)
        with prof.scope("inner:"):
            nd.zeros_like(x)
            x - x


def _run_program(pkg):
    prof = jprof if pkg is mx else tprof
    prof.set_state("run")
    try:
        if pkg is mx:
            _program(mx)
        else:
            with CPU:
                _program(mxt)
    finally:
        prof.set_state("stop")
    with prof._LOCK:
        return [e["name"] for e in prof._EVENTS if e.get("ph") == "X"]


def _prefix(name):
    return name[len("op:"):].rpartition(":")[0]


def test_op_events_count_and_prefixes_are_the_references():
    want, got = _run_program(mx), _run_program(mxt)
    assert len(got) == len(want) == 21
    assert sorted(map(_prefix, got)) == sorted(map(_prefix, want))
    assert any(".<locals>." in n for n in want)   # the JAX package's names
    for name in got:
        assert name.startswith("op:")
        public = name[len("op:"):].rpartition(":")[2]
        assert re.fullmatch(r"[A-Za-z]\w*|__\w+__", public), name
        assert hasattr(mxt.nd, public) or hasattr(mxt.nd.NDArray, public), \
            name
    assert {"op:FullyConnected", "op:dot", "op:Embedding", "op:__mul__",
            "op:phase:minimum", "op:phase:inner:zeros_like",
            "op:phase:inner:__sub__"} <= set(got)


def test_dump_keys_and_table_header_are_the_references(tmp_path):
    got = {}
    for pkg, prof in ((mx, jprof), (mxt, tprof)):
        _run_program(pkg)
        prof.set_config(filename=str(tmp_path / ("%s.json" % pkg.__name__)))
        prof.dump()
        with open(prof._CONFIG["filename"]) as f:
            payload = json.load(f)
        got[pkg] = (sorted(payload), prof.dumps(reset=True).splitlines()[0],
                    sorted(payload["traceEvents"][0]), payload[
                        "displayTimeUnit"])
        assert prof._EVENTS == []                # dumped, then dropped
    assert got[mx] == got[mxt]


def test_record_batch_is_the_references():
    got = []
    for prof in (jprof, tprof):
        prof.set_state("run")
        prof.record_batch("m", 3, 4, dur_us=5.0,
                          request_ids=["ab12", "cd34", "ef56"])
        prof.record_batch("m", 2, 2, dur_us=1.0)
        prof.set_state("stop")
        got.append([(e["name"], e["cat"], e["dur"], e["args"])
                    for e in prof._EVENTS])
    assert got[0] == got[1]
    assert got[1][0] == ("serve:m:batch4", "serving", 5.0, {
        "batch_size": 3, "bucket": 4, "request_ids": ["ab12", "cd34",
                                                     "ef56"]})


def test_event_timing_immune_to_wall_clock_steps(monkeypatch):
    real_time = time.time
    monkeypatch.setattr(tprof.time, "time", lambda: real_time() - 3600.0)
    tprof.set_state("run")
    t_before = tprof.now_us()
    with tprof.Marker("ntp_probe"):
        time.sleep(0.01)
    t_after = tprof.now_us()
    tprof.set_state("stop")
    assert t_after > t_before
    ev = [e for e in tprof._EVENTS if e["name"] == "ntp_probe"][0]
    assert ev["dur"] >= 10_000 * 0.5 and ev["ts"] >= t_before


def _memory_run(pkg, tmp_path):
    """tests/test_profiler.py's memory run: an injected source whose
    live set grows to 300 MB and falls back to 200."""
    prof = jprof if pkg is mx else tprof
    sizes = iter([100 << 20, 300 << 20] + [200 << 20] * 20)
    last = [0]

    def fake_stats():
        last[0] = next(sizes, last[0])
        return {"bytes_in_use": last[0], "peak_bytes_in_use": last[0]}

    prof.set_memory_source(fake_stats)
    prof.set_state("run")
    try:
        if pkg is mx:
            (mx.nd.random.normal(shape=(8, 8)) * 2.0).sum()
        else:
            with CPU:
                (mxt.nd.random.normal(shape=(8, 8)) * 2.0).sum()
    finally:
        prof.set_state("stop")
        prof.set_memory_source(None)
    table = prof.dumps()
    mem_rows = [line.split()[-1] for line in table.splitlines()[1:]]
    peak_line = prof.memory_summary().splitlines()[-1]
    prof.set_config(filename=str(tmp_path / ("m_%s.json" % pkg.__name__)))
    prof.dump()
    with open(prof._CONFIG["filename"]) as f:
        payload = json.load(f)
    counters = [e["args"]["bytes_in_use"] for e in payload["traceEvents"]
                if e.get("ph") == "C"]
    return sorted(mem_rows), peak_line, counters, payload["profiledPeakBytes"]


def test_memory_source_is_the_references(tmp_path):
    want = _memory_run(mx, tmp_path)
    got = _memory_run(mxt, tmp_path)
    assert got == want
    assert got[1] == "profiled-run peak: 300.0 MB"


def test_max_events_pause_resume_and_reset_are_the_references():
    got = []
    for pkg, prof in ((mx, jprof), (mxt, tprof)):
        prof.set_config(max_events=5, profile_memory=False)
        n_all = len(_run_program(pkg))
        calls = sum(int(line.split()[-5]) for line in
                    prof.dumps().splitlines()[1:])
        prof.set_state("run")
        prof.pause()
        assert prof.state() == "stop"
        prof.record_event("paused")
        prof.resume()
        prof.record_event("resumed")
        prof.set_state("stop")
        names = set(prof._AGG)
        rows_before = len(prof.dumps(reset=True).splitlines())
        rows_after = len(prof.dumps().splitlines())
        got.append((n_all, calls, "paused" in names, "resumed" in names,
                    rows_before > 1, rows_after))
    assert got[0] == got[1] == [(5, 21, False, True, True, 1)][0]


def test_device_memory_falls_back_to_the_host_as_the_reference():
    want, got = jprof.device_memory(), tprof.device_memory()
    assert set(got) == set(want) == {"host"}
    assert set(got["host"]) == set(want["host"]) == {"rss_bytes",
                                                     "peak_rss_bytes"}
    assert got["host"]["rss_bytes"] > 0
    assert tprof.memory_summary().splitlines()[0] == \
        jprof.memory_summary().splitlines()[0]


def test_imperative_off_records_no_op_but_host_events():
    tprof.set_config(profile_imperative=False)
    tprof.set_state("run")
    with CPU:
        (mxt.nd.ones((3,)) + 1.0).sum()
    with tprof.Marker("host"):
        pass
    tprof.set_state("stop")
    assert [e["name"] for e in tprof._EVENTS] == ["host"]


def _hf_net():
    class Net(mxt.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.fc = mxt.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.relu(self.fc(x)) + F.ones_like(x).sum()
    net = Net()
    net.initialize(mxt.init.One(), ctx=CPU)
    net.hybridize()
    return net


def _flagged_capture(step, capturing):
    """test_torch_jit.py's stand-in, saying it captures while its body
    runs (the capture and, through the stand-in's graph, each replay)."""
    from test_torch_jit import _cpu_capture
    base = _cpu_capture(step)

    class Capture(base):
        def capture(self, fn):
            def body():
                capturing[0] = True
                try:
                    return fn()
                finally:
                    capturing[0] = False
            return super().capture(body)
    return Capture


def _op_events():
    """The trace's events but the mirrored telemetry spans (TrainStep's
    ``train:*`` spans, recorded on the host around each step)."""
    return len([e for e in tprof._EVENTS if e["cat"] != "span"])


def _steps(captured, monkeypatch):
    x = mxt.nd.array(onp.arange(6.0).reshape(2, 3), ctx=CPU)
    y = mxt.nd.array(onp.full((2, 4), 10.0, "float32"), ctx=CPU)
    net = _hf_net()
    step = tjit.TrainStep(net, mxt.gluon.loss.L2Loss(), mxt.gluon.Trainer(
        net.collect_params(), "sgd", {"learning_rate": 0.001}))
    events = []
    _clear(tprof)
    tprof.set_state("run")
    try:
        if captured:
            capturing = [False]
            monkeypatch.setattr(tprof, "_capturing", lambda: capturing[0])
            monkeypatch.setattr(tjit, "_GraphCapture",
                                _flagged_capture(step, capturing))
            args = step._prepare((x, y), 1)
            losses = []
            for _ in range(3):
                losses.append(step._replay(args, 1, 2).numpy())
                events.append(_op_events())
            assert step.captures == 1
        else:
            losses = []
            for _ in range(3):
                losses.append(step(x, y).asnumpy())
                events.append(_op_events())
    finally:
        tprof.set_state("stop")
    return losses, events, net.fc.weight.data().asnumpy()


def test_no_event_inside_a_capture_and_captured_equals_eager(monkeypatch):
    eager, e_events, e_w = _steps(False, monkeypatch)
    captured, c_events, c_w = _steps(True, monkeypatch)
    per_step = e_events[0]
    assert per_step > 0 and e_events == [per_step * (i + 1) for i in range(3)]
    # only the eager first step records; its capture and replays do not
    assert c_events == [per_step] * 3
    for a, b in zip(captured, eager):
        onp.testing.assert_array_equal(a, b)
    onp.testing.assert_array_equal(c_w, e_w)


def test_batcher_records_one_event_per_dispatched_batch():
    class Echo:
        def predict_batch(self, x):
            return (x * 2.0,)

    batcher = mxt.serving.DynamicBatcher(Echo(), max_batch_size=4,
                                         batch_timeout_ms=200, name="echo")
    tprof.set_state("run")
    try:
        reqs = [batcher.submit(onp.full((3,), i, "float32"))
                for i in range(3)]
        outs = [r.result(30)[0] for r in reqs]
    finally:
        tprof.set_state("stop")
        batcher.close()
    for i, o in enumerate(outs):
        onp.testing.assert_array_equal(o, onp.full((3,), 2.0 * i))
    evs = [e for e in tprof._EVENTS if e["name"].startswith("serve:echo:")]
    assert sum(e["args"]["batch_size"] for e in evs) == 3
    assert len(evs) == batcher.metrics.batch_count
    for e in evs:
        assert e["name"] == "serve:echo:batch%d" % e["args"]["bucket"]
        assert "request_ids" not in e["args"] and e["dur"] >= 0


def test_trace_dir_writes_a_torch_profiler_trace(tmp_path):
    tprof.set_config(trace_dir=str(tmp_path / "trace"))
    try:
        tprof.set_state("run")
        with CPU:
            (mxt.nd.ones((64, 64)) * 3.0).sum()
        tprof.set_state("stop")
    finally:
        tprof.set_config(trace_dir=None)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
