"""The port's resilience reflexes on the CPU (serving/resilience.py,
serving/batcher.py, serving/registry.py, serving/generate.py), the JAX
package's tests/test_resilience.py scenarios run through the port: the
batcher's single retry of an injected replica kill and respawn, the
query of death that is never retried, the Supervisor's respawn, its
crash-loop park and ``unpark``, decode-loop resurrection with bit-exact
survivors and loud ``engine_restart`` retirement, last-known-good
rollback, and the HTTP outage contract (503 ``no_replicas`` without
Retry-After, a dead decode loop delisted until resurrected).

Every wait, join and socket read here is bounded, and what a test starts
it closes in a ``finally``: nothing here may hang the suite.
"""
import http.client
import json
import threading
import time

import numpy as onp
import pytest

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch.telemetry import faultlab, flightrec
from incubator_mxnet_tpu_torch.serving import (
    DynamicBatcher, ModelRegistry, ServingClosedError, ServingServer,
    Supervisor)
from incubator_mxnet_tpu_torch.serving import batcher as batcher_mod
from incubator_mxnet_tpu_torch.serving.batcher import NoReplicasError
from incubator_mxnet_tpu_torch.serving import generate as gen

GEO = dict(block_size=8, num_blocks=48, max_batch=4, prefill_len=16,
           max_tokens=16)


@pytest.fixture(autouse=True)
def _clean_lab():
    """No fault armed in one test may leak into the next."""
    faultlab.reset()
    yield
    faultlab.reset()


def _wait(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _rows(event, model=None):
    return [ev for ev in flightrec.snapshot()
            if ev["event"] == event
            and (model is None or ev.get("model") == model)]


class _Kill(BaseException):
    """Escapes per-batch ``except Exception`` guards: worker death."""


class _Echo:
    def __init__(self, bias=0.0):
        self.bias = float(bias)

    def predict_batch(self, x):
        return (x + self.bias,)


class _AlwaysDie:
    def predict_batch(self, x):
        raise _Kill("deterministic crasher")


class _DieOncePoisoned:
    """Kills the worker once on the poison value, then serves."""

    def __init__(self):
        self._lock = threading.Lock()
        self.died = False

    def predict_batch(self, x):
        with self._lock:
            if not self.died and float(onp.asarray(x).ravel()[0]) == -1.0:
                self.died = True
                raise _Kill("poison")
        return (x,)


def _http_post(host, port, path, payload, timeout=30.0):
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("POST", path, json.dumps(payload).encode("utf-8"),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        return r.status, hdrs, json.loads(r.read().decode("utf-8"))
    finally:
        c.close()


def _http_get(host, port, path, timeout=30.0):
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, json.loads(r.read().decode("utf-8"))
    finally:
        c.close()


def _gen_http(host, port, body, timeout=60.0):
    c = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        c.request("POST", "/generate", json.dumps(body).encode("utf-8"),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        if r.status != 200:
            return r.status, [json.loads(r.read().decode("utf-8"))]
        return r.status, [json.loads(ln) for ln in
                          r.read().decode("utf-8").splitlines()
                          if ln.strip()]
    finally:
        c.close()


def _engine(name):
    return gen.GenerativeEngine(name=name, seed=0, ctx=mxt.cpu(), **GEO)


# -------------------------------------------- retry + respawn (batcher)
def test_injected_kill_retries_once_then_respawn_rebalances():
    b = DynamicBatcher(_Echo(), max_batch_size=2, batch_timeout_ms=1.0,
                       queue_size=16, replicas=2, name="tz-respawn")
    try:
        x = onp.float32([1.0])
        b.predict(x, timeout=10.0)
        r0 = batcher_mod._RETRIES.value(model="tz-respawn")
        faultlab.arm("batcher.dispatch:replica_kill:stride=1:budget=1")
        out = b.predict(x, timeout=15.0)
        assert out[0][0] == 1.0
        assert _wait(lambda: b.dead_replicas(), 10.0), "worker never died"
        assert batcher_mod._RETRIES.value(model="tz-respawn") == r0 + 1
        assert _rows("request_retried", "tz-respawn")
        dead = b.dead_replicas()[0]
        assert b.respawn_replica(dead) is True
        assert b.dead_replicas() == []
        assert b.respawn_replica(dead) is False
        assert _rows("replica_respawned", "tz-respawn")
        for i in range(24):
            b.predict(onp.float32([float(i)]), timeout=10.0)
        assert min(b.replica_dispatch_counts()) > 0
    finally:
        b.close()
    assert b.respawn_replica(0) is False


def test_no_retry_past_deadline_or_with_retry_off(monkeypatch):
    b = DynamicBatcher(_Echo(), max_batch_size=1, batch_timeout_ms=0.5,
                       queue_size=4, replicas=2, name="tz-deadline")
    faultlab.arm("batcher.dispatch:slow_ms:ms=100;"
                 "batcher.dispatch:replica_kill:stride=1:budget=1")
    try:
        req = b.submit(onp.float32([1.0]), deadline_ms=30)
        with pytest.raises(ServingClosedError):
            req.result(10.0)
        assert batcher_mod._RETRIES.value(model="tz-deadline") == 0
    finally:
        b.close()
    monkeypatch.setenv("MXTPU_RESILIENCE_RETRY", "0")
    b = DynamicBatcher(_Echo(), max_batch_size=1, batch_timeout_ms=0.5,
                       queue_size=4, replicas=2, name="tz-noretry")
    try:
        faultlab.arm("batcher.dispatch:replica_kill:stride=1:budget=1")
        req = b.submit(onp.float32([1.0]))
        with pytest.raises(ServingClosedError):
            req.result(10.0)
        assert batcher_mod._RETRIES.value(model="tz-noretry") == 0
    finally:
        b.close()


def test_query_of_death_is_never_retried():
    b = DynamicBatcher(_DieOncePoisoned(), max_batch_size=1,
                       batch_timeout_ms=0.5, queue_size=8, replicas=2,
                       name="tz-qod")
    try:
        req = b.submit(onp.float32([-1.0]))
        with pytest.raises(_Kill):
            req.result(10.0)
        assert batcher_mod._RETRIES.value(model="tz-qod") == 0
        assert _wait(lambda: len(b.dead_replicas()) == 1, 10.0)
        assert b.predict(onp.float32([5.0]), timeout=10.0)[0][0] == 5.0
        assert b.alive
    finally:
        b.close()


# ------------------------------------------------------------ supervisor
def test_supervisor_thread_respawns_dead_replica():
    reg = ModelRegistry()
    reg.load("tz-auto", _DieOncePoisoned(), max_batch_size=1,
             batch_timeout_ms=1.0, queue_size=8, replicas=2, prewarm=False)
    sup = Supervisor(reg, poll_s=0.01, backoff_base_s=0.01,
                     backoff_cap_s=0.05, crash_n=5,
                     crash_window_s=30.0).start()
    try:
        assert sup.alive
        with pytest.raises(_Kill):
            reg.predict("tz-auto", onp.float32([-1.0]), timeout=15.0)
        assert reg.predict("tz-auto", onp.float32([2.0]),
                           timeout=15.0)[0][0] == 2.0
        b = reg._entry("tz-auto").batcher
        assert _wait(lambda: _rows("replica_respawned", "tz-auto"), 10.0), \
            sup.describe()
        assert _wait(lambda: not b.dead_replicas(), 10.0), sup.describe()
        assert reg.health()["status"] == "healthy"
    finally:
        sup.stop()
        reg.close()
    assert not sup.alive


def test_supervisor_parks_crash_loop_and_unpark_revives():
    reg = ModelRegistry()
    reg.load("tz-park", _AlwaysDie(), max_batch_size=1,
             batch_timeout_ms=1.0, queue_size=8, replicas=1, prewarm=False)
    sup = Supervisor(reg, poll_s=0.01, backoff_base_s=0.005,
                     backoff_cap_s=0.02, crash_n=3, crash_window_s=30.0)
    b = reg._entry("tz-park").batcher
    try:
        deadline = time.monotonic() + 60.0
        while not sup.parked("tz-park", 0) and \
                time.monotonic() < deadline:
            if b.dead_replicas():
                sup.poll_once()
                time.sleep(0.05)
                sup.poll_once()
            else:
                with pytest.raises((_Kill, NoReplicasError)):
                    reg.predict("tz-park", onp.float32([1.0]),
                                timeout=10.0)
        assert sup.parked("tz-park", 0), sup.describe()
        assert _rows("replica_parked", "tz-park")
        assert b.dead_replicas() == [0]
        assert reg.health()["status"] in ("degraded", "unhealthy")
        assert "tz-park:r0" in "".join(sup.describe()["parked"])
        sup.poll_once()
        time.sleep(0.05)
        sup.poll_once()
        assert b.dead_replicas() == [0]          # parked stays parked
        assert sup.unpark("tz-park", 0) is True
        assert sup.unpark("tz-park", 0) is False
        sup.poll_once()
        time.sleep(0.05)
        sup.poll_once()
        assert _wait(lambda: not b.dead_replicas(), 5.0)
    finally:
        reg.close()


# --------------------------------------------- decode-loop resurrection
def test_genloop_kill_resurrect_survivors_bit_exact():
    e = _engine("tz-gen")
    try:
        reqs = [dict(prompt=[3, 1, 4], max_new_tokens=10,
                     temperature=1.0, seed=11),
                dict(prompt=[2, 7, 1, 8], max_new_tokens=10,
                     temperature=1.0, seed=22)]
        refs = [e.generate_sequential(**r) for r in reqs]
        e.set_supervised(True)
        faultlab.arm("generate.step:replica_kill:stride=4:budget=1")
        streams = [e.submit(**r) for r in reqs]
        assert _wait(lambda: not e.alive, 30.0), "decode loop never died"
        died = _rows("genloop_died", "tz-gen")
        assert died and died[-1]["pool_hazard"] is False
        assert died[-1]["active"] >= 1
        assert e.resurrect() is True
        assert e.resurrect() is False
        for s, (ref_toks, ref_reason) in zip(streams, refs):
            toks, reason = s.tokens(timeout=60.0)
            assert toks == ref_toks and reason == ref_reason
        res = _rows("genloop_resurrected", "tz-gen")
        assert res and res[-1]["retired"] == 0
    finally:
        e.close()


def test_mid_update_kill_retires_engine_restart_and_frees_kv():
    e = _engine("tz-hazard")
    try:
        e.set_supervised(True)
        used0 = e._alloc.used
        real = e._decode_fn

        def poisoned(pool=None):
            def wrapped(*a):
                raise _Kill("crash inside the decode call")
            return wrapped

        e._decode_fn = poisoned
        stream = e.submit([5, 6, 7], max_new_tokens=8, seed=3)
        assert _wait(lambda: not e.alive, 30.0), "decode loop never died"
        died = _rows("genloop_died", "tz-hazard")
        assert died and died[-1]["pool_hazard"] is True
        e._decode_fn = real
        assert e.resurrect() is True
        toks, reason = stream.tokens(timeout=60.0)
        assert reason == "engine_restart"
        assert stream.finish_reason == "engine_restart"
        assert len(toks) <= 1
        assert _wait(lambda: e._alloc.used == used0, 10.0)
        # the pool was zeroed in place: its address (which its programs
        # are bound to) is unchanged, and a fresh sequence still equals
        # the sequential reference
        ref = e.generate_sequential([9, 9], max_new_tokens=5, seed=2)
        assert e.submit([9, 9], max_new_tokens=5, seed=2).tokens(60.0) \
            == ref
        res = _rows("genloop_resurrected", "tz-hazard")
        assert res and res[-1]["retired"] == 1
    finally:
        e.close()


# ------------------------------------------------- last-known-good roll
def test_degraded_rolls_back_to_last_known_good_and_quarantines():
    reg = ModelRegistry()
    reg.load("tz-roll", _Echo(1.0), max_batch_size=2, batch_timeout_ms=1.0,
             queue_size=8, prewarm=False)
    reg.load("tz-roll", _Echo(100.0), prewarm=False)
    try:
        entry = reg._entry("tz-roll")
        assert reg.predict("tz-roll", onp.float32([1.0]))[0][0] == 101.0
        entry.set_degraded("shadow divergence breach")
        d = entry.describe()
        assert d["current_version"] == 1 and d["degraded"] is None
        assert d["rolled_back"] == {"from_version": 2, "to_version": 1,
                                    "reason": "shadow divergence breach"}
        assert reg.predict("tz-roll", onp.float32([1.0]))[0][0] == 2.0
        assert reg.health()["status"] == "healthy"
        rows = _rows("rolled_back_to", "tz-roll")
        assert rows and rows[-1]["from_version"] == 2
        entry.repoint(2)
        assert entry.describe()["current_version"] == 1
        reg.load("tz-stick", _Echo(1.0), max_batch_size=2,
                 batch_timeout_ms=1.0, queue_size=8, prewarm=False)
        e2 = reg._entry("tz-stick")
        e2.set_degraded("breach with nowhere to go")
        assert e2.describe()["degraded"] == "breach with nowhere to go"
        assert e2.describe()["rolled_back"] is None
        assert reg.health()["status"] == "degraded"
    finally:
        reg.close()


def test_rollback_disabled_by_env_is_sticky_degraded(monkeypatch):
    monkeypatch.setenv("MXTPU_RESILIENCE_ROLLBACK", "0")
    reg = ModelRegistry()
    reg.load("tz-noroll", _Echo(1.0), max_batch_size=2,
             batch_timeout_ms=1.0, queue_size=8, prewarm=False)
    reg.load("tz-noroll", _Echo(100.0), prewarm=False)
    try:
        entry = reg._entry("tz-noroll")
        entry.set_degraded("breach")
        d = entry.describe()
        assert d["current_version"] == 2 and d["degraded"] == "breach"
        assert d["rolled_back"] is None
    finally:
        reg.close()


# ------------------------------------------------- HTTP outage contract
def test_http_503_no_replicas_has_no_retry_after():
    reg = ModelRegistry()
    reg.load("tz-dead", _AlwaysDie(), max_batch_size=1,
             batch_timeout_ms=1.0, queue_size=4, replicas=1, prewarm=False)
    try:
        with ServingServer(reg, port=0) as srv:
            b = reg._entry("tz-dead").batcher
            st, _h, _b = _http_post(srv.host, srv.port,
                                    "/v1/models/tz-dead:predict",
                                    {"inputs": [[1.0]]})
            assert st == 503
            assert _wait(lambda: not b.alive, 10.0)
            st, hdrs, body = _http_post(srv.host, srv.port,
                                        "/v1/models/tz-dead:predict",
                                        {"inputs": [[1.0]]})
            assert st == 503 and body["shed_reason"] == "no_replicas"
            assert "retry-after" not in hdrs, hdrs
            with pytest.raises(NoReplicasError):
                reg.submit("tz-dead", onp.float32([1.0]))
    finally:
        reg.close()


class _ExitOnce:
    def __init__(self):
        self.died = False

    def predict_batch(self, x):
        if not self.died and float(onp.asarray(x).ravel()[0]) == -1.0:
            self.died = True
            raise SystemExit("poison spelled SystemExit")
        return [onp.asarray(x)]


def test_http_systemexit_query_of_death_is_503_not_dropped_conn():
    reg = ModelRegistry()
    reg.load("tz-exit", _ExitOnce(), max_batch_size=1,
             batch_timeout_ms=0.5, queue_size=8, replicas=2, prewarm=False)
    try:
        with ServingServer(reg, port=0) as srv:
            st, _h, body = _http_post(srv.host, srv.port,
                                      "/v1/models/tz-exit:predict",
                                      {"inputs": [[-1.0]]})
            assert st == 503 and "SystemExit" in body["error"]
            st, _h, body = _http_post(srv.host, srv.port,
                                      "/v1/models/tz-exit:predict",
                                      {"inputs": [[4.0]]})
            assert st == 200 and body["outputs"][0][0] == 4.0
    finally:
        reg.close()


def test_dead_genloop_delisted_until_resurrected():
    reg = ModelRegistry()
    e = reg.load_generator("tz-genb", seed=0, ctx=mxt.cpu(), **GEO)
    srv = ServingServer(reg, port=0).start()
    try:
        faultlab.arm("generate.step:replica_kill:stride=1:budget=1")
        stream = e.submit([1, 2, 3], max_new_tokens=6, seed=1)
        toks, reason = stream.tokens(timeout=60.0)
        assert reason == "error"
        assert _wait(lambda: not e.alive, 10.0)
        assert all(d["name"] != "tz-genb" for d in reg.generators())
        with pytest.raises(ServingClosedError):
            reg.generator("tz-genb")
        st, body = _gen_http(srv.host, srv.port,
                             {"model": "tz-genb", "prompt": [1],
                              "max_new_tokens": 2})
        assert st == 503 and "error" in body[0]
        st, models = _http_get(srv.host, srv.port, "/v1/models")
        assert st == 200
        assert all(g["name"] != "tz-genb" for g in models["generators"])
        assert reg.health()["status"] == "unhealthy"
        assert e.resurrect() is True
        assert _wait(lambda: e.alive, 5.0)
        assert any(g["name"] == "tz-genb" for g in reg.generators())
        st, lines = _gen_http(srv.host, srv.port,
                              {"model": "tz-genb", "prompt": [1],
                               "max_new_tokens": 2})
        assert st == 200 and lines[-1].get("done")
    finally:
        srv.stop()
        reg.close()


def test_supervisor_resurrects_a_supervised_decode_loop():
    reg = ModelRegistry()
    e = reg.load_generator("tz-gensup", seed=0, ctx=mxt.cpu(), **GEO)
    sup = Supervisor(reg, poll_s=0.01, backoff_base_s=0.01,
                     backoff_cap_s=0.05, crash_n=5, crash_window_s=30.0)
    try:
        sup.poll_once()                      # adopts: marks supervised
        assert e._supervised
        ref = e.generate_sequential([4, 2], max_new_tokens=8, seed=5,
                                    temperature=0.8, top_k=20)
        faultlab.arm("generate.step:replica_kill:stride=3:budget=1")
        stream = e.submit([4, 2], max_new_tokens=8, seed=5,
                          temperature=0.8, top_k=20)
        assert _wait(lambda: not e.alive, 30.0)
        sup.start()
        assert _wait(lambda: e.alive, 10.0), sup.describe()
        assert stream.tokens(timeout=60.0) == ref
        assert _rows("genloop_resurrected", "tz-gensup")
    finally:
        sup.stop()
        reg.close()
    assert not e._supervised
