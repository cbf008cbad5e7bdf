"""The port's HTTP front end (incubator_mxnet_tpu_torch/serving/server.py
with accesslog.py, the registry and the batcher) over a real socket on
the CPU, against the JAX package's server.

- BERT at test width, the same weights carried across
  (``from_jax_params``), served by both packages' servers: every reply
  agrees within 1e-5 in fp32.
- The error contract, the same requests through both servers: 404 for
  an unknown model or route, 400 for a malformed body, 429 with
  Retry-After when every queue is full, 504 past a deadline, 500 for a
  raising servable; ``X-Request-Id`` echoed (the client's or a fresh
  one), ``X-MXTPU-Tenant`` accounted on ``mxtpu_requests_total``.
- The surfaces: /healthz, /metrics (parsed), /metrics.json, /v1/models,
  /debug/ (every listed route answers 200, /debug/profile with a short
  torch.profiler capture), /debug/requests (the access log's
  legs), /debug/spans, /debug/flightrec, /debug/stacks, /debug/faults.

Servers bind ephemeral ports; every request has a timeout and every
server and registry is closed in a ``finally``.
"""
import http.client
import json
import re
import threading

import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import models as jmodels
from incubator_mxnet_tpu import serving as jserving

import incubator_mxnet_tpu_torch as mxt
from incubator_mxnet_tpu_torch import models as tmodels
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.serving import accesslog
from incubator_mxnet_tpu_torch.serving import server as tserver

V, S = 97, 16
KW = dict(vocab_size=V, units=64, hidden_size=64, num_layers=1,
          num_heads=2, max_length=S, dropout=0.0, attention="flash")
PACKAGES = ("jax", "port")


def _pkg(which):
    return jserving if which == "jax" else serving


def _request(srv, method, path, payload=None, headers=None, timeout=60.0):
    """-> (status, lower-cased headers, body text)."""
    c = http.client.HTTPConnection(srv.host, srv.port, timeout=timeout)
    try:
        body = None if payload is None else (
            payload if isinstance(payload, bytes)
            else json.dumps(payload).encode("utf-8"))
        c.request(method, path, body, {"Content-Type": "application/json",
                                       **(headers or {})})
        r = c.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read().decode("utf-8"))
    finally:
        c.close()


def _json(srv, method, path, payload=None, headers=None):
    st, hdrs, text = _request(srv, method, path, payload, headers)
    return st, hdrs, json.loads(text)


@pytest.fixture(scope="module")
def berts():
    jnet = jmodels.BERTModel(**KW)
    jnet.initialize(mx.init.Xavier())
    tnet = tmodels.BERTModel(**KW)
    tnet.initialize(ctx=mxt.cpu())
    mxt.from_jax_params(tnet, {k: p.data().asnumpy() for k, p in
                               jnet._collect_params_with_prefix().items()})
    return jnet, tnet


def test_bert_over_http_equals_the_jax_server(berts):
    jnet, tnet = berts
    rows = onp.random.RandomState(0).randint(0, V, (4, S)).astype("int32")
    replies = {}
    for which, net in zip(PACKAGES, berts):
        srv = _pkg(which).serve({"bert": net}, port=0, max_batch_size=2,
                                batch_timeout_ms=20)
        try:
            got = [None] * len(rows)

            def client(i):
                got[i] = _json(srv, "POST", "/v1/models/bert:predict",
                               {"inputs": [rows[i].tolist()],
                                "dtype": "int32"},
                               {"X-Request-Id": "%s-%d" % (which, i)})
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(rows))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            for i, (st, hdrs, body) in enumerate(got):
                assert st == 200, body
                assert hdrs["x-request-id"] == "%s-%d" % (which, i)
            replies[which] = [onp.asarray(b["outputs"][0], "float32")
                              for _, _, b in got]
        finally:
            srv.stop()
    for j, t in zip(replies["jax"], replies["port"]):
        assert t.shape == (S, V)
        onp.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    recs = [json.loads(ln) for ln in accesslog.export_jsonl(50).splitlines()]
    mine = [r for r in recs if str(r["request_id"]).startswith("port-")]
    assert len(mine) == len(rows)
    for r in mine:
        assert r["code"] == 200 and r["model"] == "bert"
        assert r["bucket"] in (1, 2) and r["replica"] == 0
        assert all(r[k] is not None and r[k] >= 0 for k in
                   ("queue_ms", "batch_ms", "device_ms", "latency_ms"))


class _Echo:
    def predict_batch(self, x):
        return (x * 2.0,)


class _Blocking:
    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def predict_batch(self, x):
        self.entered.set()
        self.release.wait(30)
        return (x,)


class _Raising:
    def predict_batch(self, x):
        raise ValueError("servable exploded")


@pytest.mark.parametrize("which", PACKAGES)
def test_error_contract_is_the_references(which):
    pkg = _pkg(which)
    reg = pkg.ModelRegistry()
    blocking = _Blocking()
    reg.load("echo", _Echo(), max_batch_size=2, batch_timeout_ms=1.0,
             prewarm=False)
    reg.load("slow", blocking, max_batch_size=1, batch_timeout_ms=0.0,
             queue_size=1, prewarm=False)
    reg.load("boom", _Raising(), max_batch_size=1, batch_timeout_ms=0.0,
             prewarm=False)
    srv = pkg.ServingServer(reg, port=0).start()
    try:
        st, hdrs, body = _json(srv, "POST", "/v1/models/echo:predict",
                               {"inputs": [[1.0, 2.0]]})
        assert st == 200 and body["outputs"] == [[2.0, 4.0]]
        assert len(hdrs["x-request-id"]) == 16
        assert _json(srv, "POST", "/v1/models/nope:predict",
                     {"inputs": [[1.0]]})[0] == 404
        assert _json(srv, "GET", "/v1/models/nope")[0] == 404
        assert _json(srv, "POST", "/v1/elsewhere", {})[0] == 404
        assert _json(srv, "GET", "/no/route")[0] == 404
        for bad in (b"{not json", {"inputs": []}, {"nothing": 1},
                    {"inputs": [[1.0]], "dtype": ["float32", "int32"]},
                    {"inputs": [[1.0]], "deadline_ms": "soon"}):
            assert _json(srv, "POST", "/v1/models/echo:predict",
                         bad)[0] == 400, bad
        st, _h, body = _json(srv, "POST", "/v1/models/boom:predict",
                             {"inputs": [[1.0]]})
        assert st == 500 and "servable exploded" in body["error"]
        # hold the slow model's worker, fill its one-deep queue, then 429
        held = []
        t = threading.Thread(target=lambda: held.append(_json(
            srv, "POST", "/v1/models/slow:predict", {"inputs": [[1.0]]})))
        t.start()
        assert blocking.entered.wait(30)
        queued = reg.submit("slow", onp.float32([2.0]))
        st, hdrs, body = _json(srv, "POST", "/v1/models/slow:predict",
                               {"inputs": [[3.0]]})
        assert st == 429 and body["shed_reason"] == "queue_full"
        assert int(hdrs["retry-after"]) >= 1
        blocking.release.set()
        t.join(30)
        assert not t.is_alive() and held[0][0] == 200
        assert queued.result(30)[0][0] == 2.0
        # a deadline that passes while queued: 504
        blocking.release.clear()
        blocking.entered.clear()
        t = threading.Thread(target=lambda: held.append(_json(
            srv, "POST", "/v1/models/slow:predict", {"inputs": [[1.0]]})))
        t.start()
        assert blocking.entered.wait(30)
        late = threading.Thread(target=lambda: held.append(_json(
            srv, "POST", "/v1/models/slow:predict",
            {"inputs": [[1.0]], "deadline_ms": 1})))
        late.start()
        late.join(30)
        blocking.release.set()
        t.join(30)
        assert held[-1][0] == 504 or held[-2][0] == 504
        assert any(r[2].get("shed_reason") == "deadline" for r in held)
        # tenants are accounted per terminal outcome
        _json(srv, "POST", "/v1/models/echo:predict", {"inputs": [[1.0]]},
              {"X-MXTPU-Tenant": "acme"})
        st, _h, text = _request(srv, "GET", "/metrics")
        assert st == 200
        assert re.search(r'mxtpu_requests_total\{model="echo",'
                         r'tenant="acme",code="200"\} 1', text), text[:500]
    finally:
        blocking.release.set()
        srv.stop()


def _parse_prometheus(text):
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        samples[name] = float(value)
    return samples


def test_surfaces_and_debug_routes():
    reg = serving.ModelRegistry()
    reg.load("echo", _Echo(), max_batch_size=2, batch_timeout_ms=1.0,
             prewarm=False)
    srv = serving.ServingServer(reg, port=0).start()
    try:
        for i in range(3):
            st, hdrs, _b = _json(srv, "POST", "/v1/models/echo:predict",
                                 {"inputs": [[float(i)]]},
                                 {"X-Request-Id": "surf-%d" % i})
            assert st == 200 and hdrs["x-request-id"] == "surf-%d" % i
        assert _json(srv, "GET", "/healthz")[2]["status"] == "healthy"
        st, _h, text = _request(srv, "GET", "/metrics")
        samples = _parse_prometheus(text)
        assert samples['mxtpu_serving_requests_total{model="echo"}'] >= 3
        assert any(k.startswith("mxtpu_requests_total{") for k in samples)
        assert "mxtpu_http_inflight_requests" in samples
        snap = _json(srv, "GET", "/metrics.json")[2]["echo"]
        assert snap["ok_count"] >= 3 and "replica_dispatch" in snap
        models = _json(srv, "GET", "/v1/models")[2]
        assert models["models"][0]["name"] == "echo"
        assert models["generators"] == []
        one = _json(srv, "GET", "/v1/models/echo")[2]
        assert one["metrics"]["ok_count"] >= 3
        st, _h, index = _json(srv, "GET", "/debug/")
        listed = [r["path"] for r in index["routes"]]
        assert listed == [p for p, _d in tserver.DEBUG_ROUTES]
        from incubator_mxnet_tpu.serving import server as jserver
        assert listed == [p for p, _d in jserver.DEBUG_ROUTES]
        for path in listed:
            query = "?seconds=0.1" if path == "/debug/profile" else ""
            st, _h, text = _request(srv, "GET", path + query)
            assert st == 200, (path, text[:200])
        reqs = _request(srv, "GET", "/debug/requests?n=3")[2].splitlines()
        recs = [json.loads(ln) for ln in reqs]
        assert [r["request_id"] for r in recs] == \
            ["surf-0", "surf-1", "surf-2"]
        assert all(r["device_ms"] is not None for r in recs)
        assert _request(srv, "GET", "/debug/requests?n=x")[0] == 400
        assert "--- heartbeats ---" in _request(srv, "GET",
                                                "/debug/stacks")[2]
        assert '"serve:batch"' in _request(srv, "GET", "/debug/spans")[2]
        assert "batch_dispatch" in _request(srv, "GET",
                                            "/debug/flightrec")[2]
        st, _h, body = _json(srv, "POST", "/debug/faults",
                             {"spec": "batcher.dispatch:slow_ms:ms=1:"
                                      "stride=1000000"})
        assert st == 200 and body["armed"] is True
        assert _json(srv, "POST", "/debug/faults", {"spec": "bad"})[0] == 400
        assert _json(srv, "POST", "/debug/faults", {"spec": 5})[0] == 400
        assert _json(srv, "GET", "/debug/faults")[2]["armed"] is True
        assert _json(srv, "POST", "/debug/faults",
                     {"spec": ""})[2]["armed"] is False
    finally:
        srv.stop()
    assert reg.health()["status"] == "unhealthy"       # shut down


def test_serve_refuses_an_artifact_path_naming_the_next_slice(tmp_path):
    """``serve`` of a path loads it as a ``.mxtpu`` artifact (served in
    tests/test_torch_export.py): a missing file or one without the magic
    is refused, as the JAX package's ``load`` refuses it. The mesh
    servables (tests/test_torch_serving_sharded.py) take the visible CUDA
    devices unless given ``devices=``: with none they refuse, never falling
    back to the CPU; a shadow needs a loaded model."""
    with pytest.raises(FileNotFoundError):
        serving.serve({"m": str(tmp_path / "model.mxtpu")}, port=0)
    garbage = tmp_path / "garbage.mxtpu"
    garbage.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an mxtpu serving artifact"):
        serving.serve({"m": str(garbage)}, port=0)
    if not torch.cuda.is_available():
        for fn in (lambda: serving.MeshServable(None), serving.serving_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
    reg = serving.ModelRegistry()
    try:
        with pytest.raises(serving.ModelNotFoundError):
            reg.register_shadow("m", _Echo())
        assert reg.unregister_shadow("m") is False
    finally:
        reg.close()
