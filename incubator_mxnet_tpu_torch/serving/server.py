"""HTTP serving front-end on the stdlib ThreadingHTTPServer (counterpart
of ``incubator_mxnet_tpu/serving/server.py``; no new dependencies).

One thread per connection; each request thread blocks on its batcher
future while the worker threads do the dispatch on the card — so the
server scales to many concurrent clients and only workers launch. JSON
tensor encoding keeps the whole stack exercisable end to end in the CPU
tests (tests/test_torch_serving_http.py drives it through a real socket).

The routes and the error contract are the JAX package's. ``/debug/aot``
lists the port's cache of captured graphs; ``/debug/profile`` captures
``torch.profiler`` (CPU and CUDA activity) and ``/debug/hotspots`` ranks
its CUDA kernels (``telemetry.devstats``, ``telemetry.profstats``).

Routes (TF-Serving REST-shaped):

- ``POST /v1/models/<name>:predict`` — body ``{"inputs": [<nested list>,
  ...], "deadline_ms": <optional>, "dtype": <optional, default float32>}``;
  response ``{"outputs": [<nested list>, ...]}``. Each input is ONE item,
  WITHOUT the batch dim — cross-request batching is the server's job.
- ``POST /generate`` — generative inference against a registered
  ``GenerativeEngine`` (registry.load_generator; docs/GENERATE.md). Body
  ``{"model": <name — optional when exactly one generator is loaded>,
  "prompt": [<token ids>], "max_new_tokens", "temperature", "top_k",
  "seed", "deadline_ms"}``. The response streams as
  ``Transfer-Encoding: chunked`` JSONL — one ``{"token": id, "index":
  n}`` line per generated token the moment the decode loop emits it
  (the first line is the prefill's token, so TTFT is measurable at the
  client), terminated by one ``{"done": true, "reason": "eos" |
  "max_tokens" | ..., "tokens": n}`` line. A client that hangs up
  mid-stream cancels the sequence: the decode loop retires the row and
  frees its KV blocks at the next step. Pre-stream failures use the
  predict error contract (400 bad request / invalid prompt, 429 prefill
  queue full + ``Retry-After``, 404 unknown generator, 503 shutting
  down, 504 prefill deadline).
- ``GET /v1/models``            — registered models + queue/batch config
  (incl. per-model ``replicas`` / ``replica_depths`` / ``dead_replicas``
  — the data-parallel serving topology, docs/SERVING.md) and loaded
  generators (KV-pool occupancy, bucket ladder, in-flight sequences).
- ``GET /v1/models/<name>``     — one model + its metrics snapshot
  (``replica_dispatch`` shows the router's per-replica balance).
- ``GET /metrics``              — Prometheus text exposition of the
  process-wide telemetry registry (serving counters, batch-size
  histogram, latency histogram, plus training/compile/kvstore/io
  metrics recorded in this process — docs/OBSERVABILITY.md).
- ``GET /metrics.json``         — the legacy per-model JSON snapshot
  (counters, batch-size histogram, p50/p95/p99 latency), byte-compatible
  with what ``GET /metrics`` returned before the Prometheus move.
- ``GET /healthz``              — healthy | degraded | unhealthy (503).
- ``GET /debug/stacks``         — all-thread stacks + heartbeat ages +
  the newest watchdog stall report (text/plain; the live "why is it
  stuck" view).
- ``GET /debug/flightrec``      — the flight-recorder ring as JSONL
  (newest last).
- ``GET /debug/spans``          — the finished-span ring as JSONL.
- ``GET /debug/aot``            — the process-wide AOT cache: one JSON
  record per captured graph (model id, kind, input signature, the count
  of tensors it is bound to, idle time) — the live "what is captured
  right now" view behind the no-capture-after-warm contract.
- ``GET /debug/requests?n=`` — the structured access log: the newest
  ``n`` terminal predict outcomes as JSONL ``{ts, request_id, tenant,
  model, code, shed_reason, latency_ms, queue_ms, batch_ms, device_ms,
  replica, bucket}`` (serving/accesslog.py).
- ``GET /debug/faults``     — the fault-injection registry's arming
  state (telemetry/faultlab.py; docs/RESILIENCE.md). ``POST
  /debug/faults`` with ``{"spec": "<site:kind:key=val;...>"}`` arms it
  at runtime (chaos drills mid-soak, no restart); an empty/absent spec
  disarms. Malformed specs are 400 and leave the prior arming intact.
- ``GET /debug/``           — machine-readable index of every debug
  route (path + one-line description, the DEBUG_ROUTES table) — the
  first page a runbook loads mid-incident.
- ``GET /debug/slo`` — per-SLO error-budget remaining, window burn
  rates and alert states (telemetry/slo.py).
- ``GET /debug/numerics`` — the numerics sentinel: per-site tap stats,
  storm episodes, per-model shadow divergence (telemetry/numwatch.py).
- ``GET /debug/history?series=&since=&step=`` and ``GET /debug/incident
  ?around=&before_s=&after_s=`` — the metric-history store and the
  incident timeline (telemetry/history.py).
- ``GET /debug/profile?seconds=N`` — an on-demand ``torch.profiler``
  capture with its summary (device busy/idle share, top kernels);
  single-flight, 409 while one is in flight.
- ``GET /debug/hotspots?n=&capture=`` — the rolling ranked kernel table,
  or one remembered capture's summary.

Tracing: every predict request gets a request ID (client-supplied
``X-Request-Id`` wins, else one is generated), echoed on the response
header and propagated through the batcher queue onto the profiler's
``record_batch`` chrome-trace events.

Tenancy: an ``X-MXTPU-Tenant`` header (clamped; ``default`` when
absent) labels every terminal outcome — per-tenant
``mxtpu_requests_total{model,tenant,code}`` counters and latency
histograms, the per-model SLO ledger (telemetry/slo.py) and the
access-log record.

Error contract (the robustness story made visible):

- queue full        -> 429 + ``Retry-After`` + ``shed_reason:
  "queue_full"`` (explicit backpressure; shed load upstream)
- deadline exceeded -> 504 + ``shed_reason: "deadline"``
- unknown model     -> 404
- all replicas dead -> 503 + ``shed_reason: "no_replicas"`` and NO
  ``Retry-After`` — an outage is not backpressure; no pacing hint is
  honest until the supervisor restores a worker (docs/RESILIENCE.md)
- decode loop dead  -> 503 on ``POST /generate`` (and the generator is
  delisted from ``GET /v1/models`` until resurrected)
- shutting down     -> 503
- malformed body    -> 400
- servable raised   -> 500
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import config
from .. import telemetry
from . import accesslog
from .batcher import (DeadlineExceededError, NoReplicasError,
                      QueueFullError, ServingClosedError)
from .metrics import (http_request_finished, http_request_started,
                      request_accounted)
from .registry import ModelNotFoundError, ModelRegistry

_LOG = logging.getLogger(__name__)

__all__ = ["ServingServer", "serve", "DEBUG_ROUTES"]

_PREDICT_SUFFIX = ":predict"
_MODELS_PREFIX = "/v1/models"

#: Every debug endpoint this server exposes, served machine-readably at
#: ``GET /debug/``: an undiscoverable diagnostic endpoint is one nobody
#: reaches during the incident it was built for.
DEBUG_ROUTES = (
    ("/debug/", "index of every debug route (this listing)"),
    ("/debug/stacks", "all-thread stacks + heartbeat ages + newest "
     "watchdog stall report (text)"),
    ("/debug/flightrec", "flight-recorder event ring as JSONL"),
    ("/debug/spans", "finished-span ring as JSONL"),
    ("/debug/aot", "process-wide AOT executable cache entries"),
    ("/debug/requests", "structured access log, newest n terminal "
     "outcomes as JSONL (?n=)"),
    ("/debug/slo", "per-SLO budgets, burn rates, and alert states"),
    ("/debug/numerics", "numerics sentinel: tap stats, storm episodes, "
     "shadow divergence"),
    ("/debug/faults", "faultlab arming state (GET) / arm-disarm (POST)"),
    ("/debug/profile", "on-demand device-profiler capture (?seconds=)"),
    ("/debug/hotspots", "ranked per-op hotspot table (?n=, ?capture=)"),
    ("/debug/history", "metric-history rings: raw + coarse time series "
     "and recording rules (?series=&since=&step=)"),
    ("/debug/incident", "incident timeline: flightrec events, SLO alert "
     "transitions, and metric excursions around a timestamp "
     "(?around=&before_s=&after_s=)"),
)


class _Handler(BaseHTTPRequestHandler):
    """Bound to a registry via the per-server subclass ServingServer makes."""

    registry = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass  # serving metrics replace per-request stderr lines

    # ------------------------------------------------------------------
    def _send(self, code, payload, request_id=None, headers=None):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if request_id is not None:
            self.send_header(telemetry.REQUEST_ID_HEADER, request_id)
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code, text, content_type):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _model_name(self):
        rest = self.path[len(_MODELS_PREFIX):].lstrip("/")
        if rest.endswith(_PREDICT_SUFFIX):
            rest = rest[:-len(_PREDICT_SUFFIX)]
        return rest

    # ------------------------------------------------------------------
    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            h = self.registry.health()
            self._send(503 if h["status"] == "unhealthy" else 200, h)
        elif self.path == "/metrics":
            # Prometheus text exposition of the process-wide registry
            self._send_text(200, telemetry.export_text(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/metrics.json":
            # legacy JSON snapshot (byte-compatible with the pre-Prometheus
            # GET /metrics payload)
            self._send(200, self.registry.metrics_snapshot())
        elif self.path == "/debug/stacks":
            # the on-demand "why is it stuck": all-thread stacks now, the
            # heartbeat ages, and the watchdog's newest stall report
            from ..telemetry import watchdog
            beats = "".join("%-32s %.3fs ago\n" % (n, s) for n, s in
                            sorted(watchdog.channels().items()))
            text = ("--- heartbeats ---\n" + (beats or "(none)\n")
                    + "\n" + watchdog.format_stacks())
            last = watchdog.last_report()
            if last:
                text += "\n--- last stall report ---\n" + last
            self._send_text(200, text, "text/plain; charset=utf-8")
        elif self.path == "/debug/flightrec":
            from ..telemetry import flightrec
            self._send_text(200, flightrec.format_tail(10_000),
                            "application/jsonl; charset=utf-8")
        elif self.path == "/debug/spans":
            from ..telemetry import spans
            self._send_text(200, spans.export_jsonl(),
                            "application/jsonl; charset=utf-8")
        elif self.path == "/debug/aot":
            from .. import aot
            self._send(200, {"entries": aot.CACHE.snapshot()})
        elif self.path.split("?", 1)[0] == "/debug/requests":
            # the structured access log: newest n terminal outcomes as
            # JSONL (tenant, code, shed_reason, queue/batch/device legs)
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)
            try:
                n = int(q.get("n", ["200"])[0])
            except ValueError:
                self._send(400, {"error": "n must be an integer"})
                return
            self._send_text(200, accesslog.export_jsonl(n),
                            "application/jsonl; charset=utf-8")
        elif self.path == "/debug/slo":
            # budgets, burn rates, and alert states per SLO (evaluating
            # the alert state machines now)
            from ..telemetry import slo
            self._send(200, slo.REGISTRY.describe())
        elif self.path == "/debug/numerics":
            # the numerics sentinel: per-site tap stats / storm episodes
            # and per-model shadow divergence (telemetry/numwatch.py)
            from ..telemetry import numwatch
            self._send(200, numwatch.describe())
        elif self.path.split("?", 1)[0] == "/debug/history":
            self._do_history()
        elif self.path.split("?", 1)[0] == "/debug/incident":
            self._do_incident()
        elif self.path.split("?", 1)[0] == "/debug/profile":
            self._do_profile()
        elif self.path.split("?", 1)[0] == "/debug/hotspots":
            self._do_hotspots()
        elif self.path == "/debug/faults":
            # the faultlab arming state: armed flag + per-fault
            # stride/p/budget/fired counters (telemetry/faultlab.py)
            from ..telemetry import faultlab
            self._send(200, faultlab.describe())
        elif self.path.rstrip("/") == "/debug":
            # machine-readable index of every debug route — the first
            # page an operator (or a runbook script) loads mid-incident
            self._send(200, {"routes": [{"path": p, "description": d}
                                        for p, d in DEBUG_ROUTES]})
        elif self.path.rstrip("/") == _MODELS_PREFIX:
            self._send(200, {"models": self.registry.models(),
                             "generators": self.registry.generators()})
        elif self.path.startswith(_MODELS_PREFIX + "/"):
            name = self._model_name()
            try:
                entry = self.registry._entry(name)
            except ModelNotFoundError as e:
                self._send(404, {"error": str(e)})
                return
            desc = entry.describe()
            desc["metrics"] = entry.metrics.snapshot()
            self._send(200, desc)
        else:
            self._send(404, {"error": "no route %r" % self.path})

    def _do_history(self):
        """GET /debug/history?series=&since=&step= — the metric-history
        store (telemetry/history.py): raw + coarse rings per series,
        optionally filtered (series substring / bare metric name),
        truncated (since=epoch seconds) and re-bucketed (step=seconds
        of min/max/mean folding)."""
        from urllib.parse import parse_qs, urlparse
        from ..telemetry import history
        q = parse_qs(urlparse(self.path).query)
        series = q.get("series", [None])[0]
        try:
            since = float(q["since"][0]) if "since" in q else None
            step = float(q["step"][0]) if "step" in q else None
        except ValueError:
            self._send(400, {"error": "since/step must be numbers"})
            return
        if step is not None and step <= 0:
            self._send(400, {"error": "step must be > 0"})
            return
        self._send(200, history.query(series=series, since=since,
                                      step=step))

    def _do_incident(self):
        """GET /debug/incident?around=&before_s=&after_s= — the incident
        timeline builder: flightrec events, SLO alert transitions, and
        metric excursions in the window, merged and causally ordered on
        the shared perf_counter anchor (telemetry/history.py)."""
        from urllib.parse import parse_qs, urlparse
        from ..telemetry import history
        q = parse_qs(urlparse(self.path).query)
        try:
            around = float(q["around"][0]) if "around" in q else None
            before_s = float(q.get("before_s", ["90"])[0])
            after_s = float(q.get("after_s", ["30"])[0])
        except ValueError:
            self._send(400, {"error": "around/before_s/after_s must be "
                                      "numbers"})
            return
        self._send(200, history.incident(around=around, before_s=before_s,
                                         after_s=after_s))

    def _do_profile(self):
        """GET /debug/profile?seconds=N — the on-demand ``torch.profiler``
        capture (single-flight; 409 while one is in flight). The handler
        thread blocks for the capture window; the ThreadingHTTPServer
        keeps answering /metrics and predicts meanwhile. The response
        carries the parsed ``summary`` (top-K ops + idle ratio) and a
        ``capture_id`` that stays fetchable via GET /debug/hotspots
        ?capture=<id> after the dir itself is pruned."""
        from urllib.parse import parse_qs, urlparse
        from ..telemetry import devstats
        from ..telemetry.profstats import brief, capture_and_summarize
        q = parse_qs(urlparse(self.path).query)
        try:
            seconds = float(q.get("seconds", ["2"])[0])
        except ValueError:
            self._send(400, {"error": "seconds must be a number"})
            return
        try:
            out, summary = capture_and_summarize(seconds)
        except devstats.ProfileCaptureBusy as e:
            self._send(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — capture failure, not crash
            self._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
        else:
            out["summary"] = brief(summary)
            self._send(200, out)

    def _do_hotspots(self):
        """GET /debug/hotspots?n=K — the rolling ranked hotspot table;
        ``?capture=<id>`` returns one remembered capture summary."""
        from urllib.parse import parse_qs, urlparse
        from ..telemetry import profstats
        q = parse_qs(urlparse(self.path).query)
        try:
            n = int(q.get("n", ["20"])[0])
        except ValueError:
            self._send(400, {"error": "n must be an integer"})
            return
        cid = q.get("capture", [None])[0]
        if cid:
            summary = profstats.get_summary(cid)
            if summary is None:
                self._send(404, {"error": "no remembered capture %r" % cid,
                                 "known": profstats.summaries()})
            else:
                self._send(200, summary)
            return
        self._send(200, profstats.hotspots(n))

    def do_POST(self):
        if self.path == "/debug/faults":
            self._do_faults()
            return
        if self.path == "/generate":
            req_id = self.headers.get(telemetry.REQUEST_ID_HEADER) \
                or telemetry.new_request_id()
            tenant = accesslog.clamp_tenant(
                self.headers.get(accesslog.TENANT_HEADER))
            http_request_started()
            try:
                self._do_generate(req_id, tenant)
            finally:
                http_request_finished()
            return
        if not (self.path.startswith(_MODELS_PREFIX + "/")
                and self.path.endswith(_PREDICT_SUFFIX)):
            self._send(404, {"error": "no route %r (POST "
                             "/v1/models/<name>:predict or "
                             "POST /generate)" % self.path})
            return
        name = self._model_name()
        # request-scoped trace id: a client-supplied X-Request-Id wins (the
        # caller's trace context survives), else assign one here — this is
        # the id the batcher carries queue -> dispatch -> profiler event
        req_id = self.headers.get(telemetry.REQUEST_ID_HEADER) \
            or telemetry.new_request_id()
        # tenant accounting label (X-MXTPU-Tenant, clamped; "default"
        # when absent) — rides the batcher alongside the request id and
        # keys the per-tenant counters, the SLO ledger feed, and the
        # access-log record
        tenant = accesslog.clamp_tenant(
            self.headers.get(accesslog.TENANT_HEADER))
        # inflight gauge covers body read through response written — the
        # front-end concurrency signal the load harness reads per stage
        http_request_started()
        try:
            self._do_predict(name, req_id, tenant)
        finally:
            http_request_finished()

    def _do_predict(self, name, req_id, tenant):
        import numpy as onp
        t_start = time.perf_counter()
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            raw = req["inputs"]
            if not isinstance(raw, list) or not raw:
                raise ValueError("'inputs' must be a non-empty list (one "
                                 "entry per model input, no batch dim)")
            dtypes = req.get("dtype", "float32")
            if isinstance(dtypes, str):
                dtypes = [dtypes] * len(raw)
            elif len(dtypes) != len(raw):
                raise ValueError("'dtype' list length %d != %d inputs"
                                 % (len(dtypes), len(raw)))
            inputs = [onp.asarray(x, dtype=onp.dtype(d))
                      for x, d in zip(raw, dtypes)]
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)  # non-numeric -> 400
        except Exception as e:  # noqa: BLE001 — anything malformed is a 400
            self._finish(name, tenant, req_id, 400, t_start,
                         {"error": "bad request: %s" % e})
            return
        breq = None
        try:
            # root span of the request's trace chain: submit() captures
            # this span's context into the queued request, so the worker's
            # serve:queue / serve:batch spans parent onto it across the
            # queue boundary (HTTP -> queue -> bucket -> device in one
            # dump). submit + result (rather than predict) keeps the
            # request object, whose worker-attached dispatch facts feed
            # the access-log record.
            with telemetry.request_scope(req_id), \
                    telemetry.span("http:predict", model=name,
                                   tenant=tenant):
                batcher = self.registry._entry(name).batcher
                breq = batcher.submit(*inputs, deadline_ms=deadline_ms,
                                      request_id=req_id, tenant=tenant)
                outs = breq.result(batcher.result_timeout(breq))
        except QueueFullError as e:
            # explicit backpressure: a machine-readable shed_reason (no
            # more string-matching the error text) + a Retry-After hint
            # sized to the coalescing window — the queue drains at batch
            # granularity, so "one window from now" is the earliest a
            # retry can meet a freed slot
            self._finish(name, tenant, req_id, 429, t_start,
                         {"error": str(e), "shed_reason": "queue_full"},
                         shed_reason="queue_full", breq=breq,
                         headers={"Retry-After": self._retry_after(name)})
        except DeadlineExceededError as e:
            self._finish(name, tenant, req_id, 504, t_start,
                         {"error": str(e), "shed_reason": "deadline"},
                         shed_reason="deadline", breq=breq)
        except ModelNotFoundError as e:
            self._finish(name, tenant, req_id, 404, t_start,
                         {"error": str(e)}, breq=breq)
        except NoReplicasError as e:
            # every replica worker is dead: this is an OUTAGE, not
            # backpressure — 503 (not 429) and deliberately NO
            # Retry-After, because no client-side pacing hint is honest
            # until the supervisor (or an operator) restores a worker
            self._finish(name, tenant, req_id, 503, t_start,
                         {"error": str(e), "shed_reason": "no_replicas"},
                         shed_reason="no_replicas", breq=breq)
        except ServingClosedError as e:
            self._finish(name, tenant, req_id, 503, t_start,
                         {"error": str(e)}, breq=breq)
        except Exception as e:  # noqa: BLE001 — servable failure
            self._finish(name, tenant, req_id, 500, t_start,
                         {"error": "%s: %s" % (type(e).__name__, e)},
                         breq=breq)
        except BaseException as e:
            if (isinstance(e, (KeyboardInterrupt, SystemExit))
                    and not getattr(e, "_mxtpu_died_in_servable", False)):
                # a genuine interpreter-exit signal, not a delivered
                # request error — let it propagate
                raise
            # a worker-killing defect delivered raw to the poison
            # request's future (query of death — docs/RESILIENCE.md)
            # must not kill the handler thread: at the HTTP boundary it
            # is a servable outage, 503 — even when the servable's
            # chosen defect is spelled SystemExit
            self._finish(name, tenant, req_id, 503, t_start,
                         {"error": "%s: %s" % (type(e).__name__, e)},
                         breq=breq)
        else:
            self._finish(name, tenant, req_id, 200, t_start,
                         {"outputs": [onp.asarray(o).tolist()
                                      for o in outs]}, breq=breq)

    def _do_faults(self):
        """POST /debug/faults — arm (body ``{"spec": "<site:kind:...>"}``)
        or disarm (empty/absent spec) the process-wide fault-injection
        registry at runtime. Chaos drills flip faults mid-soak through
        this without a restart; a malformed spec is a 400 and leaves the
        previous arming untouched (faultlab.arm validates before it
        swaps). The response echoes ``faultlab.describe()``."""
        from ..telemetry import faultlab
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            spec = req.get("spec") or ""
            if not isinstance(spec, str):
                raise ValueError("'spec' must be a string")
        except Exception as e:  # noqa: BLE001 — anything malformed is a 400
            self._send(400, {"error": "bad request: %s" % e})
            return
        try:
            faultlab.arm(spec)
        except ValueError as e:
            self._send(400, {"error": "bad fault spec: %s" % e})
            return
        self._send(200, faultlab.describe())

    def _retry_after(self, name):
        """Whole-second Retry-After hint for a 429: at least one batch
        window from now (rounded up) — sooner retries meet the same full
        queue that shed them."""
        try:
            window_ms = self.registry._entry(name).batcher.batch_timeout_ms
        except Exception:
            window_ms = 0.0
        return str(max(1, int(-(-window_ms // 1000))))

    # ------------------------------------------------------------ generate
    def _do_generate(self, req_id, tenant):
        """POST /generate: validate + prefill synchronously (every failure
        there still has the buffered-JSON error contract), then stream
        the decode loop's tokens as chunked JSONL."""
        from .generate import BadGenRequest
        t_start = time.perf_counter()
        name = None
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            name = req.get("model")
            if name is None:
                gens = [g["name"] for g in self.registry.generators()
                        if not g["closed"]]
                if len(gens) != 1:
                    raise ValueError(
                        "'model' is required when %d generators are "
                        "loaded" % len(gens))
                name = gens[0]
            prompt = req.get("prompt")
            kw = {"max_new_tokens": req.get("max_new_tokens"),
                  "temperature": float(req.get("temperature", 0.0)),
                  "top_k": int(req.get("top_k", 0)),
                  "seed": int(req.get("seed", 0))}
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
        except Exception as e:  # noqa: BLE001 — anything malformed is a 400
            self._finish(name or "-", tenant, req_id, 400, t_start,
                         {"error": "bad request: %s" % e})
            return
        try:
            # the root span covers validate + the batched prefill (the
            # engine's gen:prefill span parents onto it); the decode
            # stream outlives it by design — decode steps are engine-
            # scoped gen:decode_step spans, not per-request children
            with telemetry.request_scope(req_id), \
                    telemetry.span("http:generate", model=name,
                                   tenant=tenant):
                engine = self.registry.generator(name)
                stream = engine.submit(prompt, tenant=tenant,
                                       request_id=req_id,
                                       deadline_ms=deadline_ms, **kw)
        except BadGenRequest as e:
            self._finish(name, tenant, req_id, 400, t_start,
                         {"error": "bad request: %s" % e})
        except QueueFullError as e:
            self._finish(name, tenant, req_id, 429, t_start,
                         {"error": str(e), "shed_reason": "queue_full"},
                         shed_reason="queue_full",
                         headers={"Retry-After": "1"})
        except DeadlineExceededError as e:
            self._finish(name, tenant, req_id, 504, t_start,
                         {"error": str(e), "shed_reason": "deadline"},
                         shed_reason="deadline")
        except ModelNotFoundError as e:
            self._finish(name, tenant, req_id, 404, t_start,
                         {"error": str(e)})
        except ServingClosedError as e:
            # covers a registry whose decode loop is DEAD (awaiting
            # supervisor revival) as well as graceful shutdown: a 503
            # outage signal, never a 429 pacing hint
            self._finish(name, tenant, req_id, 503, t_start,
                         {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — engine failure
            self._finish(name, tenant, req_id, 500, t_start,
                         {"error": "%s: %s" % (type(e).__name__, e)})
        else:
            self._stream_generate(name, stream, tenant, req_id, t_start)

    def _chunk(self, obj):
        """One HTTP/1.1 chunk holding one JSON line."""
        data = (json.dumps(obj) + "\n").encode("utf-8")
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _stream_generate(self, name, stream, tenant, req_id, t_start):
        """Drain one GenStream into a chunked response. Terminal
        accounting happens when the engine's ``("end", reason)`` event
        arrives — BEFORE the final done-chunk is written, keeping the
        instrument-before-deliver discipline for the record the access
        log and SLO ledger see (the per-token counters/histograms were
        already recorded by the engine at emit time). A write that hits
        a dead client cancels the sequence; the decode loop frees its
        KV blocks at the next step."""
        import queue as _pyqueue
        ntok, code, shed, reason = 0, 200, None, None
        try:
            self.send_response(200)
            self.send_header("Content-Type",
                             "application/jsonl; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header(telemetry.REQUEST_ID_HEADER, req_id)
            self.send_header(accesslog.TENANT_HEADER, tenant)
            self.end_headers()
            while True:
                kind, val = stream.get(timeout=600.0)
                if kind == "end":
                    reason = val
                    break
                self._chunk({"token": val, "index": ntok})
                ntok += 1
        except (BrokenPipeError, ConnectionResetError):
            stream.cancel()
            code, shed = 499, "client_disconnect"
        except _pyqueue.Empty:
            # the decode loop stopped feeding this stream (stalled or
            # died) — give up the connection; the watchdog's stall report
            # is the diagnosis surface
            stream.cancel()
            code, shed = 504, "stream_stalled"
        except Exception:  # noqa: BLE001 — never kill the handler thread
            stream.cancel()
            code = 500
        if reason in ("kv_oom", "error"):
            # headers already said 200; the access log still records the
            # degraded finish so capacity trouble is attributable
            shed = reason
        self._account(name, tenant, req_id, code, t_start, shed_reason=shed)
        if code == 200:
            try:
                self._chunk({"done": True, "reason": reason,
                             "tokens": ntok})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                stream.cancel()

    def _account(self, name, tenant, req_id, code, t_start,
                 shed_reason=None, dispatch=None):
        """The shared terminal-outcome accounting (per-tenant counters,
        SLO ledger, access log) — guarded: telemetry failure never turns
        a served response into a 500."""
        latency_ms = (time.perf_counter() - t_start) * 1e3
        d = dispatch or {}
        try:
            request_accounted(name, tenant, code, latency_ms)
            from ..telemetry import slo
            if code != 404:
                # a 404 names no model: hostile name probes must not seed
                # unbounded SLO objects
                slo.REGISTRY.observe(name, code, latency_ms=latency_ms)
            accesslog.record(
                request_id=req_id, tenant=tenant, model=name, code=code,
                latency_ms=latency_ms, shed_reason=shed_reason,
                queue_ms=d.get("queue_ms"), batch_ms=d.get("batch_ms"),
                device_ms=d.get("device_ms"), replica=d.get("replica"),
                bucket=d.get("bucket"))
        except Exception:
            _LOG.debug("request accounting failed", exc_info=True)

    def _finish(self, name, tenant, req_id, code, t_start, payload,
                shed_reason=None, breq=None, headers=None):
        """Account one terminal outcome, then send the response.
        Accounting (per-tenant counters + latency histogram, the
        access-log record) happens BEFORE the send, mirroring
        the batcher's instrument-before-deliver discipline: a scrape
        fired the moment the client unblocks must already see this
        request."""
        self._account(name, tenant, req_id, code, t_start,
                      shed_reason=shed_reason,
                      dispatch=breq.dispatch if breq is not None else None)
        self._send(code, payload, request_id=req_id, headers=headers)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the socketserver default backlog of 5 refuses connections under a
    # concurrent burst — size it to a queue's worth of clients instead
    request_queue_size = 128


class ServingServer:
    """The single-host serving endpoint: a ModelRegistry behind HTTP.

    ``port=0`` binds an ephemeral port (read it back from ``.port``) —
    what the tier-1 tests use. ``start()`` returns immediately (the accept
    loop runs in a daemon thread); ``stop(drain=True)`` stops accepting,
    drains every model's queue, and joins — the graceful-shutdown path.
    Usable as a context manager.
    """

    def __init__(self, registry=None, host="127.0.0.1", port=None):
        self.registry = registry if registry is not None else ModelRegistry()
        if port is None:
            port = config.get_env("MXTPU_SERVE_PORT")
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._httpd = _Server((host, int(port)), handler)
        self._thread = None

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="mxtpu-serve-http")
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Graceful shutdown: close the listener, then drain (or fail)
        queued requests via the registry, then join the accept loop.
        Safe to call even if start() never ran (shutdown() would block
        forever waiting on serve_forever's loop-exit event)."""
        if self._thread is not None:
            self._httpd.shutdown()
        self.registry.close(drain=drain)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve(models, host="127.0.0.1", port=None, **batcher_kw):
    """Convenience bring-up: ``models`` maps name -> servable, a live Gluon
    block, or a path to a ``.mxtpu`` artifact (``contrib.serving.load``).
    Returns the STARTED ServingServer (caller owns ``stop()``)."""
    registry = ModelRegistry()
    for name, obj in models.items():
        if isinstance(obj, str):
            from ..contrib import serving as _artifact
            obj = _artifact.load(obj)
        registry.load(name, obj, **batcher_kw)
    return ServingServer(registry, host=host, port=port).start()
