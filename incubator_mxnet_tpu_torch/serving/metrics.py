"""Serving observability (counterpart of
``incubator_mxnet_tpu/serving/metrics.py``, carried over with it;
TF-Serving BatchingSession metrics analog).

One ``ServingMetrics`` per registered model: monotonic counters, the
dispatched batch-size histogram (the coalescing proof), and request
latency percentiles from a bounded ring buffer — cheap enough to stay on
for every request, rich enough to tune ``MXTPU_SERVE_*`` capacity knobs
from (see docs/SERVING.md).

Every update is double-written: the per-instance fields feed the
JSON ``snapshot()`` (served at ``GET /metrics.json``) and the
process-wide telemetry registry feeds the Prometheus exposition at
``GET /metrics`` (telemetry/registry.py) — one surface shared with the
captured steps and the AOT cache.
"""
from __future__ import annotations

import math
import threading
from collections import deque

from .. import telemetry

__all__ = ["ServingMetrics", "percentile", "request_accounted",
           "http_request_started", "http_request_finished"]


def percentile(sorted_values, q):
    """Nearest-rank percentile of an ascending-sorted sequence (q in 0..100).

    rank = ceil(n * q / 100), clamped to [1, n]. The epsilon guards float
    representation error at exact-integer products (e.g. n=70, q=30 gives
    21.000000000000004, which a bare ceil would round UP to rank 22); it
    also keeps small windows exact: q=50 of 1 element is that element,
    q=99 of 2 elements is the max.
    """
    if not sorted_values:
        return None
    n = len(sorted_values)
    q = min(max(float(q), 0.0), 100.0)
    rank = int(math.ceil(n * q / 100.0 - 1e-9))
    return sorted_values[min(max(rank, 1), n) - 1]


# ---------------------------------------------------------------------------
# Shared-registry metrics (one series per model label). Batch-size buckets
# cover the power-of-two bucketing the batcher pads to; latency buckets
# span sub-ms CPU echoes to multi-second compiled first calls.
_REQS = telemetry.counter(
    "mxtpu_serving_requests_total",
    "Requests accepted into a model's serving queue.", ("model",))
_OK = telemetry.counter(
    "mxtpu_serving_ok_total",
    "Requests completed successfully.", ("model",))
_ERRORS = telemetry.counter(
    "mxtpu_serving_errors_total",
    "Requests failed by a raising servable.", ("model",))
_REJECTED = telemetry.counter(
    "mxtpu_serving_rejected_total",
    "Requests rejected at submit time (queue full backpressure).",
    ("model",))
_EXPIRED = telemetry.counter(
    "mxtpu_serving_expired_total",
    "Requests whose deadline passed while queued.", ("model",))
_PREWARMS = telemetry.counter(
    "mxtpu_aot_prewarms_total",
    "Batcher buckets warmed ahead of traffic (hot-reload / warm_spec "
    "prewarm through the shared AOT executable cache).", ("model",))
_BATCHES = telemetry.counter(
    "mxtpu_serving_batches_total", "Dispatched batches.", ("model",))
_BATCHED_ITEMS = telemetry.counter(
    "mxtpu_serving_batched_items_total",
    "Real (non-padding) items dispatched.", ("model",))
_PADDED_ITEMS = telemetry.counter(
    "mxtpu_serving_padded_items_total",
    "Padding rows added to reach a bucket shape.", ("model",))
_BATCH_SIZE = telemetry.histogram(
    "mxtpu_serving_batch_size",
    "Real items per dispatched batch (the coalescing proof).",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256), labelnames=("model",))
_LATENCY_MS = telemetry.histogram(
    "mxtpu_serving_request_latency_ms",
    "End-to-end request latency (enqueue -> result ready) in ms.",
    buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
    labelnames=("model",))
_QUEUE_DEPTH = telemetry.gauge(
    "mxtpu_serving_queue_depth",
    "Requests currently waiting in the model's bounded queue.", ("model",))
_QUEUE_CAPACITY = telemetry.gauge(
    "mxtpu_serving_queue_capacity",
    "Aggregate queue capacity of the model (per-replica bound x "
    "replicas) — the saturation line the metric-history pressure_rising "
    "predictor extrapolates mxtpu_serving_queue_depth toward "
    "(telemetry/history.py; docs/OBSERVABILITY.md).", ("model",))
_BUCKET_DEPTH = telemetry.gauge(
    "mxtpu_serving_bucket_queue_depth",
    "Requests gathered into this batch bucket and not yet completed "
    "(padding + servable dispatch + result slicing). Together with "
    "mxtpu_serving_queue_depth this splits waiting time into queue vs "
    "dispatch — the per-bucket saturation signal the load harness joins "
    "against client latency (docs/LOADGEN.md).", ("model", "bucket"))
_REPLICA_DEPTH = telemetry.gauge(
    "mxtpu_serving_replica_queue_depth",
    "Requests routed to this data-parallel replica and not yet completed "
    "(queued on its dispatch queue + handed to its worker). This is the "
    "exact signal the batcher's least-depth router balances on, so a "
    "persistently deeper replica means a slower executor (bad device, "
    "noisy neighbor) — the per-replica saturation view the load harness "
    "joins against serve:dispatch spans (docs/SERVING.md, docs/LOADGEN.md).",
    ("model", "replica"))
_REPLICA_DISPATCH = telemetry.counter(
    "mxtpu_serving_replica_dispatch_total",
    "Requests dispatched by this data-parallel replica (cumulative) — "
    "compare across replicas to verify the router is balancing "
    "(docs/SERVING.md).", ("model", "replica"))
_TENANT_REQS = telemetry.counter(
    "mxtpu_requests_total",
    "Terminal predict outcomes by model, tenant (X-MXTPU-Tenant header, "
    "clamped via serving/accesslog.clamp_tenant; 'default' when absent) "
    "and HTTP status code — the per-tenant request accounting the SLO "
    "engine and fair scheduling build on (docs/OBSERVABILITY.md 'SLOs "
    "and tenants'). Hostile random tenant values collapse onto the "
    "'_other_' series past MXTPU_TELEMETRY_MAX_SERIES.",
    ("model", "tenant", "code"))
_TENANT_LATENCY_MS = telemetry.histogram(
    "mxtpu_request_latency_ms",
    "End-to-end HTTP predict latency per tenant (body read -> response "
    "computed, the http:predict span window) in ms — the per-tenant "
    "complement of mxtpu_serving_request_latency_ms.",
    buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
             10000),
    labelnames=("model", "tenant"))


def request_accounted(model, tenant, code, latency_ms):
    """One terminal HTTP predict outcome (server.py): per-tenant request
    counter + latency histogram on the shared registry. ``code`` is the
    final HTTP status; every outcome counts, including 4xx."""
    code_s = str(int(code))
    _TENANT_REQS.inc(model=model, tenant=tenant, code=code_s)
    _TENANT_LATENCY_MS.observe(latency_ms, model=model, tenant=tenant)


_HTTP_INFLIGHT = telemetry.gauge(
    "mxtpu_http_inflight_requests",
    "Predict requests currently held by the HTTP front-end (body read "
    "through response written). Tracks client-side concurrency pressure: "
    "rising inflight with flat queue depth means time is spent outside "
    "the batcher (docs/LOADGEN.md).")

def http_request_started():
    """One predict request entered the HTTP front-end (server.py)."""
    _HTTP_INFLIGHT.inc()


def http_request_finished():
    _HTTP_INFLIGHT.dec()


_COUNTER_MAP = {
    "request_count": _REQS,
    "ok_count": _OK,
    "error_count": _ERRORS,
    "rejected_count": _REJECTED,
    "expired_count": _EXPIRED,
    "prewarm_count": _PREWARMS,
}


class ServingMetrics:
    """Thread-safe per-model serving counters + batch histogram + latency ring.

    Latency is end-to-end request time (enqueue -> result ready), the number
    a client observes; the ring buffer bounds memory so a long-lived server
    reports a moving window, not its whole history. ``model`` names the
    telemetry-registry label this instance's updates are mirrored onto.
    """

    def __init__(self, latency_window=4096, model="model"):
        self._lock = threading.Lock()
        self.model = model
        self.request_count = 0        # accepted into the queue
        self.ok_count = 0
        self.error_count = 0          # dispatch raised
        self.rejected_count = 0       # queue full (backpressure)
        self.expired_count = 0        # deadline passed while queued
        self.prewarm_count = 0        # buckets warmed ahead of traffic
        self.batch_count = 0          # dispatches
        self.batched_items = 0        # real (non-padding) items dispatched
        self.padded_items = 0         # padding rows added to reach a bucket
        self.batch_size_hist = {}     # real batch size -> count
        self.replica_dispatch = {}    # replica -> requests dispatched
        self._latencies_ms = deque(maxlen=latency_window)
        self._queue_depth_fn = None   # injected by the batcher
        self._bucket_depth_fns = []   # per-bucket samplers, ditto
        self._replica_depth_fns = []  # per-replica samplers, ditto
        self._capacity_fn = None      # constant sampler, ditto

    # ------------------------------------------------------------------
    @property
    def queue_depth_fn(self):
        return self._queue_depth_fn

    @queue_depth_fn.setter
    def queue_depth_fn(self, fn):
        self._queue_depth_fn = fn
        if fn is not None:
            # sampled at scrape time — depth is a point-in-time gauge
            _QUEUE_DEPTH.set_function(fn, model=self.model)

    def set_queue_capacity(self, capacity):
        """Publish the model's aggregate queue capacity (batcher init).
        Bound as a constant CALLBACK, not a set() value, so teardown can
        remove it by identity like every other per-instance series —
        immune to the hot-reload remove-by-label race detach_telemetry
        documents."""
        cap = float(capacity)
        self._capacity_fn = lambda: cap
        _QUEUE_CAPACITY.set_function(self._capacity_fn, model=self.model)

    def bind_bucket_depth(self, bucket, fn):
        """Register ``fn() -> depth`` as the sampler for one batch bucket
        (batcher init — buckets are known up front, so cardinality is
        bounded by the bucket list, not by traffic)."""
        self._bucket_depth_fns.append(fn)
        _BUCKET_DEPTH.set_function(fn, model=self.model, bucket=bucket)

    def bind_replica_depth(self, replica, fn):
        """Register ``fn() -> depth`` as the sampler for one data-parallel
        replica (batcher init — replica count is fixed up front, so
        cardinality is bounded by configuration, not traffic)."""
        with self._lock:
            self._replica_depth_fns.append(fn)
        _REPLICA_DEPTH.set_function(fn, model=self.model, replica=replica)

    def detach_replica_depth(self, fn):
        """Drop ONE replica's depth series (dead-replica path, called from
        the dying worker thread): removal is by callback identity,
        mirroring detach_telemetry, so the other replicas' series keep
        exporting."""
        _REPLICA_DEPTH.remove_function(fn)
        with self._lock:
            try:
                self._replica_depth_fns.remove(fn)
            except ValueError:
                pass

    def inc_replica_dispatch(self, replica, n=1):
        """Count ``n`` requests dispatched by one replica (worker side)."""
        with self._lock:
            self.replica_dispatch[replica] = \
                self.replica_dispatch.get(replica, 0) + n
        _REPLICA_DISPATCH.inc(n, model=self.model, replica=replica)

    def detach_telemetry(self):
        """Drop this instance's gauge-callback series from the shared
        registry (batcher close/unload): a dead model must not keep
        exporting a stale depth, nor keep its queue object alive through
        the callback closure. Removal is by callback IDENTITY, so a
        hot-reload that already re-registered the same model name keeps
        its series, and a series the cardinality clamp re-keyed is still
        found. Counters/histograms stay — they are process-lifetime
        cumulative by Prometheus convention."""
        _QUEUE_DEPTH.remove_function(self._queue_depth_fn)
        _QUEUE_CAPACITY.remove_function(self._capacity_fn)
        for fn in self._bucket_depth_fns:
            _BUCKET_DEPTH.remove_function(fn)
        with self._lock:
            replica_fns = list(self._replica_depth_fns)
            self._replica_depth_fns = []
        for fn in replica_fns:
            _REPLICA_DEPTH.remove_function(fn)

    # ------------------------------------------------------------------
    def inc(self, counter, n=1):
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)
        prom = _COUNTER_MAP.get(counter)
        if prom is not None:
            prom.inc(n, model=self.model)

    def observe_batch(self, size, bucket):
        with self._lock:
            self.batch_count += 1
            self.batched_items += size
            self.padded_items += bucket - size
            self.batch_size_hist[size] = self.batch_size_hist.get(size, 0) + 1
        _BATCHES.inc(model=self.model)
        _BATCHED_ITEMS.inc(size, model=self.model)
        _PADDED_ITEMS.inc(bucket - size, model=self.model)
        _BATCH_SIZE.observe(size, model=self.model)

    def observe_latency_ms(self, ms):
        with self._lock:
            self._latencies_ms.append(ms)
        _LATENCY_MS.observe(ms, model=self.model)

    # ------------------------------------------------------------------
    @property
    def mean_batch_size(self):
        """Mean REAL items per dispatch — > 1 means coalescing is happening."""
        with self._lock:
            if not self.batch_count:
                return 0.0
            return self.batched_items / self.batch_count

    def latency_percentiles_ms(self, qs=(50, 95, 99)):
        with self._lock:
            ordered = sorted(self._latencies_ms)
        return {"p%d" % q: percentile(ordered, q) for q in qs}

    def snapshot(self):
        """One JSON-able dict with every counter, the histogram, and p50/95/99."""
        with self._lock:
            out = {
                "request_count": self.request_count,
                "ok_count": self.ok_count,
                "error_count": self.error_count,
                "rejected_count": self.rejected_count,
                "expired_count": self.expired_count,
                "prewarm_count": self.prewarm_count,
                "batch_count": self.batch_count,
                "batched_items": self.batched_items,
                "padded_items": self.padded_items,
                "batch_size_hist": dict(self.batch_size_hist),
                "replica_dispatch": {str(r): c for r, c in
                                     sorted(self.replica_dispatch.items())},
                "mean_batch_size": (self.batched_items / self.batch_count
                                    if self.batch_count else 0.0),
                "latency_window": len(self._latencies_ms),
            }
        out["latency_ms"] = self.latency_percentiles_ms()
        if self.queue_depth_fn is not None:
            out["queue_depth"] = self.queue_depth_fn()
        return out
