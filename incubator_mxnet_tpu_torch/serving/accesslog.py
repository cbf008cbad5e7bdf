"""Structured per-request access log (counterpart of
``incubator_mxnet_tpu/serving/accesslog.py``, carried over with it): one
bounded ring of terminal predict outcomes, each a small JSON-able record

    {ts, request_id, tenant, model, code, shed_reason, latency_ms,
     queue_ms, batch_ms, device_ms, replica, bucket}

— the request-granular complement to the aggregate counters: *which*
request from *which tenant* was shed, how long it queued, which replica
dispatched it. The HTTP front-end (server.py) records every terminal
outcome, including 4xx/shed ones (``shed_reason`` is ``queue_full`` for
429 backpressure and ``deadline`` for 504 — the machine-readable split
clients used to string-match out of the error text); the batch-stage
legs (queue/batch/device, replica, bucket) come from the dispatch facts
the batcher worker attaches to each request and are null for requests
that never reached a dispatch.

Surfaces:

- the in-memory ring (``MXTPU_ACCESSLOG_SIZE`` records, oldest aged
  out; telemetry/ringbuf.py — appends never raise into the serving
  path), served at ``GET /debug/requests?n=`` as JSONL;
- optional sampled JSONL file export: ``MXTPU_ACCESSLOG_FILE`` appends
  every record the **deterministic stride sampler** selects
  (``MXTPU_ACCESSLOG_SAMPLE``: 1.0 = all, 0.5 = every second record, 0
  = none) — deterministic so two identical runs export identical files,
  and so tests pin exact sample membership without probability bounds.

Tenants: ``clamp_tenant`` normalizes the raw ``X-MXTPU-Tenant`` header
(default ``"default"`` when absent, length-clamped, control characters
stripped) BEFORE it becomes a metric label or log field — the telemetry
registry's cardinality clamp (MXTPU_TELEMETRY_MAX_SERIES -> ``_other_``)
is the backstop against hostile random tenants; this keeps single
values bounded too.
"""
from __future__ import annotations

import json
import logging
import threading

from ..telemetry.ringbuf import BoundedRing

__all__ = ["TENANT_HEADER", "DEFAULT_TENANT", "clamp_tenant", "record",
           "snapshot", "tail", "export_jsonl", "reset"]

_LOG = logging.getLogger(__name__)

#: request header naming the tenant an outcome is accounted to
TENANT_HEADER = "X-MXTPU-Tenant"
DEFAULT_TENANT = "default"
_TENANT_MAXLEN = 64

_ring = BoundedRing("MXTPU_ACCESSLOG_SIZE", min_size=16)
_export_lock = threading.Lock()     # file handle + stride counter
_export_count = 0
_export_file = None                 # cached (path, handle) — the export
                                    # sits on the response path, so it
                                    # must not pay open/close per record


def clamp_tenant(raw):
    """Normalize a raw tenant header value into a bounded label: None /
    empty -> ``"default"``; control characters dropped; length clamped.
    Cardinality stays the registry clamp's job — this only bounds one
    value's size."""
    if raw is None:
        return DEFAULT_TENANT
    cleaned = "".join(c for c in str(raw).strip() if c.isprintable())
    return cleaned[:_TENANT_MAXLEN] or DEFAULT_TENANT


def _now_s():
    from .. import profiler
    return profiler.now_us() / 1e6   # epoch-anchored monotonic (NTP-safe)


def record(request_id, tenant, model, code, latency_ms=None,
           shed_reason=None, queue_ms=None, batch_ms=None, device_ms=None,
           replica=None, bucket=None):
    """Append one terminal-outcome record (and maybe export it). Never
    raises into the serving path; a failed file export is debug-logged
    (a full disk must not fail the request it records)."""
    try:
        rec = {"ts": round(_now_s(), 6), "request_id": request_id,
               "tenant": tenant, "model": model, "code": int(code),
               "shed_reason": shed_reason,
               "latency_ms": (round(latency_ms, 3)
                              if latency_ms is not None else None),
               "queue_ms": (round(queue_ms, 3)
                            if queue_ms is not None else None),
               "batch_ms": (round(batch_ms, 3)
                            if batch_ms is not None else None),
               "device_ms": (round(device_ms, 3)
                             if device_ms is not None else None),
               "replica": replica, "bucket": bucket}
        _ring.append(rec)
        _maybe_export(rec)
    except Exception:
        _LOG.debug("access-log record failed", exc_info=True)


def _maybe_export(rec):
    from .. import config
    path = config.get_env("MXTPU_ACCESSLOG_FILE")
    if not path:
        return
    rate = min(1.0, max(0.0, config.get_env("MXTPU_ACCESSLOG_SAMPLE")))
    if rate <= 0.0:
        return
    global _export_count, _export_file
    with _export_lock:
        _export_count += 1
        # stride sampler: record n is written when floor(n*rate) advances
        # over floor((n-1)*rate) — exactly ceil(N*rate) of N records, at
        # evenly-spaced deterministic positions
        take = int(_export_count * rate) > int((_export_count - 1) * rate)
        if not take:
            return
        try:
            if _export_file is None or _export_file[0] != path:
                if _export_file is not None:
                    _export_file[1].close()
                _export_file = (path, open(path, "a"))
            f = _export_file[1]
            f.write(json.dumps(rec) + "\n")
            f.flush()
        except Exception:
            _export_file = None
            _LOG.debug("access-log export to %r failed", path,
                       exc_info=True)


def snapshot():
    """Every buffered record, oldest first (readers never block writers)."""
    return _ring.snapshot()


def tail(n=200):
    """The newest ``n`` records, oldest first."""
    return snapshot()[-max(0, int(n)):]


def export_jsonl(n=200):
    """The tail as JSONL text — what ``GET /debug/requests?n=`` serves."""
    return "".join(json.dumps(rec) + "\n" for rec in tail(n))


def reset():
    """Drop the ring, re-read MXTPU_ACCESSLOG_SIZE, rewind the export
    stride, and close the cached export handle (test isolation)."""
    global _export_count, _export_file
    _ring.reset()
    with _export_lock:
        _export_count = 0
        if _export_file is not None:
            try:
                _export_file[1].close()
            except Exception:
                pass
            _export_file = None
