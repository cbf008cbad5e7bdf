"""Framework telemetry (counterpart of ``incubator_mxnet_tpu/telemetry``).

One process-wide registry of named counters, gauges and fixed-bucket
histograms with labels, exported in Prometheus text format, shared by the
serving stack (``serving/metrics.py``), the captured steps (``jit.py``)
and the AOT cache (``aot.py``); request-scoped trace ids ride from the
HTTP front end through the batcher into spans and the profiler's events.

The port carries the seven device-agnostic modules the serving path
calls, as the JAX package has them: ``ringbuf``, ``trace``, ``registry``,
``spans``, ``flightrec``, ``watchdog`` and ``faultlab``. The five that
read the device or feed SLOs (``devstats``, ``profstats``, ``numwatch``,
``slo`` and ``history``) wait for ROADMAP §1 item 7: reaching any of them
through this package raises ``NotImplementedError`` naming that item.

Two consumption paths, as in the JAX package: the serving front end's
``GET /metrics``, and for headless jobs ``start_periodic_flush()`` (or
``MXTPU_TELEMETRY_FLUSH_S > 0`` at import), which writes the exposition
atomically to ``MXTPU_TELEMETRY_FILE`` every interval.
"""
from __future__ import annotations

import logging
import os
import threading

from .registry import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                       DEFAULT_BUCKETS, OVERFLOW_LABEL, counter, gauge,
                       histogram, export_text, reset)
from .trace import (new_request_id, current_request_id,
                    set_current_request_id, request_scope,
                    REQUEST_ID_HEADER)
from . import faultlab
from . import flightrec
from . import spans
from . import watchdog
from .spans import (Span, SpanContext, span, record_span, current_span,
                    current_context)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "OVERFLOW_LABEL",
    "counter", "gauge", "histogram", "export_text", "reset",
    "new_request_id", "current_request_id", "set_current_request_id",
    "request_scope", "REQUEST_ID_HEADER",
    "start_periodic_flush", "stop_periodic_flush", "flush_to_file",
    "faultlab", "flightrec", "spans", "watchdog",
    "Span", "SpanContext", "span", "record_span", "current_span",
    "current_context",
]

#: the JAX package's telemetry modules that read the device or feed SLOs
WAITING = ("devstats", "profstats", "numwatch", "slo", "history")


def __getattr__(name):
    if name in WAITING:
        raise NotImplementedError(
            "telemetry.%s (device statistics, profiles, numerics and SLOs) "
            "comes with ROADMAP §1 item 7 of the port" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


_flush_lock = threading.Lock()
_flush_stop = None        # threading.Event of the running flusher, or None
_flush_thread = None


def flush_to_file(path=None):
    """Write the full exposition atomically (tmp + rename) so a concurrent
    reader never sees a torn file; the tmp name carries the pid and the
    thread id, so two writers in one process never share it."""
    from .. import config
    if path is None:
        path = config.get_env("MXTPU_TELEMETRY_FILE")
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        f.write(export_text())
    os.replace(tmp, path)
    return path


def start_periodic_flush(path=None, interval_s=None):
    """Flush the registry to ``path`` every ``interval_s`` seconds from a
    daemon thread (defaults: MXTPU_TELEMETRY_FILE / MXTPU_TELEMETRY_FLUSH_S).
    A second call restarts it with the new settings. Returns the path."""
    from .. import config
    global _flush_stop, _flush_thread
    if interval_s is None:
        interval_s = config.get_env("MXTPU_TELEMETRY_FLUSH_S")
    interval_s = max(0.05, float(interval_s))
    if path is None:
        path = config.get_env("MXTPU_TELEMETRY_FILE")

    def run(stop):
        while not stop.wait(interval_s):
            try:
                flush_to_file(path)
            except Exception:
                # a full disk must not kill the job telemetry observes
                logging.getLogger(__name__).debug(
                    "telemetry flush to %r failed", path, exc_info=True)
        try:                      # final flush so short jobs leave a file
            flush_to_file(path)
        except Exception:
            logging.getLogger(__name__).debug(
                "final telemetry flush to %r failed", path, exc_info=True)

    # stop-old and start-new are one critical section: concurrent starts
    # never orphan a running flusher
    with _flush_lock:
        _stop_locked()
        stop = threading.Event()
        t = threading.Thread(target=run, args=(stop,), daemon=True,
                             name="mxtpu-telemetry")
        _flush_stop, _flush_thread = stop, t
        t.start()
    return path


def _stop_locked():
    """Signal and join the current flusher (the caller holds
    ``_flush_lock``; the flusher never takes it)."""
    global _flush_stop, _flush_thread
    stop, t = _flush_stop, _flush_thread
    _flush_stop = _flush_thread = None
    if stop is not None:
        stop.set()
        if t is not None:
            t.join(timeout=5.0)


def stop_periodic_flush():
    """Stop the flusher; it writes one final snapshot on its way out."""
    with _flush_lock:
        _stop_locked()


def _maybe_autostart():
    """Package-import hook, as the JAX package's: MXTPU_TELEMETRY_FLUSH_S >
    0 starts the flusher, the flight recorder chains its crash-dump
    excepthooks (gated per crash by MXTPU_FLIGHTREC_DUMP_ON_CRASH), and
    MXTPU_WATCHDOG=1 starts the stall watchdog. Each is guarded: telemetry
    never fails the import that carries it."""
    from .. import config
    log = logging.getLogger(__name__)
    try:
        if config.get_env("MXTPU_TELEMETRY_FLUSH_S") > 0:
            start_periodic_flush()
    except Exception:
        log.debug("telemetry flusher autostart failed", exc_info=True)
    try:
        flightrec.install_crash_dump()
    except Exception:
        log.debug("flight recorder hooks failed", exc_info=True)
    try:
        if config.get_env("MXTPU_WATCHDOG"):
            watchdog.start()
    except Exception:
        log.debug("watchdog autostart failed", exc_info=True)
