"""Hierarchical span tracing: *which phase of which step/request did the
time go to* (the causal layer on top of the registry's aggregate metrics).

Counterpart of ``incubator_mxnet_tpu/telemetry/spans.py``, carried over
with it: the module reads no device.

A span is one named, timed region of work. Spans nest: entering a span
pushes it on a thread-local stack, so a span opened inside another becomes
its child (``parent_id`` link) with zero caller bookkeeping — the same
ambient-context discipline TensorFlow's runtime tracer uses. Each span
also carries the serving request ID (``telemetry.trace``) when one is
ambient, so one HTTP request's chain is greppable end to end.

Cross-thread / queue-boundary propagation is EXPLICIT (a thread-local
stack cannot follow a request through the batcher queue):

- ``current_context()`` captures the open span as an immutable
  ``SpanContext`` the producer attaches to the queued work item;
- the consumer either opens a live child with
  ``with span("phase", parent=ctx):`` or — when the duration was measured
  elsewhere (e.g. queue wait computed at dispatch) — emits it
  retroactively with ``record_span(name, start_us, dur_us, parent=ctx)``,
  which touches no stack at all and is therefore safe from any thread.

Every finished span lands in a bounded ring buffer (``MXTPU_SPANS_BUFFER``
records, oldest dropped) exportable as JSONL (``export_jsonl`` /
``dump_jsonl``; served at ``GET /debug/spans``), and is mirrored into the
profiler's chrome-trace stream as a complete event with
``span_id``/``parent_id``/``request_id`` args whenever the profiler is
running — one dump shows metrics-invisible causality: HTTP handler ->
queue wait -> batch dispatch -> device step.

Opt-in histogram bridge: ``set_histogram_bridge(True)`` (or
``MXTPU_SPANS_HISTOGRAM=1``) feeds every finished span's duration into the
``mxtpu_span_seconds{span=<name>}`` histogram on the shared registry —
span names are code-authored constants, a bounded label by construction.

Discipline (enforced by mxtpulint R008): a span is entered with ``with``
or, when the manual ``start()``/``end()`` API is unavoidable, inside
``try/finally`` — a span left open on an exception corrupts the ambient
parent stack for everything that thread runs next.
"""
from __future__ import annotations

import itertools
import json
import threading

from . import trace
from .ringbuf import BoundedRing

__all__ = ["Span", "SpanContext", "span", "record_span", "current_span",
           "current_context", "snapshot", "export_jsonl", "dump_jsonl",
           "set_histogram_bridge", "reset"]

# Span ids: a GIL-atomic counter (no lock, no urandom syscall per span);
# hex-rendered with a per-process random prefix so ids from two processes
# writing one trace directory cannot collide.
_ids = itertools.count(1)
_local = threading.local()

#: finished-span record ring (shared machinery with the flight recorder)
_buffer = BoundedRing("MXTPU_SPANS_BUFFER", min_size=1)

_bridge = None                   # None = follow env; True/False = forced
_SPAN_SECONDS = None             # lazily declared histogram

_PID_PREFIX = None


def _now_us():
    # profiler.now_us is the one epoch-anchored monotonic clock every
    # trace event uses; imported lazily (the package imports telemetry
    # before profiler).
    from .. import profiler
    return profiler.now_us()


def _next_id():
    global _PID_PREFIX
    if _PID_PREFIX is None:
        import os
        _PID_PREFIX = os.urandom(3).hex()
    return "%s-%x" % (_PID_PREFIX, next(_ids))


def _bridge_enabled():
    if _bridge is not None:
        return _bridge
    from .. import config
    return config.get_env("MXTPU_SPANS_HISTOGRAM")


def set_histogram_bridge(enabled=True):
    """Force the span->histogram bridge on/off (None: follow
    MXTPU_SPANS_HISTOGRAM). Opt-in because per-span observe() cost is only
    worth paying when something scrapes the histogram."""
    global _bridge
    _bridge = enabled


def _observe_bridge(rec):
    global _SPAN_SECONDS
    if _SPAN_SECONDS is None:
        from . import registry
        _SPAN_SECONDS = registry.histogram(
            "mxtpu_span_seconds",
            "Duration of finished trace spans by span name "
            "(opt-in bridge: MXTPU_SPANS_HISTOGRAM).",
            labelnames=("span",))
    _SPAN_SECONDS.observe(rec["dur_us"] / 1e6, span=rec["name"])


class SpanContext:
    """Immutable handle to a span, safe to carry across threads/queues.
    Only identity rides along — never the live Span (the owner thread
    ends it)."""

    __slots__ = ("span_id", "request_id")

    def __init__(self, span_id, request_id=None):
        self.span_id = span_id
        self.request_id = request_id

    def __repr__(self):
        return "SpanContext(%s, request_id=%s)" % (self.span_id,
                                                   self.request_id)


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_span():
    """The innermost OPEN span on this thread, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def current_context():
    """SpanContext of the innermost open span on this thread (None when no
    span is open) — the value a producer attaches to queued work."""
    sp = current_span()
    return sp.context() if sp is not None else None


class Span:
    """One named, timed region. Use ``with span(...)``; the manual
    ``start()``/``end()`` pair exists for generators/callbacks that cannot
    hold a ``with`` open and MUST be guarded by try/finally (mxtpulint
    R008)."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "args",
                 "start_us", "_open")

    def __init__(self, name, parent=None, request_id=None, **args):
        self.name = name
        self.span_id = _next_id()
        if parent is None:
            parent = current_span()
        if isinstance(parent, Span):
            self.parent_id = parent.span_id
            inherited_rid = parent.request_id
        elif isinstance(parent, SpanContext):
            self.parent_id = parent.span_id
            inherited_rid = parent.request_id
        else:
            self.parent_id = None
            inherited_rid = None
        self.request_id = (request_id if request_id is not None
                           else inherited_rid
                           if inherited_rid is not None
                           else trace.current_request_id())
        self.args = args or None
        self.start_us = None
        self._open = False

    def context(self):
        return SpanContext(self.span_id, self.request_id)

    # ------------------------------------------------------------------
    def start(self):
        self.start_us = _now_us()
        _stack().append(self)
        self._open = True
        return self

    def end(self, **extra_args):
        if not self._open:
            return
        self._open = False
        st = _stack()
        # tolerate out-of-order ends (a leaked child) without corrupting
        # everything above us: pop through to this span if present
        if self in st:
            while st and st.pop() is not self:
                pass
        if extra_args:
            self.args = dict(self.args or (), **extra_args)
        _emit(self.name, self.start_us, _now_us() - self.start_us,
              self.span_id, self.parent_id, self.request_id, self.args)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.end(error=exc_type.__name__)
        else:
            self.end()

    def __repr__(self):
        return "Span(%r, id=%s, parent=%s)" % (self.name, self.span_id,
                                               self.parent_id)


def span(name, parent=None, request_id=None, **args):
    """Open a span: ``with span("train:step"):``. ``parent`` (a Span or a
    SpanContext carried across a queue) overrides the ambient thread-local
    parent; ``args`` land on the finished record and the chrome-trace
    event."""
    return Span(name, parent=parent, request_id=request_id, **args)


def record_span(name, start_us, dur_us, parent=None, request_id=None,
                **args):
    """Emit a finished span retroactively — no stack interaction, safe
    from any thread. This is the queue-boundary form: the dispatcher
    measures queue wait AFTER the fact and emits it as a child of the
    producer's captured SpanContext. Returns the new span's id."""
    parent_id = parent.span_id if isinstance(parent, (Span, SpanContext)) \
        else parent
    if request_id is None:
        if isinstance(parent, (Span, SpanContext)):
            request_id = parent.request_id
        if request_id is None:
            request_id = trace.current_request_id()
    span_id = _next_id()
    _emit(name, start_us, dur_us, span_id, parent_id, request_id,
          args or None)
    return span_id


def _emit(name, start_us, dur_us, span_id, parent_id, request_id, args):
    rec = {"name": name, "span_id": span_id, "parent_id": parent_id,
           "request_id": request_id, "start_us": start_us,
           "dur_us": dur_us, "thread": threading.current_thread().name}
    if args:
        rec["args"] = args
    # BoundedRing.append never raises: a misconfigured MXTPU_SPANS_BUFFER
    # drops the record, it does not crash the instrumented hot path
    _buffer.append(rec)
    # mirror into the profiler's chrome-trace stream (no-op unless the
    # profiler is running) so spans and op/batch events share one dump
    try:
        from .. import profiler
        ev_args = {"span_id": span_id}
        if parent_id is not None:
            ev_args["parent_id"] = parent_id
        if request_id is not None:
            ev_args["request_id"] = request_id
        if args:
            ev_args.update(args)
        profiler.record_event(name, "span", start_us, dur_us, args=ev_args)
    except Exception:
        pass          # tracing must never take down the traced path
    if _bridge_enabled():
        try:
            _observe_bridge(rec)
        except Exception:
            pass
    return rec


# ---------------------------------------------------------------- export
def snapshot():
    """Finished-span records, oldest first (bounded by
    MXTPU_SPANS_BUFFER); readers never block writers."""
    return _buffer.snapshot()


def export_jsonl():
    """The span buffer as JSON Lines (one span per line) — the on-demand
    export ``GET /debug/spans`` serves."""
    return "".join(json.dumps(rec, default=str) + "\n"
                   for rec in snapshot())


def dump_jsonl(path):
    """Write the span buffer to ``path`` as JSONL; returns the path."""
    with open(path, "w") as f:
        f.write(export_jsonl())
    return path


def reset():
    """Drop buffered spans and re-read MXTPU_SPANS_BUFFER (test isolation;
    open spans on other threads keep working — their records land in the
    fresh ring)."""
    _buffer.reset()
