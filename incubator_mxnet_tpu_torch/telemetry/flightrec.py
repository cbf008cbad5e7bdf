"""Flight recorder: a bounded, lock-cheap ring buffer of structured
events — *what was the process doing just before it stalled or died*.

Counterpart of ``incubator_mxnet_tpu/telemetry/flightrec.py``, carried over
with it: the module reads no device.

Hot paths append one small dict per coarse phase transition (step
begin/end, compile start/end, batcher dispatch, kvstore push/pull, io
waits). The ring is a ``deque(maxlen=MXTPU_FLIGHTREC_SIZE)``: appends are
GIL-atomic (no lock on the hot path), memory is bounded, and the oldest
events age out — the black-box recorder model. Readers copy the ring with
a bounded retry instead of locking writers out.

Three ways the tape leaves the process:

- **on demand** — ``snapshot()``/``tail(n)``/``dump(path)`` (JSONL), and
  the serving front-end's ``GET /debug/flightrec``;
- **on unhandled exceptions** — ``install_crash_dump()`` (wired at
  package import) chains ``sys.excepthook`` and ``threading.excepthook``
  so a crashing main thread OR a dying worker writes the tail to
  ``MXTPU_FLIGHTREC_FILE`` before the stack trace scrolls by (gate:
  ``MXTPU_FLIGHTREC_DUMP_ON_CRASH``);
- **on stalls** — the watchdog appends the tail to its stall report
  (telemetry/watchdog.py).

``record()`` is safe before/without configuration and never raises into
the instrumented path.
"""
from __future__ import annotations

import itertools
import json
import sys
import threading
import time

from .ringbuf import BoundedRing

__all__ = ["record", "snapshot", "tail", "format_tail", "dump",
           "event_mono_us", "install_crash_dump", "reset"]

_seq = itertools.count(1)
#: the tape (shared machinery with the span ring)
_ring = BoundedRing("MXTPU_FLIGHTREC_SIZE", min_size=16)
_hooks_installed = False
_dump_lock = threading.Lock()    # one crash dump at a time


def _now_us():
    from .. import profiler
    return profiler.now_us()


def record(event, **fields):
    """Append one event (``event`` kind + small JSON-able fields; the
    reserved keys seq/ts_us/mono_us/event/thread are set here). Events
    carry BOTH clocks: ``ts_us`` is the epoch-anchored profiler clock
    (human-readable, joins chrome traces), ``mono_us`` is the raw
    ``perf_counter`` — the NTP-step-immune anchor the metric-history
    incident builder (telemetry/history.py) orders timelines on. Old
    dumps without mono_us still parse (readers fall back to ts_us).
    Never raises into the caller — the recorder must not be able to
    fail the path it observes."""
    try:
        ev = {"seq": next(_seq), "ts_us": _now_us(),
              "mono_us": time.perf_counter() * 1e6, "event": event,
              "thread": threading.current_thread().name}
        if fields:
            ev.update(fields)
        _ring.append(ev)
    except Exception:
        pass


def event_mono_us(ev):
    """The perf_counter anchor of one recorded event, falling back to
    ts_us for pre-dual-clock dumps (the two clocks differ by a constant
    within one process, so ordering is preserved either way)."""
    v = ev.get("mono_us")
    return float(v) if v is not None else float(ev.get("ts_us", 0.0))


def snapshot():
    """Current ring contents, oldest first; readers never block writers."""
    return _ring.snapshot()


def tail(n=200):
    """The newest ``n`` events, oldest first."""
    return snapshot()[-int(n):]


def format_tail(n=200):
    """The tail as JSONL text — what the watchdog embeds in a stall report
    and ``GET /debug/flightrec`` serves."""
    return "".join(json.dumps(ev, default=str) + "\n" for ev in tail(n))


def dump(path=None):
    """Write the full ring to ``path`` (default MXTPU_FLIGHTREC_FILE) as
    JSONL; returns the path."""
    if path is None:
        from .. import config
        path = config.get_env("MXTPU_FLIGHTREC_FILE")
    with open(path, "w") as f:
        for ev in snapshot():
            f.write(json.dumps(ev, default=str) + "\n")
    return path


def _crash_dump(origin, exc_type):
    """Best-effort tape dump on an unhandled exception; once per process
    unless the first attempt failed. Returns the path or None."""
    from .. import config
    try:
        if not config.get_env("MXTPU_FLIGHTREC_DUMP_ON_CRASH"):
            return None
        if not len(_ring):
            return None           # nothing recorded: nothing worth a file
        with _dump_lock:
            record("crash", origin=origin, exc=exc_type.__name__)
            path = dump()
        sys.stderr.write("[mxtpu] flight recorder dumped to %s (%s in %s)\n"
                         % (path, exc_type.__name__, origin))
        return path
    except Exception:
        return None               # the crash handler must never crash


def install_crash_dump():
    """Chain the flight-recorder dump onto ``sys.excepthook`` and
    ``threading.excepthook`` (both: a serving worker dies via the
    threading hook, a training script via the sys one). Idempotent; the
    previous hooks still run, so tracebacks print exactly as before."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    prev_sys = sys.excepthook
    prev_threading = threading.excepthook

    def sys_hook(exc_type, exc, tb):
        _crash_dump("main", exc_type)
        prev_sys(exc_type, exc, tb)

    def threading_hook(args):
        if args.exc_type is not SystemExit:
            _crash_dump(getattr(args.thread, "name", "thread"),
                        args.exc_type)
        prev_threading(args)

    sys.excepthook = sys_hook
    threading.excepthook = threading_hook


def reset():
    """Drop the tape and re-read MXTPU_FLIGHTREC_SIZE (test isolation)."""
    _ring.reset()
