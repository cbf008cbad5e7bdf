"""Stall watchdog: heartbeats from the framework's worker loops plus a
monitor thread that answers *why is it stuck* — without killing anything.

Counterpart of ``incubator_mxnet_tpu/telemetry/watchdog.py``, carried over
with it: the module reads no device.

Instrumented loops (TrainStep, the serving batcher workers, io prefetch
threads) call ``heartbeat(name)`` once per iteration: one dict store, no
lock, cheap enough for every step. The monitor thread wakes every
``MXTPU_WATCHDOG_POLL_S`` and, when a registered channel has been quiet
for ``MXTPU_WATCHDOG_QUIET_S`` (per-channel override via
``register(quiet_s=)``), emits ONE stall report for that stall:

- all-thread stacks (``sys._current_frames`` + ``traceback`` — the
  in-process, serveable form of a faulthandler dump),
- the flight-recorder tail (what the process was doing as it went quiet),

appended to ``MXTPU_WATCHDOG_FILE`` (when set) and logged; the newest
report stays readable at ``last_report()`` / ``GET /debug/stacks``. The
channel re-arms when its heartbeat resumes, so a recurring stall produces
one report per episode, not one per poll. The process is never killed:
the watchdog diagnoses, the operator (or orchestrator) decides.

Lifecycle: ``start()`` spawns the (daemonized) monitor; ``stop()`` joins
it. ``MXTPU_WATCHDOG=1`` autostarts at package import. A worker that
exits cleanly must ``unregister`` its channel (the batcher/prefetcher
close paths do) — a silent channel is indistinguishable from a stalled
one, by design.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
import traceback

from . import flightrec
from .registry import counter

__all__ = ["heartbeat", "register", "unregister", "channels",
           "format_stacks", "last_report", "start", "stop", "running"]

_LOG = logging.getLogger(__name__)

_STALLS = counter(
    "mxtpu_watchdog_stalls_total",
    "Stall episodes detected per heartbeat channel (one per episode, "
    "not per poll).", ("channel",))


class _Channel:
    __slots__ = ("name", "last", "quiet_s", "stalled")

    def __init__(self, name, quiet_s=None):
        self.name = name
        self.last = time.perf_counter()
        self.quiet_s = quiet_s        # None: the watchdog default
        self.stalled = False


_channels = {}                       # name -> _Channel
#: guards _channels MAP mutation + iteration (R010: register runs on
#: worker threads — io prefetchers register their own channel — while
#: the monitor iterates). The per-beat fast path stays lock-free: it
#: mutates the _Channel OBJECT (two attribute stores), never the map.
_channels_lock = threading.Lock()
_state_lock = threading.Lock()       # monitor lifecycle only
_report_lock = threading.Lock()      # guards _last_report (R010)
_thread = None
_stop_event = None
_last_report = None                  # newest stall report text


def register(name, quiet_s=None):
    """Declare a heartbeat channel (optionally with its own quiet bound —
    an io prefetcher that legally blocks for minutes should not page at a
    train step's threshold). Idempotent; resets the beat."""
    with _channels_lock:
        ch = _channels.get(name)
        if ch is None or ch.quiet_s != quiet_s:
            _channels[name] = _Channel(name, quiet_s)
        else:
            ch.last = time.perf_counter()
            ch.stalled = False
    return name


def unregister(name):
    """Remove a channel (worker exiting cleanly): silence from a gone
    worker is not a stall."""
    with _channels_lock:
        _channels.pop(name, None)


def heartbeat(name):
    """One beat: a dict lookup and two attribute stores — hot-loop cheap,
    no lock on the steady-state path. Only the first beat of an unknown
    channel takes the map lock to auto-register it."""
    ch = _channels.get(name)
    if ch is None:
        with _channels_lock:
            ch = _channels.get(name)
            if ch is None:
                ch = _channels[name] = _Channel(name)
    ch.last = time.perf_counter()
    ch.stalled = False


def _channel_snapshot():
    """Consistent copy of the channel map for iteration (monitor poll,
    liveness view) — readers never see a half-built map entry."""
    with _channels_lock:
        return dict(_channels)


def channels():
    """{name: seconds_since_last_beat} — the liveness snapshot
    ``GET /debug/stacks`` includes."""
    now = time.perf_counter()
    return {name: now - ch.last
            for name, ch in _channel_snapshot().items()}


# ---------------------------------------------------------------- dumping
def format_stacks():
    """All-thread stack dump (sys._current_frames), thread names resolved —
    the operator-facing 'where is everyone' view."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(frames.items()):
        t = by_ident.get(ident)
        name = t.name if t is not None else "?"
        daemon = " daemon" if t is not None and t.daemon else ""
        lines.append("--- thread %r (ident %d%s) ---" % (name, ident,
                                                         daemon))
        lines.extend(l.rstrip("\n")
                     for l in traceback.format_stack(frame))
    return "\n".join(lines) + "\n"


def _build_report(stalled_names, quiet):
    beats = channels()
    head = ["=== mxtpu stall report ===",
            "stalled channel(s): %s (quiet > %.3fs)"
            % (", ".join(sorted(stalled_names)), quiet),
            "heartbeats (s since last beat): %s"
            % ", ".join("%s=%.3f" % (n, s)
                        for n, s in sorted(beats.items())),
            "", "--- all-thread stacks ---"]
    rec_tail = flightrec.format_tail(100)
    return "\n".join(head) + "\n" + format_stacks() \
        + "\n--- flight recorder tail ---\n" \
        + (rec_tail if rec_tail else "(empty)\n")


def last_report():
    """The newest stall report text, or None if no stall was seen."""
    with _report_lock:
        return _last_report


def _emit_report(report, path):
    global _last_report
    # file first, in-memory publish last: last_report() flipping
    # non-None is the signal readers key on, so every other artifact of
    # the report must already be visible when it does (same ordering
    # discipline as the stall counter below)
    if path:
        try:
            with open(path, "a") as f:
                f.write(report + "\n")
        except Exception:
            _LOG.debug("watchdog report write to %r failed", path,
                       exc_info=True)
    with _report_lock:
        _last_report = report
    _LOG.error("stall detected — report follows\n%s", report)


# ---------------------------------------------------------------- monitor
def _monitor(stop, quiet_default, poll_s, path):
    while not stop.wait(poll_s):
        try:
            now = time.perf_counter()
            newly_stalled = []
            for ch in _channel_snapshot().values():
                bound = ch.quiet_s if ch.quiet_s is not None \
                    else quiet_default
                if now - ch.last > bound:
                    if not ch.stalled:
                        ch.stalled = True      # once per stall episode
                        newly_stalled.append(ch.name)
                # (heartbeat() itself re-arms ch.stalled on resume)
            if newly_stalled:
                flightrec.record("watchdog_stall",
                                 channels=sorted(newly_stalled))
                _emit_report(_build_report(newly_stalled, quiet_default),
                             path)
                # counter LAST: anything keyed on mxtpu_watchdog_stalls_
                # total (tests, operator automation) must find the report
                # already published when the increment becomes visible
                for name in newly_stalled:
                    _STALLS.inc(channel=name)
        except Exception:
            # the diagnoser must outlive whatever it is diagnosing — but
            # a broken poll loop must not be silent either (R005)
            _LOG.debug("watchdog poll failed", exc_info=True)


def start(quiet_s=None, poll_s=None, path=None):
    """Start (or restart with new settings) the monitor thread. Defaults
    come from MXTPU_WATCHDOG_{QUIET_S,POLL_S,FILE}. Returns the thread."""
    from .. import config
    global _thread, _stop_event
    if quiet_s is None:
        quiet_s = config.get_env("MXTPU_WATCHDOG_QUIET_S")
    if poll_s is None:
        poll_s = config.get_env("MXTPU_WATCHDOG_POLL_S")
    if path is None:
        path = config.get_env("MXTPU_WATCHDOG_FILE")
    quiet_s = max(0.05, float(quiet_s))
    poll_s = max(0.01, float(poll_s))
    with _state_lock:
        _stop_locked()
        stop_ev = threading.Event()
        t = threading.Thread(target=_monitor,
                             args=(stop_ev, quiet_s, poll_s, path),
                             daemon=True, name="mxtpu-watchdog")
        _stop_event, _thread = stop_ev, t
        t.start()
    return t


def _stop_locked():
    global _thread, _stop_event
    stop_ev, t = _stop_event, _thread
    _stop_event = _thread = None
    if stop_ev is not None:
        stop_ev.set()
        if t is not None:
            t.join(timeout=5.0)


def stop():
    """Stop and join the monitor (R007: the daemon flag is a crash-exit
    backstop, not a lifecycle plan)."""
    with _state_lock:
        _stop_locked()


def running():
    t = _thread
    return t is not None and t.is_alive()
