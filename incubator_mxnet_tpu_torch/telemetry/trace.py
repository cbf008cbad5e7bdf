"""Request-scoped tracing: one ID per external request, carried from the
HTTP front-end through the batcher queue into the profiler's chrome-trace
events, so one slow request can be followed queue -> bucket -> device in a
single trace dump.

Counterpart of ``incubator_mxnet_tpu/telemetry/trace.py``, carried over
with it: the module reads no device.

The ID itself is a short opaque hex string. Propagation is explicit (the
serving ``_Request`` carries it through the worker-thread handoff — a
contextvar would be lost at the queue boundary), but a thread-local
*current* slot is kept for code that wants ambient access on the thread
that owns the request (e.g. user servables logging per-request).
"""
from __future__ import annotations

import os
import threading

__all__ = ["new_request_id", "REQUEST_ID_HEADER", "current_request_id",
           "set_current_request_id", "request_scope"]

#: HTTP header the serving front-end reads (client-supplied IDs win, so a
#: caller's existing trace context is preserved) and echoes on responses.
REQUEST_ID_HEADER = "X-Request-Id"

_local = threading.local()


def new_request_id():
    """16 hex chars from os.urandom — no global counter lock, no PRNG
    state shared with model seeding."""
    return os.urandom(8).hex()


def current_request_id():
    """The ambient request ID on this thread, or None."""
    return getattr(_local, "request_id", None)


def set_current_request_id(request_id):
    _local.request_id = request_id


class request_scope:
    """``with request_scope(rid):`` — sets the ambient ID, restoring the
    previous one on exit (nesting-safe for re-entrant serving paths)."""

    def __init__(self, request_id):
        self.request_id = request_id

    def __enter__(self):
        self._old = current_request_id()
        set_current_request_id(self.request_id)
        return self.request_id

    def __exit__(self, *exc):
        set_current_request_id(self._old)
