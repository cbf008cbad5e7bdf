"""Shared bounded-ring machinery for the diagnostics buffers (the span
ring and the flight recorder).

Counterpart of ``incubator_mxnet_tpu/telemetry/ringbuf.py``, carried over
with it: the module reads no device.

One design, two users: a ``deque(maxlen=...)`` sized lazily from a typed
config knob, GIL-atomic lock-free appends (writers never block and never
raise into the instrumented path — a malformed env value degrades to a
dropped record, not a crashed train step), and a retry-on-mutation
snapshot so readers never block writers either.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["BoundedRing"]


class BoundedRing:
    """Lock-cheap bounded event ring sized by a config env var.

    - ``append`` is the hot-path write: deque.append under the GIL, no
      lock, and exception-proof (the ring must never be able to fail the
      path it observes — first use parses the env knob, which can raise).
    - ``snapshot`` copies without locking writers out: a concurrent
      append can invalidate the iteration (RuntimeError), so it retries
      a few times and degrades to [] rather than stalling anyone.
    - ``reset`` drops the buffer AND re-reads the size knob (test
      isolation).
    """

    def __init__(self, size_env_var, min_size=1):
        self._size_env_var = size_env_var
        self._min_size = min_size
        self._create_lock = threading.Lock()   # guards (re)creation only
        self._ring = None

    def _get(self):
        if self._ring is None:
            from .. import config
            with self._create_lock:
                if self._ring is None:
                    self._ring = deque(maxlen=max(
                        self._min_size,
                        config.get_env(self._size_env_var)))
        return self._ring

    def append(self, item):
        try:
            self._get().append(item)
        except Exception:
            pass        # never raise into the instrumented path

    def snapshot(self):
        ring = self._ring
        if ring is None:
            return []
        for _ in range(8):
            try:
                return list(ring)
            except RuntimeError:    # deque mutated mid-iteration: retry
                continue
        return []

    def __len__(self):
        ring = self._ring
        return len(ring) if ring is not None else 0

    def reset(self):
        with self._create_lock:
            self._ring = None
