"""Serving counters (counterpart of
``incubator_mxnet_tpu/serving/metrics.py``): monotonic counters, the
dispatched batch-size histogram and request latency percentiles from a
bounded ring buffer. The JAX package mirrors every update onto its
process-wide telemetry registry; the port has no telemetry yet."""
from __future__ import annotations

import math
import threading
from collections import deque

__all__ = ["ServingMetrics", "percentile"]


def percentile(sorted_values, q):
    """Nearest-rank percentile of an ascending-sorted sequence (q in
    0..100); None for an empty one."""
    if not sorted_values:
        return None
    n = len(sorted_values)
    q = min(max(float(q), 0.0), 100.0)
    rank = int(math.ceil(n * q / 100.0 - 1e-9))
    return sorted_values[min(max(rank, 1), n) - 1]


class ServingMetrics:
    """Thread-safe per-model counters, batch histogram and latency ring.

    Latency is end-to-end request time (enqueue → result ready)."""

    _COUNTERS = ("request_count", "ok_count", "error_count",
                 "rejected_count", "expired_count")

    def __init__(self, latency_window=4096, model="model"):
        self._lock = threading.Lock()
        self.model = model
        self.request_count = 0        # accepted into the queue
        self.ok_count = 0
        self.error_count = 0          # dispatch raised
        self.rejected_count = 0       # queue full (backpressure)
        self.expired_count = 0        # deadline passed while queued
        self.batch_count = 0          # dispatches
        self.batched_items = 0        # real (non-padding) items dispatched
        self.padded_items = 0         # padding rows added to reach a bucket
        self.batch_size_hist = {}     # real batch size -> count
        self._latencies_ms = deque(maxlen=latency_window)
        self.queue_depth_fn = None    # injected by the batcher

    def inc(self, counter, n=1):
        if counter not in self._COUNTERS:
            raise KeyError("unknown counter %r" % counter)
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def observe_batch(self, size, bucket):
        with self._lock:
            self.batch_count += 1
            self.batched_items += size
            self.padded_items += bucket - size
            self.batch_size_hist[size] = self.batch_size_hist.get(size, 0) + 1

    def observe_latency_ms(self, ms):
        with self._lock:
            self._latencies_ms.append(ms)

    def latency_percentiles_ms(self, qs=(50, 95, 99)):
        with self._lock:
            ordered = sorted(self._latencies_ms)
        return {"p%d" % q: percentile(ordered, q) for q in qs}

    def snapshot(self):
        """One JSON-able dict with every counter, the histogram and
        p50/p95/p99."""
        with self._lock:
            out = {name: getattr(self, name) for name in self._COUNTERS}
            out.update({
                "batch_count": self.batch_count,
                "batched_items": self.batched_items,
                "padded_items": self.padded_items,
                "batch_size_hist": dict(self.batch_size_hist),
                "mean_batch_size": (self.batched_items / self.batch_count
                                    if self.batch_count else 0.0),
                "latency_window": len(self._latencies_ms),
            })
        out["latency_ms"] = self.latency_percentiles_ms()
        if self.queue_depth_fn is not None:
            out["queue_depth"] = self.queue_depth_fn()
        return out
