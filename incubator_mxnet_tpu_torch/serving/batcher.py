"""Dynamic request batcher (counterpart of
``incubator_mxnet_tpu/serving/batcher.py``, TF-Serving BatchingSession
analog).

``replicas`` worker threads each own a BOUNDED dispatch queue and pull
single-item requests off it, dispatching a stacked batch when either
``max_batch_size`` requests are waiting or ``batch_timeout_ms`` has passed
since the first one (size-or-deadline coalescing). ``submit()`` routes to
the replica with the fewest requests queued plus in dispatch. Batches are
padded to a small set of bucket sizes (powers of two by default) by
repeating the last row, so the servable sees only a handful of shapes.
Replica i serves on ``cuda:(i % device_count)``: a dispatch callable that
declares a ``replica`` keyword receives the worker's replica index.

Contract:
- full queues → ``QueueFullError`` at submit time (explicit backpressure),
- per-request deadline → ``DeadlineExceededError`` for requests still
  queued when it passes (dropped before padding/dispatch),
- a raising servable fails its batch, not the worker,
- ``close(drain=True)`` stops intake, finishes everything queued, then
  joins every worker; ``drain=False`` fails what is queued.

Not ported from the JAX package: fault injection, spans, the flight
recorder, the stall watchdog, numerics taps and worker-death rerouting.
"""
from __future__ import annotations

import inspect
import queue as _queue
import threading
import time

import numpy as onp

from .. import config
from .metrics import ServingMetrics

__all__ = ["DynamicBatcher", "QueueFullError", "DeadlineExceededError",
           "ServingClosedError", "default_buckets", "replica_device"]


class QueueFullError(RuntimeError):
    """Overload rejection: every replica's bounded queue is at capacity."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it could be dispatched."""


class ServingClosedError(RuntimeError):
    """Submit after close(): the batcher is shutting down."""


def default_buckets(max_batch_size):
    """Powers of two up to (and always including) max_batch_size."""
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


def replica_device(replica):
    """The CUDA device replica ``replica`` serves on."""
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("replica %d needs a CUDA device; none is visible"
                           % replica)
    return torch.device("cuda", replica % n)


def _accepts_replica(fn):
    """True when ``fn`` declares an explicit ``replica`` parameter."""
    try:
        p = inspect.signature(fn).parameters.get("replica")
    except (TypeError, ValueError):
        return False
    return p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                        p.KEYWORD_ONLY)


class _Request:
    """One queued item + the completion event its client waits on."""

    __slots__ = ("inputs", "deadline", "enqueued_at", "_event", "_result",
                 "_error")

    def __init__(self, inputs, deadline):
        self.inputs = inputs            # tuple of per-input arrays, no batch dim
        self.deadline = deadline        # absolute time.monotonic() or None
        self.enqueued_at = time.monotonic()
        self._event = threading.Event()
        self._result = None
        self._error = None

    def succeed(self, result):
        self._result = result
        self._event.set()

    def fail(self, error):
        self._error = error
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block until the batch holding this request ran (or failed)."""
        if not self._event.wait(timeout):
            if self.deadline is not None and time.monotonic() >= self.deadline:
                raise DeadlineExceededError(
                    "deadline exceeded: no result after %.3fs" % timeout)
            raise TimeoutError("request not completed after %.3fs" % timeout)
        if self._error is not None:
            raise self._error
        return self._result


class DynamicBatcher:
    """Coalesce concurrent single-item requests into bucketed batches over
    ``replicas`` dispatch queues.

    ``servable`` is an object with ``predict_batch(*stacked) -> tuple of
    stacked outputs`` or a bare callable with that signature."""

    def __init__(self, servable, max_batch_size=None, batch_timeout_ms=None,
                 queue_size=None, buckets=None, default_deadline_ms=None,
                 metrics=None, name="model", replicas=None):
        self._dispatch_fn = getattr(servable, "predict_batch", servable)
        self._replica_aware = _accepts_replica(self._dispatch_fn)
        self.name = name
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else config.get_env("MXTPU_SERVE_MAX_BATCH"))
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else config.get_env("MXTPU_SERVE_TIMEOUT_MS"))
        qsize = int(queue_size if queue_size is not None
                    else config.get_env("MXTPU_SERVE_QUEUE_SIZE"))
        if qsize < 1:
            # Queue(maxsize=0) would be unbounded: no backpressure at all
            raise ValueError("queue_size must be >= 1 (got %d)" % qsize)
        self.queue_size = qsize
        n_rep = int(replicas if replicas is not None
                    else config.get_env("MXTPU_SERVE_REPLICAS"))
        if n_rep < 1:
            raise ValueError("replicas must be >= 1 (got %d)" % n_rep)
        self.replicas = n_rep
        self.default_deadline_ms = (
            default_deadline_ms if default_deadline_ms is not None
            else config.get_env("MXTPU_SERVE_DEADLINE_MS"))
        self.buckets = sorted(buckets) if buckets \
            else default_buckets(self.max_batch_size)
        if self.buckets[-1] < self.max_batch_size:
            self.buckets.append(self.max_batch_size)
        self.metrics = metrics if metrics is not None \
            else ServingMetrics(model=name)
        self._queues = [_queue.Queue(maxsize=qsize) for _ in range(n_rep)]
        self.metrics.queue_depth_fn = self.queue_depth
        self._route_lock = threading.Lock()
        self._inflight = [0] * n_rep
        self._rr = 0
        self._closed = False
        self._workers = [
            threading.Thread(target=self._run, args=(r,), daemon=True,
                             name="mxt-batcher-%s-r%d" % (name, r))
            for r in range(n_rep)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------ client side
    def _route(self):
        """Replica indices, fewest queued + in-dispatch first, ties
        rotated."""
        with self._route_lock:
            inflight = list(self._inflight)
            rr = self._rr
            self._rr += 1
        return sorted(range(self.replicas),
                      key=lambda r: (self._queues[r].qsize() + inflight[r],
                                     (r - rr) % self.replicas))

    def submit(self, *inputs, deadline_ms=None):
        """Enqueue one item (arrays WITHOUT the batch dim); returns a
        future-like request. Raises QueueFullError / ServingClosedError
        at once instead of blocking."""
        if self._closed:
            raise ServingClosedError("batcher %r is shut down" % self.name)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (time.monotonic() + max(0.0, deadline_ms) / 1000.0
                    if deadline_ms is not None else None)
        req = _Request(tuple(onp.asarray(x) for x in inputs), deadline)
        for r in self._route():
            try:
                self._queues[r].put_nowait(req)
                break
            except _queue.Full:
                continue
        else:
            self.metrics.inc("rejected_count")
            raise QueueFullError(
                "model %r: all %d replica queue(s) full (%d-deep each)"
                % (self.name, self.replicas, self.queue_size))
        # close() can win the race between the check above and the put; if
        # the workers are gone nobody services the request — fail it
        if self._closed and not self.alive:
            err = ServingClosedError("batcher %r is shut down" % self.name)
            req.fail(err)
            raise err
        self.metrics.inc("request_count")
        return req

    def predict(self, *inputs, deadline_ms=None, timeout=None):
        """Blocking convenience: submit + wait for the result tuple."""
        req = self.submit(*inputs, deadline_ms=deadline_ms)
        if timeout is None:
            timeout = self.result_timeout(req)
        return req.result(timeout)

    def result_timeout(self, req):
        """600 s, or for a request with a deadline its deadline plus one
        batch window."""
        timeout = 600.0
        if req.deadline is not None:
            timeout = min(timeout,
                          max(0.0, req.deadline - time.monotonic())
                          + self.batch_timeout_ms / 1000.0 + 0.05)
        return timeout

    def queue_depth(self):
        """Requests waiting across every replica queue."""
        return sum(q.qsize() for q in self._queues)

    @property
    def alive(self):
        return any(w.is_alive() for w in self._workers)

    def close(self, drain=True, timeout=30.0):
        """Refuse new requests, finish (drain) or fail the queued ones, and
        join every worker."""
        self._closed = True
        if not drain:
            self._fail_queued(ServingClosedError("server shutting down"))
        end = time.monotonic() + timeout
        for w in self._workers:
            w.join(max(0.0, end - time.monotonic()))
        # a submit racing this close can slip in after a worker's final
        # empty-queue check
        self._fail_queued(ServingClosedError("server shutting down"))

    def _fail_queued(self, err):
        for q in self._queues:
            while True:
                try:
                    q.get_nowait().fail(err)
                except _queue.Empty:
                    break

    # ------------------------------------------------------------ worker side
    def _gather(self, replica):
        """Block for the first request, then take more until
        max_batch_size or the batch window elapses."""
        q = self._queues[replica]
        try:
            first = q.get(timeout=0.25)   # bounds close() latency
        except _queue.Empty:
            return None
        batch = [first]
        window_end = time.monotonic() + self.batch_timeout_ms / 1000.0
        while len(batch) < self.max_batch_size:
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(q.get(timeout=remaining))
            except _queue.Empty:
                break
        return batch

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self, replica):
        while True:
            batch = self._gather(replica)
            if batch is None:
                if self._closed and self._queues[replica].empty():
                    return
                continue
            with self._route_lock:
                self._inflight[replica] += len(batch)
            try:
                self._process_batch(batch, replica)
            finally:
                with self._route_lock:
                    self._inflight[replica] -= len(batch)
                # a BaseException (KeyboardInterrupt) ends the worker; its
                # batch must not hang
                for req in batch:
                    if not req.done():
                        req.fail(ServingClosedError(
                            "batcher %r replica %d worker died"
                            % (self.name, replica)))

    def _process_batch(self, batch, replica):
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now >= req.deadline:
                self.metrics.inc("expired_count")
                req.fail(DeadlineExceededError(
                    "deadline passed while queued (model %r)" % self.name))
            else:
                live.append(req)
        # group by per-input shape/dtype: one malformed request must not
        # fail well-formed ones that shared its window
        groups = {}
        for req in live:
            sig = tuple((x.shape, x.dtype.str) for x in req.inputs)
            groups.setdefault(sig, []).append(req)
        for group in groups.values():
            self._dispatch(group, replica)

    def _dispatch(self, live, replica):
        n = len(live)
        bucket = self._bucket_for(n)
        try:
            stacked = tuple(
                onp.stack([r.inputs[i] for r in live]
                          + [live[-1].inputs[i]] * (bucket - n))
                for i in range(len(live[0].inputs)))
            t0 = time.monotonic()
            if self._replica_aware:
                outs = self._dispatch_fn(*stacked, replica=replica)
            else:
                outs = self._dispatch_fn(*stacked)
            if not isinstance(outs, (list, tuple)):
                outs = (outs,)
            outs = [onp.asarray(o) for o in outs]
            results = [tuple(o[j] for o in outs) for j in range(n)]
        except Exception as e:  # noqa: BLE001 — forwarded to every waiter
            self.metrics.inc("error_count", n)
            for req in live:
                req.fail(e)
            return
        done = time.monotonic()
        for req in live:
            self.metrics.observe_latency_ms((done - req.enqueued_at) * 1e3)
        self.metrics.inc("ok_count", n)
        self.metrics.observe_batch(n, bucket)
        # the port's requests carry no trace id yet
        self._profile_batch(n, bucket, done - t0, request_ids=None)
        for req, res in zip(live, results):
            req.succeed(res)

    def _profile_batch(self, n, bucket, dur, request_ids=None):
        """One profiler event for the dispatched batch (nothing unless the
        profiler runs): ``serve:<model>:batch<bucket>`` over the dispatch
        and its copy to the host, with the real item count. A failure here
        is the profiler's and never fails the batch."""
        try:
            from .. import profiler
            profiler.record_batch(self.name, n, bucket,
                                  start_us=profiler.now_us() - dur * 1e6,
                                  dur_us=dur * 1e6, request_ids=request_ids)
        except Exception:  # noqa: BLE001 — profiling never takes serving down
            pass
