"""Dynamic request batcher (counterpart of
``incubator_mxnet_tpu/serving/batcher.py``; TF-Serving BatchingSession
analog, arXiv:1605.08695 §4.3: cross-request batching in front of a
compiled executable is how many small requests saturate an accelerator).

``replicas`` worker threads (default 1, ``MXTPU_SERVE_REPLICAS``) each own
a BOUNDED dispatch queue and pull single-item requests off it, dispatching
a stacked batch when either ``max_batch_size`` requests are waiting or
``batch_timeout_ms`` has passed since the first one — classic
size-or-deadline coalescing, times N data-parallel executors. A
least-depth router in ``submit()`` picks the replica with the fewest
requests queued-plus-in-dispatch (ties rotate), so aggregate goodput
scales with replicas while no replica piles up behind a slow batch
(docs/SERVING.md "Sharded serving"). Batches are padded up to a small set
of bucket sizes (powers of two by default) so the servable underneath
sees only a handful of shapes: a live Gluon block captures one CUDA
graph per bucket through jit.EvalStep and the shared ``aot`` cache.
Replica i serves on ``cuda:(i % device_count)`` (``replica_device``).

Replica-aware servables: when the dispatch callable accepts a ``replica``
keyword (the registry's dispatch closure does, forwarding to servables
whose ``predict_batch`` takes it — e.g. a ServedModel pinning each
replica's executable to its own mesh device), the worker passes its
replica index so each replica runs on its own chip. Plain servables are
called positionally, exactly as before.

Robustness contract:
- full queues -> ``QueueFullError`` raised at submit time after every
  live replica was tried (explicit backpressure; HTTP maps it to 429 —
  never unbounded latency),
- per-request deadline -> ``DeadlineExceededError`` for requests still
  queued when it passes (they are dropped BEFORE padding/dispatch),
- a DYING replica worker drains its queue back through the router:
  queued requests are re-routed to live replicas (or failed loudly when
  none remain), its depth gauge is detached, and the model keeps serving
  on the survivors — a dead replica must never strand requests until
  their deadline,
- ``close(drain=True)`` -> stops intake, finishes everything queued,
  then joins every worker.

Only worker threads touch the servable (and therefore the card), so
arbitrary many client threads can submit concurrently.

The telemetry is the JAX package's: the device-statistics dispatch
context (``devstats.dispatch_context``), the numerics sentinel's
``serve:outputs`` tap and shadow offer, spans, the flight
recorder, watchdog heartbeats, the ``batcher.dispatch`` faultlab site,
the dead-replica drain, ``respawn_replica`` and the single retry of a
replica-death failure.
"""
from __future__ import annotations

import inspect
import logging
import threading
import time
import queue as _queue

import numpy as onp

from .. import config
from ..telemetry import (devstats, faultlab, flightrec, numwatch, spans,
                         watchdog)
from ..telemetry.registry import counter as _counter
from .metrics import ServingMetrics

__all__ = ["DynamicBatcher", "QueueFullError", "DeadlineExceededError",
           "ServingClosedError", "NoReplicasError", "default_buckets",
           "replica_device"]

_LOG = logging.getLogger(__name__)

#: Idempotent predict requests re-routed after their replica worker died
#: (serving/resilience.py retry contract; docs/RESILIENCE.md).
_RETRIES = _counter(
    "mxtpu_retries_total",
    "Predict requests retried once after a replica worker death, by model.",
    ("model",))


class QueueFullError(RuntimeError):
    """Overload rejection: every live replica's bounded queue is at
    capacity."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it could be dispatched."""


class ServingClosedError(RuntimeError):
    """Submit after close(): the batcher is shutting down."""


class NoReplicasError(ServingClosedError):
    """Every replica worker is dead (or parked by the crash-loop
    breaker): nobody will ever service a submit. HTTP maps this to 503
    with shed_reason ``no_replicas`` and NO Retry-After — unlike 429
    queue_full there is no queue that drains; capacity returns only when
    the supervisor revives a worker (docs/RESILIENCE.md)."""


def default_buckets(max_batch_size):
    """Powers of two up to (and always including) max_batch_size."""
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


#: set by the "batcher.dispatch" faultlab site's nan_poison for the batch
#: this thread dispatches next
_POISON = threading.local()


def _poisoned(out):
    """A copy of a floating output with its first element NaN."""
    if not onp.issubdtype(out.dtype, onp.floating) or not out.size:
        return out
    out = onp.array(out)
    out.flat[0] = onp.nan
    return out


def replica_device(replica):
    """The CUDA device replica ``replica`` serves on."""
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("replica %d needs a CUDA device; none is visible"
                           % replica)
    return torch.device("cuda", replica % n)


def _accepts_replica(fn):
    """True when ``fn`` declares an explicit ``replica`` parameter (a bare
    **kwargs does NOT count — passing replica= to a servable that merely
    swallows it would silently drop the placement contract)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    p = sig.parameters.get("replica")
    return p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                        p.KEYWORD_ONLY)


class _Request:
    """One queued inference item + the completion event its client waits on."""

    __slots__ = ("inputs", "deadline", "enqueued_at", "request_id",
                 "span_ctx", "tenant", "dispatch", "retried", "_event",
                 "_result", "_error")

    def __init__(self, inputs, deadline, request_id=None, span_ctx=None,
                 tenant=None):
        self.inputs = inputs            # tuple of per-input arrays, NO batch dim
        self.deadline = deadline        # absolute time.monotonic() or None
        self.request_id = request_id    # trace id riding queue -> dispatch
        self.tenant = tenant            # accounting label riding alongside it
        # captured SpanContext of the submitter's open span (the HTTP
        # handler's http:predict): the explicit queue-boundary propagation
        # the worker parents its serve:queue/serve:batch spans onto
        self.span_ctx = span_ctx
        # dispatch facts the worker attaches before completing the request
        # ({replica, bucket, queue_ms, batch_ms, device_ms}) — what the
        # access-log record's batch-stage legs are assembled from; None
        # for requests that never reached a dispatch (shed, expired)
        self.dispatch = None
        # True once the request has been re-routed after a replica-death
        # failure: the retry contract is ONE bounded attempt, so a second
        # death fails it for good (serving/resilience.py)
        self.retried = False
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

    def result(self, timeout=None):
        """Block until the batch containing this request ran (or failed)."""
        if not self._event.wait(timeout):
            if (self.deadline is not None
                    and time.monotonic() >= self.deadline):
                raise DeadlineExceededError(
                    "deadline exceeded: no result after %.3fs (request "
                    "still queued or in flight)" % timeout)
            # deadline not (yet) passed: a plain caller-side wait timeout,
            # not a client-requested 504
            raise TimeoutError("request not completed after %.3fs" % timeout)
        if self._error is not None:
            raise self._error
        return self._result


class DynamicBatcher:
    """Coalesce concurrent single-item requests into bucketed batches over
    ``replicas`` data-parallel dispatch queues.

    ``servable`` is either an object with ``predict_batch(*stacked) ->
    tuple of stacked outputs`` or a bare callable with that signature
    (the registry passes its version-resolving dispatch closure here, so
    hot-reload swaps take effect at batch granularity). A dispatch
    callable declaring a ``replica`` keyword receives the dispatching
    worker's replica index (device placement hook).
    """

    def __init__(self, servable, max_batch_size=None, batch_timeout_ms=None,
                 queue_size=None, buckets=None, default_deadline_ms=None,
                 metrics=None, name="model", replicas=None):
        self._dispatch_fn = (servable.predict_batch
                             if hasattr(servable, "predict_batch")
                             else servable)
        self._replica_aware = _accepts_replica(self._dispatch_fn)
        self.name = name
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else config.get_env("MXTPU_SERVE_MAX_BATCH"))
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else config.get_env("MXTPU_SERVE_TIMEOUT_MS"))
        qsize = int(queue_size if queue_size is not None
                    else config.get_env("MXTPU_SERVE_QUEUE_SIZE"))
        if qsize < 1:
            # Queue(maxsize=0) would mean UNBOUNDED — silently deleting
            # the backpressure contract (and /healthz's >=80% threshold)
            raise ValueError(
                "queue_size must be >= 1 (got %d): the bounded queue IS "
                "the backpressure contract (MXTPU_SERVE_QUEUE_SIZE)" % qsize)
        self.queue_size = qsize         # per-replica bound
        n_rep = int(replicas if replicas is not None
                    else config.get_env("MXTPU_SERVE_REPLICAS"))
        if n_rep < 1:
            raise ValueError("replicas must be >= 1 (got %d) "
                             "(MXTPU_SERVE_REPLICAS)" % n_rep)
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
        self.metrics.queue_depth_fn = \
            lambda: sum(q.qsize() for q in self._queues)
        # the saturation line the history pressure predictor needs: the
        # trend toward "queue full" is only predictable if capacity is a
        # metric too
        self.metrics.set_queue_capacity(qsize * n_rep)
        # router state: per-replica in-dispatch counts, dispatch totals,
        # the dead set, and the tie-break rotation — one leaf lock, never
        # held while acquiring anything else
        self._route_lock = threading.Lock()
        self._inflight = [0] * n_rep        # handed to worker, not done
        self._dispatched = [0] * n_rep      # requests dispatched, ever
        self._dead = set()
        self._rr = 0
        self._replica_depth_fns = []
        for r in range(n_rep):
            fn = self._replica_depth_reader(r)
            self._replica_depth_fns.append(fn)
            self.metrics.bind_replica_depth(r, fn)
        # per-bucket dispatch-stage depth: requests gathered into a bucket
        # and not yet completed (padding + servable + slicing). Written by
        # workers, sampled by scrape threads at exposition time — its
        # own leaf lock, never held while acquiring anything else
        self._depth_lock = threading.Lock()
        self._bucket_depth = dict.fromkeys(self.buckets, 0)
        for b in self.buckets:
            self.metrics.bind_bucket_depth(b, self._bucket_depth_reader(b))
        self._closed = False
        self._paused = False
        # one bounded retry for requests orphaned by a dying worker
        # (docs/RESILIENCE.md "Retry idempotency contract")
        self._retry_on_death = bool(config.get_env("MXTPU_RESILIENCE_RETRY"))
        # per-item (shape, dtype) signature of the most recently dispatched
        # request — what a hot-reload prewarm synthesizes warm batches
        # from (registry.load); written by workers, read by warm/load
        # threads, hence its own lock
        self._sig_lock = threading.Lock()
        self._last_item_sig = None
        # stall-watchdog channels: each worker beats once per gather cycle
        # (<= 0.25s apart when idle), so silence means a stuck dispatch,
        # not an empty queue
        self._hb_channels = [
            watchdog.register("batcher:%s" % name if n_rep == 1
                              else "batcher:%s:r%d" % (name, r))
            for r in range(n_rep)]
        self._workers = [
            threading.Thread(target=self._run, args=(r,), daemon=True,
                             name="mxtpu-batcher-%s-r%d" % (name, r))
            for r in range(n_rep)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------ client side
    def _route(self):
        """Live replica indices, least-depth first (depth = queued +
        in-dispatch), ties rotated so equal-depth replicas share evenly."""
        with self._route_lock:
            live = [r for r in range(self.replicas) if r not in self._dead]
            inflight = {r: self._inflight[r] for r in live}
            rr = self._rr
            self._rr += 1
        live.sort(key=lambda r: (self._queues[r].qsize() + inflight[r],
                                 (r - rr) % self.replicas))
        return live

    def submit(self, *inputs, deadline_ms=None, request_id=None,
               tenant=None):
        """Enqueue one item (arrays WITHOUT the batch dim); returns a future-
        like _Request. Raises QueueFullError/ServingClosedError immediately
        instead of blocking — backpressure is the caller's signal to shed
        load upstream. ``request_id`` (assigned by the HTTP front-end or
        any caller) rides the queue and is emitted on the dispatch's
        profiler trace event, tying one request to its batch; ``tenant``
        (the clamped X-MXTPU-Tenant value) rides alongside it for the
        per-tenant accounting and the access-log record."""
        if self._closed or self._paused:
            raise ServingClosedError("batcher %r is shut down" % self.name)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        # NB `is not None`: deadline_ms=0 means expired-unless-dispatched-
        # immediately, not "no deadline"
        deadline = (time.monotonic() + max(0.0, deadline_ms) / 1000.0
                    if deadline_ms is not None else None)
        # materialize on the client thread: the worker groups requests by
        # shape/dtype signature, which needs real arrays
        req = _Request(tuple(onp.asarray(x) for x in inputs), deadline,
                       request_id=request_id,
                       span_ctx=spans.current_context(), tenant=tenant)
        order = self._route()
        if not order:
            # every replica worker died: nobody will ever service this —
            # a 503 (no_replicas), NOT a 429: there is no queue that
            # drains, so advertising retryability would be a lie
            raise NoReplicasError(
                "batcher %r has no live replica workers" % self.name)
        routed = None
        for r in order:
            try:
                self._queues[r].put_nowait(req)
                routed = r
                break
            except _queue.Full:
                continue
        if routed is None:
            try:
                self.metrics.inc("rejected_count")
            except Exception:
                pass
            raise QueueFullError(
                "model %r: all %d live replica queue(s) full "
                "(%d-deep each, %d replica(s) configured): rejecting — "
                "raise MXTPU_SERVE_QUEUE_SIZE, add replicas "
                "(MXTPU_SERVE_REPLICAS), or add capacity"
                % (self.name, len(order), self.queue_size,
                   self.replicas)) from None
        # the routed replica can die between _route() and the put — its
        # worker's drain may already have swept the queue, so sweep again
        # ourselves (idempotent; re-routes to survivors or fails loudly)
        with self._route_lock:
            landed_dead = routed in self._dead
        if landed_dead:
            self._reroute_queue(routed)
        # close() can win the race between the _closed check above and the
        # enqueue; if the workers are already gone nobody will ever service
        # this request — fail it instead of letting the client hang
        if self._closed and not self.alive:
            err = ServingClosedError("batcher %r is shut down" % self.name)
            req.fail(err)
            raise err
        # guarded like the worker-side updates: the request is already
        # enqueued — a telemetry failure here would error a client whose
        # work the worker still dispatches (result delivered to nobody)
        try:
            self.metrics.inc("request_count")
        except Exception:
            pass
        return req

    def predict(self, *inputs, deadline_ms=None, timeout=None,
                request_id=None, tenant=None):
        """Blocking convenience: submit + wait for the result tuple.

        A request with a deadline never waits (much) past it: the wait is
        capped at deadline + one batch window, so a client behind a stuck
        batch gets DeadlineExceededError at its deadline instead of
        hanging — the worker-side check then drops the stale entry when it
        finally dequeues it."""
        req = self.submit(*inputs, deadline_ms=deadline_ms,
                          request_id=request_id, tenant=tenant)
        if timeout is None:
            timeout = self.result_timeout(req)
        return req.result(timeout)

    def result_timeout(self, req):
        """The bounded wait predict() applies to one submitted request:
        600 s absolute cap, or — for a request with a deadline — the
        deadline plus one batch window, so a client behind a stuck batch
        errors at its deadline instead of hanging. Exposed so callers
        that need the _Request itself (the HTTP front-end assembling
        access-log records) can reproduce predict()'s wait exactly."""
        timeout = 600.0
        if req.deadline is not None:
            timeout = min(timeout,
                          max(0.0, req.deadline - time.monotonic())
                          + self.batch_timeout_ms / 1000.0 + 0.05)
        return timeout

    def queue_depth(self):
        """Requests waiting across every replica queue (not yet gathered)."""
        return sum(q.qsize() for q in self._queues)

    @property
    def total_queue_size(self):
        """Aggregate queue capacity (per-replica bound x replicas) — the
        denominator /healthz's >=80% occupancy check uses."""
        return self.queue_size * self.replicas

    def _bucket_depth_reader(self, bucket):
        """Sampler closure for one bucket's dispatch-stage depth gauge."""
        def read():
            with self._depth_lock:
                return self._bucket_depth.get(bucket, 0)
        return read

    def _replica_depth_reader(self, replica):
        """Sampler closure for one replica's depth gauge: queued + handed
        to its worker and not yet completed — the router's signal, so the
        scrape shows exactly what routing decisions are made on."""
        def read():
            with self._route_lock:
                inflight = self._inflight[replica]
            return self._queues[replica].qsize() + inflight
        return read

    def bucket_depths(self):
        """{bucket -> in-dispatch request count} snapshot (test hook; the
        scrape surface is the mxtpu_serving_bucket_queue_depth gauge)."""
        with self._depth_lock:
            return dict(self._bucket_depth)

    def replica_depths(self):
        """[queued + in-dispatch per replica] snapshot (test hook; the
        scrape surface is mxtpu_serving_replica_queue_depth)."""
        return [fn() for fn in self._replica_depth_fns]

    def replica_dispatch_counts(self):
        """[requests dispatched per replica, cumulative] — the balance
        proof (mirrored on mxtpu_serving_replica_dispatch_total)."""
        with self._route_lock:
            return list(self._dispatched)

    def dead_replicas(self):
        with self._route_lock:
            return sorted(self._dead)

    def respawn_replica(self, replica):
        """Bring one dead replica worker back: a fresh thread on the
        SAME queue, a fresh watchdog channel, the depth gauge re-bound,
        and the replica removed from the router's dead set — the
        supervisor's repair verb (serving/resilience.py). Returns False
        (no-op) when the batcher is closed or the replica is not dead."""
        if self._closed:
            return False
        with self._route_lock:
            if replica not in self._dead:
                return False
            self._dead.discard(replica)
        # fresh heartbeat channel: the dying worker unregistered its old
        # one, and the watchdog must see the reborn worker's beats under
        # the same name
        self._hb_channels[replica] = watchdog.register(
            "batcher:%s" % self.name if self.replicas == 1
            else "batcher:%s:r%d" % (self.name, replica))
        try:
            self.metrics.bind_replica_depth(
                replica, self._replica_depth_fns[replica])
        except Exception:
            _LOG.debug("replica depth gauge rebind failed", exc_info=True)
        w = threading.Thread(target=self._run, args=(replica,), daemon=True,
                             name="mxtpu-batcher-%s-r%d"
                             % (self.name, replica))
        self._workers[replica] = w
        w.start()
        flightrec.record("replica_respawned", model=self.name,
                         replica=replica)
        return True

    @property
    def last_item_sig(self):
        """Per-item ((shape, dtype), ...) of the newest dispatched request,
        or None before any dispatch — the observed signature hot-reload
        prewarm builds synthetic warm batches from."""
        with self._sig_lock:
            return self._last_item_sig

    def pause_intake(self):
        """Reject new submits (ServingClosedError) while the workers keep
        draining what's queued — the unload-last-version drain uses this.
        Unlike close(), fully reversible via resume_intake()."""
        self._paused = True

    def resume_intake(self):
        self._paused = False

    @property
    def alive(self):
        """True while at least one replica worker can still dispatch."""
        return any(w.is_alive() for w in self._workers)

    @property
    def closed(self):
        return self._closed

    def close(self, drain=True, timeout=30.0):
        """Graceful shutdown: refuse new requests, optionally finish the
        queued ones, join every worker. With drain=False queued requests
        fail with ServingClosedError."""
        self._closed = True
        if not drain:
            self._fail_queued(ServingClosedError("server shutting down"))
        deadline = time.monotonic() + timeout
        for w in self._workers:
            w.join(max(0.0, deadline - time.monotonic()))
        # a submit racing this close can slip a request in after a
        # worker's final empty-queue check; fail any such leftovers so no
        # client waits on a queue nobody services
        self._fail_queued(ServingClosedError("server shutting down"))
        # unbind the queue-depth gauge callbacks from the shared telemetry
        # registry (they would otherwise pin this batcher's queues forever
        # and export stale series for an unloaded model)
        try:
            self.metrics.detach_telemetry()
        except Exception:
            pass
        # the same for the device gauges, the numerics sentinel's series
        # and shadow, the SLO engine's gauges and the history rings: an
        # unloaded model must not export frozen series
        from ..telemetry import history, slo
        for detach in (devstats.detach_model, numwatch.detach_model,
                       slo.REGISTRY.detach_model, history.detach_model):
            try:
                detach(self.name)
            except Exception:
                _LOG.debug("telemetry detach of %r failed", self.name,
                           exc_info=True)

    def _fail_queued(self, err):
        for q in self._queues:
            while True:
                try:
                    req = q.get_nowait()
                except _queue.Empty:
                    break
                req.fail(err)

    # ------------------------------------------------------------ worker side
    def _gather(self, replica):
        """Collect the next batch off this replica's queue: block for the
        first request, then keep taking until max_batch_size or the batch
        window elapses."""
        q = self._queues[replica]
        try:
            # the poll period only bounds close() latency — keep it coarse
            # so idle models cost ~4 wakeups/s per replica, not 20
            first = q.get(timeout=0.25)
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
        died = True
        try:
            self._run_loop(replica)
            died = False
        except BaseException:
            # the loop body already contains the request-failing guards;
            # anything escaping it is a worker-killing defect — log it,
            # then hand this replica's queue back to the router below
            _LOG.error("batcher %r replica %d worker died",
                       self.name, replica, exc_info=True)
        finally:
            # a cleanly-exiting (or dying) worker must not read as a
            # stall: silence from a gone thread is unregistered, silence
            # from a live-but-stuck one is the watchdog's signal
            watchdog.unregister(self._hb_channels[replica])
            if died and not self._closed:
                self._drain_dead_replica(replica)

    def _fail_or_retry_on_death(self, req, replica, err):
        """Completion path for a request held by a dying worker: one
        bounded retry for idempotent predicts (MXTPU_RESILIENCE_RETRY),
        else fail now.

        The retry re-enters the DYING replica's own queue: the death
        path's _reroute_queue sweep (the existing drain-back machinery)
        then carries it to a survivor — or fails it loudly as
        NoReplicasError when none remain. The request keeps its original
        deadline, so a retry can never outlive the client's budget, and
        the ``retried`` flag bounds it to one attempt (a second death
        fails it for good).

        Deaths that originated INSIDE the servable call are never
        retried: the request's own content is the prime suspect (a query
        of death), and re-dispatching it serially kills the survivors —
        the drains-back contract (test_serving_sharded) is that one
        poison request costs one replica while every innocent request
        completes. Only exogenous deaths (the worker killed around the
        dispatch: injection, runtime faults in the batcher's own
        machinery) are safe to re-route."""
        if (self._retry_on_death and not req.retried and not self._closed
                and not getattr(err, "_mxtpu_died_in_servable", False)
                and not (req.deadline is not None
                         and time.monotonic() >= req.deadline)):
            req.retried = True
            try:
                self._queues[replica].put_nowait(req)
            except _queue.Full:
                # a dying replica with a FULL queue: nothing to absorb
                # the retry into without displacing someone — fail below
                _LOG.debug("retry of request %r dropped: queue full",
                           req.request_id)
            else:
                try:
                    _RETRIES.inc(model=self.name)
                except Exception:
                    _LOG.debug("retry counter update failed", exc_info=True)
                flightrec.record("request_retried", model=self.name,
                                 replica=replica,
                                 request_id=req.request_id)
                return
        if getattr(err, "_mxtpu_died_in_servable", False):
            # query of death: the sender gets the servable's own defect,
            # raw — the pre-resilience drains-back contract (the HTTP
            # front-end maps a raw worker-killing BaseException to 503)
            req.fail(err)
            return
        # an exogenous BaseException (injected WorkerKilled, MemoryError
        # in the batcher's own machinery) must not ride a _Request into
        # an arbitrary client thread / the HTTP handler's `except
        # Exception` ladder — surface worker death as the
        # servable-unavailable error it is
        req.fail(err if isinstance(err, Exception) else ServingClosedError(
            "model %r replica %d worker died mid-dispatch (%s)"
            % (self.name, replica, err)))

    def _drain_dead_replica(self, replica):
        """Death path: mark the replica dead so the router skips it,
        detach its depth gauge (a dead replica must not export a frozen
        depth), and re-route everything sitting in its queue — mirror of
        the detach-on-close contract, at replica granularity."""
        with self._route_lock:
            self._dead.add(replica)
        flightrec.record("replica_died", model=self.name, replica=replica)
        try:
            self.metrics.detach_replica_depth(
                self._replica_depth_fns[replica])
        except Exception:
            _LOG.debug("replica depth gauge detach failed", exc_info=True)
        self._reroute_queue(replica)

    def _reroute_queue(self, replica):
        """Drain one (dead) replica's queue back through the router."""
        q = self._queues[replica]
        while True:
            try:
                req = q.get_nowait()
            except _queue.Empty:
                break
            rerouted = False
            for r in self._route():
                try:
                    self._queues[r].put_nowait(req)
                    rerouted = True
                    break
                except _queue.Full:
                    continue
            if not rerouted:
                # no live replica (or all full): fail loudly NOW — a
                # request must never sit in a dead replica's queue until
                # its deadline expires it
                req.fail(NoReplicasError(
                    "model %r replica %d worker died and no live replica "
                    "could absorb its queue" % (self.name, replica)))

    def _run_loop(self, replica):
        while True:
            watchdog.heartbeat(self._hb_channels[replica])
            batch = self._gather(replica)
            if batch is None:
                if self._closed and self._queues[replica].empty():
                    return
                continue
            with self._route_lock:
                self._inflight[replica] += len(batch)
            try:
                with devstats.LAUNCH_GATE.shared():
                    self._process_batch(batch, replica)
            except BaseException as e:
                # a worker-killing defect (BaseException escaping the
                # per-batch Exception guards) must still answer the batch
                # it was holding — clients of a dying replica get the
                # error now (or one bounded retry), not a timeout at
                # their deadline
                for req in batch:
                    if not req._event.is_set():
                        self._fail_or_retry_on_death(req, replica, e)
                raise
            finally:
                with self._route_lock:
                    self._inflight[replica] -= len(batch)

    def _process_batch(self, batch, replica):
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now >= req.deadline:
                try:
                    self.metrics.inc("expired_count")
                except Exception:
                    # telemetry failure must not fail the request path,
                    # but the dropped increment is debug-visible (R005)
                    _LOG.debug("expired_count update failed",
                               exc_info=True)
                req.fail(DeadlineExceededError(
                    "deadline passed while queued (model %r)" % self.name))
            else:
                live.append(req)
        if not live:
            return
        # group by per-input shape/dtype signature: one client's
        # malformed request must not fail well-formed requests that
        # happened to share its gather window (cross-client isolation);
        # homogeneous traffic stays one group = one dispatch
        groups = {}
        for req in live:
            sig = tuple((x.shape, x.dtype.str) for x in req.inputs)
            groups.setdefault(sig, []).append(req)
        for group in groups.values():
            self._dispatch_replica(group, replica)

    def _dispatch_replica(self, live, replica):
        """Pad one shape-homogeneous group to its bucket, dispatch it on
        this replica, and deliver results (or one shared error) to every
        waiter — the per-replica dispatch hot path (mxtpulint
        HOT_PATH_PATTERNS covers it)."""
        if faultlab.armed:
            # faultlab site "batcher.dispatch": an injected FaultInjected
            # fails just this group (real-servable-raise semantics, the
            # worker survives); WorkerKilled and anything else propagate
            # into _run_loop's worker-death path
            try:
                # nan_poison: this batch's outputs get a NaN (the site's
                # corruption), which the numerics tap then sees
                _POISON.value = faultlab.fire(
                    "batcher.dispatch", model=self.name,
                    replica=replica) == "nan_poison"
            except faultlab.FaultInjected as e:
                try:
                    self.metrics.inc("error_count", len(live))
                except Exception:
                    _LOG.debug("error_count update failed", exc_info=True)
                for req in live:
                    req.fail(e)
                return
        n = len(live)
        bucket = self._bucket_for(n)
        t0 = time.monotonic()
        request_ids = [r.request_id for r in live
                       if r.request_id is not None]
        with self._depth_lock:
            self._bucket_depth[bucket] = self._bucket_depth.get(bucket, 0) + n
        with self._route_lock:
            self._dispatched[replica] += n
        try:
            self.metrics.inc_replica_dispatch(replica, n)
        except Exception:
            pass
        try:
            self._dispatch_bucketed(live, n, bucket, t0, replica,
                                    request_ids)
        finally:
            with self._depth_lock:
                self._bucket_depth[bucket] -= n

    def _dispatch_bucketed(self, live, n, bucket, t0, replica, request_ids):
        with self._sig_lock:
            self._last_item_sig = tuple((x.shape, x.dtype.str)
                                        for x in live[0].inputs)
        self._trace_queue_waits(live, t0)
        flightrec.record("batch_dispatch", model=self.name, n=n,
                         bucket=bucket, replica=replica)
        # live span on the worker thread: the servable (and, for a
        # BlockServable, EvalStep's eval:step span) nests inside it. A
        # batch has many logical parents — the span parents onto the
        # OLDEST request's captured context; the rest stay findable via
        # args.request_ids.
        with spans.span("serve:batch", parent=live[0].span_ctx,
                        model=self.name, bucket=bucket, batch_size=n,
                        replica=replica, request_ids=request_ids):
            self._dispatch_batch_traced(live, n, bucket, t0, replica,
                                        request_ids)

    def _trace_queue_waits(self, live, t0):
        """Retroactive serve:queue child spans, one per request: queue
        wait is only measurable at dispatch, after the submitting thread
        has long moved on — the record_span queue-boundary form (no
        thread-local stack is touched)."""
        try:
            from .. import profiler
            now_us = profiler.now_us()
            for req in live:
                wait_s = max(0.0, t0 - req.enqueued_at)
                spans.record_span("serve:queue", now_us - wait_s * 1e6,
                                  wait_s * 1e6, parent=req.span_ctx,
                                  request_id=req.request_id,
                                  model=self.name)
        except Exception:
            # tracing must never take down serving, but a queue-wait
            # trace that silently stops emitting is undiagnosable (R005
            # discipline): keep the drop debug-visible
            _LOG.debug("serve:queue span emission failed", exc_info=True)

    def _call_servable(self, stacked, replica, request_ids):
        """The one servable call site: per-replica ``serve:dispatch`` span
        (the loadgen span-join attributes device time per replica off its
        ``replica`` arg; ``request_ids`` make it joinable per request),
        replica kwarg forwarded when the servable declares it."""
        with spans.span("serve:dispatch", model=self.name, replica=replica,
                        batch=int(stacked[0].shape[0]) if stacked else 0,
                        request_ids=request_ids), \
                devstats.dispatch_context(self.name, replica):
            if self._replica_aware:
                return self._dispatch_fn(*stacked, replica=replica)
            return self._dispatch_fn(*stacked)

    def _note_dispatch(self, live, bucket, replica, t0, call_s):
        """Attach the per-request dispatch facts the access-log record is
        assembled from (server.py): queue wait (enqueue -> gather), batch
        time (gather -> now: pad + servable + slice), and the servable
        call's own duration (the device leg: the forward and its copy to
        the host). Set BEFORE succeed()/fail()
        so the completion event's happens-before makes them visible to
        the client thread."""
        now = time.monotonic()
        for req in live:
            req.dispatch = {
                "replica": replica, "bucket": bucket,
                "queue_ms": max(0.0, t0 - req.enqueued_at) * 1e3,
                "batch_ms": (now - t0) * 1e3,
                "device_ms": call_s * 1e3 if call_s is not None else None}

    def _dispatch_batch_traced(self, live, n, bucket, t0, replica,
                               request_ids):
        call_s = None
        try:
            # pad by repeating the last row: always shape/dtype-consistent,
            # never introduces out-of-range values. A raising servable must
            # fail THIS batch, not kill the worker thread.
            stacked = tuple(
                onp.stack([r.inputs[i] for r in live]
                          + [live[-1].inputs[i]] * (bucket - n))
                for i in range(len(live[0].inputs)))
            # timer brackets the servable call ONLY: host-side pad/stack
            # time belongs to the batch leg, not the device_ms fact
            tc0 = time.monotonic()
            # the numerics sentinel's stride-sampled tap over the outputs:
            # a BlockServable reduces them on the card before its copy to
            # the host (numwatch.device_tap), adding no host synchronise
            tap = numwatch.tapping(self.name, "serve:outputs")
            try:
                with tap:
                    outs = self._call_servable(stacked, replica,
                                               request_ids)
            except BaseException as e:
                if not isinstance(e, Exception):
                    # a worker-killing BaseException escaping the servable
                    # ITSELF is request-correlated until proven otherwise
                    # (a query of death): mark it so the death path fails
                    # this batch instead of retrying the killer onto a
                    # survivor — one poison request must cost one replica,
                    # not the fleet
                    e._mxtpu_died_in_servable = True
                raise
            call_s = time.monotonic() - tc0
        except Exception as e:  # noqa: BLE001 — forwarded to every waiter
            try:
                self.metrics.inc("error_count", n)
            except Exception:
                pass
            self._note_dispatch(live, bucket, replica, t0, call_s)
            for req in live:
                req.fail(e)
            return
        dur = time.monotonic() - t0
        try:
            # normalize + slice BEFORE delivering anything: malformed
            # servable output (scalar, short dim 0, ragged) must fail the
            # batch loudly, not kill the worker or deliver to only some
            # waiters
            if not isinstance(outs, (list, tuple)):
                outs = (outs,)
            # results land on the host here (a BlockServable already
            # copied them): they are sliced per request and handed to
            # client threads and HTTP JSON
            outs = [onp.asarray(o) for o in outs]
            if getattr(_POISON, "value", False):
                _POISON.value = False
                outs = [_poisoned(o) for o in outs]
                tap.bundle = None       # the tap reads the poisoned outputs
            results = [tuple(o[j] for o in outs) for j in range(n)]
            tap.finish(outs)
        except Exception as e:  # noqa: BLE001 — forwarded to every waiter
            try:
                self.metrics.inc("error_count", n)
            except Exception:
                pass
            self._note_dispatch(live, bucket, replica, t0, call_s)
            for req in live:
                req.fail(e)
            return
        done = time.monotonic()
        # instrument BEFORE delivering: a client unblocks the moment
        # succeed() fires, and a scrape right after a response must see
        # this batch's counters and trace event already recorded. Guarded:
        # a telemetry failure (misconfigured registry bound, -W error)
        # must neither kill the worker nor leave the waiters hanging.
        try:
            for req in live:
                self.metrics.observe_latency_ms(
                    (done - req.enqueued_at) * 1000.0)
            self.metrics.inc("ok_count", n)
            self.metrics.observe_batch(n, bucket)
        except Exception:
            pass
        self._profile_batch(n, bucket, dur, request_ids)
        self._note_dispatch(live, bucket, replica, t0, call_s)
        for j, req in enumerate(live):
            req.succeed(results[j])
        # shadow sampling after delivery: a full shadow queue drops the
        # sample, never delays the response
        numwatch.shadow_offer(self.name, stacked, outs)

    def _profile_batch(self, n, bucket, dur, request_ids=None):
        """Per-batch hook into the framework profiler (no-op unless
        profiler.set_state('run')). ``request_ids`` — the trace ids of the
        live requests in the batch — land as an event arg, so one HTTP
        request is findable queue -> bucket -> device in the trace dump."""
        try:
            from .. import profiler
            # epoch-anchored monotonic us (profiler.now_us — NTP-step safe)
            profiler.record_batch(self.name, n, bucket,
                                  start_us=profiler.now_us() - dur * 1e6,
                                  dur_us=dur * 1e6,
                                  request_ids=request_ids)
        except Exception:  # profiling must never take down serving
            pass
