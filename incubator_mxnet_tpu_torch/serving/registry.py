"""Multi-model registry: named, versioned servables behind one batcher each
(counterpart of ``incubator_mxnet_tpu/serving/registry.py``; TF-Serving
ServerCore/ModelManager analog).

A *servable* is anything with ``predict_batch(*stacked_inputs) -> tuple of
stacked outputs``, or a live Gluon block, which ``load`` wraps in
``BlockServable`` (``jit.EvalStep``: one captured CUDA graph per bucket on
the card). ``load()`` on an existing name installs a new version and
repoints dispatch; batches in flight finish on the old servable, and
``unload(..., drain=True)`` waits for them.

Prewarmed hot reload (``MXTPU_AOT_PREWARM``): when a per-item input
signature is known (``warm_spec``, or the batcher's observed one) the
incoming version is registered un-routed and a background warm thread
runs every configured (bucket x replica) pair of it, smallest bucket
first, so each bucket's graph is captured before traffic reaches it.
Dispatch cuts over after the first bucket, as in the JAX package, with
one departure: until its warm has finished, a batch whose bucket the
incoming version has not warmed yet still goes to the version that was
serving (``_ModelEntry._route``). The JAX package lets such a batch
compile on the worker (single-flight with the warm); a capture is a
stall of the same kind, and the port keeps it off the request path:
after a prewarmed load no batcher worker captures (ROADMAP §3,
departures). A version that goes releases its graphs from the ``aot``
cache (``BlockServable.release``).

Resilience, as in the JAX package: ``set_degraded`` with last-known-good
rollback (``MXTPU_RESILIENCE_ROLLBACK``), ``health()``, and the
``batchers()``/``engines()`` scan surface of ``resilience.Supervisor``;
generators (``load_generator``) are served beside the models.

Not here: the JAX package's hlolint and hlodiff load gates read the
StableHLO of persisted artifacts and have no analog in the port (a
departure, ROADMAP §3), so ``MXTPU_HLOLINT_GATE`` is not read. Numerics shadows
(``register_shadow``) are ``telemetry.numwatch``'s, as in the JAX
package. A ``contrib.serving.ServedModel`` (an exported artifact) is a
servable like any other: its ``predict_batch`` re-chunks each bucket
onto its exported batch, and a prewarm captures its one program.
"""
from __future__ import annotations

import logging
import threading
import time

import torch

from .. import config
from ..gluon.block import Block
from ..jit import EvalStep, net_device
from ..telemetry import devstats, faultlab, flightrec, numwatch, spans
from .batcher import (DynamicBatcher, ServingClosedError, _accepts_replica,
                      replica_device)
from .metrics import ServingMetrics

__all__ = ["ModelRegistry", "BlockServable", "ModelNotFoundError"]

_LOG = logging.getLogger(__name__)


def _seed_slos(name):
    """The model's default SLOs (availability; latency too when
    ``MXTPU_SLO_LATENCY_MS`` is set), from its first load, so /debug/slo
    and the budget gauges carry it before any request; the batcher's or
    the engine's close detaches them. A misconfigured objective must not
    make the model unloadable, so a failure is logged, not raised."""
    from ..telemetry import slo
    try:
        slo.REGISTRY.ensure_model(name)
    except (ValueError, TypeError, KeyError):
        _LOG.debug("SLO seeding for model %r failed", name, exc_info=True)


class ModelNotFoundError(KeyError):
    """Unknown model name (or version); HTTP maps this to 404."""


class BlockServable:
    """Serve a live, initialized Gluon block through ``jit.EvalStep``.

    A net on the CPU serves every replica on the CPU. A net on a CUDA
    device serves replica i on ``cuda:(i % device_count)``, through a copy
    of the net made on that device at first use (replicas that land on one
    device share one step, and so its graphs).

    Deliberate difference from the JAX package's ``BlockServable``: outputs
    in bfloat16 come back as float32 numpy arrays, because numpy has no
    bfloat16 type here. Every bfloat16 value is exact in float32. Other
    types come back unchanged.
    """

    def __init__(self, net, model_id=None):
        self._net = net
        self._model_id = model_id
        self._steps = {net_device(net): EvalStep(net, model_id=model_id)}
        self._lock = threading.Lock()

    def _step(self, replica):
        device = net_device(self._net)
        if device.type == "cuda":
            device = replica_device(replica)
        with self._lock:
            step = self._steps.get(device)
            if step is None:
                import copy
                step = EvalStep(copy.deepcopy(self._net).to(device),
                                model_id=self._model_id)
                self._steps[device] = step
        return step

    def predict_batch(self, *stacked_inputs, replica=0):
        out = self._step(replica)._run(*stacked_inputs)
        outs = out if isinstance(out, tuple) else (out,)
        numwatch.device_tap(outs)
        return tuple(_to_host(o) for o in outs)

    def release(self):
        """Drop this servable's graphs from the ``aot`` cache."""
        with self._lock:
            steps = list(self._steps.values())
        for step in steps:
            step.release()


def _to_host(t):
    """``t`` as a numpy array, bfloat16 widened to float32. From the card
    a bfloat16 output crosses in its own width into pinned host memory
    (the caching host allocator's, reused batch to batch) and is widened
    on the host: half the bytes of widening on the card first, and none
    of a pageable copy's staging. Widening is exact either way."""
    if t.device.type == "cuda" and t.dtype == torch.bfloat16:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.float().numpy()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _as_servable(obj):
    if hasattr(obj, "predict_batch"):
        return obj
    if isinstance(obj, Block):
        return BlockServable(obj)
    raise TypeError("not a servable: %r (need predict_batch() or a Gluon "
                    "block)" % (obj,))


class _ModelEntry:
    """One name: version -> servable map, its batcher and in-flight
    accounting."""

    def __init__(self, name, **batcher_kw):
        self.name = name
        self.versions = {}
        self.current_version = None
        self.metrics = ServingMetrics(model=name)
        _seed_slos(name)
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._inflight = {}             # version -> dispatched-batch count
        self._replica_aware = {}        # version -> predict_batch(replica=)?
        self._warming = 0               # active prewarm threads (describe)
        self._warm_target = None        # only THIS version may repoint()
        # version being warmed -> (the version serving before it, the
        # (bucket, replica) pairs warmed so far): _route's per-bucket cut
        self._warm_state = {}
        self._degraded = None
        # last-known-good rollback: versions a degraded flip quarantined,
        # and the sticky provenance of the latest rollback
        self._quarantined = set()
        self.rollback_info = None
        self.batcher = DynamicBatcher(self._dispatch, name=name,
                                      metrics=self.metrics, **batcher_kw)

    def _route(self, bucket, replica):
        """The version a batch of ``bucket`` rows on ``replica`` runs on:
        the current one, unless it is still warming and has not warmed
        this (bucket, replica) yet, when the version it replaces serves
        it (caller holds the lock)."""
        version = self.current_version
        state = self._warm_state.get(version)
        if state is not None:
            before, warmed = state
            if (bucket, replica) not in warmed and before in self.versions \
                    and before not in self._quarantined:
                return before
        return version

    def _dispatch(self, *stacked_inputs, replica=0):
        """Resolve the version at dispatch time (batch granularity) and
        pin it with an in-flight count so unload can drain."""
        bucket = int(stacked_inputs[0].shape[0]) if stacked_inputs else 0
        with self._lock:
            if self.current_version is None:
                raise ModelNotFoundError(
                    "model %r has no loaded version" % self.name)
            version = self._route(bucket, replica)
            servable = self.versions[version]
            aware = self._replica_aware.get(version, False)
            self._inflight[version] = self._inflight.get(version, 0) + 1
        try:
            if aware:
                return servable.predict_batch(*stacked_inputs,
                                              replica=replica)
            return servable.predict_batch(*stacked_inputs)
        finally:
            with self._drained:
                # an unload(drain=False) may have forgotten this version:
                # the batch's results must still reach their waiters
                if version in self._inflight:
                    self._inflight[version] -= 1
                self._drained.notify_all()

    def install(self, servable, version):
        """Install (version=None: the next one) and repoint dispatch, as
        one atomic step."""
        with self._lock:
            if version is None:
                version = (max(self.versions) + 1) if self.versions else 1
            self.versions[version] = servable
            self._replica_aware[version] = \
                _accepts_replica(servable.predict_batch)
            self._quarantined.discard(version)
            self.current_version = version
            # a direct install supersedes any warm in flight
            self._warm_target = version
            self._degraded = None
            return version

    def add_version(self, servable, version):
        """install() without the repoint: the prewarm path registers the
        incoming version here, warms it, then cuts over. Only the newest
        registration's warm may repoint. On a first load (nothing routable
        yet) the version is made current at once."""
        with self._lock:
            if version is None:
                version = (max(self.versions) + 1) if self.versions else 1
            self.versions[version] = servable
            self._replica_aware[version] = \
                _accepts_replica(servable.predict_batch)
            self._quarantined.discard(version)
            self._warm_target = version
            self._degraded = None
            if self.current_version is None:
                self.current_version = version
            return version

    def set_degraded(self, reason):
        """Flip this model to degraded with ``reason``. With last-known-good
        rollback (MXTPU_RESILIENCE_ROLLBACK, default on) and an earlier
        version still resident, dispatch is repointed to the newest such
        version instead, the bad one is quarantined (no late repoint()
        brings it back), the rollback lands on flightrec ``rolled_back_to``
        and in ``describe()``, and the flag clears. Otherwise the flag is
        sticky until the next install/add_version."""
        reason = str(reason)
        rolled = None
        with self._lock:
            self._degraded = reason
            bad = self.current_version
            if bad is not None and self._rollback_enabled():
                prior = [v for v in self.versions
                         if v < bad and v not in self._quarantined]
                if prior:
                    to = max(prior)
                    self._quarantined.add(bad)
                    self.current_version = to
                    self.rollback_info = {"from_version": bad,
                                          "to_version": to,
                                          "reason": reason}
                    self._degraded = None
                    rolled = (bad, to)
        if rolled is not None:
            bad, to = rolled
            _LOG.warning(
                "model %r v%s flipped degraded (%s) — ROLLED BACK to "
                "last known good v%s (v%s quarantined)",
                self.name, bad, reason, to, bad)
            flightrec.record("rolled_back_to", model=self.name,
                             from_version=bad, to_version=to,
                             reason=reason)

    @staticmethod
    def _rollback_enabled():
        try:
            return bool(config.get_env("MXTPU_RESILIENCE_ROLLBACK"))
        except Exception:
            return True

    def repoint(self, version):
        """Cut dispatch over to ``version``, only while it is still the
        newest warm target (and not quarantined)."""
        with self._lock:
            if (version in self.versions and version == self._warm_target
                    and version not in self._quarantined):
                self.current_version = version

    def warm(self, servable, version, item_sig):
        """Pre-warm every configured (bucket x replica) pair of
        ``servable``, smallest bucket first (all its replicas, then the
        next bucket), each inside an ``aot:warm`` span; dispatch is
        repointed at ``version`` after the first bucket, and until the
        warm ends a batch of a bucket not yet warmed keeps going to the
        version it replaces (``_route``). A replica-unaware servable warms
        each bucket once. A warm that fails (the incoming model refuses
        the observed signature) stops warming and still cuts over: its
        remaining buckets capture on first dispatch. Runs on the warm
        thread while the batcher workers keep serving."""
        import numpy as onp
        aware = _accepts_replica(servable.predict_batch)
        n_rep = self.batcher.replicas if aware else 1
        with self._lock:
            self._warming += 1
            before = self.current_version
            warmed = set()
            if before is not None and before != version:
                self._warm_state[version] = (before, warmed)
        try:
            for b in sorted(set(self.batcher.buckets)):
                try:
                    if faultlab.armed:
                        faultlab.fire("registry.load", model=self.name,
                                      stage="warm", bucket=b)
                    synth = [onp.zeros((b,) + tuple(shape),
                                       dtype=onp.dtype(dt))
                             for shape, dt in item_sig]
                    for r in range(n_rep):
                        with spans.span("aot:warm", model=self.name,
                                        version=version, bucket=b,
                                        replica=r), \
                                devstats.LAUNCH_GATE.shared():
                            if aware:
                                servable.predict_batch(*synth, replica=r)
                            else:
                                servable.predict_batch(*synth)
                        with self._lock:
                            if aware:
                                warmed.add((b, r))
                            else:
                                warmed.update((b, rr) for rr in range(
                                    self.batcher.replicas))
                        try:
                            self.metrics.inc("prewarm_count")
                        except Exception:
                            _LOG.debug("prewarm_count update failed",
                                       exc_info=True)
                except Exception:
                    _LOG.warning(
                        "prewarm of model %r v%s bucket %d failed; "
                        "remaining buckets will capture on first dispatch",
                        self.name, version, b, exc_info=True)
                    break
                self.repoint(version)
        finally:
            self.repoint(version)
            with self._lock:
                self._warm_state.pop(version, None)
                self._warming -= 1

    def drop(self, version, drain, timeout, wait_queue_empty=False):
        """Remove one version. With a successor, dispatch is repointed
        first so the victim can drain; draining the last version keeps it
        routable until queued and in-flight work settles
        (``wait_queue_empty``; the registry pauses intake around this). A
        dropped servable releases its graphs (``release()``)."""
        with self._drained:
            remaining = [v for v in self.versions if v != version]
            if version == self.current_version and remaining:
                self.current_version = max(remaining)
            if drain:
                def settled():
                    return (self._inflight.get(version, 0) == 0
                            and (not wait_queue_empty
                                 or self.batcher.queue_depth() == 0))
                # poll as well as wait: deadline expiry consumes queued
                # requests without a dispatch, so nothing notifies
                end = time.monotonic() + timeout
                while not settled():
                    left = end - time.monotonic()
                    if left <= 0:
                        raise TimeoutError(
                            "model %r v%s still has in-flight batches"
                            % (self.name, version))
                    self._drained.wait(min(left, 0.05))
            servable = self.versions.pop(version, None)
            self._inflight.pop(version, None)
            self._replica_aware.pop(version, None)
            self._quarantined.discard(version)
            if version == self.current_version:
                self.current_version = (max(self.versions)
                                        if self.versions else None)
        release = getattr(servable, "release", None)
        if release is not None:
            try:
                release()
            except Exception:
                _LOG.debug("releasing model %r v%s failed", self.name,
                           version, exc_info=True)

    def describe(self):
        with self._lock:
            return {"name": self.name,
                    "versions": sorted(self.versions),
                    "current_version": self.current_version,
                    "warming": self._warming > 0,
                    "degraded": self._degraded,
                    "rolled_back": self.rollback_info,
                    "queue_depth": self.batcher.queue_depth(),
                    "queue_size": self.batcher.queue_size,
                    "replicas": self.batcher.replicas,
                    "dead_replicas": self.batcher.dead_replicas(),
                    "replica_depths": self.batcher.replica_depths(),
                    "max_batch_size": self.batcher.max_batch_size,
                    "batch_timeout_ms": self.batcher.batch_timeout_ms}


class ModelRegistry:
    """Thread-safe name -> model map (one batcher each) and name ->
    generative engine map: the server front end's substrate."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._generators = {}           # name -> GenerativeEngine
        self._closed = False
        # the continuous profiler's overload signal: it skips a capture
        # cycle while any of this registry's queues runs hot
        from ..telemetry import profstats
        self._probe_name = "serving-registry-%d" % id(self)
        profstats.add_load_probe(self._probe_name, self._queue_occupancy)

    def _queue_occupancy(self):
        """Max replica-queue occupancy across loaded models, in [0, 1]."""
        with self._lock:
            entries = list(self._entries.values())
        occ = 0.0
        for e in entries:
            cap = max(1, e.batcher.total_queue_size)
            occ = max(occ, e.batcher.queue_depth() / cap)
        return occ

    # ------------------------------------------------------------ lifecycle
    def load(self, name, servable, version=None, prewarm=None,
             warm_spec=None, warm_timeout=None, **batcher_kw):
        """Register (or hot-reload) ``name``; returns the installed version.

        The first load creates the name's batcher from ``batcher_kw``
        (max_batch_size, batch_timeout_ms, queue_size, buckets,
        default_deadline_ms, replicas; defaults from ``MXTPU_SERVE_*``).

        Prewarm (``prewarm`` default: MXTPU_AOT_PREWARM): when a per-item
        signature is known (``warm_spec``, a list of ``(shape, dtype)`` per
        input without the batch dim, or the batcher's observed one) the
        version is registered un-routed and warmed on a background thread
        (``_ModelEntry.warm``); this call returns when the warm ends,
        bounded by ``warm_timeout`` / MXTPU_AOT_WARM_TIMEOUT_S. Without a
        signature, or with prewarm=False, dispatch repoints at once and
        buckets capture on first dispatch."""
        if faultlab.armed:
            faultlab.fire("registry.load", model=name, stage="load")
        servable = _as_servable(servable)
        warm_thread = None
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is shut down")
            entry = self._entries.get(name)
            if entry is None:
                entry = _ModelEntry(name, **batcher_kw)
                self._entries[name] = entry
            elif batcher_kw:
                raise ValueError("batcher options are fixed at first load "
                                 "of %r" % name)
            if prewarm is None:
                prewarm = config.get_env("MXTPU_AOT_PREWARM")
            item_sig = warm_spec if warm_spec is not None \
                else entry.batcher.last_item_sig
            if prewarm and item_sig:
                version = entry.add_version(servable, version)
                warm_thread = threading.Thread(
                    target=entry.warm, args=(servable, version, item_sig),
                    daemon=True, name="mxtpu-aot-warm-%s" % name)
                warm_thread.start()
            else:
                version = entry.install(servable, version)
        if warm_thread is not None:
            if warm_timeout is None:
                warm_timeout = config.get_env("MXTPU_AOT_WARM_TIMEOUT_S")
            warm_thread.join(warm_timeout)
            if warm_thread.is_alive():
                _LOG.warning(
                    "prewarm of model %r v%s still running after %.1fs — "
                    "returning; remaining buckets finish in the background",
                    name, version, warm_timeout)
        return version

    def unload(self, name, version=None, drain=True, timeout=30.0):
        """Drop one version (default: current). Dropping the last version
        shuts the name's batcher down and forgets the name."""
        entry = self._entry(name)
        if version is None:
            version = entry.current_version
        if version not in entry.versions:
            raise ModelNotFoundError("model %r has no version %s"
                                     % (name, version))
        with entry._lock:
            last = set(entry.versions) == {version}
        if last and drain:
            # no successor: pause intake so the queue only shrinks, serve
            # what was accepted, unroute at the end
            entry.batcher.pause_intake()
        try:
            entry.drop(version, drain, timeout, wait_queue_empty=last)
        except TimeoutError:
            if last and drain:
                entry.batcher.resume_intake()
            raise
        close_batcher = False
        with self._lock:
            # a concurrent load() may have revived the entry
            if not entry.versions and self._entries.get(name) is entry:
                self._entries.pop(name)
                close_batcher = True
        if close_batcher:
            entry.batcher.close(drain=drain)
        elif last and drain:
            entry.batcher.resume_intake()

    def close(self, drain=True):
        """Shut every model's batcher down (queues drained first) and close
        every generator (live sequences retire)."""
        from ..telemetry import profstats
        profstats.remove_load_probe(self._probe_name)
        with self._lock:
            self._closed = True
            entries = list(self._entries.values())
            generators = list(self._generators.values())
        for entry in entries:
            entry.batcher.close(drain=drain)
        for engine in generators:
            try:
                engine.close()
            except Exception:
                _LOG.debug("generator close failed", exc_info=True)

    # ----------------------------------------------------------- generators
    def load_generator(self, name, engine=None, **engine_kw):
        """Register a generative engine under ``name`` (``POST /generate``
        routes on it): a constructed ``GenerativeEngine``, or one built
        here from ``engine_kw`` (its warm captures every program before
        this returns). Replacing an open generator is an error: close it
        first."""
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is shut down")
            old = self._generators.get(name)
            if old is not None and not old.closed:
                raise ValueError("generator %r is already loaded (close "
                                 "it before replacing)" % name)
        if engine is None:
            from .generate import GenerativeEngine
            engine = GenerativeEngine(name=name, **engine_kw)
        _seed_slos(name)
        with self._lock:
            if self._closed:
                engine.close()
                raise RuntimeError("registry is shut down")
            self._generators[name] = engine
        return engine

    def generator(self, name):
        """The live engine for ``name``: ModelNotFoundError (404) when
        absent or closed; ServingClosedError (503) while its decode loop
        is dead and awaiting the supervisor."""
        with self._lock:
            engine = self._generators.get(name)
            names = sorted(n for n, e in self._generators.items()
                           if not e.closed) if engine is None else None
        if engine is None or engine.closed:
            raise ModelNotFoundError("no generator %r loaded (have: %s)"
                                     % (name, names or sorted(
                                         self._generators)))
        if not engine.alive:
            raise ServingClosedError(
                "generator %r decode loop is dead (awaiting supervisor "
                "revival)" % name)
        return engine

    def generators(self):
        """Describe every generator except one whose decode loop died (not
        alive, not closed): it relists when the supervisor revives it."""
        with self._lock:
            engines = list(self._generators.values())
        return [e.describe() for e in engines if e.alive or e.closed]

    # ------------------------------------------------------------ resilience
    def batchers(self):
        """{name -> DynamicBatcher}: the supervisor's replica scan."""
        with self._lock:
            return {n: e.batcher for n, e in self._entries.items()}

    def engines(self):
        """{name -> GenerativeEngine}: the supervisor's decode-loop scan."""
        with self._lock:
            return dict(self._generators)

    # ------------------------------------------------------------ inference
    def _entry(self, name):
        with self._lock:
            entry = self._entries.get(name)
            names = sorted(self._entries) if entry is None else None
        if entry is None:
            raise ModelNotFoundError("no model %r loaded (have: %s)"
                                     % (name, names))
        return entry

    def submit(self, name, *inputs, deadline_ms=None, request_id=None,
               tenant=None):
        return self._entry(name).batcher.submit(
            *inputs, deadline_ms=deadline_ms, request_id=request_id,
            tenant=tenant)

    def predict(self, name, *inputs, deadline_ms=None, timeout=None,
                request_id=None, tenant=None):
        return self._entry(name).batcher.predict(
            *inputs, deadline_ms=deadline_ms, timeout=timeout,
            request_id=request_id, tenant=tenant)

    def metrics(self, name):
        return self._entry(name).metrics

    # ------------------------------------------------------------- numerics
    def register_shadow(self, name, reference, stride=None, threshold=None):
        """Attach ``reference`` (servable or Gluon block) as ``name``'s
        numerics shadow: a deterministic stride of dispatched batches is
        re-executed through it off the hot path and compared
        (telemetry/numwatch.py). A max-abs-diff breach beyond
        ``threshold`` (default MXTPU_SHADOW_THRESHOLD) flips this model to
        degraded (``set_degraded``, with its last-known-good rollback)."""
        entry = self._entry(name)
        reference = _as_servable(reference)
        from ..telemetry import numwatch
        numwatch.register_shadow(name, reference, stride=stride,
                                 threshold=threshold,
                                 on_breach=entry.set_degraded)

    def unregister_shadow(self, name):
        """Detach ``name``'s numerics shadow (the degraded flag, if already
        flipped, stays until the next load)."""
        from ..telemetry import numwatch
        return numwatch.unregister_shadow(name)

    # ------------------------------------------------------------ inspection
    def models(self):
        with self._lock:
            entries = list(self._entries.values())
        return [e.describe() for e in entries]

    def metrics_snapshot(self):
        with self._lock:
            entries = list(self._entries.items())
        return {name: e.metrics.snapshot() for name, e in entries}

    def health(self):
        """healthy | degraded (a queue >= 80% full, a degraded model, a
        dead replica) | unhealthy (shut down, or every worker of a model
        or a decode loop dead): the load balancer's contract."""
        with self._lock:
            closed = self._closed
            entries = list(self._entries.values())
            generators = list(self._generators.values())
        if closed:
            return {"status": "unhealthy", "reason": "shutting down"}
        for e in entries:
            if not e.batcher.alive and not e.batcher.closed:
                return {"status": "unhealthy",
                        "reason": "worker thread dead for model %r" % e.name}
        for g in generators:
            if not g.alive and not g.closed:
                return {"status": "unhealthy",
                        "reason": "decode loop dead for generator %r"
                                  % g.name}
        for e in entries:
            if e.batcher.queue_depth() >= 0.8 * e.batcher.total_queue_size:
                return {"status": "degraded",
                        "reason": "queue >= 80%% for model %r" % e.name,
                        "queue_depth": e.batcher.queue_depth()}
        for e in entries:
            if e._degraded:
                return {"status": "degraded",
                        "reason": "model %r degraded: %s"
                                  % (e.name, e._degraded)}
        for e in entries:
            dead = e.batcher.dead_replicas()
            if dead:
                return {"status": "degraded",
                        "reason": "model %r lost replica worker(s) %s"
                                  % (e.name, dead)}
        return {"status": "healthy", "models": len(entries)}
