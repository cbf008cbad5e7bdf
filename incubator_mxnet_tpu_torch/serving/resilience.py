"""Self-healing serving: the reflexes that act on failure signals
(counterpart of ``incubator_mxnet_tpu/serving/resilience.py``, carried
over with it).

The observability stack reports failure — a dead replica worker lands in
``dead_replicas()`` and flips ``/healthz`` degraded, a crashed decode
loop reads unhealthy. The :class:`Supervisor` here acts on it, treating
component death as a normal event to recover from rather than an error
to report (the TensorFlow system-design stance on worker failure,
arXiv:1605.08695):

- **Replica respawn.** A daemon thread polls every registered batcher's
  dead set (``MXTPU_RESILIENCE_POLL_S``) and respawns dead replica
  workers via :meth:`DynamicBatcher.respawn_replica` after an
  exponential backoff with seeded jitter (``base * 2^(deaths-1)``,
  capped; ``MXTPU_RESILIENCE_BACKOFF_BASE_S`` / ``_CAP_S``). The jitter
  keeps a fleet of supervisors from respawning in lockstep.
- **Crash-loop circuit breaker.** ``MXTPU_RESILIENCE_CRASH_N`` deaths of
  one replica within ``MXTPU_RESILIENCE_CRASH_WINDOW_S`` seconds parks
  it: no further respawns (flightrec ``replica_parked``), and because a
  parked replica stays in the router's dead set, ``/healthz`` keeps
  reporting degraded until an operator calls :meth:`unpark` — respawning
  a deterministic crasher forever would just burn the error budget.
- **Decode-loop resurrection.** Engines are marked supervised
  (``set_supervised(True)``), so a dying decode loop PRESERVES its
  sequences; the supervisor then drives
  :meth:`GenerativeEngine.resurrect` under the same backoff/park policy.
  Survivors continue bit-exactly from their KV state; rows lost with a
  pool caught mid-update (a decode or join call in flight when the loop
  died) retire as ``finish_reason="engine_restart"``.

The other two reflexes live where the state lives: the bounded
single-retry of replica-death predict failures in serving/batcher.py
(``mxtpu_retries_total``), and last-known-good version rollback in
serving/registry.py (flightrec ``rolled_back_to``).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque

from .. import config
from ..telemetry import flightrec

__all__ = ["Supervisor"]

_LOG = logging.getLogger(__name__)


class Supervisor:
    """Respawn dead batcher replicas and resurrect dead decode loops for
    every model in ``registry``, with exponential backoff + jitter and a
    crash-loop circuit breaker. One supervisor per registry; start() /
    stop() bracket the serving lifetime (ServingServer does not start
    one implicitly — chaos tests need supervised and unsupervised
    fleets)."""

    def __init__(self, registry, poll_s=None, backoff_base_s=None,
                 backoff_cap_s=None, crash_n=None, crash_window_s=None,
                 seed=0):
        self.registry = registry
        self.poll_s = float(poll_s if poll_s is not None
                            else config.get_env("MXTPU_RESILIENCE_POLL_S"))
        self.backoff_base_s = float(
            backoff_base_s if backoff_base_s is not None
            else config.get_env("MXTPU_RESILIENCE_BACKOFF_BASE_S"))
        self.backoff_cap_s = float(
            backoff_cap_s if backoff_cap_s is not None
            else config.get_env("MXTPU_RESILIENCE_BACKOFF_CAP_S"))
        self.crash_n = int(crash_n if crash_n is not None
                           else config.get_env("MXTPU_RESILIENCE_CRASH_N"))
        self.crash_window_s = float(
            crash_window_s if crash_window_s is not None
            else config.get_env("MXTPU_RESILIENCE_CRASH_WINDOW_S"))
        # seeded jitter: deterministic in tests, still decorrelates a
        # fleet whose supervisors seed differently
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._deaths = {}       # (kind, model, replica) -> deque[monotonic]
        self._due = {}          # (kind, model, replica) -> respawn-at
        self._parked = set()    # (kind, model, replica)
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------- lifecycle
    def start(self):
        """Start the poll thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-supervisor")
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        """Stop supervising. Dead-but-supervised engines are resurrected
        one last time (their preserved sequences must not strand), then
        every engine reverts to the unsupervised death path."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        for name, engine in self._engines().items():
            try:
                if not engine.closed and not engine.alive:
                    engine.resurrect()
            except Exception:
                _LOG.error("final resurrection of %r failed", name,
                           exc_info=True)
            try:
                engine.set_supervised(False)
            except Exception:
                _LOG.debug("unsupervising %r failed", name, exc_info=True)

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------ inspection
    def describe(self):
        """Park/backoff state snapshot (the /debug surface + tests)."""
        with self._lock:
            return {
                "alive": self.alive,
                "parked": sorted("%s:%s:r%s" % (k, m, r)
                                 for (k, m, r) in self._parked),
                "pending": {"%s:%s:r%s" % (k, m, r): round(t, 3)
                            for (k, m, r), t in self._due.items()}}

    def parked(self, model, replica=None):
        """True when the replica (or, with replica=None, the model's
        decode loop) is parked by the crash-loop breaker."""
        key = (("gen", str(model), 0) if replica is None
               else ("replica", str(model), int(replica)))
        with self._lock:
            return key in self._parked

    def unpark(self, model, replica=None):
        """Operator verb: forget a parked component's crash history so
        the next poll respawns it."""
        key = (("gen", str(model), 0) if replica is None
               else ("replica", str(model), int(replica)))
        with self._lock:
            was = key in self._parked
            self._parked.discard(key)
            self._deaths.pop(key, None)
            self._due.pop(key, None)
        return was

    # -------------------------------------------------------------- internals
    def _engines(self):
        try:
            return dict(self.registry.engines())
        except Exception:
            _LOG.debug("engine scan failed", exc_info=True)
            return {}

    def _batchers(self):
        try:
            return dict(self.registry.batchers())
        except Exception:
            _LOG.debug("batcher scan failed", exc_info=True)
            return {}

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                # the supervisor must outlive anything it supervises; a
                # scan hiccup is logged, never fatal (R005)
                _LOG.error("supervisor poll failed", exc_info=True)

    def poll_once(self):
        """One scan: schedule/execute respawns and resurrections that
        are due. Public so tests can drive the state machine without the
        poll thread."""
        now = time.monotonic()
        for name, batcher in self._batchers().items():
            if batcher.closed:
                continue
            for r in batcher.dead_replicas():
                self._consider(("replica", name, r), now,
                               lambda b=batcher, r=r: b.respawn_replica(r))
        for name, engine in self._engines().items():
            if engine.closed:
                continue
            # mark supervised on sight, so the NEXT death preserves
            # state; an engine loaded mid-flight is adopted within one
            # poll period
            try:
                if not getattr(engine, "_supervised", False):
                    engine.set_supervised(True)
            except Exception:
                _LOG.debug("supervising %r failed", name, exc_info=True)
            if not engine.alive:
                self._consider(("gen", name, 0), now,
                               lambda e=engine: e.resurrect())

    def _consider(self, key, now, repair):
        """Backoff/park state machine for one dead component: first
        sighting records the death and schedules the repair after the
        backoff; a later poll past the due time runs it; crash-looping
        parks it."""
        with self._lock:
            if key in self._parked:
                return
            due = self._due.get(key)
            if due is None:
                dq = self._deaths.setdefault(key, deque())
                dq.append(now)
                while dq and now - dq[0] > self.crash_window_s:
                    dq.popleft()
                if len(dq) >= self.crash_n:
                    self._parked.add(key)
                    deaths = len(dq)
                    park = True
                else:
                    delay = min(self.backoff_cap_s,
                                self.backoff_base_s * 2 ** (len(dq) - 1))
                    delay *= 1.0 + 0.25 * self._rng.random()
                    self._due[key] = now + delay
                    return
            elif now >= due:
                del self._due[key]
                park = False
            else:
                return
        kind, model, replica = key
        if park:
            _LOG.error(
                "%s %r%s crash-looped (%d deaths in %.1fs) — PARKED; "
                "health stays degraded until unpark()",
                "replica" if kind == "replica" else "decode loop", model,
                " r%d" % replica if kind == "replica" else "",
                deaths, self.crash_window_s)
            flightrec.record(
                "replica_parked" if kind == "replica" else "genloop_parked",
                model=model, replica=replica, deaths=deaths,
                window_s=self.crash_window_s)
            return
        try:
            repair()
        except Exception:
            _LOG.error("repair of %s %r r%s failed (will re-observe)",
                       kind, model, replica, exc_info=True)
