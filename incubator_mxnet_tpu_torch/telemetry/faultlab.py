"""Deterministic fault injection for the serving stack (faultlab).

Counterpart of ``incubator_mxnet_tpu/telemetry/faultlab.py``, carried over
with it: the module reads no device.

Named fault points are compiled into the hot paths as near-zero-cost
no-ops: a site guards its hook with ``if faultlab.armed:`` — one module
attribute read when the lab is disarmed, nothing else. Arming installs a
set of faults parsed from a spec string (``MXTPU_FAULTLAB`` at import, or
``POST /debug/faults`` at runtime), and from then on ``fire(site)``
consults the armed set under a lock.

Spec grammar (docs/RESILIENCE.md "Fault spec grammar")::

    spec    := entry (";" entry)*
    entry   := site ":" kind (":" key "=" value)*
    kind    := exception | replica_kill | slow_ms | kv_oom
             | nan_poison | artifact_corrupt
    key     := stride | p | seed | budget | ms

``stride=N`` fires on every Nth call of the site (deterministic; the
default is stride=1, i.e. every call). ``p=0.3`` fires each call with
probability 0.3 from a seeded ``random.Random`` (``seed=N``; the default
seed is derived from the site+kind string, so two processes arming the
same spec fire identically). ``budget=N`` caps total firings — an
exhausted fault disarms itself. ``ms=N`` is the sleep for ``slow_ms``.

What a firing does depends on the kind:

- ``exception``    -> raises :class:`FaultInjected` (a RuntimeError —
  absorbed by the same guards that absorb real servable failures),
- ``replica_kill`` -> raises :class:`WorkerKilled` (a **BaseException**,
  so it escapes per-batch ``except Exception`` guards and kills the
  worker thread the way a segfaulting dispatch would),
- ``slow_ms``      -> sleeps ``ms`` milliseconds in place,
- ``kv_oom``       -> raises :class:`KVOomInjected`,
- ``nan_poison`` / ``artifact_corrupt`` -> returns the kind string; the
  SITE applies the corruption itself (poisons its output tensor, treats
  the artifact as unreadable) because only the site knows its data.

Every firing lands in the flight recorder (``fault_injected``) and on
``mxtpu_faults_injected_total{site,kind}`` — a chaos run's injected
faults are first-class telemetry, auditable next to their effects.

Known sites (the registry is open — any string names a site, these are
the ones the port wires): ``batcher.dispatch``, ``registry.load`` and
``generate.step``. The JAX package's ``aot.artifact_read`` waits for the
port's artifact layer and ``numwatch.shadow`` for its numerics sentinel.
"""
from __future__ import annotations

import logging
import random
import threading
import time
import zlib

from .registry import counter
from . import flightrec

__all__ = ["FaultInjected", "WorkerKilled", "KVOomInjected", "KINDS",
           "arm", "disarm", "describe", "fire", "reset", "armed"]

_LOG = logging.getLogger(__name__)

KINDS = ("exception", "replica_kill", "slow_ms", "kv_oom", "nan_poison",
         "artifact_corrupt")

#: Kinds fire() RETURNS (site applies the corruption) instead of raising.
_PASSIVE_KINDS = ("nan_poison", "artifact_corrupt")

_FIRED = counter(
    "mxtpu_faults_injected_total",
    "Faultlab firings by site and kind (chaos-run audit trail).",
    ("site", "kind"))

#: Module-level fast path: hot sites guard with ``if faultlab.armed:`` so
#: a disarmed lab costs one attribute read on the dispatch path.
armed = False

_lock = threading.RLock()
_faults = {}                     # site -> [_Fault, ...]


class FaultInjected(RuntimeError):
    """Injected servable-level failure (absorbed like a real one)."""


class WorkerKilled(BaseException):
    """Injected worker death: a BaseException on purpose, so it escapes
    per-batch ``except Exception`` guards and takes the worker thread
    down the way a hard crash would."""


class KVOomInjected(RuntimeError):
    """Injected KV-cache allocation failure (decode-loop site)."""


class _Fault:
    """One armed fault: site + kind + firing policy + budget."""

    __slots__ = ("site", "kind", "stride", "p", "seed", "budget", "ms",
                 "calls", "fired", "_rng")

    def __init__(self, site, kind, stride=None, p=None, seed=None,
                 budget=None, ms=50.0):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (site %r); kinds: %s"
                             % (kind, site, ", ".join(KINDS)))
        if stride is not None and p is not None:
            raise ValueError("fault %s:%s: stride= and p= are exclusive"
                             % (site, kind))
        self.site = site
        self.kind = kind
        self.stride = int(stride) if stride is not None else None
        self.p = float(p) if p is not None else None
        # default seed derived from the site+kind STRING (not hash(),
        # which is per-process randomized): same spec -> same firings
        # in every process, which is what makes a chaos run replayable
        self.seed = (int(seed) if seed is not None
                     else zlib.crc32(("%s:%s" % (site, kind)).encode()))
        self.budget = int(budget) if budget is not None else None
        self.ms = float(ms)
        self.calls = 0
        self.fired = 0
        self._rng = random.Random(self.seed)

    def should_fire(self):
        """Advance the call counter and decide (caller holds _lock)."""
        if self.budget is not None and self.fired >= self.budget:
            return False
        self.calls += 1
        if self.p is not None:
            fire = self._rng.random() < self.p
        else:
            stride = self.stride or 1
            fire = self.calls % stride == 0
        if fire:
            self.fired += 1
        return fire

    def exhausted(self):
        return self.budget is not None and self.fired >= self.budget

    def describe(self):
        return {"site": self.site, "kind": self.kind, "stride": self.stride,
                "p": self.p, "seed": self.seed, "budget": self.budget,
                "ms": self.ms, "calls": self.calls, "fired": self.fired}


def parse_spec(spec):
    """Parse a spec string into a list of _Fault (raises ValueError on a
    malformed entry — an armed typo must fail loudly, not silently test
    nothing)."""
    faults = []
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                "fault entry %r: want site:kind[:key=value...]" % entry)
        site, kind = parts[0].strip(), parts[1].strip()
        kwargs = {}
        for kv in parts[2:]:
            if "=" not in kv:
                raise ValueError("fault entry %r: bad option %r (want "
                                 "key=value)" % (entry, kv))
            k, v = kv.split("=", 1)
            k = k.strip()
            if k not in ("stride", "p", "seed", "budget", "ms"):
                raise ValueError("fault entry %r: unknown key %r" % (entry, k))
            kwargs[k] = v.strip()
        faults.append(_Fault(site, kind, **kwargs))
    return faults


def arm(spec):
    """Replace the armed fault set with the parsed ``spec`` (empty/None
    disarms everything). Returns describe()."""
    global armed
    faults = parse_spec(spec)
    with _lock:
        _faults.clear()
        for f in faults:
            _faults.setdefault(f.site, []).append(f)
        armed = bool(_faults)
        for f in faults:
            flightrec.record("fault_armed", site=f.site, kind=f.kind,
                             stride=f.stride, p=f.p, budget=f.budget)
    return describe()


def disarm():
    """Remove every armed fault (the ``POST /debug/faults`` empty-spec
    path and the test teardown path)."""
    return arm("")


def reset():
    """Test hook: disarm and forget all firing counters."""
    disarm()


def describe():
    """{armed, faults: [...]} — the ``GET /debug/faults`` body."""
    with _lock:
        return {"armed": armed,
                "faults": [f.describe()
                           for fl in _faults.values() for f in fl]}


def fire(site, **ctx):
    """Evaluate the armed faults for ``site``. Hot paths call this only
    behind the ``armed`` fast-path check.

    Raises for the raising kinds (FaultInjected / WorkerKilled /
    KVOomInjected), sleeps in place for slow_ms, and RETURNS the kind
    string for the passive kinds (nan_poison / artifact_corrupt) so the
    site can apply its own corruption; returns None when nothing fires.
    ``ctx`` keyword facts (model, replica, ...) ride onto the flightrec
    row."""
    global armed
    to_fire = []
    with _lock:
        for f in _faults.get(site, ()):
            if f.should_fire():
                to_fire.append(f)
        # budget-exhausted faults self-disarm; recompute the fast path
        for fl in list(_faults.values()):
            fl[:] = [f for f in fl if not f.exhausted()]
        for s in [s for s, fl in _faults.items() if not fl]:
            del _faults[s]
        armed = bool(_faults)
    passive = None
    for f in to_fire:
        try:
            _FIRED.inc(site=site, kind=f.kind)
        except Exception:
            _LOG.debug("fault firing counter update failed", exc_info=True)
        flightrec.record("fault_injected", site=site, kind=f.kind,
                         fired=f.fired, **ctx)
        if f.kind == "exception":
            raise FaultInjected("faultlab: injected exception at %r" % site)
        if f.kind == "replica_kill":
            raise WorkerKilled("faultlab: injected worker kill at %r" % site)
        if f.kind == "kv_oom":
            raise KVOomInjected("faultlab: injected KV OOM at %r" % site)
        if f.kind == "slow_ms":
            time.sleep(f.ms / 1000.0)
        else:                        # nan_poison / artifact_corrupt
            passive = f.kind
    return passive


def _arm_from_env():
    """Import-time arming from MXTPU_FAULTLAB (guarded: faultlab must
    never take down an import chain, and config may not be importable yet
    in exotic bootstrap orders)."""
    try:
        from .. import config
        spec = config.get_env("MXTPU_FAULTLAB")
    except Exception:
        _LOG.debug("MXTPU_FAULTLAB read failed at import", exc_info=True)
        return
    if spec:
        try:
            arm(spec)
        except Exception:
            _LOG.error("MXTPU_FAULTLAB spec %r failed to arm", spec,
                       exc_info=True)


_arm_from_env()
