"""SLO engine (counterpart of ``incubator_mxnet_tpu/telemetry/slo.py``,
carried over as it is: nothing here reads the device): per-model
objectives, error-budget accounting, and multi-window burn-rate alerts
(the SRE-workbook alerting model on the serving path).

The serving front-end feeds every terminal request outcome into a
per-model good/bad ledger (2xx good; 429/504/5xx bad; other 4xx are
client mistakes and count for neither side), from which three operator
facts are derived:

- **error budget remaining** over a sliding window
  (``MXTPU_SLO_WINDOW_S``): 1.0 = untouched, 0.0 = exhausted; refills as
  bad events age out of the window;
- **burn rates** per window: ``bad_fraction / (1 - target)`` — 1.0 means
  the budget is being spent exactly as fast as the objective allows,
  14.4 means a 30-day budget would be gone in ~2 days;
- **alert pairs** (``MXTPU_SLO_WINDOWS``, SHORT:LONG seconds): a pair
  breaches only when BOTH windows' burn rates exceed its threshold
  (``MXTPU_SLO_FAST_BURN`` for the first pair, ``MXTPU_SLO_SLOW_BURN``
  for the rest) — the short window detects fast, the long window
  suppresses blips. Each pair runs a pending -> firing -> resolved state
  machine with hysteresis: firing requires the breach to hold for
  ``pending_s``, resolving requires it to stay clear for ``resolve_s``,
  so a single good sample never flaps an active alert.

Two objective kinds per model: ``availability`` (a 2xx IS good) and,
when a threshold is configured (``MXTPU_SLO_LATENCY_MS`` or
``define(kind="latency", latency_ms=...)``), ``latency`` (a 2xx slower
than the threshold spends latency budget; server-class failures spend it
too — a request that never answered is not fast).

Every piece of time arithmetic runs on an **injectable clock** (a
``clock()`` -> monotonic-seconds callable, default ``time.monotonic``),
so the whole engine — window aging, budget refill, alert lifecycle — is
unit-testable with zero real sleeps (the loadgen fake-clock pattern).

Surfaces:

- gauges ``mxtpu_slo_burn_rate{slo,window}`` /
  ``mxtpu_slo_budget_remaining{slo}`` / ``mxtpu_slo_alert_firing
  {slo,pair}`` (sampled live at scrape time via gauge callbacks, so a
  scrape also advances the alert state machine — resolution does not
  need traffic), counters ``mxtpu_slo_events_total{slo,outcome}``;
- flightrec events (``slo_alert``) on every state transition — alert
  history survives in the black-box tape;
- ``GET /debug/slo`` (serving/server.py) renders ``REGISTRY.describe()``.

SLO objects are seeded per served model by the serving registry
(``ensure_model``) and detached when the model's batcher closes — a
dead model must not keep exporting a frozen burn rate.
"""
from __future__ import annotations

import logging
import math
import threading
import time

from . import flightrec
from .registry import counter as _counter, gauge as _gauge

__all__ = ["SLO", "SLORegistry", "REGISTRY", "AlertPair", "observe",
           "ensure_model", "describe"]

_LOG = logging.getLogger(__name__)

_EVENTS = _counter(
    "mxtpu_slo_events_total",
    "Eligible request outcomes fed into an SLO's good/bad ledger "
    "(2xx good; 429/504/5xx bad; other 4xx not counted; a latency SLO "
    "additionally counts slow 2xx as bad) — docs/OBSERVABILITY.md "
    "'SLOs and tenants'.", ("slo", "outcome"))
_BURN = _gauge(
    "mxtpu_slo_burn_rate",
    "Error-budget burn rate over one sliding window: bad_fraction / "
    "(1 - target). 1.0 spends the budget exactly at the objective rate; "
    "the alert pairs compare this against MXTPU_SLO_FAST_BURN / "
    "MXTPU_SLO_SLOW_BURN. Sampled live at scrape time.",
    ("slo", "window"))
_BUDGET = _gauge(
    "mxtpu_slo_budget_remaining",
    "Fraction of the error budget left over the MXTPU_SLO_WINDOW_S "
    "sliding window (1 = untouched, 0 = exhausted; clamped at 0). "
    "Refills as bad events age out of the window.", ("slo",))
_FIRING = _gauge(
    "mxtpu_slo_alert_firing",
    "1 while this SLO's alert-window pair is in the firing state, else "
    "0 (pending/resolved/inactive). State transitions also land in the "
    "flight recorder as slo_alert events.", ("slo", "pair"))


def _default_clock():
    return time.monotonic()


def _eligible(code):
    """Is this outcome SLO-eligible for ANY objective kind? (2xx, 429,
    504, 5xx; other 4xx are the client's mistake.) The gate that keeps
    auto-seeding from minting SLO objects for attacker-controlled model
    names: a name that never loaded can only ever produce 400/404."""
    code = int(code)
    return 200 <= code < 300 or code == 429 or code == 504 \
        or 500 <= code < 600


# --------------------------------------------------------------------- ledger
class _Ledger:
    """Bucketed good/bad ring covering the longest window an SLO reads.

    Buckets are ``bucket_s`` wide (resolution, floored so the ring never
    exceeds ~4096 slots even for a 6 h window); ``add`` lands in the
    bucket the clock says is current, zeroing any buckets the clock
    skipped — so a window sum over the newest ``ceil(W / bucket_s)``
    buckets is exact to one bucket of quantization at the boundary.
    Caller (SLO) holds the lock; the ledger itself is lock-free.
    """

    def __init__(self, max_window_s, resolution_s=0.25):
        self.bucket_s = max(float(resolution_s), float(max_window_s) / 4096.0)
        self.slots = int(math.ceil(float(max_window_s) / self.bucket_s)) + 1
        self.good = [0] * self.slots
        self.bad = [0] * self.slots
        self._head = None          # absolute bucket index of the newest add

    def _advance(self, now):
        idx = int(now // self.bucket_s)
        if self._head is None:
            self._head = idx
            return idx
        if idx > self._head:
            # zero every bucket the clock skipped (bounded by ring size)
            for i in range(self._head + 1,
                           min(idx, self._head + self.slots) + 1):
                self.good[i % self.slots] = 0
                self.bad[i % self.slots] = 0
            self._head = idx
        return self._head

    def add(self, good, now):
        idx = self._advance(now)
        if good:
            self.good[idx % self.slots] += 1
        else:
            self.bad[idx % self.slots] += 1

    def window_counts(self, window_s, now):
        """(good, bad) totals over the trailing ``window_s`` seconds."""
        idx = self._advance(now)
        k = min(self.slots, int(math.ceil(float(window_s) / self.bucket_s)))
        g = b = 0
        for i in range(idx - k + 1, idx + 1):
            g += self.good[i % self.slots]
            b += self.bad[i % self.slots]
        return g, b


# ---------------------------------------------------------------- alert pairs
class AlertPair:
    """One SRE-workbook multi-window alert: breach = burn(short) AND
    burn(long) above ``threshold``; pending -> firing after ``pending_s``
    of sustained breach, firing -> resolved after ``resolve_s`` of
    sustained clear (the hysteresis that stops a single good sample from
    flapping an active alert). ``resolved`` is sticky until the next
    breach restarts the cycle at pending."""

    def __init__(self, name, short_s, long_s, threshold,
                 pending_s=0.0, resolve_s=None):
        self.name = name
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        if self.long_s < self.short_s:
            raise ValueError(
                "alert pair %r: long window %.0fs < short window %.0fs"
                % (name, self.long_s, self.short_s))
        self.threshold = float(threshold)
        self.pending_s = float(pending_s)
        self.resolve_s = (float(resolve_s) if resolve_s is not None
                          else self.short_s / 2.0)
        self.state = "inactive"
        self.since = None           # clock time of the last state change
        self._clear_since = None    # breach-clear streak start while firing

    def evaluate(self, burn_short, burn_long, now):
        """Advance the state machine; returns the list of states entered
        (empty when nothing changed). A zero ``pending_s`` still passes
        through pending — the full pending -> firing lifecycle lands in
        the event stream — because the long window already provides the
        sustain requirement the pending timer would otherwise add."""
        breach = burn_short > self.threshold and burn_long > self.threshold
        entered = []
        if self.state in ("inactive", "resolved"):
            if breach:
                self.state, self.since = "pending", now
                entered.append("pending")
        if self.state == "pending":
            if not breach:
                if "pending" not in entered:   # a held pending that cleared
                    self.state, self.since = "inactive", now
                    entered.append("inactive")
            elif now - self.since >= self.pending_s:
                self.state, self.since = "firing", now
                self._clear_since = None
                entered.append("firing")
        elif self.state == "firing":
            if breach:
                self._clear_since = None
            else:
                if self._clear_since is None:
                    self._clear_since = now
                if now - self._clear_since >= self.resolve_s:
                    self.state, self.since = "resolved", now
                    entered.append("resolved")
        return entered

    def describe(self, now):
        return {"pair": self.name, "short_s": self.short_s,
                "long_s": self.long_s, "threshold": self.threshold,
                "state": self.state,
                "state_age_s": (now - self.since
                                if self.since is not None else None)}


def _parse_windows(spec):
    """'300:3600,3600:21600' -> [('fast', 300.0, 3600.0),
    ('slow', 3600.0, 21600.0), ('slow2', ...)]."""
    pairs = []
    for i, part in enumerate(str(spec).split(",")):
        part = part.strip()
        if not part:
            continue
        short, sep, long_ = part.partition(":")
        if not sep:
            raise ValueError("bad MXTPU_SLO_WINDOWS pair %r "
                             "(want SHORT:LONG seconds)" % part)
        name = "fast" if i == 0 else ("slow" if i == 1 else "slow%d" % i)
        pairs.append((name, float(short), float(long_)))
    if not pairs:
        raise ValueError("MXTPU_SLO_WINDOWS is empty")
    return pairs


# ------------------------------------------------------------------------ SLO
class SLO:
    """One objective over one model's request stream.

    ``kind`` is ``"availability"`` (2xx good), ``"latency"`` (2xx good
    only when its end-to-end latency is <= ``latency_ms``), or
    ``"inter_token"`` (same threshold arithmetic as latency, but the
    outcome stream is PER GENERATED TOKEN, not per request — the decode
    engine feeds one observation per token gap, so the target reads as
    "p-target of inter-token gaps under latency_ms"; objectives are
    minted per tenant by serving/generate.py under
    ``MXTPU_GEN_SLO_INTER_TOKEN_MS``). All kinds count 429/504/5xx as
    bad and ignore other 4xx. All time arithmetic uses the injected
    ``clock``.
    """

    def __init__(self, name, model, kind="availability", target=None,
                 latency_ms=None, window_s=None, windows=None,
                 fast_burn=None, slow_burn=None, pending_s=0.0,
                 resolve_s=None, resolution_s=0.25, clock=None):
        from .. import config
        if kind not in ("availability", "latency", "inter_token"):
            raise ValueError("unknown SLO kind %r" % kind)
        if kind in ("latency", "inter_token") and latency_ms is None:
            raise ValueError("%s SLO %r needs latency_ms" % (kind, name))
        self.name = name
        self.model = model
        self.kind = kind
        self.target = float(target if target is not None
                            else config.get_env("MXTPU_SLO_TARGET"))
        if not 0.0 < self.target < 1.0:
            raise ValueError("SLO target must be in (0, 1), got %r"
                             % self.target)
        self.latency_ms = (float(latency_ms)
                           if latency_ms is not None else None)
        self.window_s = float(window_s if window_s is not None
                              else config.get_env("MXTPU_SLO_WINDOW_S"))
        spec = (windows if windows is not None
                else config.get_env("MXTPU_SLO_WINDOWS"))
        parsed = _parse_windows(spec) if isinstance(spec, str) else [
            ("fast" if i == 0 else ("slow" if i == 1 else "slow%d" % i),
             float(s), float(l)) for i, (s, l) in enumerate(spec)]
        if fast_burn is None:
            fast_burn = config.get_env("MXTPU_SLO_FAST_BURN")
        if slow_burn is None:
            slow_burn = config.get_env("MXTPU_SLO_SLOW_BURN")
        self.pairs = [AlertPair(nm, s, l,
                                fast_burn if nm == "fast" else slow_burn,
                                pending_s=pending_s, resolve_s=resolve_s)
                      for nm, s, l in parsed]
        self.windows = sorted({w for p in self.pairs
                               for w in (p.short_s, p.long_s)})
        self.clock = clock if clock is not None else _default_clock
        max_window = max([self.window_s] + self.windows)
        self._lock = threading.Lock()
        self._ledger = _Ledger(max_window, resolution_s=resolution_s)
        self._eval_bucket = None    # last bucket the pairs were evaluated in

    # ------------------------------------------------------------- outcomes
    def classify(self, code, latency_ms=None):
        """'good' / 'bad' / None (not an SLO-eligible outcome)."""
        code = int(code)
        if 200 <= code < 300:
            if (self.kind in ("latency", "inter_token")
                    and latency_ms is not None
                    and latency_ms > self.latency_ms):
                return "bad"
            return "good"
        if code == 429 or code == 504 or 500 <= code < 600:
            return "bad"
        return None                 # 400/404/...: the client's mistake

    def observe(self, code, latency_ms=None, now=None):
        """Feed one terminal outcome; returns the list of alert
        transitions it caused (the registry turns them into flightrec
        events). Evaluation is amortized to once per ledger bucket."""
        outcome = self.classify(code, latency_ms)
        if outcome is None:
            return []
        if now is None:
            now = self.clock()
        with self._lock:
            self._ledger.add(outcome == "good", now)
        try:
            _EVENTS.inc(slo=self.name, outcome=outcome)
        except Exception:
            _LOG.debug("slo event counter update failed", exc_info=True)
        return self.evaluate(now)

    # ---------------------------------------------------------------- reads
    def burn_rate(self, window_s, now=None):
        """bad_fraction over the window / (1 - target); 0 with no events."""
        if now is None:
            now = self.clock()
        with self._lock:
            g, b = self._ledger.window_counts(window_s, now)
        total = g + b
        if not total:
            return 0.0
        return (b / total) / (1.0 - self.target)

    def budget_remaining(self, now=None):
        """1 - spent fraction of the window's error budget, clamped at 0
        (a fully-good window reads 1.0; so does an empty one)."""
        if now is None:
            now = self.clock()
        with self._lock:
            g, b = self._ledger.window_counts(self.window_s, now)
        total = g + b
        if not total:
            return 1.0
        allowed = total * (1.0 - self.target)
        return max(0.0, 1.0 - b / allowed)

    def evaluate(self, now=None, force=False):
        """Advance every alert pair; returns [(pair, new_state,
        burn_short, burn_long), ...] for pairs that changed state.
        Amortized: repeat calls within one ledger bucket are no-ops
        unless ``force`` (scrape paths force, so resolution never waits
        for traffic)."""
        if now is None:
            now = self.clock()
        with self._lock:
            bucket = int(now // self._ledger.bucket_s)
            if not force and bucket == self._eval_bucket:
                return []
            self._eval_bucket = bucket
            burns = {}
            for w in self.windows:
                g, b = self._ledger.window_counts(w, now)
                total = g + b
                burns[w] = ((b / total) / (1.0 - self.target)
                            if total else 0.0)
            transitions = []
            for p in self.pairs:
                bs, bl = burns[p.short_s], burns[p.long_s]
                for state in p.evaluate(bs, bl, now):
                    transitions.append((p, state, bs, bl))
        return transitions

    def describe(self, now=None, evaluate=True):
        """Snapshot dict. ``evaluate=False`` lets a caller that already
        ran evaluate(now) itself (and emitted the transitions) skip the
        re-evaluation — a second forced pass with a later ``now`` could
        cross a state edge whose transition nobody would ever emit."""
        if now is None:
            now = self.clock()
        if evaluate:
            self.evaluate(now, force=True)
        out = {"name": self.name, "model": self.model, "kind": self.kind,
               "target": self.target,
               "window_s": self.window_s,
               "budget_remaining": self.budget_remaining(now),
               "burn_rates": {"%gs" % w: self.burn_rate(w, now)
                              for w in self.windows},
               "alerts": [p.describe(now) for p in self.pairs]}
        if self.latency_ms is not None:
            out["latency_ms"] = self.latency_ms
        return out


# ------------------------------------------------------------------ registry
class SLORegistry:
    """Name -> SLO map + the gauge/flightrec publication wiring.

    Only a registry constructed with ``publish=True`` (the process-wide
    ``REGISTRY``) binds the shared telemetry gauges — unit tests build
    private instances with a fake clock and read the SLO objects
    directly, so two registries never fight over one gauge series.
    """

    def __init__(self, clock=None, publish=False):
        self._lock = threading.Lock()
        self._slos = {}             # name -> SLO
        self._by_model = {}         # model -> [SLO, ...]
        self._gauge_fns = {}        # slo name -> [bound callbacks]
        self.clock = clock
        self.publish = publish

    # ----------------------------------------------------------- definition
    def define(self, name, model, **kw):
        """Get-or-create (idempotent by name; a re-define returns the
        existing SLO unchanged — ledgers must survive hot reloads)."""
        with self._lock:
            s = self._slos.get(name)
            if s is not None:
                return s
            kw.setdefault("clock", self.clock)
            s = SLO(name, model, **kw)
            self._slos[name] = s
            self._by_model.setdefault(model, []).append(s)
        if self.publish:
            self._publish(s)
        return s

    def ensure_model(self, model):
        """Seed the default objectives for one served model: availability
        always; latency too when MXTPU_SLO_LATENCY_MS is set. Called by
        the serving registry at model-entry creation."""
        from .. import config
        out = [self.define("%s/availability" % model, model,
                           kind="availability")]
        lat = config.get_env("MXTPU_SLO_LATENCY_MS")
        if lat is not None:
            out.append(self.define("%s/latency" % model, model,
                                   kind="latency", latency_ms=lat))
        return out

    def _publish(self, s):
        """Bind the live-sampling gauge callbacks for one SLO. Each
        callback evaluates first (amortized to once per ledger bucket —
        one scrape reading all of an SLO's series pays one evaluation,
        not one per series), so a scrape advances the alert lifecycle
        even when no traffic is arriving (firing alerts can resolve
        during a quiet incident tail)."""
        fns = []

        def budget_fn(s=s):
            self._emit(s.evaluate(), s)
            return s.budget_remaining()
        _BUDGET.set_function(budget_fn, slo=s.name)
        fns.append((_BUDGET, budget_fn))
        for w in s.windows:
            wl = "%gs" % w

            def burn_fn(s=s, w=w):
                self._emit(s.evaluate(), s)
                return s.burn_rate(w)
            _BURN.set_function(burn_fn, slo=s.name, window=wl)
            fns.append((_BURN, burn_fn))
        for p in s.pairs:
            def firing_fn(s=s, p=p):
                self._emit(s.evaluate(), s)
                return 1.0 if p.state == "firing" else 0.0
            _FIRING.set_function(firing_fn, slo=s.name, pair=p.name)
            fns.append((_FIRING, firing_fn))
        with self._lock:
            self._gauge_fns[s.name] = fns

    # ----------------------------------------------------------- observation
    def observe(self, model, code, latency_ms=None, now=None):
        """Feed one terminal outcome into every SLO of ``model`` (seeding
        the defaults on first sight of an ELIGIBLE outcome — a model
        served without going through registry.load still gets accounted,
        but a hostile probe of a nonexistent name, whose only possible
        outcomes are 400/404, never mints an SLO). Emits flightrec
        events for any alert transitions."""
        with self._lock:
            slos = list(self._by_model.get(model, ()))
        if not slos:
            if not _eligible(code):
                return
            slos = self.ensure_model(model)
        for s in slos:
            self._emit(s.observe(code, latency_ms=latency_ms, now=now), s)

    def observe_named(self, name, code, latency_ms=None, now=None):
        """Feed one outcome into EXACTLY the named SLO (no-op when it
        does not exist). The per-tenant inter-token objectives need this
        addressing: ``observe(model, ...)`` fans one outcome into every
        SLO of the model, which would charge tenant A's token gap
        against tenant B's budget. The caller defines the objective
        first (``define``) and then feeds only its own series here."""
        with self._lock:
            s = self._slos.get(name)
        if s is None:
            return
        self._emit(s.observe(code, latency_ms=latency_ms, now=now), s)

    def _emit(self, transitions, s):
        """One flightrec event per alert state transition — the alert
        history rides the black-box tape (and the crash/stall dumps)."""
        for p, state, burn_short, burn_long in transitions:
            flightrec.record("slo_alert", slo=s.name, pair=p.name,
                             state=state, threshold=p.threshold,
                             burn_short=round(burn_short, 3),
                             burn_long=round(burn_long, 3))

    # ------------------------------------------------------------ inspection
    def get(self, name):
        with self._lock:
            return self._slos.get(name)

    def for_model(self, model):
        with self._lock:
            return list(self._by_model.get(model, ()))

    def names_for_model(self, model):
        with self._lock:
            return [s.name for s in self._by_model.get(model, ())]

    def describe(self):
        """The GET /debug/slo payload: every SLO's budget, burn rates,
        and alert states (evaluated now)."""
        with self._lock:
            slos = list(self._slos.values())
        out = []
        for s in slos:
            now = s.clock()
            self._emit(s.evaluate(now, force=True), s)
            out.append(s.describe(now, evaluate=False))
        return {"slos": out}

    # -------------------------------------------------------------- teardown
    def detach_model(self, model):
        """Forget one model's SLOs and unbind their gauge callbacks
        (batcher close / model unload): a dead model must not export a
        frozen burn rate, nor have its gauge closures pin the ledgers.
        The mxtpu_slo_events_total counters stay — process-lifetime
        cumulative by Prometheus convention."""
        with self._lock:
            slos = self._by_model.pop(model, [])
            fns = []
            for s in slos:
                self._slos.pop(s.name, None)
                fns.extend(self._gauge_fns.pop(s.name, ()))
        for metric, fn in fns:
            metric.remove_function(fn)

    def reset(self):
        """Drop every SLO + gauge binding (test isolation)."""
        with self._lock:
            models = list(self._by_model)
        for m in models:
            self.detach_model(m)


#: The process-wide registry the serving path feeds (the only publisher
#: of the mxtpu_slo_* gauges).
REGISTRY = SLORegistry(publish=True)


def observe(model, code, latency_ms=None):
    REGISTRY.observe(model, code, latency_ms=latency_ms)


def ensure_model(model):
    return REGISTRY.ensure_model(model)


def describe():
    return REGISTRY.describe()
