"""Process-wide metrics registry with Prometheus text exposition.

Counterpart of ``incubator_mxnet_tpu/telemetry/registry.py``, carried over
with it: the module reads no device.

One registry serves every subsystem (serving, training, kvstore, data IO):
named counters, gauges, and fixed-bucket histograms, each with optional
labels, all behind one lock-per-metric design cheap enough to stay on for
every request and every training step. ``export_text()`` renders the
Prometheus text format (version 0.0.4) without any external dependency —
the serving front-end serves it at ``GET /metrics`` and headless jobs
flush it to a file (telemetry.start_periodic_flush).

Design points:

- *Get-or-create*: ``counter(name, ...)`` returns the existing metric on
  repeat calls so every module can declare its metrics at import time
  without coordinating ownership; a re-declaration with a different type
  or label set raises loudly (silent divergence would corrupt exposition).
- *Bounded label cardinality*: a metric accepts at most
  ``MXTPU_TELEMETRY_MAX_SERIES`` distinct label combinations; past the
  bound new combinations are clamped onto the ``"_other_"`` series with a
  one-time RuntimeWarning — an unbounded label (request IDs, user IDs)
  must never OOM the process or melt the scrape.
- *Closed-right histogram buckets*: an observation lands in every bucket
  whose upper bound ``le`` is >= the value (Prometheus ``le`` is an
  INCLUSIVE upper bound); exposition is cumulative with a ``+Inf``
  terminal bucket, ``_sum`` and ``_count``.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import warnings

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "export_text", "reset",
           "DEFAULT_BUCKETS", "OVERFLOW_LABEL"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Series a metric folds overflow label combinations onto once the
#: cardinality bound is hit (every label value becomes this sentinel).
OVERFLOW_LABEL = "_other_"

#: Default histogram buckets (seconds-flavored; pass explicit buckets for
#: anything that is not a small latency).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


def _max_series():
    # read lazily so MXTPU_TELEMETRY_MAX_SERIES set before first overflow
    # takes effect without an import-order dance
    from .. import config
    return max(1, config.get_env("MXTPU_TELEMETRY_MAX_SERIES"))


def _escape_label_value(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h):
    return str(h).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v):
    """Prometheus sample value: integers render without a trailing .0."""
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v == -math.inf:
            return "-Inf"
        if v != v:  # NaN
            return "NaN"
        if v.is_integer() and abs(v) < 1e15:
            return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _Metric:
    """Shared label handling: series keyed by the label-value tuple."""

    type_name = "untyped"

    def __init__(self, name, help, labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError("invalid label name %r (metric %r)"
                                 % (ln, name))
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series = {}            # label-value tuple -> series state
        self._overflowed = False

    def _key(self, labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                "metric %r takes labels %r, got %r"
                % (self.name, self.labelnames, tuple(sorted(labels))))
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _series_for(self, labels, factory):
        """Resolve (creating if needed) the series for a label set, with
        the cardinality clamp. Caller holds no lock; this takes it."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= _max_series() and self.labelnames:
                    if not self._overflowed:
                        self._overflowed = True
                        warnings.warn(
                            "metric %r exceeded MXTPU_TELEMETRY_MAX_SERIES "
                            "(%d) distinct label sets — new label values are "
                            "clamped onto %r. An unbounded label (request "
                            "id, user id, raw path) does not belong on a "
                            "metric." % (self.name, _max_series(),
                                         OVERFLOW_LABEL),
                            RuntimeWarning, stacklevel=4)
                    key = tuple(OVERFLOW_LABEL for _ in self.labelnames)
                    s = self._series.get(key)
                if s is None:
                    s = factory()
                    self._series[key] = s
            return s

    def remove(self, **labels):
        """Drop one series (e.g. a gauge callback whose owner is being
        unloaded — a dead model must not export stale depth forever nor
        pin its queue in memory). No-op if the series never existed."""
        key = self._key(labels)
        with self._lock:
            self._series.pop(key, None)

    def _label_str(self, key, extra=""):
        parts = ['%s="%s"' % (ln, _escape_label_value(v))
                 for ln, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{%s}" % ",".join(parts) if parts else ""

    def _header_lines(self):
        return ["# HELP %s %s" % (self.name, _escape_help(self.help)),
                "# TYPE %s %s" % (self.name, self.type_name)]


class Counter(_Metric):
    """Monotonically increasing value (use a Gauge for anything that can
    fall). ``inc(n, **labels)``; negative increments raise."""

    type_name = "counter"

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError("counter %r cannot decrease (inc %r)"
                             % (self.name, n))
        s = self._series_for(labels, lambda: [0])
        with self._lock:
            s[0] += n

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return s[0] if s is not None else 0

    def collect(self):
        lines = self._header_lines()
        with self._lock:
            for key in sorted(self._series):
                lines.append("%s%s %s" % (self.name, self._label_str(key),
                                          _fmt(self._series[key][0])))
        return lines

    def series(self):
        """[(labels_dict, value)] snapshot for programmatic consumers
        (devstats.dispatch_totals sums windows over every label set —
        exposition-text parsing is for scrapers, not in-process code)."""
        with self._lock:
            items = [(key, s[0]) for key, s in sorted(self._series.items())]
        return [(dict(zip(self.labelnames, key)), v) for key, v in items]


class Gauge(_Metric):
    """Point-in-time value: ``set``/``inc``/``dec``, or ``set_function`` to
    sample a callable at exposition time (queue depths, cache sizes)."""

    type_name = "gauge"

    def set(self, v, **labels):
        s = self._series_for(labels, lambda: [0.0])
        with self._lock:
            # same guard as inc/dec: a series bound to a live sampler via
            # set_function() must not be silently frozen to a constant
            if callable(s[0]):
                raise ValueError(
                    "gauge %r series is bound to a callback via "
                    "set_function(); set() would silently detach the "
                    "live sampler (use set_function again, or "
                    "remove_function first)" % self.name)
            s[0] = v

    def inc(self, n=1, **labels):
        s = self._series_for(labels, lambda: [0.0])
        with self._lock:
            if callable(s[0]):
                raise ValueError(
                    "gauge %r series is bound to a callback via "
                    "set_function(); inc/dec would silently detach the "
                    "live sampler" % self.name)
            s[0] += n

    def dec(self, n=1, **labels):
        self.inc(-n, **labels)

    def set_function(self, fn, **labels):
        """Bind the series to ``fn() -> number``, evaluated per export."""
        s = self._series_for(labels, lambda: [0.0])
        with self._lock:
            s[0] = fn

    def remove_function(self, fn):
        """Drop every series bound to exactly ``fn`` (identity compare).
        The safe unbind for an owner being torn down: a label-keyed
        remove() could delete a NEWER owner's series after a reload race,
        or miss a series the cardinality clamp re-keyed onto the overflow
        label — identity can do neither. No-op if fn is not bound."""
        if fn is None:
            return
        with self._lock:
            for k in [k for k, s in self._series.items() if s[0] is fn]:
                self._series.pop(k)

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            raw = s[0] if s is not None else 0.0
        if callable(raw):
            try:
                return raw()
            except Exception:
                return 0.0
        return raw

    def collect(self):
        lines = self._header_lines()
        for key, val in self._evaluated():
            lines.append("%s%s %s" % (self.name, self._label_str(key),
                                      _fmt(val)))
        return lines

    def _evaluated(self):
        """[(key_tuple, float)] with set_function callbacks sampled NOW —
        the one place gauge callbacks are evaluated, shared by text
        exposition and the programmatic series() walk (evaluating an SLO
        gauge advances its alert state machine; both consumers must drive
        it identically)."""
        with self._lock:
            items = [(key, s[0]) for key, s in sorted(self._series.items())]
        out = []
        for key, raw in items:
            try:
                if callable(raw):
                    raw = raw()
                val = float(raw)
            except Exception:  # a dead/None-returning callback must not
                val = 0.0      # kill the scrape
            out.append((key, val))
        return out

    def series(self):
        """[(labels_dict, value)] snapshot with callbacks evaluated — the
        programmatic mirror of Counter.series() for in-process consumers
        (the history self-scrape reads depth/burn gauges through this
        instead of re-parsing its own process's exposition text)."""
        return [(dict(zip(self.labelnames, key)), v)
                for key, v in self._evaluated()]


class Histogram(_Metric):
    """Fixed-bucket histogram. Buckets are CLOSED-RIGHT: an observation
    equal to a boundary counts in that boundary's bucket (Prometheus
    ``le`` semantics); exposition is cumulative with ``+Inf``/_sum/_count."""

    type_name = "histogram"

    def __init__(self, name, help, buckets=DEFAULT_BUCKETS, labelnames=()):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram %r needs at least one bucket" % name)
        if bounds[-1] == math.inf:
            bounds = bounds[:-1]
        self.buckets = tuple(bounds)

    def _new_series(self):
        # per-bucket NON-cumulative counts + [sum, count]; cumulated at
        # exposition so observe() touches exactly one bucket slot
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                "count": 0}

    def observe(self, v, **labels):
        v = float(v)
        s = self._series_for(labels, self._new_series)
        # closed-right: first bucket with bound >= v; bisect_left returns
        # exactly that index (the +Inf overflow slot is the final index)
        lo = bisect.bisect_left(self.buckets, v)
        with self._lock:
            s["counts"][lo] += 1
            s["sum"] += v
            s["count"] += 1

    def value(self, **labels):
        """(sum, count) for one series — the cheap programmatic read."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return (s["sum"], s["count"]) if s is not None else (0.0, 0)

    def series(self):
        """[(labels_dict, (sum, count))] snapshot — the programmatic
        mirror of Counter.series(); the history self-scrape derives
        per-tick mean latency from the sum/count deltas."""
        with self._lock:
            items = [(key, (s["sum"], s["count"]))
                     for key, s in sorted(self._series.items())]
        return [(dict(zip(self.labelnames, key)), v) for key, v in items]

    def bucket_counts(self, **labels):
        """CUMULATIVE counts per bucket bound (+Inf last) — test hook."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            raw = list(s["counts"]) if s is not None \
                else [0] * (len(self.buckets) + 1)
        out, acc = [], 0
        for c in raw:
            acc += c
            out.append(acc)
        return out

    def collect(self):
        lines = self._header_lines()
        with self._lock:
            items = [(key, [list(s["counts"]), s["sum"], s["count"]])
                     for key, s in sorted(self._series.items())]
        for key, (counts, total, count) in items:
            acc = 0
            for bound, c in zip(self.buckets, counts):
                acc += c
                lines.append("%s_bucket%s %d" % (
                    self.name,
                    self._label_str(key, 'le="%s"' % _fmt(float(bound))),
                    acc))
            acc += counts[-1]
            lines.append("%s_bucket%s %d" % (
                self.name, self._label_str(key, 'le="+Inf"'), acc))
            lines.append("%s_sum%s %s" % (self.name, self._label_str(key),
                                          _fmt(float(total))))
            lines.append("%s_count%s %d" % (self.name, self._label_str(key),
                                            count))
        return lines


class MetricsRegistry:
    """Thread-safe name -> metric map with get-or-create declaration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _declare(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls:
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, type(m).type_name, cls.type_name))
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r already registered with labels %r, not %r"
                        % (name, m.labelnames, tuple(labelnames)))
                if "buckets" in kw:
                    bounds = sorted(float(b) for b in kw["buckets"]
                                    if float(b) != math.inf)
                    if tuple(bounds) != m.buckets:
                        raise ValueError(
                            "histogram %r already registered with buckets "
                            "%r, not %r — observations would silently land "
                            "in the wrong bounds"
                            % (name, m.buckets, tuple(bounds)))
                return m
            m = cls(name, help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS,
                  labelnames=()):
        m = self._declare(Histogram, name, help, labelnames, buckets=buckets)
        return m

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def samples(self):
        """Every numeric sample in the registry as ``(name, kind,
        labels_dict, value)`` tuples, sorted by metric name — the
        registry-iteration API the metric-history self-scrape
        (telemetry/history.py) walks each tick. Counters and gauges
        yield one sample per label set (gauge callbacks evaluated NOW,
        exactly like text exposition); histograms yield ``<name>_sum``
        and ``<name>_count`` samples so rate rules can derive per-tick
        means without parsing exposition text."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out = []
        for m in metrics:
            kind = m.type_name
            if isinstance(m, Histogram):
                for labels, (total, count) in m.series():
                    out.append((m.name + "_sum", kind, labels,
                                float(total)))
                    out.append((m.name + "_count", kind, labels,
                                float(count)))
            else:
                for labels, v in m.series():
                    out.append((m.name, kind, labels, float(v)))
        return out

    def export_text(self):
        """The full Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        """Zero every metric's series IN PLACE — test isolation only;
        production metrics are process-lifetime cumulative. The metric
        objects themselves stay registered: modules cache them at import
        time, and dropping the name->metric map would orphan those caches
        (updates still applied, but invisible to every future export)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                m._series.clear()
                m._overflowed = False


#: The process-wide default registry every subsystem instruments against.
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", buckets=DEFAULT_BUCKETS, labelnames=()):
    return REGISTRY.histogram(name, help, buckets=buckets,
                              labelnames=labelnames)


def export_text():
    return REGISTRY.export_text()


def reset():
    REGISTRY.reset()
