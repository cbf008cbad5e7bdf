"""Metric history (counterpart of ``incubator_mxnet_tpu/telemetry/
history.py``, carried over as it is; its window MFU reads the dispatch
totals ``telemetry.devstats`` publishes under the JAX package's names): a
bounded in-process time-series store — *what did the metrics look like in
the 90 seconds before the page*.

Every existing signal is instantaneous (a scrape, an EMA gauge, an event
ring with no metric context). This module closes the postmortem gap: a
daemon thread self-scrapes the process-wide telemetry registry every
``MXTPU_HISTORY_INTERVAL_S`` through ``REGISTRY.samples()`` (the
registry-iteration API — no exposition-text round trip) into per-series
fixed-size rings with tiered downsampling:

- **raw ring** — the newest ``MXTPU_HISTORY_RAW`` (t, value) points;
- **coarse ring** — every ``MXTPU_HISTORY_COARSE_EVERY`` raw samples fold
  into one {t, min, max, mean} point, ``MXTPU_HISTORY_COARSE`` kept — so
  retention covers RAW*interval of full-resolution history plus
  COARSE*COARSE_EVERY*interval of summarized history, in constant memory.

Recording rules run at sample time, not query time:

- ``rate(<counter>)``       — per-second increase of every counter since
  the previous tick (scrape-gap-exact, clamped at resets);
- ``slope(<gauge>)``        — least-squares trend of queue-depth and SLO
  burn-rate gauges over ``MXTPU_HISTORY_SLOPE_WINDOW_S`` (the
  burn-rate *trajectory*: is the budget spend accelerating?);
- ``mxtpu_history_window_mfu`` — window MFU from devstats dispatch-total
  deltas between ticks (delta flops / delta chip-seconds / peak), the
  honest utilization-over-time series the cumulative gauges cannot give.

A trend detector turns the derived series into hysteresis-gated flightrec
early warnings — one event per episode, not per tick:

- ``pressure_rising``  — a model's queue-depth trend line predicts
  crossing its capacity (mxtpu_serving_queue_capacity, else
  ``MXTPU_HISTORY_PRESSURE_DEPTH``) within
  ``MXTPU_HISTORY_PRESSURE_HORIZON_S``; closes when the prediction
  retreats past twice the horizon or the slope turns non-positive.
- ``mfu_droop`` — window MFU falls below ``MXTPU_HISTORY_DROOP_FRAC`` of
  its trailing ``MXTPU_HISTORY_DROOP_WINDOW_S`` median; closes at
  halfway between the droop line and the median (re-arm hysteresis).

Consumption: ``GET /debug/history?series=&since=&step=`` (query()),
``GET /debug/incident?around=<ts>`` (incident() — flightrec events, SLO
alert transitions and metric excursions merged into one causally-ordered
timeline on the shared perf_counter anchor), JSONL export to
``MXTPU_HISTORY_FILE`` (atomic tmp+rename rotation; tools/tsq.py reads
it offline), and the loadgen between-stage ``history`` block.

Lifecycle mirrors the watchdog: ``start()``/``stop()``/``running()``,
``MXTPU_HISTORY=1`` autostarts at package import, and batcher close calls
``detach_model(name)`` so an unloaded model's series and episode state do
not outlive it. Samples are timestamped with BOTH clocks (epoch-anchored
``profiler.now_us`` and raw ``perf_counter``) so they join flightrec's
dual-clock events exactly.
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
import re
import threading
import time

from . import flightrec
from .registry import REGISTRY, counter

__all__ = ["sample_once", "query", "stats", "series_names", "incident",
           "export_jsonl", "detach_model", "start", "stop", "running",
           "describe", "reset"]

_LOG = logging.getLogger(__name__)

#: gauges whose trend (least-squares slope) is a recording rule — queue
#: depths feed the pressure detector, burn rates give the SLO trajectory
SLOPE_RULES = ("mxtpu_serving_queue_depth", "mxtpu_slo_burn_rate")

#: metric prefixes the history store does NOT retain: its own bookkeeping
#: (self-reference would grow series per restart) — everything else the
#: registry exports is fair game for the postmortem.
_SKIP_PREFIXES = ("mxtpu_history_store_",)

_TICKS = counter(
    "mxtpu_history_store_ticks_total",
    "Self-scrape ticks the metric-history daemon completed.")
_DROPPED = counter(
    "mxtpu_history_store_dropped_series_total",
    "Samples dropped because the store was at MXTPU_HISTORY_MAX_SERIES "
    "distinct series (new series only; established series keep "
    "recording).")
_WARNINGS = counter(
    "mxtpu_history_early_warnings_total",
    "Trend-detector episodes opened, by kind (pressure_rising, "
    "mfu_droop) — one per episode, not per tick.", ("kind",))


def _cfg(name):
    from .. import config
    return config.get_env(name)


def _now_s():
    from .. import profiler
    return profiler.now_us() / 1e6


class _Series:
    """One series' tiered rings + fold accumulator. All mutation happens
    under the store lock (the sampler is single-threaded; queries and
    exports take the same lock for a consistent copy)."""

    __slots__ = ("raw", "coarse", "_acc", "_acc_n")

    def __init__(self, raw_cap, coarse_cap):
        self.raw = collections.deque(maxlen=raw_cap)     # (t, value)
        self.coarse = collections.deque(maxlen=coarse_cap)  # (t,min,max,mean)
        self._acc = None                 # [t0, min, max, sum, n] folding
        self._acc_n = 0

    def add(self, t, v, fold_every):
        self.raw.append((t, v))
        if self._acc is None:
            self._acc = [t, v, v, 0.0, 0]
        a = self._acc
        a[1] = min(a[1], v)
        a[2] = max(a[2], v)
        a[3] += v
        a[4] += 1
        if a[4] >= fold_every:
            # the coarse point is stamped at the fold's LAST raw t: the
            # summary describes the window ENDING there
            self.coarse.append((t, a[1], a[2], a[3] / a[4]))
            self._acc = None


class _Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._series = {}          # series id -> _Series
        self._prev_counters = {}   # series id -> (t, value) for rate()
        self._prev_devstats = None  # (t, flops, chip_s)
        self._episodes = {}        # (kind, key) -> True while open
        self._last_mono = None     # perf_counter of the newest tick
        self._last_epoch = None

    def reset(self):
        with self._lock:
            self._series.clear()
            self._prev_counters.clear()
            self._prev_devstats = None
            self._episodes.clear()
            self._last_mono = self._last_epoch = None


_STORE = _Store()

_state_lock = threading.Lock()   # daemon lifecycle only
_thread = None
_stop_event = None


# ------------------------------------------------------------ series ids
def _series_id(name, labels):
    """Prometheus-style identity: ``name{label="v",...}`` (labels in the
    metric's declared order, the same rendering exposition uses) — the
    key series are queried, exported, and diffed by."""
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join('%s="%s"' % (k, v)
                                      for k, v in labels.items()))


_MODEL_LABEL_RE = re.compile(r'model="([^"]*)"')


def _series_model(sid):
    m = _MODEL_LABEL_RE.search(sid)
    return m.group(1) if m else None


# ------------------------------------------------------------- sampling
def _put(t, sid, value, raw_cap, coarse_cap, fold_every, max_series):
    """Record one sample under the store lock; new series past the cap
    are dropped (counted), established series always record."""
    s = _STORE._series.get(sid)
    if s is None:
        if len(_STORE._series) >= max_series:
            _DROPPED.inc()
            return
        s = _STORE._series[sid] = _Series(raw_cap, coarse_cap)
    s.add(t, float(value), fold_every)


def _linfit_slope(points):
    """Least-squares slope (value units per second) of [(t, v)] — the
    queue-depth / burn-rate trend rule. None for degenerate windows."""
    n = len(points)
    if n < 3:
        return None
    mt = sum(p[0] for p in points) / n
    mv = sum(p[1] for p in points) / n
    den = sum((p[0] - mt) ** 2 for p in points)
    if den <= 0.0:
        return None
    return sum((p[0] - mt) * (p[1] - mv) for p in points) / den


def _window_mfu(t):
    """Window MFU from devstats dispatch-total deltas between ticks —
    None when devstats is idle (no dispatches this window)."""
    try:
        from . import devstats
        tot = devstats.dispatch_totals()
        peak = devstats.peaks()[0]
    except Exception:
        return None
    cur = (t, float(tot["flops"]), float(tot["chip_s"]))
    prev, _STORE._prev_devstats = _STORE._prev_devstats, cur
    if prev is None:
        return None
    d_flops, d_chip = cur[1] - prev[1], cur[2] - prev[2]
    if d_chip <= 0.0 or peak <= 0.0:
        return None
    return max(0.0, d_flops / d_chip / peak)


def _trailing(sid, t, window_s):
    ser = _STORE._series.get(sid)
    if ser is None:
        return []
    lo = t - window_s
    return [p for p in ser.raw if p[0] >= lo]


def _episode(kind, key, open_now, fields):
    """Hysteresis bookkeeping: flightrec-record the OPEN transition once
    per episode; silently close. Returns True while the episode is open."""
    ek = (kind, key)
    was = _STORE._episodes.get(ek, False)
    if open_now and not was:
        _STORE._episodes[ek] = True
        flightrec.record(kind, **fields)
        _WARNINGS.inc(kind=kind)
    elif not open_now and was:
        _STORE._episodes.pop(ek, None)
    return open_now


def _detect_pressure(t, depths, capacities, horizon_s, fallback_depth,
                     slope_window_s):
    """pressure_rising per model: the depth trend line predicts crossing
    capacity within the horizon. Open: predicted time-to-saturation <=
    horizon. Close: slope <= 0 or prediction retreats past 2x horizon
    (hysteresis — a prediction hovering at the boundary must not flap)."""
    for model, depth in depths.items():
        sid = _series_id("mxtpu_serving_queue_depth", {"model": model})
        slope = _linfit_slope(_trailing(sid, t, slope_window_s))
        cap = capacities.get(model, fallback_depth)
        ek = ("pressure_rising", model)
        if slope is None or cap is None or cap <= 0.0:
            _STORE._episodes.pop(ek, None)
            continue
        _put(t, "slope(%s)" % sid, slope, *_caps())
        if slope <= 0.0 or depth >= cap:
            # falling (or already saturated — that is shedding territory,
            # not an early warning): close
            _STORE._episodes.pop(ek, None)
            continue
        eta_s = (cap - depth) / slope
        was_open = _STORE._episodes.get(ek, False)
        open_now = eta_s <= (horizon_s if not was_open else 2.0 * horizon_s)
        _episode("pressure_rising", model, open_now,
                 {"model": model, "queue_depth": depth, "capacity": cap,
                  "slope_per_s": slope, "eta_s": eta_s,
                  "horizon_s": horizon_s})


def _detect_droop(t, mfu, droop_frac, droop_window_s):
    """mfu_droop: window MFU below droop_frac of its trailing median.
    Close threshold is halfway between the droop line and the median —
    MFU must genuinely recover before the detector re-arms."""
    sid = "mxtpu_history_window_mfu"
    pts = _trailing(sid, t, droop_window_s)
    ek = ("mfu_droop", "-")
    if mfu is None or len(pts) < 6:
        _STORE._episodes.pop(ek, None)
        return
    vals = sorted(v for _, v in pts)
    med = vals[len(vals) // 2]
    if med <= 0.0:
        _STORE._episodes.pop(ek, None)
        return
    open_thr = droop_frac * med
    close_thr = (open_thr + med) / 2.0
    was_open = _STORE._episodes.get(ek, False)
    open_now = mfu < (close_thr if was_open else open_thr)
    _episode("mfu_droop", "-", open_now,
             {"window_mfu": mfu, "median_mfu": med, "droop_frac": droop_frac,
              "window_s": droop_window_s})


def _caps():
    return (max(2, int(_cfg("MXTPU_HISTORY_RAW"))),
            max(2, int(_cfg("MXTPU_HISTORY_COARSE"))),
            max(1, int(_cfg("MXTPU_HISTORY_COARSE_EVERY"))),
            max(1, int(_cfg("MXTPU_HISTORY_MAX_SERIES"))))


def sample_once(now_s=None):
    """One self-scrape tick: walk REGISTRY.samples(), evaluate the
    recording rules against the previous tick, run the trend detector,
    export when MXTPU_HISTORY_FILE is set. The daemon calls this on its
    interval; tests and the CI stage call it directly for deterministic
    timelines. Returns the number of samples stored this tick."""
    t = _now_s() if now_s is None else float(now_s)
    raw_cap, coarse_cap, fold_every, max_series = _caps()
    try:
        scraped = REGISTRY.samples()
    except Exception:
        _LOG.debug("history scrape failed", exc_info=True)
        return 0
    stored = 0
    depths, capacities = {}, {}
    with _STORE._lock:
        _STORE._last_mono = time.perf_counter()
        _STORE._last_epoch = t
        for name, kind, labels, value in scraped:
            if name.startswith(_SKIP_PREFIXES):
                continue
            sid = _series_id(name, labels)
            _put(t, sid, value, raw_cap, coarse_cap, fold_every,
                 max_series)
            stored += 1
            if kind == "counter" or name.endswith(("_sum", "_count")):
                # rate() rule: per-second increase since the previous
                # tick; a reset (restarted counter) clamps to 0, never a
                # negative rate
                prev = _STORE._prev_counters.get(sid)
                _STORE._prev_counters[sid] = (t, value)
                if prev is not None and t > prev[0]:
                    rate = max(0.0, (value - prev[1]) / (t - prev[0]))
                    _put(t, "rate(%s)" % sid, rate, raw_cap, coarse_cap,
                         fold_every, max_series)
            elif name == "mxtpu_serving_queue_depth":
                depths[labels.get("model", "-")] = value
            elif name == "mxtpu_serving_queue_capacity":
                capacities[labels.get("model", "-")] = value
            elif name == "mxtpu_slo_burn_rate":
                slope = _linfit_slope(_trailing(sid, t, float(
                    _cfg("MXTPU_HISTORY_SLOPE_WINDOW_S"))))
                if slope is not None:
                    _put(t, "slope(%s)" % sid, slope, raw_cap,
                         coarse_cap, fold_every, max_series)
        mfu = _window_mfu(t)
        if mfu is not None:
            _put(t, "mxtpu_history_window_mfu", mfu, raw_cap, coarse_cap,
                 fold_every, max_series)
        try:
            _detect_pressure(
                t, depths, capacities,
                float(_cfg("MXTPU_HISTORY_PRESSURE_HORIZON_S")),
                _cfg("MXTPU_HISTORY_PRESSURE_DEPTH"),
                float(_cfg("MXTPU_HISTORY_SLOPE_WINDOW_S")))
            _detect_droop(t, mfu, float(_cfg("MXTPU_HISTORY_DROOP_FRAC")),
                          float(_cfg("MXTPU_HISTORY_DROOP_WINDOW_S")))
        except Exception:
            _LOG.debug("history trend detection failed", exc_info=True)
    _TICKS.inc()
    path = _cfg("MXTPU_HISTORY_FILE")
    if path:
        try:
            export_jsonl(path)
        except Exception:
            _LOG.debug("history export to %r failed", path, exc_info=True)
    return stored


# -------------------------------------------------------------- querying
def series_names():
    """Sorted ids of every retained series (scraped and derived)."""
    with _STORE._lock:
        return sorted(_STORE._series)


def _downsample(points, step):
    """Raw (t, v) points folded into step-aligned {t, min, max, mean}
    buckets (t = bucket END) — the ?step= query shape, same summary
    statistics as the coarse ring."""
    out = []
    cur_end, mn, mx, sm, n = None, 0.0, 0.0, 0.0, 0
    for t, v in points:
        end = (math.floor(t / step) + 1) * step
        if cur_end is None or end != cur_end:
            if n:
                out.append({"t": cur_end, "min": mn, "max": mx,
                            "mean": sm / n})
            cur_end, mn, mx, sm, n = end, v, v, 0.0, 0
        mn, mx = min(mn, v), max(mx, v)
        sm += v
        n += 1
    if n:
        out.append({"t": cur_end, "min": mn, "max": mx, "mean": sm / n})
    return out


def query(series=None, since=None, step=None):
    """The /debug/history payload. ``series``: exact id, bare metric name
    (matches every label set), or substring; ``since``: epoch seconds
    (drop older points); ``step``: fold raw points into step-second
    min/max/mean buckets instead of returning them verbatim. The coarse
    ring rides along untouched — it is the long-horizon context."""
    with _STORE._lock:
        ids = sorted(_STORE._series)
        if series:
            ids = [sid for sid in ids
                   if sid == series or series in sid
                   or sid.split("{", 1)[0] == series]
        picked = {sid: (list(_STORE._series[sid].raw),
                        list(_STORE._series[sid].coarse)) for sid in ids}
        out = {"now": _STORE._last_epoch, "interval_s":
               float(_cfg("MXTPU_HISTORY_INTERVAL_S")), "series": {}}
    for sid, (raw, coarse) in picked.items():
        if since is not None:
            raw = [p for p in raw if p[0] >= since]
            coarse = [p for p in coarse if p[0] >= since]
        entry = {"coarse": [{"t": t, "min": mn, "max": mx, "mean": mean}
                            for t, mn, mx, mean in coarse]}
        if step:
            entry["raw"] = _downsample(raw, float(step))
        else:
            entry["raw"] = [[t, v] for t, v in raw]
        out["series"][sid] = entry
    return out


def stats(series, since=None):
    """(min, max, mean, n) over one series' retained raw points — the
    cheap reduction the loadgen between-stage history block reports."""
    with _STORE._lock:
        ser = _STORE._series.get(series)
        pts = list(ser.raw) if ser is not None else []
    if since is not None:
        pts = [p for p in pts if p[0] >= since]
    if not pts:
        return None
    vals = [v for _, v in pts]
    return (min(vals), max(vals), sum(vals) / len(vals), len(vals))


# ------------------------------------------------------------- incidents
#: series whose excursions an incident report hunts for — the saturation
#: and health signals a postmortem reads first.
_EXCURSION_SERIES = ("mxtpu_serving_queue_depth",
                     "mxtpu_serving_replica_queue_depth",
                     "mxtpu_http_inflight_requests",
                     "mxtpu_history_window_mfu",
                     "mxtpu_slo_burn_rate")


def _excursions(win_lo, win_hi):
    """Metric excursions inside [win_lo, win_hi]: for each watched series,
    the in-window extreme that escapes the out-of-window envelope (the
    series' own quiet baseline). Returns timeline entries stamped at the
    extreme's sample time."""
    with _STORE._lock:
        picked = {sid: list(ser.raw)
                  for sid, ser in _STORE._series.items()
                  if sid.split("{", 1)[0] in _EXCURSION_SERIES}
    out = []
    for sid, pts in sorted(picked.items()):
        inside = [p for p in pts if win_lo <= p[0] <= win_hi]
        outside = [v for t, v in pts if t < win_lo or t > win_hi]
        if not inside:
            continue
        hi_t, hi_v = max(inside, key=lambda p: p[1])
        lo_t, lo_v = min(inside, key=lambda p: p[1])
        if outside:
            base_hi, base_lo = max(outside), min(outside)
            spread = max(base_hi - base_lo, 1e-9)
        else:
            # no baseline: only a genuinely moving series is reportable
            base_hi, base_lo = hi_v, lo_v
            spread = max(hi_v - lo_v, 1e-9)
            if hi_v == lo_v:
                continue
        if hi_v > base_hi + 0.5 * spread or (not outside and hi_v > lo_v):
            out.append({"t": hi_t, "type": "excursion", "series": sid,
                        "direction": "high", "value": hi_v,
                        "baseline_max": base_hi, "baseline_min": base_lo})
        if outside and lo_v < base_lo - 0.5 * spread:
            out.append({"t": lo_t, "type": "excursion", "series": sid,
                        "direction": "low", "value": lo_v,
                        "baseline_max": base_hi, "baseline_min": base_lo})
    return out


def incident(around=None, before_s=90.0, after_s=30.0):
    """The /debug/incident payload: one causally-ordered timeline of
    flightrec events (fault injections, respawns, early warnings), SLO
    alert transitions (the slo_alert events the SLO engine records), and
    the metric excursions bracketing them, for the window
    ``[around-before_s, around+after_s]``. ``around`` is epoch seconds
    (profiler.now_us()/1e6 domain), default now. Ordering is on the
    shared perf_counter anchor (events' mono_us, converted via this
    process's constant epoch-mono offset), so an NTP step between event
    and scrape cannot reorder the story."""
    t_now = _now_s()
    around = t_now if around is None else float(around)
    win_lo, win_hi = around - float(before_s), around + float(after_s)
    # this process's constant offset between the epoch-anchored clock and
    # raw perf_counter: lets event mono_us sort on the same axis as the
    # epoch-stamped samples
    off = t_now - time.perf_counter()
    entries = []
    for ev in flightrec.snapshot():
        t = flightrec.event_mono_us(ev) / 1e6
        if "mono_us" in ev:
            t += off
        if not (win_lo <= t <= win_hi):
            continue
        kind = "alert" if ev.get("event") == "slo_alert" else "event"
        e = {"t": t, "type": kind}
        e.update({k: v for k, v in ev.items() if k != "mono_us"})
        entries.append(e)
    entries.extend(_excursions(win_lo, win_hi))
    entries.sort(key=lambda e: (e["t"], e.get("seq", 0)))
    return {"around": around, "window": [win_lo, win_hi],
            "timeline": entries}


# --------------------------------------------------------------- export
def _canon(obj):
    """The one serialization tsq must byte-match on round-trip."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def export_jsonl(path=None):
    """Write the full store as JSONL — one meta line, then one line per
    series, sorted — atomically (tmp + rename, the flush_to_file
    discipline): a concurrent tsq read never sees a torn file. The
    serialization is canonical (sorted keys, no whitespace) so tsq can
    round-trip it byte-stable. Returns the path."""
    if path is None:
        path = _cfg("MXTPU_HISTORY_FILE")
    if not path:
        raise ValueError("no path given and MXTPU_HISTORY_FILE unset")
    with _STORE._lock:
        meta = {"schema": "mxtpu-history-v1",
                "interval_s": float(_cfg("MXTPU_HISTORY_INTERVAL_S")),
                "now": _STORE._last_epoch}
        rows = [{"series": sid,
                 "raw": [[t, v] for t, v in ser.raw],
                 "coarse": [[t, mn, mx, mean]
                            for t, mn, mx, mean in ser.coarse]}
                for sid, ser in sorted(_STORE._series.items())]
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        f.write(_canon(meta) + "\n")
        for row in rows:
            f.write(_canon(row) + "\n")
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------- lifecycle
def detach_model(model):
    """Drop every series labeled model=<model> (scraped AND derived) plus
    its trend-episode and rate state — batcher close calls this so an
    unloaded model's history cannot leak memory or resurface in the next
    incident report."""
    needle = 'model="%s"' % model
    with _STORE._lock:
        for sid in [s for s in _STORE._series if needle in s]:
            _STORE._series.pop(sid, None)
        for sid in [s for s in _STORE._prev_counters if needle in s]:
            _STORE._prev_counters.pop(sid, None)
        for ek in [k for k in _STORE._episodes if k[1] == model]:
            _STORE._episodes.pop(ek, None)


def describe():
    """Store shape for dashboards/tests: series count, caps, tick facts."""
    raw_cap, coarse_cap, fold_every, max_series = _caps()
    with _STORE._lock:
        n = len(_STORE._series)
        last = _STORE._last_epoch
    return {"series": n, "max_series": max_series, "raw_cap": raw_cap,
            "coarse_cap": coarse_cap, "coarse_every": fold_every,
            "interval_s": float(_cfg("MXTPU_HISTORY_INTERVAL_S")),
            "last_tick": last, "running": running()}


def _monitor(stop, interval_s):
    while not stop.wait(interval_s):
        try:
            sample_once()
        except Exception:
            # the postmortem recorder must outlive what it records — but
            # a broken tick must not be silent either (R005)
            _LOG.debug("history tick failed", exc_info=True)


def start(interval_s=None):
    """Start (or restart with new settings) the self-scrape daemon.
    Default interval: MXTPU_HISTORY_INTERVAL_S. Returns the thread."""
    global _thread, _stop_event
    if interval_s is None:
        interval_s = _cfg("MXTPU_HISTORY_INTERVAL_S")
    interval_s = max(0.01, float(interval_s))
    with _state_lock:
        _stop_locked()
        stop_ev = threading.Event()
        t = threading.Thread(target=_monitor, args=(stop_ev, interval_s),
                             daemon=True, name="mxtpu-history")
        _stop_event, _thread = stop_ev, t
        t.start()
    return t


def _stop_locked():
    global _thread, _stop_event
    stop_ev, t = _stop_event, _thread
    _stop_event = _thread = None
    if stop_ev is not None:
        stop_ev.set()
        if t is not None:
            t.join(timeout=5.0)


def stop():
    """Stop and join the daemon (R007: the daemon flag is a crash-exit
    backstop, not a lifecycle plan). The store keeps its rings — history
    outlives the sampler so a post-stop incident query still answers."""
    with _state_lock:
        _stop_locked()


def running():
    t = _thread
    return t is not None and t.is_alive()


def reset():
    """Stop the daemon and drop every ring (test isolation)."""
    stop()
    _STORE.reset()
