"""Op-level profile intelligence (counterpart of ``incubator_mxnet_tpu/
telemetry/profstats.py``) over ``torch.profiler``'s chrome traces:
per-kernel self time, the device's busy and idle share, hotspots, and
the continuous low-duty-cycle profiler daemon.

- ``summarize_capture(dir)`` walks every chrome trace in a capture dir
  (``*.trace.json[.gz]``, and the profiler module's ``trace_*.json``)
  into per-kernel aggregates {op, category, self time, count, share}, the
  device's busy and idle time and its largest idle gaps.
- ``capture_and_summarize(seconds)`` wraps ``devstats.capture_profile``
  with before/after snapshots of the dispatch counters: window MFU,
  per-category MFU, per-op estimated FLOPs and the host-side bubble
  (wall time inside ``serve:dispatch``/``train:step`` spans minus device
  busy time).
- the daemon (``start()``/``stop()``, watchdog channel "profstats")
  captures ``MXTPU_PROFSTATS_CAPTURE_S`` every
  ``MXTPU_PROFSTATS_INTERVAL_S`` under the same skip and duty rules as
  the JAX package's, folding each capture into
  ``mxtpu_profile_op_seconds_total{model,category}`` and
  ``mxtpu_profile_device_idle_ratio``, served ranked by
  ``GET /debug/hotspots``.

Event model, re-derived for CUDA (the XLA trace layout does not carry
over; ROADMAP §3, departures): a device activity is a ``ph == "X"``
event whose ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``; its
``pid`` is the device and its ``tid`` the stream. Every device activity
is an op with its duration as its self time (kernels do not nest), and
the streams of one device form one track: busy time is the union of its
activities' intervals, so two kernels overlapping on two streams count
once. Host events (``cpu_op``, ``cuda_runtime``,
``python_function``, user annotations) are not ops. ``categorize`` maps
CUDA kernel names onto categories: K1-K3's ``flash_*`` kernels are
``attention``; cuBLAS/CUTLASS GEMMs ``matmul``; cuDNN convolutions
``conv``; NCCL ``collective``; copies and layout kernels ``copy``;
reductions (softmax, norms) ``reduce``; PyTorch's elementwise kernels
``elementwise``.
"""
from __future__ import annotations

import collections
import gzip
import io
import json
import logging
import os
import re
import threading

from .registry import counter, gauge

_LOG = logging.getLogger(__name__)

SCHEMA = "mxtpu-profstats-summary-v1"

# the JAX package's markers of annotation custom calls (its hlolint reads
# them); kept for the surface
ANNOTATION_TARGET_MARKERS = ("profiler", "annotation", "named_scope")

__all__ = [
    "SCHEMA", "ANNOTATION_TARGET_MARKERS", "DEVICE_CATEGORIES",
    "categorize", "load_trace", "iter_trace_files",
    "summarize_events", "summarize_capture", "summarize_trace",
    "format_table", "capture_and_summarize", "remember", "get_summary",
    "brief",
    "summaries", "fold_summary", "hotspots", "reset_rolling",
    "add_load_probe", "remove_load_probe", "current_load",
    "start", "stop", "running", "run_once",
]

# ------------------------------------------------------------ metrics
_OP_SECONDS = counter(
    "mxtpu_profile_op_seconds_total",
    "Device self-seconds attributed by the profstats layer, by kernel "
    "category, accumulated over every folded profiler capture. Model "
    "attribution follows the window's per-model share of "
    "mxtpu_device_dispatch_seconds_total ('-' when no serving traffic "
    "dispatched during the capture).", ("model", "category"))
_IDLE_RATIO = gauge(
    "mxtpu_profile_device_idle_ratio",
    "Device-idle fraction of the newest folded profiler capture window "
    "(1 - busy/window over the device tracks). High here with queued "
    "requests means host-side dispatch bubbles, not device saturation.")
_CAPTURES = counter(
    "mxtpu_profile_captures_total",
    "Profstats capture cycles by outcome: ok, empty (no op events), "
    "skipped_busy (operator capture in flight), skipped_load (probe "
    "over MXTPU_PROFSTATS_MAX_LOAD), error.", ("outcome",))

# ------------------------------------------------------ categorization
#: rules checked IN ORDER over a CUDA kernel's lower-cased name: a cuDNN
#: convolution's implicit GEMM ranks as conv, not matmul; K1-K3
#: (flash_fwd_tc, flash_bwd_dkv_tc, ...) rank as attention
_ATTENTION_TOKENS = frozenset(("flash", "fmha", "attention", "sdpa"))
_COLLECTIVE_HINTS = ("nccl", "allreduce", "all_reduce", "allgather",
                     "reducescatter", "alltoall", "sendrecv")
_CONV_HINTS = ("conv", "cudnn", "dgrad", "wgrad", "fprop", "winograd")
_MATMUL_HINTS = ("gemm", "gemv", "cublas", "cutlass", "xmma", "matmul", "nvjet",
                 "sm90_", "sm80_", "wgmma", "bmm")
_COPY_HINTS = ("memcpy", "memset", "copy", "transpose", "catarray", "cat_",
               "index", "gather", "scatter", "permute", "pad", "slice",
               "embedding", "fill")
_REDUCE_HINTS = ("reduce", "softmax", "norm", "sum_", "mean", "argmax",
                 "cunn_", "welford", "topk", "sort", "cumsum")
_ELEMENTWISE_HINTS = ("elementwise", "vectorized", "unrolled", "pointwise",
                      "gelu", "relu", "tanh", "sigmoid", "exp", "add",
                      "mul", "div", "where", "fused", "triton_")

_TOKEN_RE = re.compile(r"[^a-z0-9]+")


def categorize(name):
    """Map a CUDA kernel's name (``flash_fwd_tc``,
    ``sm90_xmma_gemm_bf16bf16_...``, ``void at::native::vectorized_
    elementwise_kernel<...>``, ``Memcpy DtoD``, ``ncclDevKernel_...``)
    onto the category the hotspot table ranks by: attention / matmul /
    conv / elementwise / reduce / copy / collective / other."""
    base = str(name).lower()
    tokens = frozenset(t for t in _TOKEN_RE.split(base) if t)
    if tokens & _ATTENTION_TOKENS or "flash_" in base:
        return "attention"
    if any(h in base for h in _COLLECTIVE_HINTS):
        return "collective"
    if any(h in base for h in _CONV_HINTS):
        return "conv"
    if any(h in base for h in _MATMUL_HINTS):
        return "matmul"
    if any(h in base for h in _COPY_HINTS):
        return "copy"
    if any(h in base for h in _REDUCE_HINTS):
        return "reduce"
    if any(h in base for h in _ELEMENTWISE_HINTS):
        return "elementwise"
    return "other"


# -------------------------------------------------------- trace loading
def load_trace(path):
    """Load one chrome-trace file (plain or gzipped JSON) and return its
    event list. Raises ValueError on an unreadable/misshapen file — the
    per-capture walk downgrades that to a counted parse error."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            data = json.load(io.TextIOWrapper(f, encoding="utf-8",
                                              errors="replace"))
    except (OSError, ValueError) as e:
        raise ValueError("unreadable trace %s: %s" % (path, e))
    events = data if isinstance(data, list) \
        else data.get("traceEvents") if isinstance(data, dict) else None
    if not isinstance(events, list):
        raise ValueError("trace %s has no traceEvents list" % path)
    return events


def iter_trace_files(capture_dir):
    """Every chrome trace under a capture dir, sorted: ``*.trace.json
    [.gz]`` (``devstats.capture_profile`` writes ``capture.trace.json``)
    and the profiler module's ``trace_*.json``."""
    out = []
    for root, _dirs, files in os.walk(capture_dir):
        for fn in files:
            if fn.endswith((".trace.json", ".trace.json.gz")) or (
                    fn.startswith("trace") and fn.endswith(".json")):
                out.append(os.path.join(root, fn))
    return sorted(out)


# ----------------------------------------------------- event aggregation
#: ``cat`` of the device activities in a torch.profiler chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_pids(events):
    """pids that carry device activity (``cat`` in DEVICE_CATEGORIES):
    torch.profiler gives each device its own pid."""
    return {ev.get("pid") for ev in events
            if isinstance(ev, dict) and ev.get("ph") == "X"
            and ev.get("cat") in DEVICE_CATEGORIES}


def _merged_busy(intervals):
    """(busy_total, gaps) over a sorted-by-start interval list."""
    busy = 0.0
    gaps = []
    end = None
    for s, e in intervals:
        if end is None:
            end = e
            busy += e - s
            continue
        if s > end:
            gaps.append((end, s - end))
            busy += e - s
        else:
            busy += max(0.0, e - end)
        end = max(end, e)
    return busy, gaps


def summarize_events(events):
    """Aggregate one trace's events: per-kernel device time (kernels do
    not nest: each activity's self time is its duration, also where two
    streams overlap), per-device busy time (the union of its activities'
    intervals over every stream) and window, largest idle gaps. Malformed
    events are skipped and counted, never raised."""
    device_pids = _device_pids(events)
    tracks = collections.defaultdict(list)     # device pid -> activities
    skipped = 0
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        try:
            ts = float(ev["ts"])
            dur = float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            skipped += 1
            continue
        if dur < 0:
            skipped += 1
            continue
        name = ev.get("name")
        if not isinstance(name, str):
            skipped += 1
            continue
        if ev.get("cat") not in DEVICE_CATEGORIES or \
                ev.get("pid") not in device_pids:
            continue          # host events: operators, runtime calls
        tracks[ev.get("pid")].append((ts, dur, name))

    ops = {}                  # (op, module) -> [self_us, count, category]
    busy_us = 0.0
    window_lo = window_hi = None
    gaps = []
    for pid in sorted(tracks, key=str):
        intervals = []
        for ts, dur, name in tracks[pid]:
            intervals.append((ts, ts + dur))
            cell = ops.get((name, None))
            if cell is None:
                ops[(name, None)] = [dur, 1, categorize(name)]
            else:
                cell[0] += dur
                cell[1] += 1
        intervals.sort()
        lo, hi = intervals[0][0], max(e for _s, e in intervals)
        window_lo = lo if window_lo is None else min(window_lo, lo)
        window_hi = hi if window_hi is None else max(window_hi, hi)
        track_busy, track_gaps = _merged_busy(intervals)
        busy_us += track_busy
        gaps.extend(track_gaps)
    n_tracks = len(tracks)
    gaps.sort(key=lambda g: -g[1])
    return {
        "ops": ops, "skipped": skipped, "busy_us": busy_us,
        "window_lo": window_lo, "window_hi": window_hi,
        "tracks": n_tracks, "gaps": gaps[:10],
    }


def _merge_agg(total, part):
    for k, cell in part["ops"].items():
        tot = total["ops"].get(k)
        if tot is None:
            total["ops"][k] = list(cell)
        else:
            tot[0] += cell[0]
            tot[1] += cell[1]
    total["skipped"] += part["skipped"]
    total["busy_us"] += part["busy_us"]
    total["tracks"] += part["tracks"]
    for bound in ("window_lo", "window_hi"):
        v = part[bound]
        if v is None:
            continue
        cur = total[bound]
        pick = min if bound == "window_lo" else max
        total[bound] = v if cur is None else pick(cur, v)
    total["gaps"] = sorted(total["gaps"] + part["gaps"],
                           key=lambda g: -g[1])[:10]


def _to_summary(agg, traces, errors, capture_dir=None):
    window_us = 0.0
    if agg["window_lo"] is not None:
        window_us = max(0.0, agg["window_hi"] - agg["window_lo"])
    total_self = sum(cell[0] for cell in agg["ops"].values())
    ops = []
    cats = {}
    for (op, module), (self_us, count, cat) in agg["ops"].items():
        share = (self_us / total_self) if total_self > 0 else 0.0
        ops.append({"op": op, "module": module, "category": cat,
                    "self_us": self_us, "count": count, "share": share})
        cell = cats.setdefault(cat, {"self_us": 0.0, "count": 0,
                                     "share": 0.0})
        cell["self_us"] += self_us
        cell["count"] += count
        cell["share"] += share
    ops.sort(key=lambda o: (-o["self_us"], o["op"]))
    programs = {}
    for o in ops:
        if o["module"]:
            programs[o["module"]] = \
                programs.get(o["module"], 0.0) + o["self_us"]
    idle = None
    if window_us > 0 and agg["tracks"] > 0:
        idle = 1.0 - agg["busy_us"] / (window_us * agg["tracks"])
        idle = min(1.0, max(0.0, idle))
    return {
        "schema": SCHEMA,
        "capture_id": os.path.basename(capture_dir.rstrip(os.sep))
        if capture_dir else None,
        "dir": capture_dir,
        "traces": traces, "trace_errors": errors,
        "events": sum(c[1] for c in agg["ops"].values()),
        "skipped_events": agg["skipped"],
        "window_us": window_us,
        "device_busy_us": agg["busy_us"],
        "device_tracks": agg["tracks"],
        "device_idle_ratio": idle,
        "ops": ops,
        "categories": cats,
        "programs": programs,
        "gaps": [{"start_us": s, "dur_us": d} for s, d in agg["gaps"]],
    }


def _empty_agg():
    return {"ops": {}, "skipped": 0, "busy_us": 0.0, "window_lo": None,
            "window_hi": None, "tracks": 0, "gaps": []}


def summarize_capture(capture_dir):
    """Summarize every trace file under a capture dir into the shared
    summary dict (schema ``mxtpu-profstats-summary-v1``). Unreadable
    trace files are counted in ``trace_errors``; an empty or missing dir
    yields a valid zero summary rather than raising."""
    agg = _empty_agg()
    traces = errors = 0
    for path in iter_trace_files(capture_dir):
        try:
            events = load_trace(path)
        except ValueError:
            _LOG.debug("profstats: bad trace %s", path, exc_info=True)
            errors += 1
            continue
        traces += 1
        _merge_agg(agg, summarize_events(events))
    return _to_summary(agg, traces, errors, capture_dir=capture_dir)


def summarize_trace(path):
    """Summarize one trace file (the hand-me-a-.json.gz CLI path)."""
    agg = _empty_agg()
    _merge_agg(agg, summarize_events(load_trace(path)))
    return _to_summary(agg, 1, 0, capture_dir=os.path.dirname(path) or None)


# ------------------------------------------------------- devstats join
def _dispatch_overlap_us(t0_us, t1_us):
    """Wall microseconds spent inside finished serve:dispatch /
    train:step spans that overlap [t0_us, t1_us] (span start_us is
    epoch-anchored, same clock as profiler.now_us)."""
    from . import spans as spans_mod
    busy = 0.0
    n = 0
    for rec in spans_mod.snapshot():
        if rec.get("name") not in ("serve:dispatch", "train:step"):
            continue
        try:
            s = float(rec["start_us"])
            e = s + float(rec["dur_us"])
        except (KeyError, TypeError, ValueError):
            continue
        o = min(e, t1_us) - max(s, t0_us)
        if o > 0:
            busy += o
            n += 1
    return busy, n


def _attach_devstats(summary, before, after, wall_s, t0_us, t1_us):
    from . import devstats
    d = {k: max(0.0, after[k] - before[k])
         for k in ("flops", "bytes", "dispatch_s", "chip_s")}
    by_model = {}
    for m, v in after["by_model"].items():
        dv = v - before["by_model"].get(m, 0.0)
        if dv > 0:
            by_model[m] = dv
    peak = devstats.peaks()[0]
    exec_s = d["chip_s"] if d["chip_s"] > 0 else d["dispatch_s"]
    denom_s = exec_s if exec_s > 0 else wall_s
    mfu = (d["flops"] / (denom_s * peak)) if denom_s > 0 else 0.0
    cat_mfu = {c: mfu * info["share"]
               for c, info in summary["categories"].items()}
    for o in summary["ops"]:
        o["flops_est"] = o["share"] * d["flops"]
    dispatch_busy_us, n_spans = _dispatch_overlap_us(t0_us, t1_us)
    device_busy_us = summary["device_busy_us"]
    summary["devstats"] = {
        "window_s": wall_s,
        "flops": d["flops"], "bytes": d["bytes"],
        "dispatch_s": d["dispatch_s"], "chip_s": d["chip_s"],
        "mfu": mfu, "peak_flops": peak,
        "by_model": by_model,
        "category_mfu": cat_mfu,
    }
    summary["bubbles"] = {
        "spans": n_spans,
        "dispatch_busy_us": dispatch_busy_us,
        "device_busy_us": device_busy_us,
        # host-side bubble: wall time INSIDE dispatch spans the device
        # spent idle — the gap the MFU sprint chases when idle_ratio is
        # high under load
        "host_bubble_us": max(0.0, dispatch_busy_us - device_busy_us),
    }
    return summary


def capture_and_summarize(seconds, out_dir=None, fold=True):
    """One instrumented capture: snapshot the devstats dispatch counters,
    run ``devstats.capture_profile`` (ProfileCaptureBusy propagates),
    summarize the fresh dir, attach the devstats window join + bubble
    estimate, remember the summary under its capture id, and (daemon /
    route path) fold it into the rolling aggregates.

    Returns ``(capture_result, summary)``."""
    from .. import profiler
    from . import devstats
    before = devstats.dispatch_totals()
    t0 = profiler.now_us()
    out = devstats.capture_profile(seconds, out_dir=out_dir)
    t1 = profiler.now_us()
    summary = summarize_capture(out["dir"])
    summary["capture_id"] = out.get("capture_id") \
        or os.path.basename(out["dir"].rstrip(os.sep))
    after = devstats.dispatch_totals()
    _attach_devstats(summary, before, after, (t1 - t0) / 1e6, t0, t1)
    summary["devstats"]["traced_s"] = out.get("traced_s")
    remember(summary)
    if fold:
        fold_summary(summary)
    return out, summary


# ------------------------------------------------- bounded summary store
_summaries_lock = threading.Lock()
_summaries = collections.OrderedDict()   # capture_id -> summary


def remember(summary):
    """Key a summary by capture id in the bounded store (newest
    MXTPU_PROFSTATS_SUMMARIES survive) — the store is what keeps
    ``GET /debug/hotspots?capture=<id>`` answering after devstats._prune
    deletes the capture dir itself."""
    from .. import config
    cid = summary.get("capture_id")
    if not cid:
        return
    bound = max(1, int(config.get_env("MXTPU_PROFSTATS_SUMMARIES")))
    with _summaries_lock:
        _summaries.pop(cid, None)
        _summaries[cid] = summary
        while len(_summaries) > bound:
            _summaries.popitem(last=False)


def get_summary(capture_id):
    with _summaries_lock:
        return _summaries.get(capture_id)


def brief(summary, top=15):
    """The trimmed view HTTP responses embed: top-``top`` ops plus the
    window facts (the full summary stays fetchable by capture id)."""
    out = {k: summary.get(k) for k in
           ("capture_id", "window_us", "events", "device_idle_ratio",
            "categories", "devstats", "bubbles")}
    out["ops"] = (summary.get("ops") or [])[:max(0, int(top))]
    return out


def summaries():
    """Remembered capture ids, oldest first."""
    with _summaries_lock:
        return list(_summaries)


# ------------------------------------------------------ rolling aggregates
_roll_lock = threading.Lock()
_roll = {"captures": 0, "ops": {}, "categories": {}, "busy_us": 0.0,
         "window_us": 0.0, "last_capture_id": None, "last_idle": None}


def fold_summary(summary):
    """Fold one capture summary into the rolling process aggregates and
    the exported series. Model attribution of the category seconds
    follows the window's per-model dispatch share; '-' when nothing
    dispatched during the window."""
    by_model = (summary.get("devstats") or {}).get("by_model") or {}
    total = sum(by_model.values())
    shares = {m: v / total for m, v in by_model.items()} if total > 0 \
        else {"-": 1.0}
    with _roll_lock:
        _roll["captures"] += 1
        _roll["busy_us"] += summary["device_busy_us"]
        _roll["window_us"] += summary["window_us"] \
            * max(1, summary["device_tracks"])
        _roll["last_capture_id"] = summary.get("capture_id")
        _roll["last_idle"] = summary.get("device_idle_ratio")
        for o in summary["ops"]:
            k = (o["op"], o["category"])
            cell = _roll["ops"].get(k)
            if cell is None:
                _roll["ops"][k] = [o["self_us"], o["count"]]
            else:
                cell[0] += o["self_us"]
                cell[1] += o["count"]
        for c, info in summary["categories"].items():
            _roll["categories"][c] = \
                _roll["categories"].get(c, 0.0) + info["self_us"]
    idle = summary.get("device_idle_ratio")
    if idle is not None:
        _IDLE_RATIO.set(idle)
    for c, info in summary["categories"].items():
        secs = info["self_us"] / 1e6
        for m, sh in shares.items():
            _OP_SECONDS.inc(secs * sh, model=m, category=c)


def hotspots(n=20):
    """The ranked rolling view GET /debug/hotspots serves: top-n ops and
    the per-category split accumulated over every folded capture."""
    with _roll_lock:
        total = sum(c[0] for c in _roll["ops"].values())
        ops = [{"op": op, "category": cat, "self_us": cell[0],
                "count": cell[1],
                "share": (cell[0] / total) if total > 0 else 0.0}
               for (op, cat), cell in _roll["ops"].items()]
        ops.sort(key=lambda o: (-o["self_us"], o["op"]))
        cats = {c: {"self_us": v,
                    "share": (v / total) if total > 0 else 0.0}
                for c, v in _roll["categories"].items()}
        busy, window = _roll["busy_us"], _roll["window_us"]
        return {
            "captures": _roll["captures"],
            "ops": ops[:max(0, int(n))],
            "categories": cats,
            "device_idle_ratio": _roll["last_idle"],
            "rolling_idle_ratio": (1.0 - busy / window)
            if window > 0 else None,
            "last_capture_id": _roll["last_capture_id"],
        }


def reset_rolling():
    """Forget the rolling aggregates (tests; the exported *_total
    counters keep their process-lifetime values by convention)."""
    with _roll_lock:
        _roll.update({"captures": 0, "ops": {}, "categories": {},
                      "busy_us": 0.0, "window_us": 0.0,
                      "last_capture_id": None, "last_idle": None})
    with _summaries_lock:
        _summaries.clear()


# ----------------------------------------------------------- load probes
_probes_lock = threading.Lock()
_load_probes = {}        # name -> fn() -> occupancy in [0, 1]


def add_load_probe(name, fn):
    """Register a load source the daemon consults before each capture
    (serving registries install their max queue-occupancy here). The
    daemon skips a cycle when any probe exceeds
    MXTPU_PROFSTATS_MAX_LOAD."""
    with _probes_lock:
        _load_probes[str(name)] = fn


def remove_load_probe(name):
    with _probes_lock:
        _load_probes.pop(str(name), None)


def current_load():
    """max over registered probes (0.0 with none; a raising probe reads
    as 0 — a broken probe must not pin the profiler off forever)."""
    with _probes_lock:
        probes = list(_load_probes.values())
    load = 0.0
    for fn in probes:
        try:
            load = max(load, float(fn()))
        except Exception:
            _LOG.debug("profstats load probe failed", exc_info=True)
    return load


# ---------------------------------------------------------------- daemon
_state_lock = threading.Lock()
_daemon_thread = None
_daemon_stop = None


def run_once(capture_s=None, interval_s=None):
    """One daemon cycle, callable directly (tests, the CI profstats
    stage): skip under an operator capture or overload, else capture +
    fold. Returns the summary, or None on a skipped/failed cycle; the
    outcome lands on mxtpu_profile_captures_total{outcome}."""
    from .. import config
    from . import devstats
    if capture_s is None:
        capture_s = float(config.get_env("MXTPU_PROFSTATS_CAPTURE_S"))
    if interval_s is None:
        interval_s = float(config.get_env("MXTPU_PROFSTATS_INTERVAL_S"))
    if devstats.capture_in_progress():
        _CAPTURES.inc(outcome="skipped_busy")
        return None
    max_load = float(config.get_env("MXTPU_PROFSTATS_MAX_LOAD"))
    if current_load() > max_load:
        _CAPTURES.inc(outcome="skipped_load")
        return None
    # overhead budget: the capture window may not exceed MAX_DUTY of the
    # interval — a fat capture knob must not turn the low-duty-cycle
    # profiler into a steady tracing tax
    max_duty = float(config.get_env("MXTPU_PROFSTATS_MAX_DUTY"))
    if interval_s > 0 and max_duty > 0:
        capture_s = min(capture_s, max(0.05, interval_s * max_duty))
    try:
        _out, summary = capture_and_summarize(capture_s)
    except devstats.ProfileCaptureBusy:
        _CAPTURES.inc(outcome="skipped_busy")
        return None
    except Exception:
        _LOG.warning("profstats capture cycle failed", exc_info=True)
        _CAPTURES.inc(outcome="error")
        return None
    _CAPTURES.inc(outcome="ok" if summary["events"] else "empty")
    return summary


def _daemon_loop(stop, interval_s, capture_s):
    from . import watchdog
    while not stop.wait(interval_s):
        watchdog.heartbeat("profstats")
        try:
            run_once(capture_s=capture_s, interval_s=interval_s)
        except Exception:
            _LOG.warning("profstats daemon cycle failed", exc_info=True)
        watchdog.heartbeat("profstats")


def start(interval_s=None, capture_s=None):
    """Start the continuous low-duty-cycle profiler daemon (idempotent;
    watchdog channel "profstats"). Defaults come from
    MXTPU_PROFSTATS_INTERVAL_S / MXTPU_PROFSTATS_CAPTURE_S."""
    from .. import config
    from . import watchdog
    global _daemon_thread, _daemon_stop
    if interval_s is None:
        interval_s = float(config.get_env("MXTPU_PROFSTATS_INTERVAL_S"))
    if capture_s is None:
        capture_s = float(config.get_env("MXTPU_PROFSTATS_CAPTURE_S"))
    interval_s = max(0.05, interval_s)
    with _state_lock:
        if _daemon_thread is not None and _daemon_thread.is_alive():
            return False
        stop_ev = threading.Event()
        t = threading.Thread(
            target=_daemon_loop, args=(stop_ev, interval_s, capture_s),
            name="mxtpu-profstats", daemon=True)
        _daemon_stop = stop_ev
        _daemon_thread = t
        # generous quiet budget: a cycle = capture + parse; three missed
        # intervals means the daemon is wedged, not slow
        watchdog.register("profstats",
                          quiet_s=3 * interval_s + 60.0)
        watchdog.heartbeat("profstats")
        t.start()
        return True


def _stop_locked():
    from . import watchdog
    global _daemon_thread, _daemon_stop
    t, stop_ev = _daemon_thread, _daemon_stop
    _daemon_thread = _daemon_stop = None
    if stop_ev is not None:
        stop_ev.set()
    if t is not None and t.is_alive():
        t.join(timeout=5.0)
    watchdog.unregister("profstats")
    # detach the continuous signal: a stopped daemon must not export its
    # last idle ratio forever (the op-seconds counters stay — process-
    # lifetime cumulative by Prometheus convention)
    _IDLE_RATIO.remove()


def stop():
    """Stop the daemon and detach its continuous gauge series."""
    with _state_lock:
        _stop_locked()


def running():
    t = _daemon_thread
    return t is not None and t.is_alive()


# ------------------------------------------------------------ formatting
def format_table(summary, top=40):
    """The ranked-hotspot table both tools/profsum.py and
    tools/profile_bench.py print (one renderer, one parser)."""
    lines = []
    ops = summary.get("ops") or []
    lines.append("%4s  %12s  %6s  %8s  %-12s %s"
                 % ("rank", "self-ms", "%dev", "count", "category",
                    "op [module]"))
    for i, o in enumerate(ops[:max(0, int(top))], 1):
        label = o["op"] + (" [%s]" % o["module"] if o.get("module") else "")
        lines.append("%4d  %12.3f  %5.1f%%  %8d  %-12s %s"
                     % (i, o["self_us"] / 1e3, 100.0 * o["share"],
                        o["count"], o["category"], label))
    if not ops:
        lines.append("(no op events)")
    cats = summary.get("categories") or {}
    if cats:
        split = ", ".join(
            "%s %.1f%%" % (c, 100.0 * info["share"]) for c, info in
            sorted(cats.items(), key=lambda kv: -kv[1]["self_us"]))
        lines.append("categories: %s" % split)
    idle = summary.get("device_idle_ratio")
    if idle is not None:
        lines.append("device idle: %.1f%% of a %.1f ms window "
                     "(%d track(s))"
                     % (100.0 * idle, summary.get("window_us", 0.0) / 1e3,
                        summary.get("device_tracks", 0)))
    dv = summary.get("devstats")
    if dv:
        lines.append("window MFU %.4f (peak %.3g FLOP/s); category MFU: %s"
                     % (dv["mfu"], dv["peak_flops"],
                        ", ".join("%s %.4f" % (c, v) for c, v in
                                  sorted(dv["category_mfu"].items(),
                                         key=lambda kv: -kv[1]))))
    bub = summary.get("bubbles")
    if bub and bub["spans"]:
        lines.append("dispatch bubbles: %.3f ms host-side inside %d "
                     "dispatch/train spans (device busy %.3f ms)"
                     % (bub["host_bubble_us"] / 1e3, bub["spans"],
                        bub["device_busy_us"] / 1e3))
    return "\n".join(lines)
