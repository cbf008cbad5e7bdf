"""Device statistics (counterpart of ``incubator_mxnet_tpu/telemetry/
devstats.py``, re-derived for the CUDA card): program facts, live device
memory, per-dispatch MFU and the on-demand profile capture.

- **Per program** (``program_stats``): the JAX package harvests XLA's
  cost and memory analysis of each compiled executable once. Torch has
  no cost analysis, so the port measures a program once, on the eager
  run that precedes its capture (``measure``): FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (K1 counts through its
  operator's formula), ``peak_bytes`` the bytes the captured graph's
  private memory pool holds (``pool_bytes``: the process-wide allocator
  peak is left alone), ``output_bytes`` from the outputs. ``bytes_accessed`` stays None (a
  departure, ROADMAP §3): nothing in torch counts a program's HBM
  traffic, so the bandwidth gauges read 0. The stats ride on the
  program (``.stats``), the AOT cache entry and the artifact header, and
  feed ``mxtpu_aot_program_flops`` / ``mxtpu_aot_program_peak_bytes``.
- **Per dispatch** (``observe_dispatch``): a caller times a replay with
  CUDA events around it (never a host read inside a capture) and divides
  the entry's FLOPs by that device time against the peak table: rolling
  ``mxtpu_device_mfu{model,kind,replica}`` and the window counters
  ``mxtpu_device_{flops,bytes_accessed,dispatch_seconds,chip_seconds}_
  total``.
- **Continuous** (the memory sampler): a daemon polls the caching
  allocator (``torch.cuda.memory_stats``: ``bytes_in_use``,
  ``peak_bytes_in_use``) and the device's total memory (``bytes_limit``)
  into ``mxtpu_device_memory_bytes{device,stat}`` and files an
  ``hbm_pressure`` flight-recorder event once per episode above 90 %.
  Without CUDA it reports the host's RSS under ``device="host"``.

Peaks come from ``MXTPU_DEVICE_PEAK_FLOPS`` / ``MXTPU_DEVICE_PEAK_HBM_BPS``
when set, else ``PEAK_TABLE`` keyed on ``torch.cuda.get_device_name`` (the
H100's dense bf16 rate and HBM bandwidth), else report-only constants.
``hbm_capacity`` reads ``torch.cuda.mem_get_info``'s total, or
``HBM_TABLE``.

``capture_profile(seconds)`` is ``GET /debug/profile?seconds=N``: one
``torch.profiler`` session over CPU and CUDA activity, exported as a
chrome trace into a fresh subdirectory; single-flight (a concurrent call
raises ``ProfileCaptureBusy``, HTTP 409), and exclusive with the port's
``profiler.py`` trace (one ``torch.profiler`` session at a time in a
process).
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import shutil
import tempfile
import threading
import time as _time

from . import flightrec
from . import watchdog
from .registry import counter, gauge

__all__ = ["program_stats", "peaks", "observe_dispatch", "dispatch_context",
           "start", "stop", "running", "sample_now", "device_memory",
           "set_memory_source", "capture_profile", "ProfileCaptureBusy",
           "capture_in_progress", "dispatch_totals", "measure",
           "pool_bytes",
           "PEAK_TABLE", "reset_peaks", "HBM_TABLE", "hbm_capacity",
           "device_kind", "TORCH_PROFILER_LOCK"]

_LOG = logging.getLogger(__name__)

#: device name prefix -> (peak dense FLOP/s at the serving/bench compute
#: type (bf16, no sparsity), peak HBM bytes/s), from NVIDIA's data sheets;
#: the same denominators chip_smoke.py's bounds use
PEAK_TABLE = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
    "NVIDIA H100": (989e12, 3.35e12),
    "NVIDIA H200": (989e12, 4.8e12),
    "NVIDIA A100-SXM4-80GB": (312e12, 2.039e12),
    "NVIDIA A100": (312e12, 1.555e12),
}

#: report-only fallback for devices not in the table (the CPU, unknown
#: cards): the gauges stay live and consistent but are not meaningful
#: against hardware peaks (peaks()[2] == "fallback")
_FALLBACK_PEAKS = (1e12, 100e9)

#: device name prefix -> device memory capacity in bytes, for when
#: ``torch.cuda.mem_get_info`` cannot be read; unknown names (the CPU)
#: give None and the caller skips instead of guessing
HBM_TABLE = {
    "NVIDIA H100 80GB HBM3": 80 * 2 ** 30,
    "NVIDIA H100 PCIe": 80 * 2 ** 30,
    "NVIDIA H100 NVL": 94 * 2 ** 30,
    "NVIDIA H200": 141 * 2 ** 30,
    "NVIDIA A100-SXM4-80GB": 80 * 2 ** 30,
}


def device_kind():
    """``torch.cuda.get_device_name(0)``, or "" without CUDA."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0) or ""
    except Exception:
        _LOG.debug("device name unavailable", exc_info=True)
    return ""


def _table_lookup(table, kind):
    """The entry of the longest prefix of ``kind`` that ends at a word
    boundary, or None."""
    for prefix in sorted(table, key=len, reverse=True):
        if kind == prefix or (kind.startswith(prefix)
                              and not kind[len(prefix)].isalnum()):
            return table[prefix]
    return None


def hbm_capacity():
    """(device memory bytes, source): ``torch.cuda.mem_get_info``'s total
    (source 'device'), else the HBM_TABLE entry of the device's name
    ('table'), else (None, 'unknown')."""
    try:
        import torch
        if torch.cuda.is_available():
            return float(torch.cuda.mem_get_info(0)[1]), "device"
    except Exception:
        _LOG.debug("mem_get_info failed", exc_info=True)
    got = _table_lookup(HBM_TABLE, device_kind())
    if got is not None:
        return float(got), "table"
    return None, "unknown"


# --------------------------------------------------------------- program facts
def program_stats(compiled):
    """``{flops, bytes_accessed, peak_bytes, output_bytes}`` of a program
    (``compiled``: a captured graph or a program run as it is) that was
    measured when it was built (its ``stats``, set from ``measure``), or
    None. Never measures: a per-dispatch measurement would put a FLOP
    count into the hot path."""
    stats = getattr(compiled, "stats", None)
    return dict(stats) if stats else None


def measure(fn):
    """Run ``fn()`` once under ``FlopCounterMode`` and return (its result,
    its stats): ``flops`` counted by the mode (K1 through its operator's
    formula), ``output_bytes`` of the result's tensors, ``bytes_accessed``
    None (torch has no cost analysis) and ``peak_bytes`` 0.0, which the
    caller fills with ``pool_bytes`` of the capture that follows."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn()
    outs = []
    _tensor_leaves(out, outs)
    return out, {"flops": float(counter.get_total_flops()),
                 "bytes_accessed": None, "peak_bytes": 0.0,
                 "output_bytes": float(sum(t.numel() * t.element_size()
                                           for t in outs))}


def pool_bytes(device, pool):
    """Bytes the caching allocator holds in ``pool``, the private memory
    pool of one captured CUDA graph on ``device``: what its replay keeps
    (intermediates and outputs), read from ``torch.cuda.memory_snapshot``
    without resetting the allocator's process-wide peak, and untouched by
    other threads' allocations (nothing but the capture allocates into its
    pool). 0.0 on the CPU."""
    import torch
    if pool is None or getattr(device, "type", "cpu") != "cuda":
        return 0.0
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    want = tuple(pool)
    return float(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if seg.get("device") == index
                     and tuple(seg.get("segment_pool_id", ())) == want))


def _tensor_leaves(tree, out):
    import torch
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensor_leaves(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensor_leaves(t, out)


# ------------------------------------------------------------------ peak table
_peaks_lock = threading.Lock()
_peaks = None            # (flops_per_s, hbm_bytes_per_s, source)

_PEAK_FLOPS_G = gauge(
    "mxtpu_device_peak_flops",
    "Per-device peak FLOP/s the MFU gauges divide by (MXTPU_DEVICE_PEAK_"
    "FLOPS override, else the built-in table keyed on the CUDA device "
    "name, else a report-only fallback).")
_PEAK_BW_G = gauge(
    "mxtpu_device_peak_hbm_bps",
    "Per-chip peak HBM bytes/s the bandwidth-utilization gauges divide "
    "by (MXTPU_DEVICE_PEAK_HBM_BPS override, else the device-name "
    "table, else a report-only fallback).")


def peaks():
    """(peak_flops_per_s, peak_hbm_bytes_per_s, source) for this process's
    backend; source is 'env' | 'table' | 'fallback'. Resolved once and
    published on the mxtpu_device_peak_* gauges."""
    global _peaks
    if _peaks is not None:
        return _peaks
    with _peaks_lock:
        if _peaks is not None:
            return _peaks
        from .. import config
        env_f = config.get_env("MXTPU_DEVICE_PEAK_FLOPS")
        env_b = config.get_env("MXTPU_DEVICE_PEAK_HBM_BPS")
        table = _table_lookup(PEAK_TABLE, device_kind())
        flops_p, bw_p = table if table is not None else _FALLBACK_PEAKS
        base = "table" if table is not None else "fallback"
        if env_f is not None and env_b is not None:
            source = "env"
        elif env_f is not None or env_b is not None:
            # only ONE peak overridden: the other is still `base` — the
            # composite source keeps "fallback" visible so a consumer
            # checking for report-only mode is not lied to
            source = "env+" + base
        else:
            source = base
        if env_f is not None:
            flops_p = float(env_f)
        if env_b is not None:
            bw_p = float(env_b)
        flops_p = max(1.0, float(flops_p))
        bw_p = max(1.0, float(bw_p))
        _PEAK_FLOPS_G.set(flops_p)
        _PEAK_BW_G.set(bw_p)
        _peaks = (flops_p, bw_p, source)
        return _peaks


def reset_peaks():
    """Forget the resolved peaks (tests changing MXTPU_DEVICE_PEAK_*)."""
    global _peaks
    with _peaks_lock:
        _peaks = None


# ------------------------------------------------------- per-dispatch rolling
_MFU = gauge(
    "mxtpu_device_mfu",
    "Rolling (EMA) model-FLOPs utilization per dispatch: the cached "
    "program's FLOPs (FlopCounterMode at its build) over the dispatch's "
    "device time (CUDA events around the replay), against "
    "mxtpu_device_peak_flops. Labels: serving "
    "model (or model digest outside serving), entry kind "
    "(train|eval|serve), data-parallel replica.",
    ("model", "kind", "replica"))
_BW_UTIL = gauge(
    "mxtpu_device_hbm_bw_util",
    "Rolling (EMA) HBM bandwidth utilization per dispatch: the program's "
    "bytes accessed over the dispatch span, against "
    "mxtpu_device_peak_hbm_bps. Torch counts no program's bytes "
    "accessed, so this reads 0 in the port.",
    ("model", "kind", "replica"))
_FLOPS_TOTAL = counter(
    "mxtpu_device_flops_total",
    "Cost-analysis FLOPs dispatched (sum over instrumented dispatches). "
    "delta(this)/window/mxtpu_device_peak_flops is a scrape window's "
    "achieved MFU — what loadgen stage reports and the devstats CI soak "
    "compute.", ("model", "kind"))
_BYTES_TOTAL = counter(
    "mxtpu_device_bytes_accessed_total",
    "Cost-analysis HBM bytes accessed by instrumented dispatches "
    "(window deltas give achieved bandwidth).", ("model", "kind"))
_DISPATCH_SECONDS = counter(
    "mxtpu_device_dispatch_seconds_total",
    "Measured device dispatch seconds (CUDA events) — the device "
    "leg of a scrape window, to set against wall-clock for host-overhead "
    "attribution.", ("model", "kind"))
_CHIP_SECONDS = counter(
    "mxtpu_device_chip_seconds_total",
    "Dispatch seconds x participating chips (a K-chip tensor-parallel "
    "program burns K chip-seconds per wall second). "
    "delta(mxtpu_device_flops_total) / delta(this) / "
    "mxtpu_device_peak_flops is a scrape window's achieved PER-CHIP MFU "
    "while executing — exact under any replica/tp topology, which a "
    "wall-window division is not.", ("model", "kind"))

#: EMA smoothing for the rolling gauges: ~last 10 dispatches dominate
_EMA_ALPHA = 0.2
_ema_lock = threading.Lock()
_ema = {}                # (model, kind, replica) -> [mfu, bw]

_ctx = threading.local()


class dispatch_context:
    """Thread-scoped serving context: the batcher worker wraps its
    servable call in ``dispatch_context(model, replica)`` so the MFU
    observation — which happens levels deeper, where the compiled entry
    and its FLOPs are known (EvalStep, ServedModel._run) — is labeled
    with the serving model name and replica index instead of a digest."""

    def __init__(self, model, replica):
        self.model = model
        self.replica = replica

    def __enter__(self):
        self._saved = getattr(_ctx, "value", None)
        _ctx.value = (self.model, self.replica)
        return self

    def __exit__(self, *exc):
        _ctx.value = self._saved


def detach_model(model):
    """Drop one model's rolling per-dispatch gauge series (mxtpu_device_
    mfu / _hbm_bw_util) and their EMA state — the batcher close/unload
    hook, mirroring ServingMetrics.detach_telemetry: a dead model must
    not export its last MFU forever, and hot-reload churn must not grow
    the EMA map without bound. The *_total counters stay (process-
    lifetime cumulative by Prometheus convention)."""
    model = str(model)
    with _ema_lock:
        keys = [k for k in _ema if k[0] == model]
        for k in keys:
            _ema.pop(k, None)
    for m, kind, replica in keys:
        try:
            _MFU.remove(model=m, kind=kind, replica=replica)
            _BW_UTIL.remove(model=m, kind=kind, replica=replica)
        except Exception:
            _LOG.debug("mfu gauge detach failed", exc_info=True)


def in_dispatch_context():
    """True on a batcher worker thread inside dispatch_context — the
    serving path, where a timed observation moves cost
    instead of adding any (jit.EvalStep gates its sync on this)."""
    return getattr(_ctx, "value", None) is not None


def observe_dispatch(kind, stats, dur_s, model=None, replica=None,
                     devices=1):
    """Record one measured dispatch of a program with known ``stats``
    (the aot.CACHE entry's program_stats dict). ``dur_s`` is the
    device time the caller measured; ``devices`` is how many
    chips executed the program (a tensor-parallel group passes its mesh
    size — the program's FLOPs are spread over all of
    them, so dividing by ONE chip's peak would overstate MFU by the
    group size). An ambient dispatch_context (the batcher worker's
    serving model name) WINS over the caller's ``model`` — the caller
    passes its model digest as the fallback label for dispatches outside
    serving. Never raises into the hot path; a dropped observation is
    debug-logged (R005 discipline)."""
    if not stats or dur_s <= 0.0:
        return
    try:
        ctx = getattr(_ctx, "value", None)
        if ctx is not None:
            model = ctx[0]
            if replica is None:
                replica = ctx[1]
        model = str(model if model is not None else "-")
        replica = int(replica or 0)
        devices = max(1, int(devices))
        flops_p, bw_p, _src = peaks()
        flops = float(stats.get("flops") or 0.0)
        nbytes = float(stats.get("bytes_accessed") or 0.0)  # None: unknown
        mfu = flops / dur_s / (flops_p * devices)
        bw = nbytes / dur_s / (bw_p * devices)
        key = (model, str(kind), replica)
        with _ema_lock:
            cur = _ema.get(key)
            if cur is None:
                cur = _ema[key] = [mfu, bw]
            else:
                cur[0] += _EMA_ALPHA * (mfu - cur[0])
                cur[1] += _EMA_ALPHA * (bw - cur[1])
            mfu_s, bw_s = cur
        _MFU.set(mfu_s, model=model, kind=kind, replica=replica)
        _BW_UTIL.set(bw_s, model=model, kind=kind, replica=replica)
        _FLOPS_TOTAL.inc(flops, model=model, kind=kind)
        _BYTES_TOTAL.inc(nbytes, model=model, kind=kind)
        _DISPATCH_SECONDS.inc(dur_s, model=model, kind=kind)
        _CHIP_SECONDS.inc(dur_s * devices, model=model, kind=kind)
    except Exception:
        _LOG.debug("devstats dispatch observation dropped", exc_info=True)


# ------------------------------------------------------------- HBM sampler
_MEMORY_BYTES = gauge(
    "mxtpu_device_memory_bytes",
    "Live device memory sampled by the devstats daemon from the CUDA "
    "caching allocator (stats: bytes_in_use, peak_bytes_in_use; "
    "bytes_limit the device's total memory). Without CUDA it degrades to "
    "host-RSS report-only samples under device='host' (stats: rss_bytes, "
    "peak_rss_bytes). >90% of bytes_limit files a flightrec "
    "hbm_pressure event once per episode.", ("device", "stat"))

_MEM_STATS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
#: pressure episode hysteresis: fire at >90% of bytes_limit, re-arm <85%
_PRESSURE_HIGH = 0.90
_PRESSURE_LOW = 0.85

_mem_lock = threading.Lock()
_mem_source = None       # injectable: fn() -> {device: {stat: bytes}}
_last_snapshot = {}
_published_series = set()          # (device, stat) pairs set on the gauge
_pressured = set()                 # devices currently in a pressure episode
#: gauge publishing happens ONLY between start() and stop() (guarded by
#: _mem_lock): a passive device_memory()/profiler read after stop() must
#: not resurrect mxtpu_device_memory_bytes series nobody will ever
#: refresh or detach again
_session_active = False
_sampler_lock = threading.Lock()   # sampler lifecycle
_sampler_thread = None
_sampler_stop = None
_HB_CHANNEL = "devstats"


def set_memory_source(fn):
    """Override where memory samples come from: ``fn() -> {device_name:
    {stat_name: bytes}}`` (tests; backends with out-of-band memory
    telemetry). None restores the CUDA allocator's."""
    global _mem_source
    with _mem_lock:
        _mem_source = fn


def _host_rss():
    """Report-only host fallback so the memory series never silently
    vanishes without CUDA."""
    import sys
    out = {}
    try:
        import resource
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss unit is platform-defined: kilobytes on Linux/BSD,
        # BYTES on macOS — scaling unconditionally would report 1024x
        out["peak_rss_bytes"] = int(peak) * (
            1 if sys.platform == "darwin" else 1024)
    except Exception:
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        out["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        if "peak_rss_bytes" in out:
            out["rss_bytes"] = out["peak_rss_bytes"]
    return {"host": out} if out else {}


def _collect():
    with _mem_lock:
        src = _mem_source
    if src is not None:
        try:
            snap = src() or {}
            return {str(d): {str(k): int(v) for k, v in s.items()}
                    for d, s in snap.items()}
        except Exception:
            _LOG.debug("injected memory source failed", exc_info=True)
            return {}
    out = {}
    try:
        import torch
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                st = torch.cuda.memory_stats(i)
                out["cuda:%d" % i] = {
                    "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                               0)),
                    "peak_bytes_in_use": int(
                        st.get("allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory)}
    except Exception:
        _LOG.debug("device memory sample failed", exc_info=True)
    if not out:
        out = _host_rss()
    return out


def sample_now():
    """One sampler tick, callable without the daemon: poll the memory
    source live, run the pressure check, and return the
    {device: {stat: bytes}} snapshot. The mxtpu_device_memory_bytes
    gauges are published only while a sampler session is active (between
    start() and stop()) — a passive read outside it must not leave
    frozen series on the exposition."""
    global _last_snapshot
    snap = _collect()
    with _mem_lock:
        publish = _session_active
    for dev, stats in snap.items():
        if publish:
            for stat, val in stats.items():
                try:
                    with _mem_lock:
                        # re-check under the lock: a concurrent stop()
                        # must not race a publish past its detach sweep
                        if _session_active:
                            _MEMORY_BYTES.set(val, device=dev, stat=stat)
                            _published_series.add((dev, stat))
                except Exception:
                    _LOG.debug("memory gauge update dropped",
                               exc_info=True)
        limit = stats.get("bytes_limit")
        used = stats.get("bytes_in_use")
        if limit and used is not None:
            frac = used / float(limit)
            with _mem_lock:
                in_episode = dev in _pressured
                if frac > _PRESSURE_HIGH and not in_episode:
                    _pressured.add(dev)
                    fire = True
                else:
                    fire = False
                    if frac < _PRESSURE_LOW and in_episode:
                        _pressured.discard(dev)
            if fire:
                flightrec.record("hbm_pressure", device=dev,
                                 frac=round(frac, 4), bytes_in_use=used,
                                 bytes_limit=limit)
                _LOG.warning("device %s HBM pressure: %.1f%% of limit "
                             "(%d / %d bytes)", dev, 100 * frac, used,
                             limit)
    with _mem_lock:
        _last_snapshot = snap
    return snap


def device_memory():
    """The newest sampler snapshot (stable keys: bytes_in_use /
    peak_bytes_in_use / bytes_limit per device; rss fallback keys under
    'host'). Samples on demand when the daemon is not running, but keeps
    serving the last-known snapshot if a live sample fails — this is the
    delegate behind profiler.device_memory()."""
    if not running():
        try:
            return sample_now()
        except Exception:
            _LOG.debug("on-demand memory sample failed", exc_info=True)
    with _mem_lock:
        return {d: dict(s) for d, s in _last_snapshot.items()}


def _poll(stop, poll_s):
    while not stop.wait(poll_s):
        watchdog.heartbeat(_HB_CHANNEL)
        try:
            sample_now()
        except Exception:
            # the sampler must outlive whatever it samples; the skipped
            # tick stays debug-visible (R005)
            _LOG.debug("devstats sampler tick failed", exc_info=True)


def start(poll_s=None):
    """Start (or restart with new settings) the HBM sampler daemon.
    Heartbeat-registered on the 'devstats' watchdog channel; autostarted
    at package import when MXTPU_DEVSTATS=1. Returns the thread."""
    from .. import config
    global _sampler_thread, _sampler_stop
    if poll_s is None:
        poll_s = config.get_env("MXTPU_DEVSTATS_POLL_S")
    poll_s = max(0.01, float(poll_s))
    global _session_active
    with _sampler_lock:
        _stop_locked()
        watchdog.register(_HB_CHANNEL, quiet_s=max(60.0, poll_s * 10))
        with _mem_lock:
            _session_active = True
        # first sample SYNCHRONOUSLY, before the daemon exists: a
        # device_memory() call right after start() must see a live
        # snapshot, not an empty one that only fills after the first
        # poll tick
        try:
            sample_now()
        except Exception:
            _LOG.debug("initial devstats sample failed", exc_info=True)
        stop_ev = threading.Event()
        t = threading.Thread(target=_poll, args=(stop_ev, poll_s),
                             daemon=True, name="mxtpu-devstats")
        _sampler_stop, _sampler_thread = stop_ev, t
        t.start()
    return t


def _stop_locked():
    """Signal + join the sampler and DETACH its state: the heartbeat
    channel is unregistered (silence from a stopped sampler is not a
    stall) and every memory series it published is removed (a stopped
    sampler must not export frozen bytes forever). Caller holds
    _sampler_lock."""
    global _sampler_thread, _sampler_stop, _session_active
    stop_ev, t = _sampler_stop, _sampler_thread
    _sampler_stop = _sampler_thread = None
    if stop_ev is not None:
        stop_ev.set()
        if t is not None:
            t.join(timeout=5.0)
        watchdog.unregister(_HB_CHANNEL)
        # end the session BEFORE the detach sweep: any sample racing the
        # stop re-checks _session_active under _mem_lock and cannot
        # publish after (and so escape) the sweep
        with _mem_lock:
            _session_active = False
            series = list(_published_series)
            _published_series.clear()
        for dev, stat in series:
            try:
                _MEMORY_BYTES.remove(device=dev, stat=stat)
            except Exception:
                _LOG.debug("memory gauge detach failed", exc_info=True)


def stop():
    with _sampler_lock:
        _stop_locked()


def running():
    t = _sampler_thread
    return t is not None and t.is_alive()


# ----------------------------------------------------------- profile capture
class ProfileCaptureBusy(RuntimeError):
    """A profile capture (or the profiler module's ``torch.profiler``
    trace) is already in flight (HTTP 409)."""


#: one ``torch.profiler`` session at a time in the process: held by
#: ``capture_profile`` and by ``profiler.py``'s trace between its run and
#: stop
TORCH_PROFILER_LOCK = threading.Lock()
_capture_lock = threading.Lock()
_capture_seq = itertools.count(1)


class _LaunchGate:
    """Shared sections (a serving thread's unit of device work) against
    exclusive ones (``torch.profiler``'s start or stop): an exclusive
    section waits until no other thread is inside a shared one and holds
    new ones back until it ends. Shared sections nest within a thread;
    the thread inside an exclusive section passes its own shared ones, and
    a thread inside a shared section does not wait for itself."""

    def __init__(self):
        self._cond = threading.Condition()
        self._inside = 0
        self._owner = None          # the thread inside the exclusive section
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._local, "depth", 0)
        me = threading.get_ident()
        if not depth:
            with self._cond:
                while self._owner is not None and self._owner != me:
                    self._cond.wait()
                self._inside += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if not depth:
                with self._cond:
                    self._inside -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        mine = 1 if getattr(self._local, "depth", 0) else 0
        with self._cond:
            while self._owner is not None:
                self._cond.wait()
            self._owner = threading.get_ident()
            while self._inside > mine:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._owner = None
                self._cond.notify_all()


#: the batchers' batches, the decode loops' steps, a prewarm's buckets
#: and the shadow comparisons run inside ``LAUNCH_GATE.shared()``; the
#: profiler starts and stops inside ``profiler_transition``
LAUNCH_GATE = _LaunchGate()


@contextlib.contextmanager
def profiler_transition():
    """Start or stop ``torch.profiler`` here: with no serving thread
    inside a unit of device work (``LAUNCH_GATE``) and no CUDA graph
    capture in flight (``jit._CAPTURE_LOCK``; both synchronise the
    device, which a capture forbids). A stop while a decode loop replayed
    its graph on another thread hung the whole process: the stopping
    thread never returned and held the interpreter lock."""
    from .. import jit
    with LAUNCH_GATE.exclusive(), jit._CAPTURE_LOCK:
        yield


def _capture_base(out_dir=None):
    from .. import config
    base = out_dir or config.get_env("MXTPU_PROFILE_DIR")
    if not base:
        base = os.path.join(tempfile.gettempdir(), "mxtpu_profile")
    return base


def _prune_mtime(path):
    """Missing-file-tolerant sort key: a capture subdir can be deleted
    (concurrent prune in another process, operator rm) between
    os.listdir and the sort's getmtime — a vanished dir sorts oldest and
    its rmtree below is already an ignore_errors no-op."""
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def _prune(base, keep):
    """Bound the capture dir: keep the ``keep`` newest capture subdirs."""
    try:
        subdirs = [os.path.join(base, d) for d in os.listdir(base)
                   if d.startswith("capture-")]
        subdirs.sort(key=_prune_mtime)
        for victim in subdirs[:max(0, len(subdirs) - keep)]:
            shutil.rmtree(victim, ignore_errors=True)
    except Exception:
        _LOG.debug("profile dir prune failed", exc_info=True)


@contextlib.contextmanager
def _trace_session(path):
    """One ``torch.profiler`` session over CPU and CUDA activity, exported
    as ``capture.trace.json`` (a chrome trace) into ``path``. Python frames are
    off unless MXTPU_PROFILE_PYTHON_TRACER is set (``with_stack``): they
    tax every interpreter call while tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from .. import config
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   with_stack=bool(config.get_env(
                       "MXTPU_PROFILE_PYTHON_TRACER")))
    span = {}
    with profiler_transition():
        prof.start()
        t0 = _time.monotonic()
    try:
        yield span
    finally:
        with profiler_transition():
            span["traced_s"] = _time.monotonic() - t0
            prof.stop()
        prof.export_chrome_trace(os.path.join(path, "capture.trace.json"))


def capture_profile(seconds=2.0, out_dir=None):
    """On-demand ``torch.profiler`` capture (GET /debug/profile?seconds=N):
    trace into a fresh subdir of MXTPU_PROFILE_DIR for ``seconds``
    (clamped to MXTPU_PROFILE_MAX_S), then prune the dir down to
    MXTPU_PROFILE_KEEP captures. Single-flight: a concurrent call raises
    ProfileCaptureBusy instead of corrupting the in-flight trace (the
    HTTP route maps it to 409)."""
    from .. import config
    if _capture_lock.acquire(blocking=False):
        if not TORCH_PROFILER_LOCK.acquire(blocking=False):
            _capture_lock.release()
            raise ProfileCaptureBusy(
                "the profiler module's torch.profiler trace is running "
                "(one torch.profiler session at a time)")
        try:
            max_s = float(config.get_env("MXTPU_PROFILE_MAX_S"))
            seconds = min(max(0.05, float(seconds)), max(0.05, max_s))
            base = _capture_base(out_dir)
            path = os.path.join(base, "capture-%d-%d"
                                % (os.getpid(), next(_capture_seq)))
            os.makedirs(path, exist_ok=True)
            with _trace_session(path) as span:
                _time.sleep(seconds)
            _prune(base, int(config.get_env("MXTPU_PROFILE_KEEP")))
            # capture_id = the subdir basename: stable across _prune (a
            # remembered profstats summary under this id outlives the
            # dir), unique per process+sequence; traced_s = the seconds
            # the profiler recorded, from its start's return to its stop
            # (the call's wall time adds the start, stop and export)
            return {"dir": path, "seconds": seconds,
                    "traced_s": span.get("traced_s"),
                    "capture_id": os.path.basename(path)}
        finally:
            TORCH_PROFILER_LOCK.release()
            _capture_lock.release()
    raise ProfileCaptureBusy(
        "a profiler capture is already in progress (single-flight: "
        "retry after it finishes)")


def capture_in_progress():
    """True while capture_profile holds the single-flight lock."""
    if _capture_lock.acquire(blocking=False):
        try:
            return False
        finally:
            _capture_lock.release()
    return True


def dispatch_totals():
    """Process-cumulative dispatch facts summed over every (model, kind)
    series — the before/after snapshot pair profstats subtracts to join
    a capture window against device truth: {"flops", "bytes",
    "dispatch_s", "chip_s", "by_model": {model: dispatch_s}}."""
    out = {"flops": 0.0, "bytes": 0.0, "dispatch_s": 0.0, "chip_s": 0.0,
           "by_model": {}}
    for metric, key in ((_FLOPS_TOTAL, "flops"), (_BYTES_TOTAL, "bytes"),
                        (_DISPATCH_SECONDS, "dispatch_s"),
                        (_CHIP_SECONDS, "chip_s")):
        for labels, v in metric.series():
            out[key] += v
            if key == "dispatch_s":
                m = labels.get("model", "-")
                out["by_model"][m] = out["by_model"].get(m, 0.0) + v
    return out
