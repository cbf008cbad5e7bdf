"""Profiler (counterpart of ``incubator_mxnet_tpu/profiler.py``; MXNet's
``python/mxnet/profiler.py`` and ``src/profiler/profiler.h``).

The JAX package's API, clock and files: ``set_config``/``set_state('run'
| 'stop')``, ``pause``/``resume``, a ``scope`` prefix for event names,
``Marker`` and ``record_event`` for host events, ``record_batch`` for the
serving batcher, ``dumps`` (the aggregate table) and ``dump`` (a
chrome://tracing JSON file with ``traceEvents``, ``displayTimeUnit``,
``deviceMemory`` and ``profiledPeakBytes``).

With ``profile_imperative`` (the default) every eager ``nd`` operator is
timed where it passes ``ndarray._apply``: ``record_op`` synchronises the
device's current stream before it stamps the end, so an event covers the
operator's device work, and names the event ``op:<scope><operator>`` by
the public operator (``op:FullyConnected``, ``op:dot``, ``op:__mul__``).
Inside a CUDA-graph capture (``jit.TrainStep``, a hybridized block) it
neither records nor synchronises: a synchronise would break the capture,
and a captured operator is not an execution. ``profile_memory`` adds the
device's allocated bytes after each recorded operator (the caching
allocator's ``allocated_bytes.all``, summed over devices).

``trace_dir`` (the JAX package's ``jax_trace_dir`` is read too) runs
``torch.profiler`` over CPU and CUDA activity between ``run`` and
``stop`` and writes its chrome trace into that directory.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause", "resume",
           "scope", "Marker", "record_event", "record_batch", "device_memory",
           "memory_summary", "set_memory_source", "now_us"]

# Event timing: time.time() is not monotonic (an NTP step mid-run would
# make durations negative), so every timestamp is a time.perf_counter()
# difference anchored once to the wall clock at import: real epoch
# microseconds whose differences are perf_counter differences.
_EPOCH_TIME_S = time.time()
_EPOCH_PERF_S = time.perf_counter()


def now_us():
    """Epoch-anchored monotonic timestamp in microseconds: the one clock
    of every profiler event (and of the batcher's ``record_batch``)."""
    return (_EPOCH_TIME_S + (time.perf_counter() - _EPOCH_PERF_S)) * 1e6


_CONFIG = {"filename": "profile.json", "aggregate_stats": True,
           # profile_imperative: time every eager nd operator at _apply,
           # synchronised (MXNet's per-operator engine profiling)
           "profile_imperative": True,
           # profile_memory: the allocated device bytes after each recorded
           # operator, as counter events and the table's Mem column
           "profile_memory": True}
_STATE = {"running": False, "trace": None, "trace_dir": None, "traces": 0,
          "peak_bytes": 0}
_EVENTS = []
_LOCK = threading.Lock()
_AGG = {}
_MEM_SOURCE = None  # injectable for tests


def set_config(**kwargs):
    """Set options: ``filename``, ``profile_imperative``,
    ``profile_memory``, ``max_events``, ``trace_dir``, ..."""
    _CONFIG.update(kwargs)


def set_state(state_="stop", profile_process="worker"):
    """Start (``'run'``) or stop (``'stop'``) recording."""
    if state_ == "run" and not _STATE["running"]:
        trace_dir = _CONFIG.get("trace_dir") or _CONFIG.get("jax_trace_dir")
        if trace_dir:
            _start_trace(trace_dir)
        _STATE["running"] = True
        _STATE["peak_bytes"] = 0  # a fresh run, a fresh peak
    elif state_ == "stop" and _STATE["running"]:
        _STATE["running"] = False
        if _STATE["trace"] is not None:
            _stop_trace()


def _start_trace(trace_dir):
    """A ``torch.profiler`` session until ``_stop_trace``; it holds
    ``devstats.TORCH_PROFILER_LOCK`` (one session at a time: a
    ``/debug/profile`` capture in flight raises here)."""
    from torch.profiler import ProfilerActivity, profile
    from .telemetry import devstats
    if not devstats.TORCH_PROFILER_LOCK.acquire(blocking=False):
        raise devstats.ProfileCaptureBusy(
            "a torch.profiler capture is in flight (GET /debug/profile); "
            "trace_dir needs the one torch.profiler session")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    from . import jit
    with jit._CAPTURE_LOCK:          # not inside another thread's capture
        prof.start()
    _STATE["trace"], _STATE["trace_dir"] = prof, trace_dir


def _stop_trace():
    from .telemetry import devstats
    prof, trace_dir = _STATE["trace"], _STATE["trace_dir"]
    _STATE["trace"] = _STATE["trace_dir"] = None
    from . import jit
    try:
        with jit._CAPTURE_LOCK:
            prof.stop()
    finally:
        devstats.TORCH_PROFILER_LOCK.release()
    os.makedirs(trace_dir, exist_ok=True)
    _STATE["traces"] += 1
    prof.export_chrome_trace(os.path.join(
        trace_dir, "trace_%d_%d.json" % (os.getpid(), _STATE["traces"])))


def state():
    return "run" if _STATE["running"] else "stop"


def record_event(name, categories="host", start_us=None, dur_us=None,
                 args=None):
    """Record one host event (a complete 'X' event).

    The event list is bounded by the ``max_events`` option (default
    500,000): recording stops at the cap, the aggregate table goes on."""
    if not _STATE["running"]:
        return
    with _LOCK:
        if len(_EVENTS) < _CONFIG.get("max_events", 500_000):
            ev = {"name": name, "cat": categories, "ph": "X",
                  "ts": start_us if start_us is not None else now_us(),
                  "dur": dur_us or 0, "pid": 0, "tid": threading.get_ident()}
            if args is not None:
                ev["args"] = args
            _EVENTS.append(ev)
        agg = _AGG.setdefault(name, {"count": 0, "total_us": 0.0, "max_us": 0.0})
        agg["count"] += 1
        agg["total_us"] += dur_us or 0
        agg["max_us"] = max(agg["max_us"], dur_us or 0)


def record_batch(model, size, bucket, start_us=None, dur_us=None,
                 request_ids=None):
    """One event per batch the serving batcher dispatches, named by model
    and padded bucket (``serve:<model>:batch<bucket>``), with the real
    item count, the bucket and the requests' trace ids as arguments."""
    args = {"batch_size": size, "bucket": bucket}
    if request_ids:
        args["request_ids"] = list(request_ids)
    record_event("serve:%s:batch%d" % (model, bucket), "serving",
                 start_us, dur_us, args=args)


class Marker:
    """A scoped host event."""

    def __init__(self, name, categories="host"):
        self.name = name
        self.categories = categories

    def __enter__(self):
        self._t0 = now_us()
        return self

    def __exit__(self, *a):
        record_event(self.name, self.categories, self._t0,
                     now_us() - self._t0)


class scope:
    """Operator events inside are named under the prefix ``name``."""

    _current = threading.local()

    def __init__(self, name="<unk>:"):
        self.name = name

    def __enter__(self):
        self._old = getattr(scope._current, "value", "")
        scope._current.value = self._old + self.name
        return self

    def __exit__(self, *a):
        scope._current.value = self._old


def imperative_active():
    """Whether ``ndarray._apply`` times its operators now."""
    return _STATE["running"] and _CONFIG.get("profile_imperative", True)


def _capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _tensors(outs):
    for o in outs:
        if isinstance(o, (list, tuple)):
            yield from _tensors(o)
        else:
            t = getattr(o, "_data", o)
            if isinstance(t, torch.Tensor):
                yield t


def record_op(name, t0_us, outs):
    """Record one eager operator that started at ``t0_us``: the current
    streams of its outputs' devices are synchronised first, so the event
    ends when its device work does. Inside a capture it does nothing."""
    if _capturing():
        return
    for device in {t.device for t in _tensors(outs) if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()
    prefix = getattr(scope._current, "value", "")
    full = "op:" + prefix + name
    record_event(full, "operator", t0_us, now_us() - t0_us)
    if _CONFIG.get("profile_memory", True):
        _sample_memory(full)


def set_memory_source(fn):
    """Where memory samples come from: ``fn()`` gives bytes in use, or
    ``{'bytes_in_use': int, 'peak_bytes_in_use': int}``; None restores
    the CUDA caching allocator's statistics."""
    global _MEM_SOURCE
    _MEM_SOURCE = fn


def _mem_now():
    """(bytes in use, peak bytes in use) summed over the CUDA devices, or
    None where CUDA has not started (the CPU)."""
    if _MEM_SOURCE is not None:
        s = _MEM_SOURCE()
        if isinstance(s, dict):
            return (int(s.get("bytes_in_use", 0)),
                    int(s.get("peak_bytes_in_use",
                              s.get("bytes_in_use", 0))))
        return int(s), int(s)
    if not torch.cuda.is_initialized():
        return None
    live = peak = 0
    for i in range(torch.cuda.device_count()):
        a = _allocated(i)
        live += a.get("current", 0)
        peak += a.get("peak", 0)
    return live, peak


def _allocated(device):
    """The caching allocator's allocated-bytes counters of ``device``
    (``current``, ``peak``, ...): read from the nested statistics, without
    flattening them as ``torch.cuda.memory_stats`` does (that costs more
    than a small operator when every operator is sampled)."""
    return torch.cuda.memory_stats_as_nested_dict(device).get(
        "allocated_bytes", {}).get("all", {})


def _sample_memory(op_name):
    """Attach a memory sample to the operator's aggregate row and add a
    chrome-trace counter event."""
    mem = _mem_now()
    if mem is None:
        return
    live, peak = mem
    with _LOCK:
        _STATE["peak_bytes"] = max(_STATE["peak_bytes"], peak, live)
        agg = _AGG.get(op_name)
        if agg is not None:
            agg["mem_bytes"] = live
            agg["peak_mem_bytes"] = max(agg.get("peak_mem_bytes", 0), live)
        if len(_EVENTS) < _CONFIG.get("max_events", 500_000):
            _EVENTS.append({"name": "device_memory", "ph": "C",
                            "ts": now_us(), "pid": 0,
                            "args": {"bytes_in_use": live}})


def _host_rss():
    """The process's resident bytes now and at its peak, under 'host'."""
    import resource
    import sys
    out = {"peak_rss_bytes": int(resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss) * (
            1 if sys.platform == "darwin" else 1024)}
    try:
        with open("/proc/self/statm") as f:
            out["rss_bytes"] = int(f.read().split()[1]) * \
                os.sysconf("SC_PAGE_SIZE")
    except OSError:
        out["rss_bytes"] = out["peak_rss_bytes"]
    return {"host": out}


def device_memory():
    """Memory of each CUDA device: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (the caching allocator's allocated bytes) and
    ``bytes_limit`` (the device's total memory), keyed ``cuda:<i>``.
    Without CUDA, the host's resident bytes under ``'host'``
    (``rss_bytes``, ``peak_rss_bytes``), as the JAX package reports a
    backend without memory statistics. (The JAX package reads these
    through ``telemetry/devstats.py``, which takes this over when it is
    ported.)"""
    if not torch.cuda.is_available():
        return _host_rss()
    out = {}
    for i in range(torch.cuda.device_count()):
        a = _allocated(i)
        out["cuda:%d" % i] = {
            "bytes_in_use": int(a.get("current", 0)),
            "peak_bytes_in_use": int(a.get("peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory)}
    return out


def memory_summary():
    """Each device's live, peak and limit in MB, and the profiled run's
    peak."""
    lines = ["%-24s %14s %14s %14s"
             % ("Device", "Live(MB)", "Peak(MB)", "Limit(MB)")]
    mb = 1.0 / (1024 * 1024)
    for dev, s in device_memory().items():
        lines.append("%-24s %14.1f %14.1f %14.1f"
                     % (dev,
                        s.get("bytes_in_use", s.get("rss_bytes", 0)) * mb,
                        s.get("peak_bytes_in_use",
                              s.get("peak_rss_bytes", 0)) * mb,
                        s.get("bytes_limit", 0) * mb))
    lines.append("profiled-run peak: %.1f MB"
                 % (_STATE["peak_bytes"] * mb))
    return "\n".join(lines)


def pause(profile_process="worker"):
    _STATE["running"] = False


def resume(profile_process="worker"):
    _STATE["running"] = True


def dumps(reset=False, format="table"):
    """The aggregate table, busiest first: calls, total, mean and longest
    microseconds, and the device bytes in use after the last recorded
    call ('-' where no sample was taken)."""
    lines = ["%-48s %8s %12s %10s %10s %10s"
             % ("Name", "Calls", "Total(us)", "Avg(us)", "Max(us)",
                "Mem(MB)")]
    mb = 1.0 / (1024 * 1024)
    with _LOCK:
        order = sorted(_AGG.items(), key=lambda kv: -kv[1]["total_us"])
        for name, agg in order:
            mem = ("%10.1f" % (agg["mem_bytes"] * mb)) \
                if "mem_bytes" in agg else "%10s" % "-"
            lines.append("%-48s %8d %12.1f %10.1f %10.1f %s"
                         % (name[:48], agg["count"], agg["total_us"],
                            agg["total_us"] / max(agg["count"], 1),
                            agg["max_us"], mem))
        if reset:
            _AGG.clear()
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write the chrome://tracing JSON to the ``filename`` option: the
    events, the memory counters and a last per-device snapshot
    (``deviceMemory``). The lock is held only to copy the event list; the
    events dumped are dropped when ``finished``, those recorded while the
    file was written stay for the next dump."""
    with _LOCK:
        events = list(_EVENTS)
        peak = _STATE["peak_bytes"]
    payload = {"traceEvents": events, "displayTimeUnit": "ms",
               "deviceMemory": device_memory(),
               "profiledPeakBytes": peak}
    with open(_CONFIG["filename"], "w") as f:
        json.dump(payload, f)
    if finished:
        with _LOCK:
            del _EVENTS[:len(events)]
