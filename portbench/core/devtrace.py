"""The traced run's device trace: a profiled segment after the measured
window, its device activities on the host's clock, busy time and idle
gaps, and the ``breakdown`` of the result line.

Busy time is the union of the intervals of every device activity (kernels,
copies, fills) over all streams, as ``telemetry/profstats.py`` of the port
computes it (``_merged_busy``, copied here so the yardstick does not move
with the program). Activities come from the profiler's raw results, as
``chip_smoke.py`` reads them, without building an event object for every
host operator.

The port's spans are on ``profiler.now_us()``'s clock; the profiler's
events are on its own. A ``record_function`` marker entered at a known
``now_us()`` gives the offset between the two.
"""
from __future__ import annotations

import collections

MARKER = "portbench.segment"


def merged_busy(intervals):
    """(busy total, gaps [(start, length)]) over intervals sorted by start
    (``profstats._merged_busy``)."""
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


def _is_activity(event):
    """A kernel, copy or fill: not a hidden event, and not the device-side
    shadow of a ``record_function`` range (a ``gpu_user_annotation``, which
    spans the range and would count it all as busy)."""
    if getattr(event, "is_hidden_event", lambda: False)():
        return False
    if getattr(event, "is_user_annotation", lambda: False)():
        return False
    kind = getattr(event, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return False
    return event.name() != MARKER


class Segment:
    """``with Segment(dev, now_us) as seg:`` profiles what runs inside on the
    host and the device. After it: ``t0_us``/``t1_us`` (host clock, from
    after the profiler started to after a final synchronise), ``events``
    [(start_us, end_us, name)] of every device activity on the host clock,
    clipped to the segment."""

    def __init__(self, dev, now_us):
        self.dev = dev
        self.now_us = now_us
        self.events = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.dev.is_cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.dev.sync()
        self.t0_us = self.now_us()
        self._mark = record_function(MARKER)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._mark.__exit__(*exc)
        self.dev.sync()
        self.t1_us = self.now_us()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType
        raw = self._prof.profiler.kineto_results.events()
        offset = None
        device = []
        for e in raw:
            if e.device_type() == DeviceType.CUDA:
                if not _is_activity(e):
                    continue
                device.append((e.start_ns() / 1e3, e.end_ns() / 1e3,
                               e.name()))
            elif offset is None and e.name() == MARKER:
                offset = self.t0_us - e.start_ns() / 1e3
        if offset is None:
            raise RuntimeError("the profiler's trace lacks the %s marker"
                               % MARKER)
        lo, hi = self.t0_us, self.t1_us
        out = []
        for s, e, name in device:
            s, e = max(lo, s + offset), min(hi, e + offset)
            if e > s:
                out.append((s, e, name))
        out.sort()
        self.events = out

    @property
    def window_s(self):
        return (self.t1_us - self.t0_us) / 1e6

    def busy_s(self):
        busy, _ = merged_busy([(s, e) for s, e, _ in self.events])
        return busy / 1e6

    def gaps(self):
        """Idle gaps [(start_us, length_us)], the segment's edges
        included."""
        busy, gaps = merged_busy([(s, e) for s, e, _ in self.events])
        if not self.events:
            return [(self.t0_us, self.t1_us - self.t0_us)]
        first = self.events[0][0]
        last = max(e for _, e, _ in self.events)
        edges = [(self.t0_us, first - self.t0_us), (last, self.t1_us - last)]
        return gaps + [g for g in edges if g[1] > 0]

    def device_time_s(self, patterns, within=None):
        """Summed device time of activities whose name holds one of
        ``patterns``; with ``within`` [(start_us, end_us)], only those that
        start inside one of those intervals."""
        total = 0.0
        for s, e, name in self.events:
            if not any(p in name for p in patterns):
                continue
            if within is not None and not any(a <= s < b for a, b in within):
                continue
            total += e - s
        return total / 1e6


def innermost_span(spans, t_us):
    """The name of the innermost span open at ``t_us`` (the latest start
    among those covering it), or "no span"."""
    best = None
    for rec in spans:
        s = rec["start_us"]
        if s <= t_us <= s + rec["dur_us"] and (best is None or
                                               s >= best["start_us"]):
            best = rec
    return best["name"] if best is not None else "no span"


def breakdown(seg, spans, top=10):
    """``{"device_ops": [[name, seconds]], "idle_gaps": [[the host span
    open in the gap, seconds]]}``, the ``top`` largest of each."""
    by_name = collections.defaultdict(float)
    for s, e, name in seg.events:
        by_name[name[:200]] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(seg.gaps(), key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[innermost_span(spans, s + n / 2), n / 1e6]
                          for s, n in gaps]}


def attention_bound_s(batch, heads, seq, head_dim, causal, itemsize,
                      backward, peak_flops, peak_bytes):
    """Least time of one attention call at these shapes: max(FLOPs / peak,
    bytes / bandwidth). Forward 4·B·H·D·pairs FLOPs, reading q, k, v and
    writing o and the log-sum-exp; backward 8·B·H·D·pairs, reading q, k, v,
    o, dO and the log-sum-exp and writing dq, dk, dv. Pairs are S², or
    S(S+1)/2 when causal."""
    pairs = seq * (seq + 1) / 2 if causal else seq * seq
    bhd = batch * heads * seq * head_dim
    lse = batch * heads * seq * 4
    if backward:
        flops = 8.0 * batch * heads * head_dim * pairs
        nbytes = 8 * bhd * itemsize + lse
    else:
        flops = 4.0 * batch * heads * head_dim * pairs
        nbytes = 4 * bhd * itemsize + lse
    return max(flops / peak_flops, nbytes / peak_bytes)
