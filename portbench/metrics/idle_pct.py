"""``idle_pct.train``, ``idle_pct.serve``: the share of the profiled
segment in which no device activity ran (100 − the union of kernels,
copies and fills over the segment, ``devtrace.merged_busy``)."""
from __future__ import annotations


def read(t):
    seg = t.segment
    if seg is None or not seg.events or seg.window_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.window_s)
