"""``batch_rows.serve``: the mean ``batch_size`` (requests, padding
excluded) of the ``serve:batch`` spans of ``DynamicBatcher`` that started
in the window."""
from __future__ import annotations


def read(t):
    spans = t.window_spans("serve:batch")
    if not spans:
        return None
    return sum(r["args"]["batch_size"] for r in spans) / len(spans)
