"""``batch_ms.serve_open``: the mean time of one batch in
``DynamicBatcher``, its ``serve:batch`` span (padding, the servable's call
through the captured ``EvalStep`` and the copy to the host, and the
replies handed back), over the spans that started in the window."""
from __future__ import annotations


def read(t):
    spans = t.window_spans("serve:batch")
    if not spans:
        return None
    return sum(r["dur_us"] for r in spans) / len(spans) / 1e3
