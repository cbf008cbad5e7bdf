"""``queue_ms.serve``: the median wait of a request in the batcher's
queue, its ``serve:queue`` span (from its submit to its batch's
gathering), over the spans that started in the window."""
from __future__ import annotations

import statistics


def read(t):
    spans = t.window_spans("serve:queue")
    if not spans:
        return None
    return statistics.median(r["dur_us"] for r in spans) / 1e3
