"""What a ``--trace 1`` run hands each per-layer metric's reader."""
from __future__ import annotations

from portbench.core import peaks, spec


class Trace:
    """The measured window and the profiled segment after it.

    - ``spans``: the port's span records (``telemetry.spans``) from the
      window's start to the segment's end; ``window_spans(name)`` those of
      one name that started inside the window;
    - ``t0_us``, ``t1_us``, ``window_s``: the window on the host's clock
      (``profiler.now_us``);
    - ``steps``, ``tokens`` (training) or ``served`` (serving: replies
      received in the window): the work the window completed;
    - ``segment``: the profiled segment (``devtrace.Segment``), with
      ``segment_steps`` training steps in it;
    - ``cell``, ``peaks``, ``attention_kernels``.
    """

    def __init__(self, cell, dev, spans, t0_us, t1_us, window_s, segment,
                 steps=0, tokens=0, served=0, segment_steps=0):
        self.cell = cell
        self.spans = spans
        self.t0_us, self.t1_us, self.window_s = t0_us, t1_us, window_s
        self.segment = segment
        self.steps, self.tokens, self.served = steps, tokens, served
        self.segment_steps = segment_steps
        self.device_name = dev.name()
        self.peaks = peaks.of(self.device_name)
        self.attention_kernels = [p for names in
                                  spec.attention_kernels().values()
                                  for p in names]

    def window_spans(self, name):
        return [r for r in self.spans if r["name"] == name and
                self.t0_us <= r["start_us"] < self.t1_us]

    def segment_spans(self, name):
        seg = self.segment
        return [r for r in self.spans if r["name"] == name and
                seg.t0_us <= r["start_us"] and
                r["start_us"] + r["dur_us"] <= seg.t1_us]
