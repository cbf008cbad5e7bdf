"""The TensorBoard logging callback (counterpart of
``incubator_mxnet_tpu/contrib/tensorboard.py``; MXNet's
``contrib/tensorboard.py``).

``LogMetricsCallback(logging_dir, prefix)`` is a batch- or epoch-end
callback that writes each metric value as one JSON line of
``<logging_dir>/metrics.jsonl``: ``{"ts": <wall-clock seconds>, "step":
<int>, "name": <str>, "value": <float>}`` (the JAX package's fallback
schema), with the standard library alone: it needs no TensorBoard, and
writes the JSON lines where the JAX package would use a SummaryWriter.
``close()`` (or the callback as a context manager) flushes and releases
the file.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


class LogMetricsCallback:
    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        os.makedirs(logging_dir, exist_ok=True)
        self._jsonl = open(os.path.join(logging_dir, "metrics.jsonl"), "a")
        self.step = 0

    def __call__(self, param):
        if param.eval_metric is None:
            return
        if self._jsonl is None:
            raise ValueError("LogMetricsCallback is closed")
        self.step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self._jsonl.write(json.dumps(
                {"ts": time.time(), "step": self.step, "name": name,
                 "value": float(value)}) + "\n")
            self._jsonl.flush()

    def close(self):
        """Flush and release the file (idempotent)."""
        if self._jsonl is not None:
            try:
                self._jsonl.close()
            finally:
                self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
