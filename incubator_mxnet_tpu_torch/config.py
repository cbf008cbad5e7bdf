"""Typed environment-variable registry (counterpart of
``incubator_mxnet_tpu/config.py``): every knob the port reads is declared,
typed and documented here, and ``get_env(name)`` is the one accessor.

Only the serving knobs the port's serving path reads are declared. The
flash-attention block/force/interpret knobs of the JAX package are TPU
tiling and Pallas interpret switches and have no counterpart here.
"""
from __future__ import annotations

import os

__all__ = ["ENV_VARS", "get_env"]

ENV_VARS = {
    # name: (type, default, doc)
    "MXTPU_SERVE_MAX_BATCH": (
        int, 8,
        "Dynamic batcher dispatch bound (serving/batcher.py): a batch is "
        "dispatched when this many requests are waiting, or when "
        "MXTPU_SERVE_TIMEOUT_MS elapses after the first one."),
    "MXTPU_SERVE_TIMEOUT_MS": (
        float, 5.0,
        "Dynamic batcher coalescing window in milliseconds: the longest a "
        "request waits for companions before a partial batch is flushed."),
    "MXTPU_SERVE_QUEUE_SIZE": (
        int, 64,
        "PER-REPLICA bound on each model's dispatch queue. When every "
        "replica's queue is full, submits reject with QueueFullError."),
    "MXTPU_SERVE_REPLICAS": (
        int, 1,
        "Data-parallel replica workers per served model; replica i runs on "
        "cuda:(i % device_count)."),
    "MXTPU_SERVE_DEADLINE_MS": (
        float, None,
        "Default per-request serving deadline in milliseconds: requests "
        "still queued when it passes fail with DeadlineExceededError. "
        "None = no deadline; a request's own deadline_ms overrides."),
}


def get_env(name):
    """Typed read of a registered variable (raises on unknown names)."""
    if name not in ENV_VARS:
        raise KeyError("unregistered env var %r — add it to config.ENV_VARS"
                       % name)
    typ, default, _doc = ENV_VARS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw.strip().lower() not in ("0", "", "false", "no", "off")
    return typ(raw)

