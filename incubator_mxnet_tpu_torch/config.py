"""Typed environment-variable registry (counterpart of
``incubator_mxnet_tpu/config.py``): every knob the port reads is declared,
typed and documented here, and ``get_env(name)`` is the one accessor.

Only the knobs the port reads are declared: the serving knobs, the gate
of the conv-backward kernel and the training step's (``jit.TrainStep``:
remat, donation, the bound on its captured graphs, which also bounds a
hybridized block's), the image iterator's threads and the engine's bulk
size. The flash-attention
block/force/interpret knobs of the JAX package are TPU tiling and Pallas
interpret switches and have no counterpart here.
"""
from __future__ import annotations

import os

__all__ = ["ENV_VARS", "get_env", "evict_to_bound", "describe"]

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
    "MXTPU_CONV_BWD_PALLAS": (
        bool, True,
        "Gate of the hand-written CUDA conv-backward kernel (K4, "
        "ops/csrc/conv_bwd.cu; the name is the JAX package's, whose kernel "
        "is Pallas): ops.conv_bwd.conv3x3_s1 routes its backward through "
        "it when the shape is legal. 0 takes the library conv's gradient "
        "instead. Model-zoo convs never take it."),
    "MXTPU_AOT_CACHE_SIZE": (
        int, 64,
        "Bound on each jit.TrainStep's captured CUDA graphs, one per input "
        "shape signature, and on each hybridized block's (one forward "
        "and backward pair per call signature; the JAX package's "
        "process-wide AOT cache of "
        "compiled programs): past it the least recently replayed graph "
        "and its memory pool are released, and its signature captures "
        "again on its next call."),
    "MXTPU_NO_DONATE": (
        bool, False,
        "Debugging: jit.TrainStep's update writes new tensors and rebinds "
        "the parameters and optimizer states to them instead of updating "
        "them in place, so a tensor taken before the step keeps its "
        "values. Moving addresses cannot be replayed, so the step runs "
        "eagerly (uncaptured) on the card."),
    "MXTPU_REMAT": (
        bool, False,
        "Default remat (rematerialisation) for jit.TrainStep when the "
        "caller does not pass remat= explicitly: the forward and loss run "
        "under torch.utils.checkpoint and are recomputed in the backward "
        "(MXNET_BACKWARD_DO_MIRROR analog)."),
    "MXTPU_CPU_WORKER_NTHREADS": (
        int, 4,
        "Default decode/augment thread count of io.ImageRecordIter when "
        "preprocess_threads is not given (MXNET_CPU_WORKER_NTHREADS "
        "analog)."),
    "MXTPU_ENGINE_BULK_SIZE": (
        int, 15,
        "Initial engine bulk size (MXNET_ENGINE_BULK_SIZE analog), read "
        "by engine.set_bulk_size. It groups nothing: eager operators "
        "launch one by one and the captured paths are one CUDA graph "
        "already."),
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


def evict_to_bound(cache, on_evict=None):
    """Drop the least recently used entries of a cache of captured graphs
    until it holds MXTPU_AOT_CACHE_SIZE (call after inserting). The cache
    is a dict in recency order: a caller marking a hit moves the entry to
    the end (``cache[k] = cache.pop(k)``), so the front entry is the least
    recently used. ``on_evict(key, value)`` runs for each entry dropped."""
    bound = max(1, get_env("MXTPU_AOT_CACHE_SIZE"))
    while len(cache) > bound:
        key = next(iter(cache))
        value = cache.pop(key)
        if on_evict is not None:
            on_evict(key, value)


def describe():
    """The registry as a table: name, type, default and doc per line."""
    lines = ["%-24s %-6s %-10s %s" % ("Variable", "Type", "Default", "Doc")]
    for name, (typ, default, doc) in sorted(ENV_VARS.items()):
        lines.append("%-24s %-6s %-10s %s"
                     % (name, typ.__name__, str(default), doc))
    return "\n".join(lines)

