"""Typed environment-variable registry (counterpart of
``incubator_mxnet_tpu/config.py``): every knob the port reads is declared,
typed and documented here, and ``get_env(name)`` is the one accessor.

Only the knobs the port reads are declared: the serving knobs (the
batcher, the HTTP front end, the access log, resilience and generation),
the telemetry knobs, the AOT cache's, the gate of the conv-backward
kernel and the training step's (``jit.TrainStep``: remat, donation), the
image iterator's threads and the engine's bulk size. The flash-attention
block/force/interpret knobs of the JAX package are TPU tiling and Pallas
interpret switches and have no counterpart here. Two knobs are declared
only to refuse them: ``MXTPU_AOT_CACHE_DIR`` (the artifact layer waits
for the next slice) and ``MXTPU_GEN_SLO_INTER_TOKEN_MS`` (SLOs wait for
ROADMAP §1 item 7); setting either makes its reader raise.
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
    "MXTPU_SERVE_PORT": (
        int, 8080,
        "Default port of serving.ServingServer's HTTP front end; 0 picks "
        "an ephemeral port (tests)."),
    "MXTPU_FAULTLAB": (
        str, None,
        "Faultlab arming spec applied at import (telemetry/faultlab.py): "
        "';'-separated 'site:kind[:key=value...]' entries, kind in "
        "{exception, replica_kill, slow_ms, kv_oom, nan_poison, "
        "artifact_corrupt}, keys stride=/p=/seed=/budget=/ms=. Unset = "
        "disarmed. Runtime arming via POST /debug/faults."),
    "MXTPU_RESILIENCE_RETRY": (
        bool, True,
        "One bounded retry of a predict request whose replica worker died "
        "around its dispatch (serving/batcher.py): it re-enters the router "
        "once under its original deadline; counted on "
        "mxtpu_retries_total{model}."),
    "MXTPU_RESILIENCE_ROLLBACK": (
        bool, True,
        "Last-known-good rollback (serving/registry.py): a version flipped "
        "degraded repoints dispatch to the newest earlier version still "
        "resident and quarantines itself."),
    "MXTPU_RESILIENCE_BACKOFF_BASE_S": (
        float, 0.1,
        "Supervisor respawn backoff base in seconds: the Nth consecutive "
        "death waits base * 2^(N-1) (+ seeded jitter), capped at "
        "MXTPU_RESILIENCE_BACKOFF_CAP_S."),
    "MXTPU_RESILIENCE_BACKOFF_CAP_S": (
        float, 5.0,
        "Upper bound on the supervisor's exponential respawn backoff."),
    "MXTPU_RESILIENCE_CRASH_N": (
        int, 5,
        "Crash-loop breaker: a replica (or decode loop) that dies this "
        "many times within MXTPU_RESILIENCE_CRASH_WINDOW_S is parked."),
    "MXTPU_RESILIENCE_CRASH_WINDOW_S": (
        float, 30.0,
        "Sliding window in seconds of the crash-loop breaker's count."),
    "MXTPU_RESILIENCE_POLL_S": (
        float, 0.05,
        "Supervisor poll interval in seconds."),
    "MXTPU_TELEMETRY_FLUSH_S": (
        float, 0.0,
        "Periodic telemetry flush interval in seconds: > 0 starts a daemon "
        "thread at package import that writes the Prometheus exposition "
        "to MXTPU_TELEMETRY_FILE every interval. 0 disables."),
    "MXTPU_TELEMETRY_FILE": (
        str, "telemetry.prom",
        "Path the periodic telemetry flusher writes (atomic tmp+rename)."),
    "MXTPU_TELEMETRY_MAX_SERIES": (
        int, 64,
        "Per-metric bound on distinct label combinations in the telemetry "
        "registry; past it new label values are clamped onto the "
        "'_other_' series with a one-time RuntimeWarning."),
    "MXTPU_SPANS_BUFFER": (
        int, 8192,
        "Bound on the finished-span ring buffer (telemetry/spans.py), "
        "served at GET /debug/spans."),
    "MXTPU_SPANS_HISTOGRAM": (
        bool, False,
        "Feed every finished span's duration into the "
        "mxtpu_span_seconds{span} histogram (spans.set_histogram_bridge "
        "overrides at run time)."),
    "MXTPU_FLIGHTREC_SIZE": (
        int, 2048,
        "Bound on the flight-recorder event ring (telemetry/flightrec.py)."),
    "MXTPU_FLIGHTREC_FILE": (
        str, "flightrec.jsonl",
        "Path the flight recorder writes its JSONL tape to on unhandled "
        "exceptions and flightrec.dump()."),
    "MXTPU_FLIGHTREC_DUMP_ON_CRASH": (
        bool, True,
        "Dump the flight-recorder tape to MXTPU_FLIGHTREC_FILE when an "
        "unhandled exception kills the main thread or a worker thread."),
    "MXTPU_WATCHDOG": (
        bool, False,
        "Start the stall watchdog's monitor thread at package import "
        "(telemetry/watchdog.py). Loops heartbeat regardless."),
    "MXTPU_WATCHDOG_QUIET_S": (
        float, 60.0,
        "Quiet period in seconds before a heartbeat channel is declared "
        "stalled and a stack + flight-recorder report is emitted."),
    "MXTPU_WATCHDOG_POLL_S": (
        float, 1.0,
        "Watchdog monitor poll interval in seconds."),
    "MXTPU_WATCHDOG_FILE": (
        str, None,
        "File the watchdog appends stall reports to; None: logging only "
        "(and watchdog.last_report() / GET /debug/stacks)."),
    "MXTPU_GEN_BLOCK_SIZE": (
        int, 16,
        "Token slots per KV-cache block (ops/kvcache.py paged pool)."),
    "MXTPU_GEN_KV_BLOCKS": (
        int, 256,
        "KV pool capacity in blocks, allocated at engine construction "
        "(serving/generate.py); admission waits when it runs dry."),
    "MXTPU_GEN_MAX_BATCH": (
        int, 8,
        "Row count of the continuous-batching loop's one decode program "
        "(and the prefill batcher's max batch and one bucket): every "
        "step runs at it, captured at warm()."),
    "MXTPU_GEN_PREFILL_LEN": (
        int, 64,
        "Fixed prompt shape of the prefill programs: prompts are padded to "
        "it, longer ones are refused (400)."),
    "MXTPU_GEN_MAX_TOKENS": (
        int, 128,
        "Cap on max_new_tokens per generate request; with "
        "MXTPU_GEN_PREFILL_LEN it sizes each block table."),
    "MXTPU_GEN_STEP_IDLE_MS": (
        float, 1.0,
        "Decode-loop sleep granularity when no sequence is in flight."),
    "MXTPU_GEN_SLO_INTER_TOKEN_MS": (
        float, None,
        "The JAX package's per-tenant inter-token SLO threshold. SLOs come "
        "with ROADMAP §1 item 7: a GenerativeEngine raises when it is set."),
    "MXTPU_GEN_PREWARM": (
        bool, True,
        "Capture every generative program bucket at engine construction "
        "(GenerativeEngine.warm)."),
    "MXTPU_ACCESSLOG_SIZE": (
        int, 4096,
        "Bound on the per-request access-log ring (serving/accesslog.py), "
        "served at GET /debug/requests?n=."),
    "MXTPU_ACCESSLOG_FILE": (
        str, None,
        "When set, access-log records are also appended to this path as "
        "JSONL (sampled by MXTPU_ACCESSLOG_SAMPLE)."),
    "MXTPU_ACCESSLOG_SAMPLE": (
        float, 1.0,
        "Deterministic stride sampling rate (0..1) of the access-log file "
        "export: 1.0 every record, 0.5 every second, 0 none."),
    "MXTPU_CONV_BWD_PALLAS": (
        bool, True,
        "Gate of the hand-written CUDA conv-backward kernel (K4, "
        "ops/csrc/conv_bwd.cu; the name is the JAX package's, whose kernel "
        "is Pallas): ops.conv_bwd.conv3x3_s1 routes its backward through "
        "it when the shape is legal. 0 takes the library conv's gradient "
        "instead. Model-zoo convs never take it."),
    "MXTPU_AOT_CACHE_SIZE": (
        int, 64,
        "Bound on the process-wide AOT cache (aot.CACHE) of captured CUDA "
        "graphs: each jit.EvalStep signature and each generative program "
        "bucket is one entry; past the bound the least recently "
        "dispatched entry is evicted (mxtpu_aot_evictions_total) and its "
        "signature captures again on its next call. The same bound caps "
        "each jit.TrainStep's and each hybridized block's own table of "
        "graphs."),
    "MXTPU_AOT_CACHE_DIR": (
        str, None,
        "The JAX package's directory of persisted programs. The port's "
        "artifact layer (programs written to disk) comes with the next "
        "slice: setting this raises when the AOT cache reads it."),
    "MXTPU_AOT_PREWARM": (
        bool, True,
        "Pre-warm (capture) every configured batcher bucket of an incoming "
        "model version during ModelRegistry.load() hot reloads, on a "
        "background thread, smallest bucket first. Per-call override via "
        "load(prewarm=)."),
    "MXTPU_AOT_WARM_TIMEOUT_S": (
        float, 60.0,
        "Bound on how long ModelRegistry.load() waits for its prewarm "
        "thread before returning (the warm goes on in the background)."),
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

