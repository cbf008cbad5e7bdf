"""Typed environment-variable registry (counterpart of
``incubator_mxnet_tpu/config.py``): every knob the port reads is declared,
typed and documented here, and ``get_env(name)`` is the one accessor.

Only the knobs the port reads are declared: the serving knobs (the
batcher, the HTTP front end, the access log, resilience and generation),
the telemetry knobs, the AOT cache's, the gate of the conv-backward
kernel and the training step's (``jit.TrainStep``: remat, donation), the
image iterator's threads, the native library's and the C ABI's
(``native/``), the engine's bulk size and the device
telemetry's (``devstats``, ``profstats``, ``numwatch``, ``slo``,
``history``), and those of several processes (the launcher's rendezvous,
the process group's timeout, the dist kvstores and the server role). The
flash-attention block/force/interpret knobs of the JAX
package are TPU tiling and Pallas interpret switches and have no
counterpart here.
"""
from __future__ import annotations

import os

__all__ = ["ENV_VARS", "get_env", "evict_to_bound", "describe"]

ENV_VARS = {
    # name: (type, default, doc)
    "MXTPU_INT8_SIM": (
        bool, False,
        "Run the quantized matmul/conv (ndarray/contrib.py quantized_* "
        "ops, contrib/quantization.py blocks) by dequantize -> fp32 -> "
        "requantize instead of int8 operands with int32 accumulators "
        "(torch._int_mm)."),
    "MXTPU_DEVICE_PEAK_FLOPS": (
        float, None,
        "Override the per-chip peak FLOP/s the device-truth MFU gauges "
        "(mxtpu_device_mfu, telemetry/devstats.py) divide by. Unset: "
        "resolved from torch.cuda.get_device_name via the built-in peak "
        "table (the H100's dense bf16 rate); unknown devices (the CPU) "
        "fall back to a report-only nominal peak."),
    "MXTPU_DEVICE_PEAK_HBM_BPS": (
        float, None,
        "Override the per-chip peak HBM bytes/s the "
        "mxtpu_device_hbm_bw_util gauge divides by. Unset: the device name "
        "table, else report-only fallback (telemetry/devstats.py)."),
    "MXTPU_DEVSTATS": (
        bool, False,
        "Autostart the device-memory sampler daemon at package import "
        "(telemetry/devstats.py; devstats.start()/stop() at runtime): "
        "polls the CUDA caching allocator's statistics into "
        "mxtpu_device_memory_bytes{device,stat} and files a flightrec "
        "hbm_pressure event at >90% of bytes_limit. Per-dispatch MFU "
        "gauges are driven by the hot paths regardless — the knob only "
        "controls the sampler."),
    "MXTPU_DEVSTATS_POLL_S": (
        float, 1.0,
        "Device-memory sampler poll interval in seconds "
        "(telemetry/devstats.py)."),
    "MXTPU_DEVSTATS_EVAL_SYNC": (
        bool, False,
        "Time STANDALONE EvalStep replays with CUDA events and wait for "
        "them, so the eval mxtpu_device_mfu observation has the replay's "
        "device time. Off by default: a direct eval loop overlaps host "
        "prep with device execution and the wait would serialize it. "
        "Serving dispatches (under the batcher's devstats dispatch "
        "context) always observe: there the next step is a copy to the "
        "host anyway."),
    "MXTPU_PROFILE_DIR": (
        str, None,
        "Directory for on-demand torch.profiler captures "
        "(GET /debug/profile?seconds=N, devstats.capture_profile). "
        "Unset: <tmpdir>/mxtpu_profile. Bounded: only the newest "
        "MXTPU_PROFILE_KEEP captures are kept."),
    "MXTPU_PROFILE_KEEP": (
        int, 4,
        "How many on-demand profiler captures survive in "
        "MXTPU_PROFILE_DIR (oldest pruned after each capture)."),
    "MXTPU_PROFILE_MAX_S": (
        float, 60.0,
        "Upper clamp on GET /debug/profile?seconds=N capture length — an "
        "operator typo must not leave the profiler tracing for an hour."),
    "MXTPU_PROFILE_PYTHON_TRACER": (
        bool, False,
        "Include python frames in profiler captures. OFF by default: the "
        "python tracer taxes every interpreter call while tracing (~30% "
        "on a timer-bound serving request), which lands on p99 whenever "
        "a capture overlaps traffic — the continuous profstats daemon's "
        "whole operating mode. The CUDA kernel events the attribution "
        "layer reads survive with it off."),
    "MXTPU_PROFSTATS": (
        bool, False,
        "Autostart the continuous low-duty-cycle profiler daemon at "
        "package import (telemetry/profstats.py; profstats.start()/"
        "stop() at runtime): every MXTPU_PROFSTATS_INTERVAL_S it "
        "captures MXTPU_PROFSTATS_CAPTURE_S of torch.profiler trace and "
        "folds the per-op summary into "
        "mxtpu_profile_op_seconds_total{model,category} / "
        "mxtpu_profile_device_idle_ratio and GET /debug/hotspots "
        "(docs/OBSERVABILITY.md 'Op-level attribution')."),
    "MXTPU_PROFSTATS_INTERVAL_S": (
        float, 300.0,
        "Seconds between continuous-profiler capture cycles "
        "(telemetry/profstats.py daemon)."),
    "MXTPU_PROFSTATS_CAPTURE_S": (
        float, 2.0,
        "Trace length per continuous-profiler cycle; clamped to "
        "MXTPU_PROFSTATS_MAX_DUTY x MXTPU_PROFSTATS_INTERVAL_S so the "
        "profiler stays a sampling tax, never steady tracing."),
    "MXTPU_PROFSTATS_MAX_LOAD": (
        float, 0.5,
        "Queue-occupancy ceiling above which a continuous-profiler "
        "cycle is skipped (outcome=skipped_load on "
        "mxtpu_profile_captures_total): profiling is for finding the "
        "MFU gap, not for widening it under overload. Load probes: "
        "each serving ModelRegistry registers its max replica-queue "
        "occupancy (profstats.add_load_probe)."),
    "MXTPU_PROFSTATS_MAX_DUTY": (
        float, 0.02,
        "Overhead budget: max fraction of each daemon interval spent "
        "tracing (the capture length clamp)."),
    "MXTPU_PROFSTATS_SUMMARIES": (
        int, 32,
        "How many capture summaries the bounded profstats store keeps "
        "for GET /debug/hotspots?capture=<id> re-fetch — summaries "
        "outlive the pruned capture dirs themselves "
        "(MXTPU_PROFILE_KEEP)."),
    "MXTPU_HISTORY": (
        bool, False,
        "Autostart the metric-history daemon at package import "
        "(telemetry/history.py; history.start()/stop() at runtime): "
        "every MXTPU_HISTORY_INTERVAL_S it self-scrapes the telemetry "
        "registry into bounded per-series rings, evaluates the "
        "recording rules (rate(), queue-depth slope, window MFU, "
        "burn-rate trajectory) and the pressure_rising/mfu_droop early "
        "warnings, and serves GET /debug/history and /debug/incident "
        "(docs/OBSERVABILITY.md 'Metric history & incident timelines')."),
    "MXTPU_HISTORY_INTERVAL_S": (
        float, 10.0,
        "Seconds between metric-history self-scrape ticks. Retention is "
        "a direct function of it: MXTPU_HISTORY_RAW ticks of raw points "
        "plus MXTPU_HISTORY_COARSE x MXTPU_HISTORY_COARSE_EVERY ticks "
        "of min/max/mean summaries."),
    "MXTPU_HISTORY_RAW": (
        int, 512,
        "Raw ring length per history series: the newest N (t, value) "
        "points kept at full scrape resolution (telemetry/history.py). "
        "At the default 10s interval: ~85 minutes of raw history."),
    "MXTPU_HISTORY_COARSE": (
        int, 512,
        "Coarse ring length per history series: N downsampled "
        "{t, min, max, mean} points, each folding "
        "MXTPU_HISTORY_COARSE_EVERY raw samples — the long-horizon tier "
        "raw points age out into."),
    "MXTPU_HISTORY_COARSE_EVERY": (
        int, 8,
        "Raw samples folded into one coarse min/max/mean point. The "
        "fold keeps extremes honest: a one-tick queue spike survives "
        "into the coarse tier as that window's max, never averaged "
        "away."),
    "MXTPU_HISTORY_MAX_SERIES": (
        int, 1024,
        "Bound on distinct series the history store retains (scraped + "
        "derived recording-rule series). Past it, NEW series are "
        "dropped and counted on "
        "mxtpu_history_store_dropped_series_total; established series "
        "keep recording — history must never OOM the process it "
        "observes."),
    "MXTPU_HISTORY_FILE": (
        str, None,
        "When set, every history tick also exports the full store to "
        "this path as canonical JSONL (atomic tmp+rename rotation) — "
        "the offline artifact tools/tsq.py queries, diffs, and "
        "sparkline-renders."),
    "MXTPU_HISTORY_SLOPE_WINDOW_S": (
        float, 60.0,
        "Trailing window for the least-squares slope recording rules "
        "(queue depth, SLO burn rate) — the trend the pressure_rising "
        "predictor extrapolates."),
    "MXTPU_HISTORY_PRESSURE_HORIZON_S": (
        float, 60.0,
        "pressure_rising fires when a model's queue-depth trend line "
        "predicts crossing its capacity within this many seconds; the "
        "open episode only closes when the prediction retreats past "
        "twice the horizon (hysteresis) or the slope turns "
        "non-positive."),
    "MXTPU_HISTORY_PRESSURE_DEPTH": (
        float, None,
        "Fallback saturation depth for pressure_rising when a model "
        "exports no mxtpu_serving_queue_capacity gauge (the serving "
        "batcher exports queue_size x replicas automatically). None: "
        "no capacity, no prediction."),
    "MXTPU_HISTORY_DROOP_FRAC": (
        float, 0.7,
        "mfu_droop fires when the window MFU falls below this fraction "
        "of its trailing MXTPU_HISTORY_DROOP_WINDOW_S median; the "
        "episode re-arms only after MFU recovers halfway back to the "
        "median (hysteresis)."),
    "MXTPU_HISTORY_DROOP_WINDOW_S": (
        float, 600.0,
        "Trailing window whose median window-MFU is the mfu_droop "
        "baseline (the '10-minute median' the early warning compares "
        "against)."),
    "MXTPU_SLO_TARGET": (
        float, 0.99,
        "Default availability objective for the per-model SLOs the serving "
        "registry seeds at load (telemetry/slo.py): the fraction of "
        "eligible requests (2xx good; 429/504/5xx bad; other 4xx not "
        "counted) that must succeed. The error budget is 1 - target — "
        "burn rates are bad-fraction / (1 - target) "
        "(docs/OBSERVABILITY.md 'SLOs and tenants')."),
    "MXTPU_SLO_LATENCY_MS": (
        float, None,
        "When set, every served model also gets a latency SLO: a 2xx "
        "response slower than this many milliseconds end-to-end (the "
        "http:predict span window) counts against the latency error "
        "budget. None = availability SLO only (telemetry/slo.py)."),
    "MXTPU_SLO_WINDOW_S": (
        float, 3600.0,
        "Error-budget accounting window in seconds for "
        "mxtpu_slo_budget_remaining: the sliding window over which spent "
        "budget is computed (and refills as bad events age out). The SRE "
        "30-day convention is impractical for a process-local ledger; one "
        "hour is the operational default (telemetry/slo.py)."),
    "MXTPU_SLO_WINDOWS": (
        str, "300:3600,3600:21600",
        "Multi-window burn-rate alert pairs as SHORT:LONG second pairs, "
        "comma-separated, fastest first (default: the SRE-workbook 5m/1h "
        "fast pair and 1h/6h slow pair). An alert pair breaches only when "
        "BOTH its windows' burn rates exceed the pair's threshold — the "
        "short window gives detection speed, the long one suppresses "
        "blips. CI scales these down to seconds (telemetry/slo.py)."),
    "MXTPU_SLO_FAST_BURN": (
        float, 14.4,
        "Burn-rate threshold for the FIRST (fast) alert-window pair: 14.4 "
        "means the error budget is being spent 14.4x faster than the "
        "objective allows (the SRE-workbook page-now threshold — 2% of a "
        "30-day budget in one hour)."),
    "MXTPU_SLO_SLOW_BURN": (
        float, 6.0,
        "Burn-rate threshold for the second and later (slow) alert-window "
        "pairs (the SRE-workbook ticket threshold — 5% of a 30-day "
        "budget in six hours)."),
    "MXTPU_NUMWATCH_SAMPLE": (
        float, 0.0,
        "Numerics-sentinel tap sampling rate (telemetry/numwatch.py): 0 "
        "disables the on-device stats taps (the default); a rate r in "
        "(0, 1] taps every round(1/r)-th dispatch at each site "
        "(deterministic stride, not random — two identical runs tap "
        "identical dispatches). Tap sites: TrainStep loss/params, "
        "serving dispatch outputs, decode-loop logits "
        "(docs/OBSERVABILITY.md 'Numerical health')."),
    "MXTPU_SHADOW_SAMPLE": (
        float, 0.0,
        "Default shadow-execution sampling rate for models with a "
        "registered reference servable (numwatch.register_shadow): 0 "
        "disables; rate r re-executes every round(1/r)-th dispatched "
        "batch through the reference on a background worker and compares "
        "outputs into mxtpu_shadow_divergence{model,metric}. A per-model "
        "stride passed to register_shadow overrides this."),
    "MXTPU_SHADOW_THRESHOLD": (
        float, 0.25,
        "Max-abs-diff breach threshold for shadow divergence: a shadow "
        "sample whose primary-vs-reference max absolute output "
        "difference exceeds this flips the served model's health to "
        "degraded (once per breach episode) and fires a shadow_breach "
        "flightrec event (telemetry/numwatch.py)."),
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
    "MXTPU_SERVE_TP": (
        int, 1,
        "Default tensor-parallel degree for serving.sharded.MeshServable "
        "when no mesh is passed: parameters annotated by "
        "parallel.tensor_parallel split over a 'tp' mesh axis of this size "
        "(the layers compute per shard and gather at their boundaries). "
        "1 = single-device predict."),
    "MXTPU_SPMD_TIMEOUT_S": (
        float, 300.0,
        "Deadline in seconds of each collective's rendezvous inside "
        "parallel.shard_map: a position whose peers do not all arrive "
        "within it raises RendezvousTimeout instead of waiting forever."),
    "MXTPU_COORD_ADDR": (
        str, None,
        "host:port of the rendezvous of several worker processes (rank "
        "0's TCP store). Set by tools/launch.py; with MXTPU_NUM_PROC > 1 "
        "importing the package starts torch.distributed "
        "(parallel.dist.init_distributed). DMLC_PS_ROOT_URI and "
        "DMLC_PS_ROOT_PORT stand in when it is unset."),
    "MXTPU_NUM_PROC": (
        int, 1,
        "Number of distributed worker processes (tools/launch.py; "
        "DMLC_NUM_WORKER stands in when it is unset)."),
    "MXTPU_PROC_ID": (
        int, 0,
        "This worker's rank in [0, MXTPU_NUM_PROC) (tools/launch.py; "
        "DMLC_RANK stands in when it is unset)."),
    "MXTPU_DIST_TIMEOUT_S": (
        float, 300.0,
        "Timeout in seconds of the torch.distributed process group: its "
        "rendezvous and every collective of the dist kvstores raise past "
        "it instead of waiting forever for a missing rank."),
    "MXTPU_ASYNC_STALENESS": (
        int, 4,
        "dist_async staleness bound: pushes per key between cross-process "
        "parameter averages (kvstore.DistAsyncKVStore, local SGD with "
        "periodic averaging)."),
    "MXTPU_KVSTORE_BIGARRAY_BOUND": (
        int, 1000000,
        "Element count at or above which a dense value pushed into a dist "
        "kvstore gets its own all-gather instead of riding its dtype's "
        "concatenated one (bounds the concatenation buffer)."),
    "MXTPU_P3_SLICE": (
        int, 1000000,
        "Slice bound in elements of dist_async's priority averaging "
        "(kvstore.DistAsyncKVStore._average_batch): no collective carries "
        "more elements than this, and high-priority keys go first."),
    "MXTPU_KVSTORE_DEBUG": (
        int, 0,
        "Verbose logging in the kvstore server role "
        "(kvstore_server.py)."),
    "MXTPU_ROLE": (
        str, "worker",
        "Process role for launch scripts that branch on it "
        "(kvstore_server._init_kvstore_server_module): 'worker' or "
        "'server'. DMLC_ROLE, when set, takes precedence."),
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
        "Per-tenant inter-token SLO threshold in ms: when set, each "
        "GenerativeEngine feeds one <model>/inter_token/<tenant> "
        "objective (telemetry/slo.py) a 200-coded outcome per token gap, "
        "judged against this latency."),
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
        "Directory of persisted programs (aot.py's artifact layer): eval "
        "and serve programs are exported once (torch.export) and written "
        "under torch-<version>/; a fresh process loads and captures them "
        "instead of running the model's Python forward. Unset: "
        "in-memory only."),
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
    "MXTPU_NO_NATIVE": (
        bool, False,
        "Disable the native C++ library even where g++ can build it "
        "(io.ImageRecordIter then runs its Python tier; native/lib.py)."),
    "MXTPU_PREDICT_LIB": (
        str, None,
        "Path of the libmxtpu_predict.so that the C++, Perl, R, Julia and "
        "Scala clients dlopen (cpp_package, the language packages). The "
        "port's is build/native/libmxtpu_predict.so (python -m "
        "incubator_mxnet_tpu_torch.native.lib builds it and prints it)."),
    "MXTPU_PYTHON": (
        str, None,
        "Interpreter the embedded C ABI boots in a process with none "
        "(native/src/c_predict_api.cc); defaults to the interpreter that "
        "built the library."),
    "MXTPU_CAPI_CONTEXT": (
        str, "gpu(0)",
        "Context every embedded C ABI call runs under (cpu, gpu or "
        "gpu(i); native/__init__.py capi_context): the port's counterpart "
        "of the JAX package's JAX_PLATFORMS pin. A loaded serving "
        "artifact computes on the device it was exported on."),
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

