"""Generative-inference serving: continuous batching over a paged KV cache
(counterpart of ``incubator_mxnet_tpu/serving/generate.py``).

One ``GenerativeEngine`` owns one model's autoregressive serving:

- **Prefill** rides the port's :class:`~.batcher.DynamicBatcher`: prompts
  are padded to the fixed ``MXTPU_GEN_PREFILL_LEN`` shape (the true length
  rides as an input) and batches to ``max_batch`` rows, so cross-request
  coalescing hits one program. The prefill returns the prompt's K/V and the first
  sampled token: TTFT is one batched dispatch.
- **Decode** is a persistent single-thread loop over the in-flight batch:
  each step embeds every live sequence's last token, appends its K/V into
  the paged pool (``ops/kvcache.py``), attends over the cache and samples
  the next token. Requests join between steps (their prefill K/V is
  written into freshly allocated blocks by the KV-join program) and leave
  the moment they retire (eos, max_tokens, disconnect, kv_oom,
  numeric_error), freeing their blocks. The loop pads the live set up to
  ``max_batch`` rows.

Programs. On the card each program (prefill, decode, KV join) is one CUDA
graph, captured in ``warm()`` through the shared ``aot`` cache (kinds
``"serve"`` and ``"decode"``) and bound to the engine's weights and pool
by address: a decode graph writes the pool in
place, the counterpart of the JAX package's donated pool. A step uploads
its block tables, lengths, tokens and sampling parameters in one packed
copy into the graph's static buffer before the replay and reads the
sampled tokens and the rows' logit health back in one copy after it.
After ``warm()`` steady-state decode captures nothing (the compile
counter and the ``gen:compile`` spans stay put). On the CPU the same
bodies run eagerly.

Batch-composition independence. The JAX package claims that a row's
tokens do not depend on who else is in the batch "on a fixed backend".
On the card cuBLAS may choose another GEMM for another row count, and a
reduction another split, so the last bit of a logit (and with it a
token) could move with the bucket. So every program computes at one row
count, ``max_batch``, and the JAX package's ladder of decode buckets
collapses to that one bucket: the host pads a step's rows to it (padding
rows inactive, writing only the pool's private block) and reads back the
live rows. Every step then runs the same kernels on the same shapes, and
a sequence decoded among strangers emits exactly ``generate_sequential``'s
tokens. The price is that a step with few live rows does ``max_batch``
rows of work (PERF.md measures it).

Sampling. The JAX sampler keys on ``fold_in(PRNGKey(seed), n_generated)``
inside the program; no torch generator reproduces those bits, and a
generator's state cannot be read inside a capture. The port draws with a
counter-based hash of (seed, n_generated, vocabulary index) in integer
tensor ops and takes a Gumbel-max over the top-k-masked, temperature
scaled logits: capture-safe and independent of the batch. Greedy tokens
(temperature <= 0) are the JAX package's argmax; sampled tokens follow
the same distribution through another stream (ROADMAP §3, departures).

The model served is ``TinyLM``, the JAX package's only generator: a
two-layer pre-norm transformer (tied embeddings, paramless RMSNorm, no
positional encoding) whose weights are drawn from a seed. It is small on
purpose: what is measured is the serving machinery (paging, batching,
capture-free steady state, streaming), not the language model.
``convert.tinylm_from_jax`` builds it from the JAX package's ``TinyLM``.

Telemetry, as in the JAX package: ``gen:prefill`` / ``gen:decode_step``
spans, ``mxtpu_gen_tokens_total{model,tenant,phase}``,
``mxtpu_gen_inflight_seqs``, ``mxtpu_gen_kv_blocks_{used,total}``, the
``mxtpu_gen_inter_token_ms`` histogram, flight-recorder join/retire
events, a ``genloop:<name>`` watchdog channel, the ``generate.step``
faultlab site, the numerics sentinel's ``gen:logits`` note (the step's
fused per-row finiteness over live rows) and, when
``MXTPU_GEN_SLO_INTER_TOKEN_MS`` is set, one per-tenant
``<model>/inter_token/<tenant>`` SLO fed a 200-coded outcome per token
gap (``telemetry.slo``).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque

import numpy as onp
import torch

from .. import aot, config
from .. import jit as jit_mod
from .. import telemetry
from ..ops import kvcache
from ..telemetry import (devstats, faultlab, flightrec, numwatch, spans,
                         watchdog)
from ..telemetry import slo as slo_mod
from . import accesslog
from .batcher import DynamicBatcher, QueueFullError, ServingClosedError, \
    default_buckets  # noqa: F401 — a name of the JAX module's namespace

__all__ = ["GenerativeEngine", "GenStream", "BadGenRequest", "TinyLM",
           "EOS_TOKEN", "QueueFullError", "ServingClosedError"]

_LOG = logging.getLogger(__name__)

#: Retiring token id: a sampled 0 ends the sequence (reason "eos").
EOS_TOKEN = 0

_FINISH_REASONS = ("eos", "max_tokens", "disconnect", "kv_oom", "error",
                   "numeric_error", "engine_restart")

_TOKENS = telemetry.counter(
    "mxtpu_gen_tokens_total",
    "Tokens through the generative engine: phase=prefill counts prompt "
    "tokens ingested, phase=decode counts tokens GENERATED (the goodput "
    "numerator loadgen --generate reports).",
    ("model", "tenant", "phase"))
_INFLIGHT = telemetry.gauge(
    "mxtpu_gen_inflight_seqs",
    "Sequences currently owned by the engine: decoding in the in-flight "
    "batch plus admitted-but-waiting joins.", ("model",))
_KV_USED = telemetry.gauge(
    "mxtpu_gen_kv_blocks_used",
    "KV pool blocks held by live sequences.", ("model",))
_KV_TOTAL = telemetry.gauge(
    "mxtpu_gen_kv_blocks_total",
    "KV pool capacity in blocks (MXTPU_GEN_KV_BLOCKS).", ("model",))
_INTER_TOKEN_MS = telemetry.histogram(
    "mxtpu_gen_inter_token_ms",
    "Gap between consecutive streamed tokens of one sequence, measured "
    "at engine emit (excludes HTTP write). The p99 here is what the "
    "per-tenant inter_token SLO objectives budget.",
    buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500),
    labelnames=("model",))

# the packed decode input: per row the block table, then these columns
_LEN, _LAST, _SEED, _NGEN, _TEMP, _TOPK, _ACTIVE = range(7)

_MASK32 = 0xFFFFFFFF


class BadGenRequest(ValueError):
    """Client-malformed generate request (HTTP 400): bad token ids,
    empty/oversized prompt, max_new_tokens out of range."""


def _mix32(x):
    """A 32-bit integer hash (int64 tensors in [0, 2^32)): every product
    stays below 2^59, so nothing overflows."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def gumbel_noise(seeds, n_generated, vocab):
    """(B, vocab) float32 Gumbel noise, a pure function of (seed,
    n_generated, vocabulary index) per row: hashed to 24 uniform bits,
    u = (bits + 0.5) / 2^24 in (0, 1), g = -log(-log(u))."""
    h = _mix32(seeds.long() & _MASK32)
    h = _mix32(h ^ (n_generated.long() & _MASK32))
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _mix32(h[:, None] ^ v[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


# ------------------------------------------------------------------ TinyLM
class TinyLM:
    """Two-layer pre-norm transformer, 256-token byte vocabulary, tied
    embeddings, no positional encoding, at the JAX package's widths. The
    weights are drawn with an explicit ``torch.Generator`` seeded with
    ``seed`` (not the JAX package's draws: ``convert.tinylm_from_jax``
    carries those over), or given as ``weights`` ({"emb": (V, d),
    "layers": [{"wq", "wk", "wv", "wo", "w1", "w2"}, ...]} of arrays).
    ``ctx`` is the device (default: the current context, ``gpu(0)``)."""

    VOCAB = 256
    D_MODEL = 64
    LAYERS = 2
    HEADS = 2
    HEAD_DIM = 32

    def __init__(self, seed=0, ctx=None, weights=None):
        from ..context import current_context
        self.seed = int(seed)
        self.device = (ctx if ctx is not None
                       else current_context()).torch_device
        d, h, hd = self.D_MODEL, self.HEADS, self.HEAD_DIM
        if weights is None:
            g = torch.Generator().manual_seed(self.seed)

            def draw(shape):
                return torch.randn(shape, generator=g) * 0.02
            weights = {"emb": draw((self.VOCAB, d)), "layers": [
                {"wq": draw((d, h * hd)), "wk": draw((d, h * hd)),
                 "wv": draw((d, h * hd)), "wo": draw((h * hd, d)),
                 "w1": draw((d, 4 * d)), "w2": draw((4 * d, d))}
                for _ in range(self.LAYERS)]}

        def on(a):
            return torch.as_tensor(onp.array(a, onp.float32)
                                   if not isinstance(a, torch.Tensor) else a,
                                   dtype=torch.float32,
                                   device=self.device).contiguous()
        self.emb = on(weights["emb"])
        self.layers = [{k: on(v) for k, v in layer.items()}
                       for layer in weights["layers"]]

    def model_id(self):
        """Stable digest (aot.CacheKey model_id): seed + architecture."""
        return "tinylm-s%d-v%d-d%d-l%d-h%dx%d" % (
            self.seed, self.VOCAB, self.D_MODEL, self.LAYERS, self.HEADS,
            self.HEAD_DIM)

    def tensors(self):
        """Every weight tensor (a captured program reads them by address)."""
        return [self.emb] + [layer[k] for layer in self.layers
                             for k in sorted(layer)]

    def swap_tensors(self, tensors):
        """Point the weights at ``tensors`` (``tensors()`` order) and return
        the ones they replace: an export reads traced weights."""
        old = self.tensors()
        it = iter(tensors)
        self.emb = next(it)
        for layer in self.layers:
            for k in sorted(layer):
                layer[k] = next(it)
        return old

    # -------------------------------------------------------- pure pieces
    @staticmethod
    def _rms(x):
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x / torch.sqrt(ms + 1e-6)

    def _mlp(self, layer, x):
        return torch.clamp(self._rms(x) @ layer["w1"], min=0.0) @ layer["w2"]

    def _sample(self, logits, seeds, n_generated, temperatures, top_ks):
        """Greedy (argmax) where temperature <= 0; else a Gumbel-max draw
        over the temperature-scaled logits restricted to the top_k ranked
        ones (top_k <= 0: the whole vocabulary), rank masking as the JAX
        package's (argsort of argsort, stable)."""
        greedy = torch.argmax(logits, dim=-1)
        scaled = (logits / torch.clamp(temperatures, min=1e-6)[:, None]
                  ).float()
        k_eff = torch.where(top_ks > 0, top_ks, logits.shape[-1])
        rank = torch.argsort(torch.argsort(-scaled, dim=-1, stable=True),
                             dim=-1, stable=True)
        masked = torch.where(rank < k_eff[:, None], scaled, float("-inf"))
        sampled = torch.argmax(
            masked + gumbel_noise(seeds, n_generated, logits.shape[-1]),
            dim=-1)
        return torch.where(temperatures <= 0.0, greedy, sampled).int()

    def prefill(self, tokens, lengths, seeds, temperatures, top_ks):
        """Every row's prompt pass: causal self-attention over the padded
        prompt -> (k_all, v_all), each (B, L, layers, heads, head_dim),
        and the first generated token (drawn with n_generated 0)."""
        B, L = tokens.shape
        h, hd = self.HEADS, self.HEAD_DIM
        x = self.emb[tokens.long().clamp(0, self.VOCAB - 1)]   # (B, L, d)
        pos = torch.arange(L, device=tokens.device)
        causal = pos[None, :] <= pos[:, None]                  # (Lq, Lk)
        scale = float(onp.float32(1.0) / onp.sqrt(onp.float32(hd)))
        ks, vs = [], []
        for layer in self.layers:
            hn = self._rms(x)
            q = (hn @ layer["wq"]).reshape(B, L, h, hd)
            k = (hn @ layer["wk"]).reshape(B, L, h, hd)
            v = (hn @ layer["wv"]).reshape(B, L, h, hd)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            s = torch.where(causal[None, None], s, float("-inf"))
            p = torch.softmax(s, dim=-1).to(v.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, L, h * hd)
            x = x + o @ layer["wo"]
            x = x + self._mlp(layer, x)
            ks.append(k)
            vs.append(v)
        k_all = torch.stack(ks, dim=2)                # (B, L, layers, h, hd)
        v_all = torch.stack(vs, dim=2)
        rows = torch.arange(B, device=tokens.device)
        x_last = x[rows, (lengths.long() - 1).clamp(0, L - 1)]
        logits = x_last @ self.emb.T
        first = self._sample(logits, seeds, torch.zeros_like(seeds),
                             temperatures, top_ks)
        return k_all, v_all, first

    def prefill_one(self, tokens, length, seed, temperature, top_k):
        """One row's prompt pass (the JAX package's per-row form):
        ``prefill`` of a batch of one -> (k_all (L, layers, heads,
        head_dim), v_all, first token)."""
        def row(x, dtype):
            return torch.as_tensor(x, dtype=dtype,
                                   device=self.device).reshape(1, -1)
        k_all, v_all, first = self.prefill(
            row(tokens, torch.int32), row(length, torch.int32)[:, 0],
            row(seed, torch.int32)[:, 0],
            row(temperature, torch.float32)[:, 0],
            row(top_k, torch.int32)[:, 0])
        return k_all[0], v_all[0], first[0]

    def decode_step(self, pool, block_tables, lengths, last_tokens, seeds,
                    n_generated, temperatures, top_ks, active):
        """One continuous-batching step over the whole batch: append every
        row's last-token K/V at its own position (in place in ``pool``),
        attend over its own cache prefix, sample its next token with its
        own (seed, n_generated). Returns (next tokens, row_finite): a row
        with a non-finite logit is retired by the engine."""
        B = last_tokens.shape[0]
        h, hd = self.HEADS, self.HEAD_DIM
        x = self.emb[last_tokens.long().clamp(0, self.VOCAB - 1)]  # (B, d)
        for li, layer in enumerate(self.layers):
            hn = self._rms(x)
            q = (hn @ layer["wq"]).reshape(B, h, hd)
            k = (hn @ layer["wk"]).reshape(B, h, hd)
            v = (hn @ layer["wv"]).reshape(B, h, hd)
            kvcache.append_token(pool, block_tables, lengths, li, k, v,
                                 active=active)
            keys, vals = kvcache.gather_layer(pool, block_tables, li)
            o = kvcache.paged_attention(q, keys, vals,
                                        torch.clamp(lengths + 1, min=1))
            x = x + o.reshape(B, h * hd) @ layer["wo"]
            x = x + self._mlp(layer, x)
        logits = x @ self.emb.T                       # (B, V)
        next_t = self._sample(logits, seeds, n_generated, temperatures,
                              top_ks)
        return next_t, torch.all(torch.isfinite(logits), dim=-1)


# ------------------------------------------------------------- stream handle
class GenStream:
    """The streaming handle one submit() returns: a queue of ``("tok",
    id)`` events terminated by one ``("end", reason)``. A consumer that
    dies calls ``cancel()`` and the decode loop retires the row at its
    next step (reason "disconnect")."""

    def __init__(self, request_id, tenant, maxsize=0):
        self.request_id = request_id
        self.tenant = tenant
        self.finish_reason = None
        self._q = _queue.Queue(maxsize=maxsize)
        self._cancel = threading.Event()

    @property
    def cancelled(self):
        return self._cancel.is_set()

    def cancel(self):
        """Client-gone signal: the engine frees the row's KV blocks at the
        next decode step. Idempotent; safe from any thread."""
        self._cancel.set()

    def get(self, timeout=None):
        """Next event, ('tok', id) or ('end', reason); raises queue.Empty
        on timeout."""
        return self._q.get(timeout=timeout)

    def __iter__(self):
        """Token ids until the terminal event."""
        while True:
            kind, val = self.get(timeout=600.0)
            if kind == "end":
                self.finish_reason = val
                return
            yield val

    def tokens(self, timeout=600.0):
        """Drain to completion -> (token list, finish reason)."""
        out = []
        deadline = time.monotonic() + timeout
        while True:
            kind, val = self.get(timeout=max(0.0, deadline -
                                             time.monotonic()))
            if kind == "end":
                self.finish_reason = val
                return out, val
            out.append(val)

    # engine side
    def _emit(self, tok):
        self._q.put(("tok", int(tok)))

    def _end(self, reason):
        self.finish_reason = reason
        self._q.put(("end", reason))


class _Seq:
    """Decode-loop state of one admitted sequence."""

    __slots__ = ("stream", "request_id", "tenant", "seed", "temperature",
                 "top_k", "max_new", "length", "last_token", "n_generated",
                 "blocks", "table", "k_all", "v_all", "t_last", "slo_name")

    def __init__(self, stream, k_all, v_all, length, first_token, seed,
                 temperature, top_k, max_new):
        self.stream = stream
        self.request_id = stream.request_id
        self.tenant = stream.tenant
        self.k_all = k_all          # (PREFILL_LEN, layers, h, hd), numpy
        self.v_all = v_all
        self.slo_name = None        # the tenant's inter_token SLO, if any
        self.length = int(length)   # K/V entries in cache once joined
        self.last_token = int(first_token)
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.max_new = int(max_new)
        self.n_generated = 1        # the prefill-sampled first token
        self.blocks = None
        self.table = None
        self.t_last = time.monotonic()


class _Program:
    """One fixed-shape program of the engine: on the card a captured CUDA
    graph (``jit._Captured``), on the CPU its body run eagerly. Calls
    take host arrays and return the outputs on the host."""

    def __init__(self, body, device, captured=None):
        self.body = body
        self.device = device
        self.captured = captured

    def __call__(self, *args):
        args = [torch.as_tensor(a) for a in args]
        if self.captured is None:
            with torch.no_grad():
                out = self.body(*[a.to(self.device) for a in args])
            return [o.cpu().numpy() for o in out]
        cap = self.captured
        with cap.lock:
            cap.replay(args)
            # copies: the static outputs are overwritten by the next replay
            return [o.to("cpu", copy=True).numpy() for o in cap.out]


# ------------------------------------------------------------------- engine
class GenerativeEngine:
    """Continuous-batching generative server for one model.

    Lifecycle: construct (``warm()`` captures every program) ->
    ``submit()`` per request -> ``close()``. The decode loop thread starts
    at construction and idles at ``MXTPU_GEN_STEP_IDLE_MS`` granularity
    when no sequence is live. ``ctx`` places a model built here (default:
    the current context, ``gpu(0)``)."""

    def __init__(self, name="tinylm", model=None, seed=0, block_size=None,
                 num_blocks=None, max_batch=None, prefill_len=None,
                 max_tokens=None, prewarm=None, eos_token=EOS_TOKEN,
                 batch_timeout_ms=None, ctx=None):
        self._slo_ms = config.get_env("MXTPU_GEN_SLO_INTER_TOKEN_MS")
        self.name = name
        self.model = model if model is not None else TinyLM(seed, ctx=ctx)
        self.device = self.model.device
        self.eos_token = int(eos_token)
        self.block_size = int(block_size if block_size is not None
                              else config.get_env("MXTPU_GEN_BLOCK_SIZE"))
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else config.get_env("MXTPU_GEN_KV_BLOCKS"))
        self.max_batch = int(max_batch if max_batch is not None
                             else config.get_env("MXTPU_GEN_MAX_BATCH"))
        self.prefill_len = int(prefill_len if prefill_len is not None
                               else config.get_env("MXTPU_GEN_PREFILL_LEN"))
        self.max_tokens = int(max_tokens if max_tokens is not None
                              else config.get_env("MXTPU_GEN_MAX_TOKENS"))
        self.step_idle_s = float(
            config.get_env("MXTPU_GEN_STEP_IDLE_MS")) / 1000.0
        if prewarm is None:
            prewarm = bool(config.get_env("MXTPU_GEN_PREWARM"))
        # longest cache a sequence can need: full prompt + every generated
        # token but the last (whose K/V is never appended)
        self.max_blocks = kvcache.blocks_for(
            self.prefill_len + self.max_tokens, self.block_size)
        if self.max_blocks > self.num_blocks:
            raise ValueError(
                "one max-length sequence needs %d KV blocks but the pool "
                "holds %d — raise MXTPU_GEN_KV_BLOCKS or shrink "
                "MXTPU_GEN_PREFILL_LEN/MXTPU_GEN_MAX_TOKENS"
                % (self.max_blocks, self.num_blocks))
        # one decode bucket: every step runs at max_batch rows (see the
        # module's docstring)
        self.decode_buckets = [self.max_batch]
        self._model_id = self.model.model_id()
        m = self.model
        self._alloc = kvcache.BlockAllocator(self.num_blocks)
        self._pool = kvcache.make_pool(
            self.num_blocks, self.block_size, m.LAYERS, m.HEADS, m.HEAD_DIM,
            device=self.device)
        # generate_sequential's private pool, with programs of its own
        self._seq_pool = kvcache.make_pool(
            self.num_blocks, self.block_size, m.LAYERS, m.HEADS, m.HEAD_DIM,
            device=self.device)
        self._seq_lock = threading.Lock()
        # (tag, pool) -> program; misses build through the aot cache, so
        # post-warm lookups never capture
        self._fn_lock = threading.Lock()
        self._programs = {}
        self._owner = object()      # the engine's token as a cache holder
        self._keys = []             # aot cache keys of its programs
        # decode-loop state: _active is owned by the loop thread; _pending
        # and the wake condition are the submit->loop handoff
        self._active = []
        self._pend_lock = threading.Lock()
        self._pending = deque()
        self._pending_cap = max(16, 4 * self.max_batch)
        self._wake = threading.Condition(self._pend_lock)
        self._closed = False
        # resilience: _supervised flips the loop's death path from
        # retire-everything to preserve-for-resurrect; _pool_hazard is True
        # exactly while a decode or join call updates the pool — a loop
        # that dies inside that window lost every active row's KV
        self._supervised = False
        self._pool_hazard = False
        self._inflight_fn = lambda: self._inflight_count()
        self._kv_used_fn = lambda: self._alloc.used
        self._kv_total_fn = lambda: self._alloc.total
        try:
            _INFLIGHT.set_function(self._inflight_fn, model=self.name)
            _KV_USED.set_function(self._kv_used_fn, model=self.name)
            _KV_TOTAL.set_function(self._kv_total_fn, model=self.name)
        except Exception:
            _LOG.debug("gen gauge binding failed", exc_info=True)
        self._prefill = DynamicBatcher(
            self._prefill_dispatch, max_batch_size=self.max_batch,
            buckets=[self.max_batch], batch_timeout_ms=batch_timeout_ms,
            name="%s-prefill" % self.name, replicas=1)
        try:
            if prewarm:
                self.warm()
        except BaseException:
            self._prefill.close(drain=False)
            raise
        self._hb = watchdog.register("genloop:%s" % self.name)
        self._thread = threading.Thread(target=self._decode_loop,
                                        daemon=True,
                                        name="mxtpu-gen-%s" % self.name)
        self._thread.start()

    # ------------------------------------------------------------ programs
    def _prefill_body(self, tokens, lengths, seeds, temps, top_ks):
        return list(self.model.prefill(tokens, lengths, seeds, temps,
                                       top_ks))

    def _decode_body(self, pool, packed):
        """One decode step on ``pool`` from the packed (max_batch,
        max_blocks + 7) int32 input: the block table, then length, last
        token, seed, n_generated, temperature (float32 bits), top_k and
        active. Returns one (2, max_batch) int32 tensor: the next tokens
        and row_finite."""
        mb = self.max_blocks
        col = packed[:, mb:]
        next_t, finite = self.model.decode_step(
            pool, packed[:, :mb], col[:, _LEN], col[:, _LAST], col[:, _SEED],
            col[:, _NGEN], col[:, _TEMP].view(torch.float32),
            col[:, _TOPK], col[:, _ACTIVE] != 0)
        return [torch.stack([next_t, finite.int()])]

    def _join_body(self, pool, table, k_all, v_all, length):
        kvcache.write_seq(pool, table, k_all, v_all, length)
        return []

    def _program(self, tag, body, example, kind, pool=None):
        """The engine's program ``tag``: built once (captured on the card
        through the aot cache, counted on the compile counter with a
        ``gen:compile`` span) and kept in the engine's table. With
        ``MXTPU_AOT_CACHE_DIR`` set, the prefill and decode programs are
        exported (weights and, for decode, the KV pool as inputs) and
        persisted; a persisted one is loaded and captured over this
        engine's weights and pool instead of tracing the model."""
        slot = (tag, None if pool is None else pool.data_ptr())
        with self._fn_lock:
            prog = self._programs.get(slot)
        if prog is not None:
            return prog
        fn = body if pool is None else (lambda *a: body(pool, *a))
        if not jit_mod._uses_graphs(self.device):
            prog = _Program(fn, self.device)
        else:
            args = [torch.as_tensor(a).to(self.device) for a in example]
            weights = self.model.tensors()
            bound = tuple(t.data_ptr() for t in weights)
            key = aot.cache_key(
                self._model_id, aot.input_signature(args), kind=kind,
                extra=(tag, str(self.device), aot.Bound(bound + slot[1:])))
            full = None if pool is None else kvcache._with_private_block(pool)
            held = weights + ([full] if full is not None else [])
            lead = held                   # a program's first inputs

            def capture(run):
                t0 = time.monotonic()
                captured, _out = jit_mod._capture(run, args, kind,
                                                  tensors=held)
                jit_mod._record_compile_span("gen:compile",
                                             time.monotonic() - t0)
                return captured

            def from_program(program):
                module = program.module()
                return capture(lambda *a: list(module(*lead, *a))), None

            def build():
                if not persist:
                    return capture(fn), None, None
                with spans.span("gen:export", tag=tag):
                    program = self._export(tag, body, lead, args, pool)
                return from_program(program)[0], None, program
            persist = tag in ("prefill", "decode") and \
                aot.artifact_path(key) is not None
            entry = aot.compile_cached(key, build, exportable=persist,
                                       owner=self._owner,
                                       from_program=from_program)
            self._keys.append(key)
            prog = _Program(fn, self.device, captured=entry.fn)
        with self._fn_lock:
            self._programs.setdefault(slot, prog)
            return self._programs[slot]

    def _export(self, tag, body, lead, args, pool):
        """``torch.export`` of program ``tag`` with the model's weights
        (``model.tensors()`` order) and, for decode, the pool with its
        private block as its first inputs."""
        model, n_w = self.model, len(self.model.tensors())
        n_blocks = None if pool is None else pool.shape[0]

        class _GenProgram(torch.nn.Module):
            def forward(self, *flat):
                weights, rest = flat[:n_w], flat[n_w:]
                saved = model.swap_tensors(weights)
                try:
                    if n_blocks is None:
                        return list(body(*rest))
                    return list(body(rest[0][:n_blocks], *rest[1:]))
                finally:
                    model.swap_tensors(saved)
        with jit_mod._EXPORT_LOCK, torch.no_grad():
            return torch.export.export(_GenProgram(), tuple(lead) + tuple(args),
                                       strict=False)

    def _prefill_rows(self, rows):
        """The prefill program's inputs for ``rows`` ((prompt, seed,
        temperature, top_k) each), padded to ``max_batch`` rows."""
        n, L = self.max_batch, self.prefill_len
        tokens = onp.zeros((n, L), onp.int32)
        lengths = onp.ones(n, onp.int32)
        seeds, temps = onp.zeros(n, onp.int32), onp.zeros(n, onp.float32)
        top_ks = onp.zeros(n, onp.int32)
        for i, (prompt, seed, temperature, top_k) in enumerate(rows):
            tokens[i, :len(prompt)] = prompt
            lengths[i] = len(prompt)
            seeds[i], temps[i], top_ks[i] = seed, temperature, top_k
        return tokens, lengths, seeds, temps, top_ks

    def _prefill_fn(self):
        return self._program("prefill", self._prefill_body,
                             self._prefill_rows([]), "serve")

    def _packed(self, rows):
        """The packed decode input of ``rows`` (dicts) padded to
        ``max_batch`` rows: inactive padding with tables at the private
        block."""
        mb = self.max_blocks
        packed = onp.zeros((self.max_batch, mb + 7), onp.int32)
        packed[:, :mb] = self.num_blocks
        packed[:, mb + _LEN] = 1
        for i, r in enumerate(rows):
            packed[i, :mb] = r["table"]
            packed[i, mb + _LEN] = r["length"]
            packed[i, mb + _LAST] = r["last"]
            packed[i, mb + _SEED] = r["seed"]
            packed[i, mb + _NGEN] = r["n_generated"]
            packed[i, mb + _TEMP] = onp.float32(
                r["temperature"]).view(onp.int32)
            packed[i, mb + _TOPK] = r["top_k"]
            packed[i, mb + _ACTIVE] = 1
        return packed

    def _decode_fn(self, pool=None):
        pool = self._pool if pool is None else pool
        return self._program("decode", self._decode_body,
                             (self._packed([]),), "decode", pool=pool)

    def _write_fn(self, pool=None):
        pool = self._pool if pool is None else pool
        m = self.model
        kv = onp.zeros((self.prefill_len, m.LAYERS, m.HEADS, m.HEAD_DIM),
                       onp.float32)
        example = (onp.full(self.max_blocks, self.num_blocks, onp.int32),
                   kv, kv, onp.int32(0))
        return self._program("kvjoin", self._join_body, example, "decode",
                             pool=pool)

    def warm(self):
        """Build every fixed-shape program: the prefill, the decode step
        and the KV join on the engine's pool, and ``generate_sequential``'s
        decode and join on its private pool. On the card each build is
        one capture, so decode captures nothing afterwards. (The JAX
        package also lints the fresh decode artifacts here; the port has
        no artifacts and no hlolint.)"""
        t0 = time.monotonic()
        with spans.span("aot:warm", model=self.name, what="gen-prefill",
                        bucket=self.max_batch):
            self._prefill_fn()
        with spans.span("aot:warm", model=self.name, what="gen-decode",
                        bucket=self.max_batch):
            self._decode_fn()
        with spans.span("aot:warm", model=self.name, what="gen-kvjoin"):
            self._write_fn()
        with spans.span("aot:warm", model=self.name,
                        what="gen-sequential"):
            self._decode_fn(self._seq_pool)
            self._write_fn(self._seq_pool)
        flightrec.record("gen_warm", model=self.name,
                         prefill_buckets=len(self._prefill.buckets),
                         decode_buckets=len(self.decode_buckets),
                         dur_ms=round((time.monotonic() - t0) * 1e3, 1))

    # -------------------------------------------------------------- metrics
    def _inflight_count(self):
        with self._pend_lock:
            pend = len(self._pending)
        return len(self._active) + pend

    def kv_blocks(self):
        """(used, total) — test/debug hook mirroring the gauges."""
        return self._alloc.used, self._alloc.total

    # --------------------------------------------------------------- submit
    def _validate(self, prompt, max_new_tokens, temperature, top_k, seed):
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            raise BadGenRequest("prompt must be a list of token ids")
        if not prompt:
            raise BadGenRequest("prompt must not be empty")
        if len(prompt) > self.prefill_len:
            raise BadGenRequest(
                "prompt length %d exceeds MXTPU_GEN_PREFILL_LEN=%d"
                % (len(prompt), self.prefill_len))
        if any(t < 0 or t >= self.model.VOCAB for t in prompt):
            raise BadGenRequest("token ids must be in [0, %d)"
                                % self.model.VOCAB)
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.max_tokens)
        if not 1 <= max_new <= self.max_tokens:
            raise BadGenRequest(
                "max_new_tokens must be in [1, %d] (MXTPU_GEN_MAX_TOKENS)"
                % self.max_tokens)
        try:
            temperature = float(temperature)
            top_k = int(top_k)
            # seeds ride as int32 program inputs
            seed = int(seed) & 0x7FFFFFFF
        except (TypeError, ValueError):
            raise BadGenRequest(
                "temperature/top_k/seed must be numeric")
        return prompt, max_new, temperature, top_k, seed

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               top_k=0, seed=0, tenant=None, request_id=None,
               deadline_ms=None):
        """Prefill now (batched, synchronous: the returned stream already
        holds the first token), then hand the sequence to the decode
        loop. Raises BadGenRequest (400), QueueFullError (429),
        ServingClosedError (503); batcher deadline errors propagate
        (504)."""
        if self._closed:
            raise ServingClosedError("engine %r is shut down" % self.name)
        prompt, max_new, temperature, top_k, seed = self._validate(
            prompt, max_new_tokens, temperature, top_k, seed)
        tenant = accesslog.clamp_tenant(tenant)
        slo_name = None
        if self._slo_ms is not None:
            slo_name = "%s/inter_token/%s" % (self.name, tenant)
            try:
                slo_mod.REGISTRY.define(slo_name, self.name,
                                        kind="inter_token",
                                        latency_ms=self._slo_ms)
            except Exception:
                _LOG.debug("inter_token SLO define failed", exc_info=True)
                slo_name = None
        with self._pend_lock:
            backlog = len(self._pending)
        if backlog >= self._pending_cap:
            raise QueueFullError(
                "engine %r: %d sequences awaiting decode admission "
                "(cap %d) — the KV pool or decode batch is saturated"
                % (self.name, backlog, self._pending_cap))
        P = len(prompt)
        padded = onp.zeros(self.prefill_len, onp.int32)
        padded[:P] = prompt
        with spans.span("gen:prefill", model=self.name,
                        request_id=request_id, tenant=tenant,
                        prompt_len=P):
            req = self._prefill.submit(
                padded, onp.int32(P), onp.int32(seed),
                onp.float32(temperature), onp.int32(top_k),
                deadline_ms=deadline_ms, request_id=request_id,
                tenant=tenant)
            k_all, v_all, first = req.result(
                self._prefill.result_timeout(req))
        first = int(first)
        stream = GenStream(request_id, tenant)
        try:
            _TOKENS.inc(P, model=self.name, tenant=tenant, phase="prefill")
        except Exception:
            pass
        seq = _Seq(stream, k_all, v_all, P, first, seed, temperature,
                   top_k, max_new)
        seq.slo_name = slo_name
        self._emit_token(seq, first, first_token=True)
        if first == self.eos_token:
            stream._end("eos")
            return stream
        if max_new <= 1:
            stream._end("max_tokens")
            return stream
        with self._wake:
            if self._closed:
                stream._end("error")
                raise ServingClosedError("engine %r is shut down"
                                         % self.name)
            self._pending.append(seq)
            self._wake.notify()
        return stream

    def _emit_token(self, seq, tok, first_token=False):
        """Account then deliver. The first token's delay is TTFT, not an
        inter-token gap: it counts on the token counter only."""
        now = time.monotonic()
        gap_ms = (now - seq.t_last) * 1e3
        seq.t_last = now
        try:
            _TOKENS.inc(model=self.name, tenant=seq.tenant, phase="decode")
            if not first_token:
                _INTER_TOKEN_MS.observe(gap_ms, model=self.name)
        except Exception:
            _LOG.debug("gen token metrics failed", exc_info=True)
        if seq.slo_name is not None and not first_token:
            try:
                slo_mod.REGISTRY.observe_named(seq.slo_name, 200,
                                               latency_ms=gap_ms)
            except Exception:
                _LOG.debug("inter_token SLO observe failed", exc_info=True)
        seq.stream._emit(tok)

    # ---------------------------------------------------------- decode loop
    def _admit(self):
        """Move pending sequences into the in-flight batch: allocate their
        block tables and write their prefill K/V into the pool (the join
        program). A pool too full for the head sequence leaves the queue
        intact while anything decodes (retirements free blocks); with
        nothing decoding the sequence can never fit, and retires kv_oom."""
        while len(self._active) < self.max_batch:
            with self._wake:
                if not self._pending:
                    return
                seq = self._pending[0]
                if seq.stream.cancelled:
                    self._pending.popleft()
                    seq.stream._end("disconnect")
                    continue
                need = kvcache.blocks_for(seq.length + seq.max_new - 1,
                                          self.block_size)
                try:
                    blocks = self._alloc.alloc(need)
                except kvcache.KVCacheOOM:
                    if self._active:
                        return
                    self._pending.popleft()
                    flightrec.record("gen_kv_oom", model=self.name,
                                     request_id=seq.request_id, need=need)
                    seq.stream._end("kv_oom")
                    continue
                self._pending.popleft()
            seq.blocks = blocks
            table = onp.full(self.max_blocks, self.num_blocks, onp.int32)
            table[:len(blocks)] = blocks
            seq.table = table
            # adopt into _active before the join: a loop death inside the
            # write window must find this sequence (resurrect() retires it)
            self._active.append(seq)
            # resurrect() reads this flag only after the loop thread is
            # seen dead (the happens-before edge)
            self._pool_hazard = True
            self._write_fn()(table, seq.k_all, seq.v_all,
                             onp.int32(seq.length))
            self._pool_hazard = False
            seq.k_all = seq.v_all = None
            flightrec.record("gen_join", model=self.name,
                             request_id=seq.request_id, blocks=len(blocks),
                             batch=len(self._active))

    def _retire(self, seq, reason):
        self._active.remove(seq)
        if seq.blocks:
            self._alloc.free(seq.blocks)
            seq.blocks = None
        seq.stream._end(reason)
        flightrec.record("gen_retire", model=self.name,
                         request_id=seq.request_id, reason=reason,
                         generated=seq.n_generated)

    @staticmethod
    def _row(s):
        return {"table": s.table, "length": s.length, "last": s.last_token,
                "seed": s.seed, "n_generated": s.n_generated,
                "temperature": s.temperature, "top_k": s.top_k}

    def _step(self):
        if faultlab.armed:
            # faultlab site "generate.step": fires before the decode call,
            # so an injected loop death leaves the pool (and every
            # survivor's KV) intact for a bit-exact resurrection
            faultlab.fire("generate.step", model=self.name,
                          batch=len(self._active))
        act = list(self._active)
        packed = self._packed([self._row(s) for s in act])
        fn = self._decode_fn()
        with spans.span("gen:decode_step", model=self.name, batch=len(act),
                        bucket=self.max_batch,
                        request_ids=[s.request_id for s in act
                                     if s.request_id is not None]):
            self._pool_hazard = True
            (out,) = fn(packed)
            self._pool_hazard = False
        next_t, finite = out[0], out[1]
        # the sentinel's finite fraction over the live rows (padding rows
        # must not dilute it); note() never raises
        if act:
            numwatch.note(self.name, "gen:logits",
                          float(onp.mean(finite[:len(act)] != 0)))
        for i, s in enumerate(act):
            tok = int(next_t[i])
            s.length += 1
            s.last_token = tok
            s.n_generated += 1
            if s.stream.cancelled:
                self._retire(s, "disconnect")
                continue
            if not bool(finite[i]):
                # non-finite decode logits: the sampled token is garbage
                self._retire(s, "numeric_error")
                continue
            self._emit_token(s, tok)
            if tok == self.eos_token:
                self._retire(s, "eos")
            elif s.n_generated >= s.max_new:
                self._retire(s, "max_tokens")

    def _decode_loop(self):
        try:
            while True:
                watchdog.heartbeat(self._hb)
                with devstats.LAUNCH_GATE.shared():
                    self._admit()
                    stepped = bool(self._active)
                    if stepped:
                        self._step()
                if stepped:
                    continue
                with self._wake:
                    if self._closed and not self._pending:
                        return
                    if not self._pending:
                        self._wake.wait(max(self.step_idle_s, 0.001)
                                        if not self._closed else 0.01)
        except BaseException as e:
            _LOG.error("gen decode loop for %r died", self.name,
                       exc_info=True)
            if self._supervised and not self._closed:
                # a supervisor owns this corpse: preserve _active and
                # _pending for resurrect()
                flightrec.record("genloop_died", model=self.name,
                                 active=len(self._active),
                                 pending=len(self._pending),
                                 pool_hazard=self._pool_hazard)
            else:
                for s in list(self._active):
                    try:
                        self._retire(s, "error")
                    except Exception:
                        _LOG.error(
                            "retiring %r after decode-loop death failed",
                            s.request_id, exc_info=True)
                with self._wake:
                    pend, self._pending = list(self._pending), deque()
                for s in pend:
                    s.stream._end("error")
            if not isinstance(e, Exception):
                raise
        finally:
            watchdog.unregister(self._hb)

    # ------------------------------------------------------------ resilience
    def set_supervised(self, flag=True):
        """With a supervisor attached, a dying decode loop preserves its
        sequences for :meth:`resurrect` instead of ending every stream as
        "error"."""
        self._supervised = bool(flag)

    def resurrect(self):
        """Rebuild a dead decode loop (the supervisor's repair verb).
        Sequences still in ``_active``/``_pending`` continue bit-exactly
        from their KV state; rows whose KV went down with a pool caught
        mid-update (``_pool_hazard``) retire now as "engine_restart", and
        the pool is zeroed in place (its graphs stay bound to it). Returns
        False when the engine is closed or the loop is alive."""
        if self._closed or self._thread.is_alive():
            return False
        retired = 0
        if self._pool_hazard:
            for s in list(self._active):
                try:
                    self._retire(s, "engine_restart")
                    retired += 1
                except Exception:
                    _LOG.error("engine_restart retirement of %r failed",
                               s.request_id, exc_info=True)
            self._pool.zero_()
            self._pool_hazard = False
        self._hb = watchdog.register("genloop:%s" % self.name)
        self._thread = threading.Thread(target=self._decode_loop,
                                        daemon=True,
                                        name="mxtpu-gen-%s" % self.name)
        self._thread.start()
        with self._wake:
            self._wake.notify_all()
        flightrec.record("genloop_resurrected", model=self.name,
                         survivors=len(self._active),
                         pending=len(self._pending), retired=retired)
        return True

    # ------------------------------------------------- sequential reference
    def generate_sequential(self, prompt, max_new_tokens=None,
                            temperature=0.0, top_k=0, seed=0):
        """Decode one sequence alone (the other rows inactive), through
        the same programs on the private pool -> (tokens, finish_reason):
        the oracle of the join/leave tests and the per-request
        baseline."""
        prompt, max_new, temperature, top_k, seed = self._validate(
            prompt, max_new_tokens, temperature, top_k, seed)
        P = len(prompt)
        k_all, v_all, first = self._prefill_fn()(
            *self._prefill_rows([(prompt, seed, temperature, top_k)]))
        tokens = [int(first[0])]
        if tokens[0] == self.eos_token:
            return tokens, "eos"
        if max_new <= 1:
            return tokens, "max_tokens"
        need = kvcache.blocks_for(P + max_new - 1, self.block_size)
        table = onp.full(self.max_blocks, self.num_blocks, onp.int32)
        table[:need] = onp.arange(need)
        row = {"table": table, "length": P, "last": tokens[0], "seed": seed,
               "n_generated": 1, "temperature": temperature, "top_k": top_k}
        reason = "max_tokens"
        with self._seq_lock:
            self._seq_pool.zero_()
            self._write_fn(self._seq_pool)(table, k_all[0], v_all[0],
                                           onp.int32(P))
            fn = self._decode_fn(self._seq_pool)
            while row["n_generated"] < max_new:
                (out,) = fn(self._packed([row]))
                if not bool(out[1, 0]):
                    reason = "numeric_error"
                    break
                last = int(out[0, 0])
                tokens.append(last)
                row["length"] += 1
                row["last"] = last
                row["n_generated"] += 1
                if last == self.eos_token:
                    reason = "eos"
                    break
        return tokens, reason

    # -------------------------------------------------------------- dispatch
    def _prefill_dispatch(self, prompts, lengths, seeds, temps, top_ks):
        """The batcher's servable: the stacked batch (``max_batch`` rows,
        the batcher's one bucket) through the prefill program."""
        return tuple(self._prefill_fn()(prompts, lengths, seeds, temps,
                                        top_ks))

    # ------------------------------------------------------------ inspection
    @property
    def alive(self):
        """Decode-loop thread still running (health surface)."""
        return self._thread.is_alive()

    @property
    def closed(self):
        return self._closed

    def describe(self):
        """The GET /v1/models-shaped description of this engine."""
        return {"name": self.name,
                "kind": "generator",
                "model_id": self._model_id,
                "block_size": self.block_size,
                "kv_blocks_total": self._alloc.total,
                "kv_blocks_used": self._alloc.used,
                "max_batch": self.max_batch,
                "decode_buckets": list(self.decode_buckets),
                "prefill_len": self.prefill_len,
                "max_tokens": self.max_tokens,
                "inflight": self._inflight_count(),
                "eos_token": self.eos_token,
                "closed": self._closed}

    # ---------------------------------------------------------------- close
    def close(self, timeout=30.0):
        """Stop intake, let live sequences finish their natural
        retirement (the loop drains active + pending before exiting), and
        release the telemetry bindings and the engine's cache entries."""
        self._closed = True
        try:
            self._prefill.close(drain=True, timeout=timeout)
        except Exception:
            _LOG.debug("prefill batcher close failed", exc_info=True)
        with self._wake:
            self._wake.notify_all()
        self._thread.join(timeout)
        for g, fn in ((_INFLIGHT, self._inflight_fn),
                      (_KV_USED, self._kv_used_fn),
                      (_KV_TOTAL, self._kv_total_fn)):
            try:
                g.remove_function(fn)
            except Exception:
                pass
        for detach in (numwatch.detach_model, slo_mod.REGISTRY.detach_model):
            try:
                detach(self.name)
            except Exception:
                _LOG.debug("telemetry detach failed", exc_info=True)
        # the engine lets go of its graphs: those no other engine holds
        # leave the aot cache with the weights and pool they hold
        for key in self._keys:
            aot.CACHE.release(key, self._owner)
