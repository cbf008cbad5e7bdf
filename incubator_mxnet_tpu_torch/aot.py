"""Process-wide AOT cache of captured programs (counterpart of the
in-memory half of ``incubator_mxnet_tpu/aot.py``, its lines 1-529).

The JAX package keeps one shared cache of compiled XLA executables so that
no request pays a compile: the key is ``(model_id, kind, input signature,
mesh, extra)``, a miss builds through the explicit AOT pipeline where the
caller schedules it (a prewarm thread, a build span), single-flight per
key, and entries are evicted least recently dispatched first past
``MXTPU_AOT_CACHE_SIZE``, each eviction counted.

The port keeps the cache, its key, its single-flight misses, its LRU and
its counters (``mxtpu_aot_{hits,misses,evictions}_total{kind}`` and the
``mxtpu_aot_entries`` gauge). What an entry holds differs: on the card it
is a captured CUDA graph with its static inputs and outputs
(``jit._Captured``), not an XLA executable. ``jit.TrainStep`` (kind
``"train"``), ``jit.EvalStep`` (kind ``"eval"``) and the generative
engine's prefill, decode and KV-join programs (kinds ``"serve"`` and
``"decode"``) build through ``compile_cached``; the LRU evicts from the
front of the cache's recency-ordered table. A train entry updates its own
step's parameters in place, so its key carries the step's instance token
and is never shared, and the step releases its entries when it is
collected. ``hybridize`` keeps a per-block table of graphs, bounded by
``MXTPU_EXEC_CACHE_SIZE`` (``config.evict_to_bound``).

A captured graph reads the addresses it was captured on, where the JAX
package passes parameters as run-time inputs. So a key made for a graph
carries the addresses of the tensors it reads in ``extra`` (``EvalStep``
the device and its parameters'; the engine its weights' and its pool's):
two ``EvalStep``s over one set of parameters share a graph, and a version
loaded with new weights captures its own (ROADMAP §3, departures).

An entry also holds memory an XLA executable does not: the graph's private
memory pool, which holds the activations and outputs of one replay at its
signature, and the tensors the graph reads. So an entry is owned: each
``EvalStep`` and each generative engine passes its owner token to
``lookup``/``compile_cached``, and ``release(key, owner)`` drops the entry
with its last owner's release. Two served models over one net share
their graphs, and dropping one of them leaves the other's in place. The
cache is bounded by its entry count (``MXTPU_AOT_CACHE_SIZE``), not by
its pools' bytes (ROADMAP §3, departures).

The artifact layer (``MXTPU_AOT_CACHE_DIR``) persists what the JAX
package persists, the exported program, as a ``torch.export`` program
(``torch.export.save`` after the magic and a length-prefixed JSON header
carrying the program's stats), under ``torch-<version>/`` where the JAX
package writes ``jax-<version>/``. A miss of an ``exportable`` key loads
the file instead of calling ``build()``: no Python forward of the net
runs. A CUDA graph cannot be written to disk, so the caller's
``from_program`` captures the loaded program again over its own live
tensors (as a hot reload's prewarm does). The file's name digests the
key without its ``Bound`` part (the addresses a graph reads, which
differ in every process); the in-memory key keeps them. Wrong magic, an
old format version, a truncated header or a payload that does not load
all fall back to a build. Train programs are never persisted.

Every entry's stats (``telemetry.devstats.program_stats``: FLOPs counted
by ``FlopCounterMode`` over the eager run before a capture, the
allocator's peak around it, the output bytes) feed the per-program
gauges ``mxtpu_aot_program_flops`` and ``mxtpu_aot_program_peak_bytes``,
which ``devstats.observe_dispatch`` and ``history`` read.
"""
from __future__ import annotations

import hashlib
import io
import json as _json
import logging
import os
import struct
import threading
import time as _time
from collections import namedtuple

import torch

from . import config
from . import telemetry
from .telemetry import devstats, faultlab, spans

__all__ = ["CacheKey", "cache_key", "AOTCache", "CACHE", "compile_cached",
           "model_id_for", "input_signature", "mesh_sig", "artifact_path",
           "ARTIFACT_MAGIC", "FORMAT_VERSION", "collect_inserts",
           "ProgramFactsRef", "program_digest", "facts_for_key", "Bound"]

_LOG = logging.getLogger(__name__)

#: the artifact format (its version is part of the magic and of the file
#: digest, so an old file is rebuilt, never misparsed); v2 puts a
#: length-prefixed JSON header with the program's stats before the payload
FORMAT_VERSION = 2
ARTIFACT_MAGIC = b"MXTPUAOT\x002"

_HITS = telemetry.counter(
    "mxtpu_aot_hits_total",
    "Shared program-cache hits (dispatch found a captured program).",
    ("kind",))
_MISSES = telemetry.counter(
    "mxtpu_aot_misses_total",
    "Shared program-cache misses (a fresh build: one capture).",
    ("kind",))
_EVICTIONS = telemetry.counter(
    "mxtpu_aot_evictions_total",
    "LRU evictions from the shared program cache past "
    "MXTPU_AOT_CACHE_SIZE; a climbing rate under steady traffic means the "
    "bound is too small for the live bucket set.", ("kind",))
_ARTIFACT_HITS = telemetry.counter(
    "mxtpu_aot_artifact_hits_total",
    "Cache misses satisfied by a persisted torch.export artifact "
    "(MXTPU_AOT_CACHE_DIR) instead of running the model's Python forward.",
    ("kind",))
_ARTIFACT_WRITES = telemetry.counter(
    "mxtpu_aot_artifact_writes_total",
    "Exported programs written to MXTPU_AOT_CACHE_DIR.", ("kind",))
_ENTRIES = telemetry.gauge(
    "mxtpu_aot_entries",
    "Live entries in the process-wide AOT program cache.")
_PROG_FLOPS = telemetry.gauge(
    "mxtpu_aot_program_flops",
    "FLOPs of one execution of a cached program (FlopCounterMode over the "
    "eager run before its capture; an artifact load carries it in the v2 "
    "header). The numerator of every mxtpu_device_mfu observation.",
    ("model", "kind", "bucket"))
_PROG_PEAK_BYTES = telemetry.gauge(
    "mxtpu_aot_program_peak_bytes",
    "Peak bytes the CUDA caching allocator held for one execution of a "
    "cached program beyond what was live before it (its eager run and "
    "capture).", ("model", "kind", "bucket"))


class Bound(tuple):
    """The addresses a captured graph reads, in a key's ``extra``: part of
    the in-memory key, left out of an artifact's file digest (they differ
    in every process; the loaded program is captured again over the live
    tensors)."""

#: (model_id, kind, input_sig, mesh, extra): the identity of one program.
#: kind is 'train' | 'eval' | 'serve' | 'decode'; input_sig a tuple of
#: (shape tuple, dtype string) per input; mesh is mesh_sig(); extra the
#: caller's statics (for a captured graph, the addresses it reads).
CacheKey = namedtuple("CacheKey", ("model_id", "kind", "input_sig", "mesh",
                                   "extra"))

#: (path, digest, stats) of one persisted program: the artifact layer's
ProgramFactsRef = namedtuple("ProgramFactsRef", ("path", "digest", "stats"))


def input_signature(arrs):
    """(shape, dtype) tuple per input: tensors, NDArrays or numpy arrays
    (anything with .shape and .dtype)."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrs)


def mesh_sig(mesh):
    """Hashable identity of a mesh (None for one device): its axis sizes
    and device count."""
    if mesh is None:
        return None
    return (tuple(sorted(mesh.shape.items())), len(mesh.devices.flat))


def cache_key(model_id, input_sig, kind="eval", mesh=None, extra=()):
    """The canonical CacheKey. ``input_sig`` comes from
    ``input_signature()`` or is any iterable of (shape, dtype) pairs."""
    sig = tuple((tuple(s), str(d)) for s, d in input_sig)
    return CacheKey(str(model_id), str(kind), sig,
                    mesh if (mesh is None or isinstance(mesh, tuple))
                    else mesh_sig(mesh), tuple(extra))


def _iter_blocks(net, path="net", seen=None):
    """Depth-first (path, block) walk over a Gluon block tree."""
    if seen is None:
        seen = set()
    if id(net) in seen:
        return
    seen.add(id(net))
    yield path, net
    children = getattr(net, "_children", None)
    if isinstance(children, dict):
        for name, child in sorted(children.items()):
            yield from _iter_blocks(child, "%s.%s" % (path, name), seen)


def _is_array(val):
    return hasattr(val, "shape") and hasattr(val, "dtype") \
        and (hasattr(val, "__array__") or isinstance(val, torch.Tensor))


def _baked_state_tokens(net):
    """Digest tokens for block state a program bakes in: instance
    attributes that are Python scalars or raw arrays (not registered
    Parameters). Two differently-calibrated instances of one architecture
    must not share a program, and a reloaded identical one must."""
    import numpy as onp
    scalars = (bool, int, float, str, bytes, type(None))
    # torch.nn.Module's own bookkeeping (hook tables keyed by hook ids,
    # state-dict hooks) differs between processes: not baked state
    skip = ("_children", "_reg_params", "_forward_hooks", "_cached_fn",
            "_forward_pre_hooks", "_prefix", "_name", "_scope",
            "_mx_pre_hooks", "_mx_hooks") + \
        tuple(n for n in vars(torch.nn.Module()) if n != "training")
    for path, block in _iter_blocks(net):
        try:
            items = sorted(vars(block).items())
        except TypeError:
            continue
        for name, val in items:
            if name in skip or type(val).__name__ == "Parameter" \
                    or hasattr(val, "_children"):
                continue
            if isinstance(val, dict):
                # sorted by repr: mixed-type keys must not stop the walk
                items = tuple(sorted(
                    ((k, v) for k, v in val.items()
                     if isinstance(v, scalars)), key=repr))
                yield "%s.%s=%r" % (path, name, items)
                continue
            if isinstance(val, (tuple, list)) \
                    and all(isinstance(v, scalars) for v in val):
                yield "%s.%s=%r" % (path, name, tuple(val))
            elif isinstance(val, scalars):
                yield "%s.%s=%r" % (path, name, val)
            elif _is_array(val) or hasattr(val, "_data"):
                try:
                    data = getattr(val, "_data", val)
                    if isinstance(data, torch.Tensor):
                        data = data.detach().cpu().float().numpy()
                    arr = onp.asarray(data)
                    yield "%s.%s@%s" % (path, name, hashlib.sha256(
                        arr.tobytes()).hexdigest()[:16])
                except Exception:
                    yield "%s.%s@<unhashable>" % (path, name)


def model_id_for(net, extra=()):
    """Stable content digest of a Gluon block, the JAX package's recipe
    with ``torch.__version__`` in place of ``jax.__version__``: class,
    repr, the positional (index, shape, dtype) list of its parameters, a
    hash of baked instance state, and the caller's ``extra`` tokens.
    Identical models give the same id; a different width, depth or dtype
    gives another. Which parameter storage a captured graph reads is not
    part of it: that rides in the key's ``extra``."""
    parts = [torch.__version__, type(net).__qualname__]
    try:
        parts.append(repr(net))
    except Exception:
        parts.append("<repr-failed>")
    try:
        # positional, never the parameter names: auto-naming makes every
        # instance's prefix unique
        for i, p in enumerate(net.collect_params().values()):
            shape = getattr(p, "shape", None)
            dtype = getattr(p, "dtype", None)
            parts.append("p%d:%s:%s" % (i, shape, dtype))
    except Exception:
        parts.append("<params-unavailable>")
    try:
        parts.extend(_baked_state_tokens(net))
    except Exception:
        parts.append("<baked-state-unavailable>")
    parts.extend(str(e) for e in extra)
    return "g" + hashlib.sha256("\x00".join(parts).encode()).hexdigest()[:20]


class _Entry:
    """One program, its caller's extras and its LRU bookkeeping."""

    __slots__ = ("key", "fn", "extras", "last_used", "source", "created",
                 "stats", "owners")

    def __init__(self, key, fn, extras, source, stats=None):
        self.key = key
        self.fn = fn
        self.extras = extras
        self.source = source            # 'build' or 'artifact'
        self.stats = stats
        self.created = _time.monotonic()
        self.last_used = self.created
        self.owners = set()             # tokens of the holders (release)


_collector = threading.local()


class collect_inserts:
    """Record every cache entry this thread inserts while the context is
    active (the registry's prewarm and the engine's warm wrap their
    builds in one). Nests: the inner context collects, the outer resumes
    afterwards."""

    def __enter__(self):
        self._prev = getattr(_collector, "sink", None)
        self.entries = []
        _collector.sink = self.entries
        return self.entries

    def __exit__(self, *exc):
        _collector.sink = self._prev
        return False


class AOTCache:
    """Thread-safe LRU map CacheKey -> entry (the process-wide instance is
    ``aot.CACHE``). Its table is kept in recency order: a lookup moves the
    entry to the end, and inserts evict from the front past
    MXTPU_AOT_CACHE_SIZE (``_evict_locked``), counting each."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries = {}
        self._building = {}   # key -> Event (single-flight build guard)

    def lookup(self, key, owner=None):
        """Hit -> entry (moved to most recent, hit counted, ``owner`` added
        to its holders); miss -> None."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                entry.last_used = _time.monotonic()
                self._entries[key] = entry
                if owner is not None:
                    entry.owners.add(owner)
        if entry is not None:
            _HITS.inc(kind=key.kind)
        return entry

    def peek(self, key):
        """lookup() without touching the LRU order or the counters."""
        with self._lock:
            return self._entries.get(key)

    def insert(self, key, fn, extras=None, source="build", stats=None,
               owner=None):
        if stats is None:
            # the program's stats, once per entry: what its build measured
            stats = devstats.program_stats(fn)
        entry = _Entry(key, fn, extras, source, stats)
        if owner is not None:
            entry.owners.add(owner)
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = entry
            self._evict_locked()
            _ENTRIES.set(len(self._entries))
            if stats:
                _publish_program_stats(key, stats)
        sink = getattr(_collector, "sink", None)
        if sink is not None:
            sink.append(entry)
        return entry

    def _evict_locked(self):
        """Evict from the front of the recency-ordered table (the least
        recently dispatched entry) past MXTPU_AOT_CACHE_SIZE, counting
        each."""
        bound = max(1, config.get_env("MXTPU_AOT_CACHE_SIZE"))
        while len(self._entries) > bound:
            key = next(iter(self._entries))
            del self._entries[key]
            _EVICTIONS.inc(kind=key.kind)
            self._unpublish_locked(key)

    def _unpublish_locked(self, key):
        """Drop a departed entry's program gauges, or publish a surviving
        entry's under the same (model, kind, bucket) labels."""
        label = (key.model_id, key.kind, _bucket_of(key))
        for other_key, other in self._entries.items():
            if (other_key.model_id, other_key.kind,
                    _bucket_of(other_key)) == label and other.stats:
                _publish_program_stats(other_key, other.stats)
                return
        try:
            _PROG_FLOPS.remove(model=label[0], kind=label[1],
                               bucket=label[2])
            _PROG_PEAK_BYTES.remove(model=label[0], kind=label[1],
                                    bucket=label[2])
        except Exception:
            _LOG.debug("program stats gauge removal dropped", exc_info=True)

    def discard(self, key):
        with self._lock:
            gone = self._entries.pop(key, None) is not None
            if gone:
                self._unpublish_locked(key)
            _ENTRIES.set(len(self._entries))
        return gone

    def release(self, key, owner):
        """``owner`` no longer holds ``key``'s entry; the entry (its graph,
        memory pool and bound tensors) leaves the cache when no holder is
        left. Returns whether it left."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or owner not in entry.owners:
                return False
            entry.owners.discard(owner)
            if entry.owners:
                return False
            del self._entries[key]
            self._unpublish_locked(key)
            _ENTRIES.set(len(self._entries))
        return True

    def clear(self):
        with self._lock:
            keys = list(self._entries)
            self._entries.clear()
            for key in keys:
                self._unpublish_locked(key)
            _ENTRIES.set(0)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def snapshot(self):
        """JSON-able view (GET /debug/aot): one record per entry, most
        recently dispatched first. The addresses a graph reads are
        summarised by their count."""
        now = _time.monotonic()
        with self._lock:
            entries = list(reversed(self._entries.values()))
        return [{"model_id": e.key.model_id, "kind": e.key.kind,
                 "input_sig": [[list(s), d] for s, d in e.key.input_sig],
                 "mesh": e.key.mesh if e.key.mesh is None
                 else list(e.key.mesh),
                 "bound_tensors": sum(len(x) if isinstance(x, Bound) else 1
                                      for x in e.key.extra),
                 "source": e.source,
                 "stats": dict(e.stats) if e.stats else None,
                 "age_s": round(now - e.created, 3),
                 "idle_s": round(now - e.last_used, 3)}
                for e in entries]

    def get_or_build(self, key, build, exportable=False, arg_specs=None,
                     owner=None, from_program=None):
        """Single-flight miss path: at most one thread builds a given key;
        the rest wait on its completion event and then hit; ``owner``
        becomes one of the entry's holders either way. ``build()``
        returns ``(fn, extras, exported_or_None)``; with ``exportable``
        and the layer on, the exported program is persisted, and a
        persisted one is loaded INSTEAD of calling ``build()``:
        ``from_program(program) -> (fn, extras)`` makes it runnable (a
        capture over the caller's live tensors; without it the entry is
        the program's module). ``arg_specs`` is the JAX package's and is
        not read."""
        while True:
            entry = self.lookup(key, owner)
            if entry is not None:
                return entry
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.last_used = _time.monotonic()
                    self._entries[key] = self._entries.pop(key)
                    if owner is not None:
                        entry.owners.add(owner)
                    _HITS.inc(kind=key.kind)
                    return entry
                event = self._building.get(key)
                builder = event is None
                if builder:
                    event = self._building[key] = threading.Event()
            if not builder:
                # another thread owns the build: wait, then look again
                # (bounded so a crashed builder cannot strand waiters)
                event.wait(timeout=600.0)
                continue
            try:
                _MISSES.inc(kind=key.kind)
                if exportable:
                    loaded = _load_artifact(key)
                    if loaded is not None:
                        program, stats = loaded
                        if from_program is None:
                            fn, extras = program.module(), None
                        else:
                            fn, extras = from_program(program)
                        _ARTIFACT_HITS.inc(kind=key.kind)
                        # the header's stats win, as in the JAX package
                        return self.insert(key, fn, extras,
                                           source="artifact",
                                           stats=stats or None, owner=owner)
                fn, extras, exported = build()
                entry = self.insert(key, fn, extras, source="build",
                                    owner=owner)
                if exportable and exported is not None:
                    _write_artifact(key, exported, stats=entry.stats)
                return entry
            finally:
                with self._lock:
                    self._building.pop(key, None)
                event.set()


CACHE = AOTCache()


def compile_cached(key, build, exportable=False, arg_specs=None,
                   owner=None, from_program=None):
    """The module's entry point (``jit.EvalStep``, the generative engine,
    ``contrib.serving.ServedModel``, the registry's prewarm through them):
    ``build()`` runs on a miss that no persisted artifact answers, and
    ``owner`` (a token its caller later passes to ``CACHE.release``)
    holds the entry. Returns the cache entry (``entry.fn`` is the
    program, ``entry.source`` 'build' or 'artifact')."""
    return CACHE.get_or_build(key, build, exportable=exportable,
                              arg_specs=arg_specs, owner=owner,
                              from_program=from_program)


def _bucket_of(key):
    """Batch-bucket label for the program gauges: dim 0 of the first
    input, '-' for rank-0 or inputless keys."""
    try:
        return int(key.input_sig[0][0][0])
    except Exception:
        return "-"


def _publish_program_stats(key, stats):
    """Mirror one entry's stats onto the program gauges; a telemetry
    failure never fails the build or load that made the program."""
    try:
        bucket = _bucket_of(key)
        _PROG_FLOPS.set(stats.get("flops") or 0.0, model=key.model_id,
                        kind=key.kind, bucket=bucket)
        _PROG_PEAK_BYTES.set(stats.get("peak_bytes") or 0.0,
                             model=key.model_id, kind=key.kind,
                             bucket=bucket)
    except Exception:
        _LOG.debug("program stats gauge update dropped", exc_info=True)


# --------------------------------------------------------------------------
# Persistent artifact layer (MXTPU_AOT_CACHE_DIR)
def _key_digest(key):
    """The file digest of a key: everything but its ``Bound`` addresses."""
    extra = tuple(e for e in key.extra if not isinstance(e, Bound))
    raw = repr((FORMAT_VERSION, key.model_id, key.kind, key.input_sig,
                key.mesh, extra))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def artifact_path(key, cache_dir=None):
    """Artifact file for a key, or None when the layer is off (no
    MXTPU_AOT_CACHE_DIR) or the key is a train program (never
    persisted). The directory names the torch version: a program
    exported by another version is never read."""
    if cache_dir is None:
        cache_dir = config.get_env("MXTPU_AOT_CACHE_DIR")
    if not cache_dir or key.kind == "train":
        return None
    return os.path.join(cache_dir, "torch-%s" % torch.__version__,
                        "%s-%s.mxtpu-aot" % (key.kind, _key_digest(key)))


def _pack_header(stats):
    """v2 header: 4-byte big-endian length + JSON metadata carrying the
    program's stats, so a fresh process knows its FLOPs before it runs."""
    meta = _json.dumps({"format": FORMAT_VERSION,
                        "stats": stats if stats else None},
                       sort_keys=True).encode("utf-8")
    return struct.pack(">I", len(meta)) + meta


def _unpack_header(buf):
    """(stats_or_None, payload_offset) for a v2 body (magic stripped).
    Raises on truncation or garbage: the caller rebuilds."""
    if len(buf) < 4:
        raise ValueError("truncated artifact header")
    (n,) = struct.unpack(">I", buf[:4])
    if n > len(buf) - 4:
        raise ValueError("artifact header length %d overruns file" % n)
    meta = _json.loads(buf[4:4 + n].decode("utf-8"))
    stats = meta.get("stats") if isinstance(meta, dict) else None
    if stats is not None and not isinstance(stats, dict):
        stats = None
    return stats, 4 + n


def serialize_program(program):
    """A ``torch.export`` program's bytes (``torch.export.save``), without
    the example inputs ``torch.export.save`` would write beside it (an
    eval program's are the model's parameters)."""
    examples, program.example_inputs = program.example_inputs, None
    try:
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()
    finally:
        program.example_inputs = examples


def deserialize_program(payload):
    """``torch.export.load`` of ``serialize_program``'s bytes. The port's
    operators (K1's ``mxtpu::flash_fwd``) are registered first."""
    from .ops import attention  # noqa: F401 — registers mxtpu::flash_fwd
    return torch.export.load(io.BytesIO(payload))


def _load_artifact(key):
    """(program, stats) of ``key``'s persisted file, loaded inside an
    ``aot:load`` span, or None (missing, corrupt, an old version, a
    payload that does not load: the caller builds; the drop is
    debug-logged, never raised)."""
    path = artifact_path(key)
    if path is None or not os.path.exists(path):
        return None
    try:
        # faultlab site "aot.artifact_read": artifact_corrupt reads as an
        # unreadable file (the caller builds); an exception kind lands in
        # the except-all below, the same fallback
        if faultlab.armed and faultlab.fire(
                "aot.artifact_read", kind=key.kind,
                model_id=key.model_id) == "artifact_corrupt":
            _LOG.debug("aot artifact read for %s: injected corrupt", path)
            return None
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(ARTIFACT_MAGIC):
            raise ValueError("bad magic/version in %s" % path)
        stats, off = _unpack_header(buf[len(ARTIFACT_MAGIC):])
        with spans.span("aot:load", kind=key.kind, model_id=key.model_id):
            program = deserialize_program(buf[len(ARTIFACT_MAGIC) + off:])
        return program, stats
    except Exception:
        _LOG.debug("aot artifact load failed for %s", path, exc_info=True)
        return None


def _write_artifact(key, exported, stats=None):
    """Persist an exported program atomically (a tmp file named by pid and
    thread, then ``os.replace``), its stats in the v2 header. A failure is
    debug-logged and swallowed: a full disk must not fail the dispatch
    that just built."""
    path = artifact_path(key)
    if path is None:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(ARTIFACT_MAGIC + _pack_header(stats)
                    + serialize_program(exported))
        os.replace(tmp, path)
        _ARTIFACT_WRITES.inc(kind=key.kind)
        return path
    except Exception:
        _LOG.debug("aot artifact write failed for %s", path, exc_info=True)
        return None


# --------------------------------------------------------------------------
# Per-program facts: an artifact's identity and header, without its payload
_FACTS_MEMO = {}                  # path -> (mtime_ns, size, ProgramFactsRef)
_FACTS_MEMO_LOCK = threading.Lock()
_FACTS_MEMO_MAX = 512


def program_digest(buf):
    """Stable digest of one artifact's full bytes: it changes iff the
    deployed bytes change."""
    return hashlib.sha256(bytes(buf)).hexdigest()[:32]


def facts_for_key(key, cache_dir=None):
    """``ProgramFactsRef(path, digest, stats)`` of ``key``'s persisted
    artifact, or None (train kind, layer off, missing or corrupt file).
    Reads the magic and header only, never loads the program, and memos
    per (path, mtime, size), so a re-check costs one ``stat()``."""
    path = artifact_path(key, cache_dir)
    if path is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    with _FACTS_MEMO_LOCK:
        memo = _FACTS_MEMO.get(path)
        if memo is not None and memo[0] == st.st_mtime_ns \
                and memo[1] == st.st_size:
            return memo[2]
    try:
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(ARTIFACT_MAGIC):
            return None
        stats, _off = _unpack_header(buf[len(ARTIFACT_MAGIC):])
    except Exception:
        _LOG.debug("aot facts_for_key failed for %s", path, exc_info=True)
        return None
    ref = ProgramFactsRef(path, program_digest(buf), stats)
    with _FACTS_MEMO_LOCK:
        if len(_FACTS_MEMO) >= _FACTS_MEMO_MAX:
            _FACTS_MEMO.clear()
        _FACTS_MEMO[path] = (st.st_mtime_ns, st.st_size, ref)
    return ref
