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
(``jit._Captured``), not an XLA executable. ``jit.EvalStep`` (kind
``"eval"``) and the generative engine's prefill, decode and KV-join
programs (kinds ``"serve"`` and ``"decode"``) build through
``compile_cached``; the LRU's eviction is ``config.evict_to_bound`` over
the cache's recency-ordered table. ``jit.TrainStep`` and ``hybridize``
keep their per-instance tables of graphs, bounded by the same knob: a
training graph updates its own instance's parameters in place, so it is
never shared.

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

The artifact layer (``MXTPU_AOT_CACHE_DIR``: programs written to disk and
loaded by a fresh process, ``artifact_path``, ``facts_for_key``,
``program_digest``) comes with the next slice of the port: setting the
knob or calling those functions raises ``NotImplementedError``. The JAX
package's per-program FLOP and peak-byte gauges read XLA's cost analysis
and wait for ``telemetry.devstats`` (ROADMAP §1 item 7); an entry's
``stats`` stays None.
"""
from __future__ import annotations

import hashlib
import threading
import time as _time
from collections import namedtuple

import torch

from . import config
from . import telemetry

__all__ = ["CacheKey", "cache_key", "AOTCache", "CACHE", "compile_cached",
           "model_id_for", "input_signature", "mesh_sig", "artifact_path",
           "ARTIFACT_MAGIC", "FORMAT_VERSION", "collect_inserts",
           "ProgramFactsRef", "program_digest", "facts_for_key"]

#: the JAX package's artifact format; the port writes no artifact yet
FORMAT_VERSION = 2
ARTIFACT_MAGIC = b"MXTPUAOT\x002"

_NEXT_SLICE = ("the AOT artifact layer (programs written to disk: "
               "MXTPU_AOT_CACHE_DIR, artifact_path, facts_for_key, "
               "program_digest) comes with the next slice of the port, "
               "with torch.export of the forward")

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
_ENTRIES = telemetry.gauge(
    "mxtpu_aot_entries",
    "Live entries in the process-wide AOT program cache.")

#: (model_id, kind, input_sig, mesh, extra): the identity of one program.
#: kind is 'eval' | 'serve' | 'decode'; input_sig a tuple of (shape tuple,
#: dtype string) per input; mesh is mesh_sig(); extra the caller's statics
#: (for a captured graph, the addresses it reads).
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
    skip = ("_children", "_reg_params", "_forward_hooks", "_cached_fn",
            "_forward_pre_hooks", "_prefix", "_name", "_scope")
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
        self.source = source            # 'build' (no artifacts yet)
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


def _refuse_artifacts():
    if config.get_env("MXTPU_AOT_CACHE_DIR"):
        raise NotImplementedError("MXTPU_AOT_CACHE_DIR is set, but "
                                  + _NEXT_SLICE)


class AOTCache:
    """Thread-safe LRU map CacheKey -> entry (the process-wide instance is
    ``aot.CACHE``). Its table is kept in recency order: a lookup moves the
    entry to the end, and inserts evict from the front past
    MXTPU_AOT_CACHE_SIZE (``config.evict_to_bound``), counting each."""

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
        entry = _Entry(key, fn, extras, source, stats)
        if owner is not None:
            entry.owners.add(owner)
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = entry
            config.evict_to_bound(
                self._entries,
                lambda k, _v: _EVICTIONS.inc(kind=k.kind))
            _ENTRIES.set(len(self._entries))
        sink = getattr(_collector, "sink", None)
        if sink is not None:
            sink.append(entry)
        return entry

    def discard(self, key):
        with self._lock:
            gone = self._entries.pop(key, None) is not None
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
            _ENTRIES.set(len(self._entries))
        return True

    def clear(self):
        with self._lock:
            self._entries.clear()
            _ENTRIES.set(0)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def snapshot(self):
        """JSON-able view (GET /debug/aot): one record per entry, most
        recently dispatched first. ``extra`` (the addresses a graph reads)
        is summarised by its length."""
        now = _time.monotonic()
        with self._lock:
            entries = list(reversed(self._entries.values()))
        return [{"model_id": e.key.model_id, "kind": e.key.kind,
                 "input_sig": [[list(s), d] for s, d in e.key.input_sig],
                 "mesh": e.key.mesh if e.key.mesh is None
                 else list(e.key.mesh),
                 "bound_tensors": len(e.key.extra),
                 "source": e.source,
                 "stats": dict(e.stats) if e.stats else None,
                 "age_s": round(now - e.created, 3),
                 "idle_s": round(now - e.last_used, 3)}
                for e in entries]

    def get_or_build(self, key, build, exportable=False, arg_specs=None,
                     owner=None):
        """Single-flight miss path: at most one thread builds a given key;
        the rest wait on its completion event and then hit; ``owner``
        becomes one of the entry's holders either way. ``build()``
        returns ``(fn, extras, exported_or_None)``; the exported program
        would be persisted by the artifact layer, which the port has not
        yet (``exportable`` is accepted and refused only while
        ``MXTPU_AOT_CACHE_DIR`` is set)."""
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
                    _refuse_artifacts()
                fn, extras, _exported = build()
                return self.insert(key, fn, extras, source="build",
                                   owner=owner)
            finally:
                with self._lock:
                    self._building.pop(key, None)
                event.set()


CACHE = AOTCache()


def compile_cached(key, build, exportable=False, arg_specs=None,
                   owner=None):
    """The module's entry point (``jit.EvalStep``, the generative engine,
    the registry's prewarm through them): ``build()`` runs on a miss, and
    ``owner`` (a token its caller later passes to ``CACHE.release``)
    holds the entry. Returns the cache entry (``entry.fn`` is the
    program)."""
    return CACHE.get_or_build(key, build, exportable=exportable,
                              arg_specs=arg_specs, owner=owner)


def artifact_path(key, cache_dir=None):
    """The JAX package's artifact file of a key: the next slice's."""
    raise NotImplementedError(_NEXT_SLICE)


def program_digest(buf):
    """The JAX package's digest of an artifact's bytes: the next slice's."""
    raise NotImplementedError(_NEXT_SLICE)


def facts_for_key(key, cache_dir=None):
    """The JAX package's header facts of a persisted program: the next
    slice's."""
    raise NotImplementedError(_NEXT_SLICE)
