"""Multi-model registry: named, versioned servables behind one batcher each
(counterpart of ``incubator_mxnet_tpu/serving/registry.py``).

A *servable* is anything with ``predict_batch(*stacked_inputs) -> tuple of
stacked outputs``, or a live Gluon block, which ``load`` wraps in
``BlockServable``. ``load()`` on an existing name installs a new version
and repoints dispatch; batches in flight finish on the old servable, and
``unload(..., drain=True)`` waits for them.

Not ported from the JAX package: the AOT prewarm of hot reloads, the
hlolint/hlodiff load gates, numerics shadows, last-known-good rollback and
generative engines.
"""
from __future__ import annotations

import threading
import time

import torch

from ..gluon.block import Block
from ..jit import EvalStep, net_device
from .batcher import DynamicBatcher, _accepts_replica, replica_device
from .metrics import ServingMetrics

__all__ = ["ModelRegistry", "BlockServable", "ModelNotFoundError"]


class ModelNotFoundError(KeyError):
    """Unknown model name (or version)."""


class BlockServable:
    """Serve a live, initialized Gluon block through ``jit.EvalStep``.

    A net on the CPU serves every replica on the CPU. A net on a CUDA
    device serves replica i on ``cuda:(i % device_count)``, through a copy
    of the net made on that device at first use.

    Deliberate difference from the JAX package's ``BlockServable``: outputs
    in bfloat16 come back as float32 numpy arrays, because numpy has no
    bfloat16 type here. Every bfloat16 value is exact in float32. Other
    types come back unchanged.
    """

    def __init__(self, net, model_id=None):
        self._net = net
        self._model_id = model_id
        self._steps = {net_device(net): EvalStep(net, model_id=model_id)}
        self._lock = threading.Lock()

    def _step(self, replica):
        device = net_device(self._net)
        if device.type == "cuda":
            device = replica_device(replica)
        with self._lock:
            step = self._steps.get(device)
            if step is None:
                import copy
                step = EvalStep(copy.deepcopy(self._net).to(device),
                                model_id=self._model_id)
                self._steps[device] = step
        return step

    def predict_batch(self, *stacked_inputs, replica=0):
        out = self._step(replica)._run(*stacked_inputs)
        outs = out if isinstance(out, tuple) else (out,)
        return tuple(_to_host(o) for o in outs)


def _to_host(t):
    """``t`` as a numpy array, bfloat16 widened to float32. From the card
    a bfloat16 output crosses in its own width into pinned host memory
    (the caching host allocator's, reused batch to batch) and is widened
    on the host: half the bytes of widening on the card first, and none
    of a pageable copy's staging. Widening is exact either way."""
    if t.device.type == "cuda" and t.dtype == torch.bfloat16:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.float().numpy()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _as_servable(obj):
    if hasattr(obj, "predict_batch"):
        return obj
    if isinstance(obj, Block):
        return BlockServable(obj)
    raise TypeError("not a servable: %r (need predict_batch() or a Gluon "
                    "block)" % (obj,))


class _ModelEntry:
    """One name: version → servable map, its batcher and in-flight counts."""

    def __init__(self, name, **batcher_kw):
        self.name = name
        self.versions = {}
        self.current_version = None
        self.metrics = ServingMetrics(model=name)
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._inflight = {}             # version -> dispatched-batch count
        self.batcher = DynamicBatcher(self._dispatch, name=name,
                                      metrics=self.metrics, **batcher_kw)

    def _dispatch(self, *stacked_inputs, replica=0):
        """Resolve the current version per batch and pin it while it runs."""
        with self._lock:
            version = self.current_version
            if version is None:
                raise ModelNotFoundError(
                    "model %r has no loaded version" % self.name)
            servable = self.versions[version]
            self._inflight[version] = self._inflight.get(version, 0) + 1
        try:
            if _accepts_replica(servable.predict_batch):
                return servable.predict_batch(*stacked_inputs,
                                              replica=replica)
            return servable.predict_batch(*stacked_inputs)
        finally:
            with self._drained:
                if version in self._inflight:
                    self._inflight[version] -= 1
                self._drained.notify_all()

    def install(self, servable, version):
        with self._lock:
            if version is None:
                version = (max(self.versions) + 1) if self.versions else 1
            self.versions[version] = servable
            self.current_version = version
            return version

    def drop(self, version, drain, timeout):
        """Remove one version, repointing dispatch at the newest other one
        first; with ``drain`` wait until its in-flight batches finish."""
        with self._drained:
            remaining = [v for v in self.versions if v != version]
            if version == self.current_version:
                self.current_version = max(remaining) if remaining else None
            end = time.monotonic() + timeout
            while drain and self._inflight.get(version, 0):
                left = end - time.monotonic()
                if left <= 0:
                    raise TimeoutError("model %r v%s still has in-flight "
                                       "batches" % (self.name, version))
                self._drained.wait(left)
            self.versions.pop(version, None)
            self._inflight.pop(version, None)

    def describe(self):
        with self._lock:
            return {"name": self.name,
                    "versions": sorted(self.versions),
                    "current_version": self.current_version,
                    "queue_depth": self.batcher.queue_depth(),
                    "queue_size": self.batcher.queue_size,
                    "replicas": self.batcher.replicas,
                    "max_batch_size": self.batcher.max_batch_size,
                    "batch_timeout_ms": self.batcher.batch_timeout_ms}


class ModelRegistry:
    """Thread-safe name → model map; one batcher per name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._closed = False

    def load(self, name, servable, version=None, **batcher_kw):
        """Register (or hot-reload) ``name``; returns the installed version.

        The first load creates the name's batcher from ``batcher_kw``
        (max_batch_size, batch_timeout_ms, queue_size, buckets,
        default_deadline_ms, replicas; defaults from ``MXTPU_SERVE_*``)."""
        servable = _as_servable(servable)
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is shut down")
            entry = self._entries.get(name)
            if entry is None:
                entry = _ModelEntry(name, **batcher_kw)
                self._entries[name] = entry
            elif batcher_kw:
                raise ValueError("batcher options are fixed at first load "
                                 "of %r" % name)
            return entry.install(servable, version)

    def unload(self, name, version=None, drain=True, timeout=30.0):
        """Drop one version (default: current). Dropping the last version
        closes the name's batcher (draining its queue) and forgets it."""
        entry = self._entry(name)
        if version is None:
            version = entry.current_version
        if version not in entry.versions:
            raise ModelNotFoundError("model %r has no version %s"
                                     % (name, version))
        last = set(entry.versions) == {version}
        if last:
            # serve everything already accepted before the version goes
            entry.batcher.close(drain=drain, timeout=timeout)
            with self._lock:
                self._entries.pop(name, None)
        entry.drop(version, drain, timeout)

    def close(self, drain=True):
        """Shut every model's batcher down (queues drained first)."""
        with self._lock:
            self._closed = True
            entries = list(self._entries.values())
        for entry in entries:
            entry.batcher.close(drain=drain)

    def _entry(self, name):
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise ModelNotFoundError("no model %r loaded (have: %s)"
                                         % (name, sorted(self._entries)))
            return entry

    def submit(self, name, *inputs, deadline_ms=None):
        return self._entry(name).batcher.submit(*inputs,
                                                deadline_ms=deadline_ms)

    def predict(self, name, *inputs, deadline_ms=None, timeout=None):
        return self._entry(name).batcher.predict(
            *inputs, deadline_ms=deadline_ms, timeout=timeout)

    def metrics(self, name):
        return self._entry(name).metrics

    def models(self):
        with self._lock:
            entries = list(self._entries.values())
        return [e.describe() for e in entries]
