"""KVStore implementations (counterpart of
``incubator_mxnet_tpu/kvstore/kvstore.py``): ``KVStoreBase``, ``KVStore``,
``LocalKVStore`` and ``create`` for "local" and "device".

The store keeps one copy of each key on the device of the value it was
given. ``init`` copies the value in; ``push`` sums a list of values (one per
device) and either hands the sum to the optimizer's updater, which updates
the stored weight in place, or stores a copy of it; ``pull`` copies the
stored value into each ``out`` (``copy_``). The store never shares a buffer
with the caller: the JAX package may share one because its arrays are
immutable, but a torch tensor is written in place, and a shared buffer
would carry a later write from one side to the other.

Push and pull count their payload bytes
(``mxtpu_kvstore_{push,pull}_bytes_total{store}``), run in
``kvstore:push``/``kvstore:pull`` spans and land in the flight recorder,
as the JAX package's; the ``dist*`` stores wait for the multi-GPU slice
(item 5).
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from .. import telemetry
from ..ndarray import NDArray
from ..telemetry import flightrec, spans

__all__ = ["KVStore", "KVStoreBase", "create", "LocalKVStore", "DistKVStore",
           "DistAsyncKVStore"]

_ITEM5 = "comes with the multi-GPU slice (ROADMAP.md §1 item 5)"

_PUSH_BYTES = telemetry.counter(
    "mxtpu_kvstore_push_bytes_total",
    "Payload bytes pushed into the kvstore (per-device values summed).",
    ("store",))
_PULL_BYTES = telemetry.counter(
    "mxtpu_kvstore_pull_bytes_total",
    "Payload bytes pulled out of the kvstore (per-device outs summed).",
    ("store",))


def _nbytes(v):
    """Payload bytes of one pushed or pulled value (an NDArray, a tensor,
    a sparse array, or a per-device list of them)."""
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    shape, dtype = getattr(v, "shape", None), getattr(v, "dtype", None)
    if shape is None or dtype is None:
        return 0
    import numpy as onp
    return int(onp.prod(shape)) * onp.dtype(str(dtype)).itemsize


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _clone(v):
    """A copy of a pushed value that shares nothing with it."""
    if isinstance(v, NDArray):
        return NDArray(v._data.detach().clone())
    return v.copy()


class KVStoreBase:
    """Registry base of the store classes."""

    kv_registry = {}

    @staticmethod
    def register(klass):
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass


class KVStore(KVStoreBase):
    """MXNet's push/pull API over one process's devices."""

    def __init__(self, name="local"):
        self.name = name
        self._updater = None
        self._optimizer = None
        self._data = {}
        self._compression = None

    # ---- core API ----------------------------------------------------
    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            v = v[0] if isinstance(v, (list, tuple)) else v
            self._data[k] = _clone(v)

    def push(self, key, value, priority=0):
        from ..ndarray.sparse import BaseSparseNDArray
        keys, values = self._normalize(key, value)
        nbytes = sum(_nbytes(v) for v in values)
        _PUSH_BYTES.inc(nbytes, store=self.name)
        flightrec.record("kv_push", store=self.name, keys=len(keys),
                         nbytes=nbytes)
        with spans.span("kvstore:push", store=self.name, nbytes=nbytes):
            for k, v in zip(keys, values):
                agg = self._aggregate(v, k)
                if self._updater is not None:
                    self._updater(_key_int(k), agg, self._data[k])
                else:
                    # the store holds dense values; a pushed sparse sum is
                    # densified when it is stored
                    if isinstance(agg, BaseSparseNDArray):
                        agg = agg.tostype("default")
                    self._data[k] = _clone(agg)

    @torch.no_grad()
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's value into its ``out`` (one array, or one per
        device), in place."""
        keys, outs = self._normalize(key, out)
        pulled = 0
        with spans.span("kvstore:pull", store=self.name):
            for k, o in zip(keys, outs):
                src = self._data[k]._data
                for oo in (o if isinstance(o, (list, tuple)) else [o]):
                    oo._data.copy_(src)
                    pulled += _nbytes(oo)
        # one inc a pull, not one an out tensor
        _PULL_BYTES.inc(pulled, store=self.name)
        flightrec.record("kv_pull", store=self.name, keys=len(keys),
                         nbytes=pulled)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    @torch.no_grad()
    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` into a ``RowSparseNDArray`` out;
        with a dense out, or no row_ids, a full pull."""
        from ..ndarray.sparse import RowSparseNDArray

        def _has_sparse(o):
            if isinstance(o, (list, tuple)):
                return any(_has_sparse(x) for x in o)
            return isinstance(o, RowSparseNDArray)

        if row_ids is None:
            if _has_sparse(out):
                raise ValueError("row_sparse_pull into a RowSparseNDArray "
                                 "requires row_ids")
            return self.pull(key, out, priority)
        keys, outs = self._normalize(key, out)
        for ki, (k, o) in enumerate(zip(keys, outs)):
            w = self._data[k]._data
            oo_list = o if isinstance(o, (list, tuple)) else [o]
            # row_ids pairs with the outs of each key, or with the keys, or
            # one spec serves all of them
            if isinstance(row_ids, (list, tuple)):
                if len(row_ids) == len(oo_list):
                    rid_list = list(row_ids)
                elif len(row_ids) == len(keys):
                    rid_list = [row_ids[ki]] * len(oo_list)
                else:
                    raise ValueError(
                        "row_ids (len %d) must pair with out (len %d) or "
                        "keys (len %d)" % (len(row_ids), len(oo_list),
                                           len(keys)))
            else:
                rid_list = [row_ids] * len(oo_list)
            for oo, rid in zip(oo_list, rid_list):
                rid_t = rid._data if isinstance(rid, NDArray) else \
                    torch.as_tensor(rid)
                rid_t = rid_t.to(w.device).long()
                if isinstance(oo, RowSparseNDArray):
                    oo.indices = NDArray(rid_t.to(torch.int32))
                    oo.data = NDArray(w[rid_t].clone())
                    oo._shape = tuple(w.shape)
                else:
                    oo._data.copy_(w)

    # ---- optimizer ----------------------------------------------------
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    @property
    def type(self):
        return self.name

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError("gradient compression "
                                  "(parallel/compression.py) " + _ITEM5)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "Cannot save states without an optimizer"
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        from .. import ndarray as nd
        nd.waitall()

    def set_server_profiler_state(self, state="stop", **config):
        raise NotImplementedError("the server's profiler comes with the "
                                  "dist stores and profiler.py (ROADMAP.md "
                                  "§1 items 3 and 5)")

    # ---- helpers -------------------------------------------------------
    def _normalize(self, key, value):
        if isinstance(key, (str, int)):
            return [key], [value]
        return list(key), list(value)

    def _aggregate(self, v, key):
        """The sum of a list of per-device values (sparse ones first), on
        the first value's device; a single value as it is."""
        from ..ndarray.sparse import BaseSparseNDArray
        if isinstance(v, (list, tuple)):
            if len(v) == 1:
                return v[0]
            v = sorted(v, key=lambda x: not isinstance(x, BaseSparseNDArray))
            acc = v[0]
            for x in v[1:]:
                if isinstance(acc, NDArray) and isinstance(x, NDArray):
                    x = NDArray(x._data.to(acc._data.device))
                acc = acc + x
            return acc
        return v


@KVStoreBase.register
class LocalKVStore(KVStore):
    """The 'local' / 'device' store."""


@KVStoreBase.register
class DistKVStore(KVStore):
    """'dist_sync' / 'dist_device_sync': waits for the multi-GPU slice."""

    def __init__(self, name="dist_sync"):
        raise NotImplementedError("kvstore %r %s" % (name, _ITEM5))


@KVStoreBase.register
class DistAsyncKVStore(DistKVStore):
    """'dist_async': waits for the multi-GPU slice."""

    def __init__(self, name="dist_async", staleness=None):
        raise NotImplementedError("kvstore %r %s" % (name, _ITEM5))


def create(name="local"):
    """A store by name: "local" or "device"; the ``dist*`` names raise,
    naming the slice that brings them."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name.startswith("dist_async") or name == "dist_device_async":
        return DistAsyncKVStore(name)
    if name.startswith("dist"):
        return DistKVStore(name)
    return LocalKVStore(name)
