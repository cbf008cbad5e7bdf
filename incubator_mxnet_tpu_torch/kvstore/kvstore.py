"""KVStore implementations (counterpart of
``incubator_mxnet_tpu/kvstore/kvstore.py``): ``KVStoreBase``, ``KVStore``,
``LocalKVStore`` ("local", "device"), ``DistKVStore`` ("dist_sync",
"dist_device_sync"), ``DistAsyncKVStore`` ("dist_async") and ``create``.

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
as the JAX package's. ``set_gradient_compression`` makes every dense
value pushed go through 2-bit compression with error feedback
(``parallel.compression``), keyed by the store key (and the device's
position in a list); a row-sparse value pushed into a compressing store is
refused, as MXNet refuses it.

The dist stores run over the ``torch.distributed`` process group
(``parallel.dist``): see ``DistKVStore`` and ``DistAsyncKVStore``.
"""
from __future__ import annotations

import time

import torch

from .. import optimizer as opt
from .. import telemetry
from ..ndarray import NDArray
from ..telemetry import flightrec, spans

__all__ = ["KVStore", "KVStoreBase", "create", "LocalKVStore", "DistKVStore",
           "DistAsyncKVStore"]

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
        """Compress every dense value pushed from now on (``{"type":
        "2bit", "threshold": t}``)."""
        from ..parallel.compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

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
        """MXNet's workers command the servers' profiler. There is no
        server process here: the aggregation and the updates a server ran
        run in every worker, so the command drives this process's
        ``profiler``."""
        from .. import profiler
        if config:
            profiler.set_config(**config)
        profiler.set_state(state)

    # ---- helpers -------------------------------------------------------
    def _normalize(self, key, value):
        if isinstance(key, (str, int)):
            return [key], [value]
        return list(key), list(value)

    def _aggregate(self, v, key):
        """The sum of a list of per-device values (sparse ones first), on
        the first value's device; a single value as it is. With
        compression each dense value is compressed first, under ``key``
        (``(key, i)`` for the i-th of a list)."""
        from ..ndarray.sparse import BaseSparseNDArray

        def compress(x, k):
            if self._compression is None:
                return x
            if isinstance(x, BaseSparseNDArray):
                raise ValueError(
                    "2-bit gradient compression takes dense values only: "
                    "a %s value was pushed to key %r" % (x.stype, key))
            return self._compression.compress_decompress(x, k)

        if isinstance(v, (list, tuple)):
            v = [compress(x, (key, i)) for i, x in enumerate(v)]
            if len(v) == 1:
                return v[0]
            v = sorted(v, key=lambda x: not isinstance(x, BaseSparseNDArray))
            acc = v[0]
            for x in v[1:]:
                if isinstance(acc, NDArray) and isinstance(x, NDArray):
                    x = NDArray(x._data.to(acc._data.device))
                acc = acc + x
            return acc
        return compress(v, key)


@KVStoreBase.register
class LocalKVStore(KVStore):
    """The 'local' / 'device' store."""


def _group():
    """Whether a torch.distributed process group is up."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _tensor(v):
    return v._data if isinstance(v, NDArray) else v


@KVStoreBase.register
class DistKVStore(KVStore):
    """'dist_sync' / 'dist_device_sync' over the ``torch.distributed``
    process group (``parallel.dist``).

    MXNet's parameter servers become symmetric workers, as in the JAX
    package: ``init`` broadcasts rank 0's value to every worker; ``push``
    sums each value over this process's devices (compressing first, when
    compression is set), then over the processes, and the optimizer set by
    ``set_optimizer`` runs in every worker on the same sum, as MXNet's
    server would run it once. A row-sparse value is summed densely.

    The sum over processes is one all-gather per dtype of the call's dense
    values concatenated (a value of ``MXTPU_KVSTORE_BIGARRAY_BOUND``
    elements or more gets its own), then the gathered rows added on this
    process's device in rank order, (r0 + r1) + r2 …: the order in which
    the JAX package adds the gathered values on the host, so every worker
    ends with the same bits, and with the JAX package's sums (exact where
    the values and their partial sums are exactly representable).

    Without a process group (one process) the store is the local store.
    With a group of one process (a caller that asked ``init_distributed``
    for a backend), its collectives run all the same: the sums are the
    values, and the backend's path is exercised.

    ``collective_stats`` counts the collectives, the bytes this process
    sent into them and their seconds on the host clock (the all-gathers,
    the broadcasts and the rank-order sums, which wait for the gathered
    values).
    """

    def __init__(self, name="dist_sync"):
        super().__init__(name)
        from ..parallel import dist
        self._group = _group()
        self._rank = dist.rank()
        self._num_workers = dist.num_workers()
        self.collective_stats = dict(collectives=0, bytes=0, seconds=0.0)

    def _count(self, t0, nbytes):
        st = self.collective_stats
        st["collectives"] += 1
        st["bytes"] += nbytes
        st["seconds"] += time.perf_counter() - t0

    @torch.no_grad()
    def init(self, key, value):
        from ..ndarray.sparse import BaseSparseNDArray
        import torch.distributed as dist
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            v = v[0] if isinstance(v, (list, tuple)) else v
            if isinstance(v, BaseSparseNDArray):
                v = v.tostype("default")
            t = _tensor(v).detach().clone()
            if self._group:
                t0 = time.perf_counter()
                dist.broadcast(t, src=0)
                self._count(t0, t.numel() * t.element_size())
            self._data[k] = NDArray(t)

    def push(self, key, value, priority=0):
        if not self._group:
            return super().push(key, value, priority)
        keys, values = self._normalize(key, value)
        nbytes = sum(_nbytes(v) for v in values)
        _PUSH_BYTES.inc(nbytes, store=self.name)
        flightrec.record("kv_push", store=self.name, keys=len(keys),
                         nbytes=nbytes)
        with spans.span("kvstore:push", store=self.name, nbytes=nbytes):
            return self._push_sync(keys, values)

    def _push_sync(self, keys, values):
        from ..ndarray.sparse import BaseSparseNDArray
        # this process's sum (and compression) first
        local = [KVStore._aggregate(self, v, k) for k, v in zip(keys, values)]
        dense = [i for i, a in enumerate(local)
                 if not isinstance(a, BaseSparseNDArray)]
        summed = self._cross_sum_batch([local[i] for i in dense])
        for i, s in zip(dense, summed):
            local[i] = s
        for k, agg in zip(keys, local):
            if isinstance(agg, BaseSparseNDArray):
                agg = self._cross_sum_batch([agg.tostype("default")])[0]
            if self._updater is not None:
                self._updater(_key_int(k), agg, self._data[k])
            else:
                self._data[k] = _clone(agg)

    @torch.no_grad()
    def _cross_sum_batch(self, args):
        """Each dense value (NDArray or tensor) summed over the processes:
        one all-gather per dtype (and one per value at or above
        ``MXTPU_KVSTORE_BIGARRAY_BOUND`` elements), the rows added in rank
        order. Each output keeps its input's kind, dtype and device."""
        import torch.distributed as dist
        from ..config import get_env
        if not args or not self._group:
            return list(args)
        bound = get_env("MXTPU_KVSTORE_BIGARRAY_BOUND")
        groups = {}
        for i, a in enumerate(args):
            t = _tensor(a)
            groups.setdefault((str(t.dtype), i if t.numel() >= bound
                               else -1), []).append(i)
        out = list(args)
        for _, idxs in sorted(groups.items()):
            flats = [_tensor(args[i]).detach().reshape(-1) for i in idxs]
            cat = torch.cat(flats) if len(flats) > 1 else \
                flats[0].contiguous()
            t0 = time.perf_counter()
            rows = [torch.empty_like(cat) for _ in range(self._num_workers)]
            dist.all_gather(rows, cat)
            acc = rows[0]
            for r in rows[1:]:
                acc = acc + r
            self._count(t0, cat.numel() * cat.element_size())
            off = 0
            for i, f in zip(idxs, flats):
                seg = acc[off:off + f.numel()].reshape(_tensor(args[i]).shape)
                off += f.numel()
                out[i] = NDArray(seg.clone()) if isinstance(args[i], NDArray) \
                    else seg.clone()
        return out

    def barrier(self):
        """Wait for every process (and this one's device)."""
        import torch.distributed as dist
        if self._group:
            dist.barrier()
        super().barrier()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers


@KVStoreBase.register
class DistAsyncKVStore(DistKVStore):
    """'dist_async': bounded-staleness local SGD, the JAX package's
    counterpart of MXNet's asynchronous parameter server (and of P3's
    priority propagation).

    ``push`` applies the update on this process alone, with no exchange:
    workers run at their own pace, as asynchronous workers against a stale
    server copy. Every ``staleness`` pushes of a key
    (``MXTPU_ASYNC_STALENESS``, default 4) the workers average that key
    across processes, which bounds how far they drift apart.

    The average is a collective every worker must reach:

    * in lockstep (the default) the workers run the same push loop and meet
      at the same staleness boundaries;
    * with uneven shards, ``begin_epoch(local_steps)`` at each epoch's
      start (every worker present) gathers the planned step counts and
      caps this epoch's averaging rounds at ``min(steps) // staleness``, a
      schedule every worker can keep; pushes past the cap stay local, and
      ``sync()`` at the epoch's end averages everything. ``Module.fit``
      makes both calls when its iterator has a length.

    P3's ordering: the keys due are averaged by priority class, highest
    first, each class in slices of at most ``MXTPU_P3_SLICE`` elements
    (small keys share a slice batch up to the same bound), so a later
    layer's average never waits behind one huge tensor. Each key keeps its
    dtype.
    """

    def __init__(self, name="dist_async", staleness=None):
        super().__init__(name)
        if staleness is None:
            from ..config import get_env
            staleness = get_env("MXTPU_ASYNC_STALENESS") or 4
        self._staleness = max(1, int(staleness))
        self._push_count = {}
        self._key_priority = {}
        self._round_budget = None
        self._rounds_done = {}

    def begin_epoch(self, local_steps):
        """Agree on this epoch's averaging rounds (call on every worker at
        the epoch's start with its own planned push count); returns them."""
        import torch.distributed as dist
        local_steps = int(local_steps)
        min_steps = local_steps
        if self._group:
            t = torch.tensor([local_steps], dtype=torch.int64)
            rows = [torch.empty_like(t) for _ in range(self._num_workers)]
            t0 = time.perf_counter()
            dist.all_gather(rows, t)
            self._count(t0, t.element_size())
            min_steps = int(torch.cat(rows).min())
        self._round_budget = min_steps // self._staleness
        self._rounds_done = {}
        self._push_count = {}
        return self._round_budget

    def push(self, key, value, priority=0):
        """Apply locally; average the keys whose staleness window closed.
        ``priority`` is one number or one per key."""
        KVStore.push(self, key, value, priority)
        keys, _ = self._normalize(key, value)
        if isinstance(priority, (list, tuple)):
            if len(priority) != len(keys):
                raise ValueError("priority list length %d != %d keys"
                                 % (len(priority), len(keys)))
            prios = list(priority)
        else:
            prios = [priority] * len(keys)
        due = []
        for k, pr in zip(keys, prios):
            # the first push sets the priority, later ones keep the highest
            self._key_priority[k] = pr if k not in self._key_priority \
                else max(self._key_priority[k], pr)
            c = self._push_count.get(k, 0) + 1
            self._push_count[k] = c
            if c >= self._staleness:
                if self._round_budget is not None and \
                        self._rounds_done.get(k, 0) >= self._round_budget:
                    continue
                self._rounds_done[k] = self._rounds_done.get(k, 0) + 1
                due.append(k)
        if due:
            self._sync_keys(due)

    def sync(self):
        """Average every key now (an epoch or checkpoint boundary, every
        worker present); ends the epoch's schedule."""
        self._round_budget = None
        self._rounds_done = {}
        self._sync_keys(list(self._data))

    def _sync_keys(self, keys):
        for k in keys:
            self._push_count[k] = 0
        if not self._group:
            return
        groups = {}
        for k in keys:
            groups.setdefault(self._key_priority.get(k, 0), []).append(k)
        for pr in sorted(groups, reverse=True):
            self._average_batch(groups[pr])

    @torch.no_grad()
    def _average_batch(self, keys):
        """Average ``keys`` over the processes in slices of at most
        ``MXTPU_P3_SLICE`` elements, batched in order up to the same
        bound; each key's value is written back in place, in its dtype."""
        from ..config import get_env
        bound = max(1, get_env("MXTPU_P3_SLICE"))
        inv = 1.0 / self._num_workers
        flats = {k: self._data[k]._data.reshape(-1) for k in keys}
        slices = []
        for k in keys:
            n = flats[k].numel()
            for s in range(0, max(n, 1), bound):
                slices.append((k, s, min(s + bound, n)))
        batch, batch_n, batches = [], 0, []
        for item in slices:
            ln = item[2] - item[1]
            if batch and batch_n + ln > bound:
                batches.append(batch)
                batch, batch_n = [], 0
            batch.append(item)
            batch_n += ln
        if batch:
            batches.append(batch)
        out = {k: torch.empty_like(flats[k]) for k in keys}
        for b in batches:
            summed = self._cross_sum_batch([flats[k][s:e] for k, s, e in b])
            for (k, s, e), v in zip(b, summed):
                out[k][s:e] = v * inv
        for k in keys:
            self._data[k]._data.copy_(out[k].reshape(self._data[k].shape))


def create(name="local"):
    """A store by name: "local"/"device", "dist_sync"/"dist_device_sync"
    (``DistKVStore``), "dist_async" (``DistAsyncKVStore``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name.startswith("dist_async") or name == "dist_device_async":
        return DistAsyncKVStore(name)
    if name.startswith("dist"):
        return DistKVStore(name)
    return LocalKVStore(name)
