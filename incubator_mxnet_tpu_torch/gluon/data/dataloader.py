"""DataLoader (counterpart of
``incubator_mxnet_tpu/gluon/data/dataloader.py``).

Batches are made on the host and moved to the caller's current context
(the card by default) once each:

- samples are read and batched (``batchify_fn``) under a ``cpu()``
  context, so transforms and ``nd.array`` stay on the host;
- ``num_workers=0`` batches in the caller's thread; ``thread_pool=True``
  (the default) in a thread pool that keeps ``prefetch`` batches (2 per
  worker by default) in flight; ``thread_pool=False`` in spawned process
  workers (never forked: a fork of a process holding CUDA state is not
  safe), which get the dataset and ``batchify_fn`` pickled once, see no
  CUDA device and return numpy batches;
- with ``pin_memory=True`` a batch lands in page-locked memory in the
  worker thread (``default_batchify_fn`` stacks straight into it; another
  ``batchify_fn``'s result is copied there) and goes to the card with a
  non-blocking copy, which overlaps the step running there; otherwise it
  is copied directly.

The order of the batches and their values are the JAX package's: the
same samplers (``RandomSampler`` draws from numpy's global generator) and
the same batching (a float64 or int64 array narrows to float32 or int32,
as the JAX package's arrays do).
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from queue import Queue

import numpy as onp
import torch

from ... import ndarray as nd
from ...context import as_device, cpu
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

_MP_DATASET = None
_MP_BATCHIFY = None


def _mp_init(ds_bytes, bf_bytes):
    global _MP_DATASET, _MP_BATCHIFY
    _MP_DATASET = pickle.loads(ds_bytes)
    _MP_BATCHIFY = pickle.loads(bf_bytes)


def _np_tree(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np_tree(i) for i in x)
    return onp.asarray(x)


def _mp_worker_fn(indices):
    """One batch in a process worker, as numpy (the parent uploads)."""
    with cpu():
        return _np_tree(_MP_BATCHIFY([_MP_DATASET[i] for i in indices]))


def _nd_tree(x):
    if isinstance(x, dict):
        return {k: _nd_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_nd_tree(i) for i in x)
    return nd.array(x, ctx=cpu())


def _tree(fn, x):
    """``fn`` of every NDArray in a batch (a list, tuple or dict of
    them)."""
    if isinstance(x, NDArray):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, i) for i in x)
    return x


def _pin(a):
    return NDArray(a._data.pin_memory())


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays with ``nd.stack``, tuples field
    by field, anything else through numpy."""
    return _batchify(data, False)


def _batchify(data, pin):
    """``default_batchify_fn``; with ``pin``, NDArray samples are stacked
    straight into page-locked memory (one copy, not two)."""
    if isinstance(data[0], NDArray):
        if not pin:
            return nd.stack(*data, axis=0)
        first = data[0]._data
        out = torch.empty((len(data),) + tuple(first.shape),
                          dtype=first.dtype, pin_memory=True)
        return NDArray(torch.stack([d._data for d in data], out=out))
    if isinstance(data[0], tuple):
        return [_batchify(i, pin) for i in zip(*data)]
    out = nd.array(onp.asarray(data))
    return _pin(out) if pin else out


class DataLoader:
    """Batches of ``dataset`` on the current context (see the module's
    docstring)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True, timeout=120):
        self._mp_pool = None  # before any raise: __del__ reads it
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None \
                or last_batch:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * num_workers)

    def _make_batch(self, indices):
        """One batch on the host (pinned with ``pin_memory`` where there
        is a card to copy to)."""
        pin = self._pin_memory and torch.cuda.is_available()
        with cpu():
            samples = [self._dataset[i] for i in indices]
            if self._batchify_fn is default_batchify_fn:
                return _batchify(samples, pin)
            batch = self._batchify_fn(samples)
        return _tree(_pin, batch) if pin else batch

    def _to_context(self, batch, device):
        """The host batch on ``device``: one copy of each array,
        non-blocking from pinned memory."""
        if device.type == "cpu":
            return batch
        return _tree(lambda a: NDArray(a._data.to(
            device, non_blocking=self._pin_memory)), batch)

    def __iter__(self):
        device = as_device(None)
        for batch in self._host_batches():
            yield self._to_context(batch, device)

    def _host_batches(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        if not self._thread_pool:
            yield from self._iter_multiprocess()
            return
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = Queue()
            batches = iter(self._batch_sampler)

            def submit_next():
                try:
                    b = next(batches)
                except StopIteration:
                    return False
                futures.put(pool.submit(self._make_batch, b))
                return True

            live = 0
            for _ in range(max(1, self._prefetch)):
                if not submit_next():
                    break
                live += 1
            while live:
                f = futures.get()
                live -= 1
                if submit_next():
                    live += 1
                yield f.result()

    def _get_mp_pool(self):
        """The spawned worker pool, made at first use. The workers see no
        CUDA device: they never initialise CUDA."""
        if self._mp_pool is None:
            import multiprocessing
            ctx = multiprocessing.get_context("spawn")
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                self._mp_pool = ctx.Pool(
                    self._num_workers, initializer=_mp_init,
                    initargs=(pickle.dumps(self._dataset),
                              pickle.dumps(self._batchify_fn)))
            finally:
                if saved is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved
        return self._mp_pool

    def _iter_multiprocess(self):
        """Process workers, in order, with a bounded window in flight."""
        pool = self._get_mp_pool()
        batches = iter(self._batch_sampler)
        inflight = []

        def submit_next():
            try:
                b = next(batches)
            except StopIteration:
                return False
            inflight.append(pool.apply_async(_mp_worker_fn, (list(b),)))
            return True

        for _ in range(max(2, self._prefetch)):
            if not submit_next():
                break
        while inflight:
            out = inflight.pop(0).get(self._timeout)
            submit_next()
            batch = _nd_tree(out)
            if self._pin_memory and torch.cuda.is_available():
                batch = _tree(_pin, batch)
            yield batch

    def close(self):
        """Stop the process workers, if any."""
        if self._mp_pool is not None:
            self._mp_pool.terminate()
            self._mp_pool.join()
            self._mp_pool = None

    def __del__(self):
        if self._mp_pool is not None:
            try:
                self._mp_pool.terminate()
            except Exception:
                pass  # interpreter shutdown: the pool is already torn down

    def __len__(self):
        return len(self._batch_sampler)
