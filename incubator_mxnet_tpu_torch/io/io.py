"""Data iterators (counterpart of ``incubator_mxnet_tpu/io/io.py``).

``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter``, ``ImageRecordIter``, ``MNISTIter``, ``CSVIter``,
``LibSVMIter`` and ``ImageDetRecordIter``. They hand out host (``cpu()``)
arrays, as MXNet's iterators do: the Module's executor copies each batch
to its device. Where CUDA is available ``NDArrayIter`` gathers each batch
into pinned host memory, so that copy does not block.

``ImageRecordIter`` has the JAX package's three tiers: the native C++
pipeline (``native/src/image.cc``: JPEG decode, augmentation and NCHW
assembly in C++ threads), the native record reader with PIL decode in a
thread pool, and the Python path; the tier is chosen by the JAX package's
rules (``force_python``, 3 channels, JPEG payloads, ``MXTPU_NO_NATIVE``).

The input pipeline's stalls are counted as in the JAX package:
``mxtpu_io_wait_seconds_total{iter}`` (seconds the consumer spent blocked
in ``next()``) and ``mxtpu_io_batches_total{iter}`` (batches handed out),
by ``PrefetchingIter`` (its queue wait, with an ``io_wait`` flight record)
and ``ImageRecordIter`` (the whole synchronous decode). A prefetching
thread heartbeats its own ``io_prefetch:<thread id>`` watchdog channel,
and the iterators it drives count no wait on that thread: their work
overlaps the consumer's, it is not the consumer's wait.
"""
from __future__ import annotations

import threading
import time as _time
from collections import namedtuple
from queue import Queue

import numpy as onp
import torch

from .. import ndarray as nd
from .. import telemetry
from ..context import cpu
from ..ndarray import NDArray
from ..telemetry import flightrec, watchdog

# Seconds the consumer (the training loop) spends blocked waiting for the
# next batch, by iterator class: a wait rate near the step rate means the
# input pipeline, not the card, sets the epoch time.
_IO_WAIT_SECONDS = telemetry.counter(
    "mxtpu_io_wait_seconds_total",
    "Seconds the consumer spent blocked in next() waiting for a batch.",
    ("iter",))
_IO_BATCHES = telemetry.counter(
    "mxtpu_io_batches_total", "Batches delivered to the consumer.",
    ("iter",))

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "MNISTIter", "CSVIter",
           "LibSVMIter", "ImageDetRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: data and label lists, the pad, the bucket key."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None, bucket_key=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        if bucket_key is not None:  # a bucketed batch
            self.bucket_key = bucket_key


class DataIter:
    """The iterator protocol of MXNet's data iterators."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """[(name, NDArray)] from an array, a list or a dict of them."""
    if data is None:
        assert allow_empty
        return []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    out = []
    for k, v in dict(data).items():
        if not isinstance(v, NDArray):
            v = nd.array(v, ctx=cpu())
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches over in-memory arrays ("pad", "discard" or "roll_over" the
    last batch); ``shuffle`` draws from numpy's global generator."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = onp.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor + self.batch_size <= self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrs):
        lo = self.cursor
        hi = min(lo + self.batch_size, self.num_data)
        sel = self.idx[lo:hi]
        pad = self.batch_size - (hi - lo)
        if pad:
            sel = onp.concatenate([sel, self.idx[:pad]])
        return [_gather(v._data, sel) for _, v in arrs]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        hi = self.cursor + self.batch_size
        return max(0, hi - self.num_data)


class ResizeIter(DataIter):
    """An iterator resized to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label


class PrefetchingIter(DataIter):
    """Batches of another iterator read ahead by a thread."""

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        assert len(iters) == 1, "single-iter prefetching (composite deferred)"
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    def _mark_producer_chain(self, ident):
        """Tag the wrapped chain (``ResizeIter.data_iter``,
        ``CSVIter._inner``, ...) with the producer thread's ident: an inner
        iterator's ``next()`` on that thread is overlapped work, not the
        consumer's wait. Compared at call time, so the same iterator used
        directly by a consumer later counts again."""
        inner, hops = self.iter, 0
        while inner is not None and hops < 16:
            inner._io_wait_suppressed_ident = ident
            inner = getattr(inner, "data_iter", None) \
                or getattr(inner, "_inner", None)
            hops += 1

    def _start(self):
        def run():
            # a channel a producer thread: silence means it is stuck
            # decoding or blocked on a full queue (the consumer stopped
            # taking batches), which the stall report's stacks tell apart
            channel = watchdog.register(
                "io_prefetch:%x" % threading.get_ident())
            try:
                self._mark_producer_chain(threading.get_ident())
                while not self._stop.is_set():
                    watchdog.heartbeat(channel)
                    try:
                        batch = self.iter.next()
                    except StopIteration:
                        self._queue.put(None)
                        return
                    self._queue.put(batch)
            finally:
                watchdog.unregister(channel)   # an ended epoch is no stall
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._stop.clear()
        self.iter.reset()
        self._start()

    def next(self):
        # the queue wait is the pipeline's stall: ~0 while the producer
        # keeps up, the whole decode when it does not
        t0 = _time.perf_counter()
        batch = self._queue.get()
        wait_s = _time.perf_counter() - t0
        _IO_WAIT_SECONDS.inc(wait_s, iter="PrefetchingIter")
        flightrec.record("io_wait", iter="PrefetchingIter",
                         dur_s=round(wait_s, 6))
        if batch is None:
            raise StopIteration
        _IO_BATCHES.inc(iter="PrefetchingIter")
        return batch

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label


def _payload_is_jpeg(path):
    """Whether the first record is an IRHeader (flag u32, label f32, id
    u64 x 2: 24 bytes, then ``flag`` extra label floats) before JPEG's SOI
    bytes."""
    import struct
    from .. import recordio
    r = recordio.MXRecordIO(path, "r")
    try:
        raw = r.read()
    finally:
        r.close()
    if raw is None or len(raw) < 26:
        return False
    flag = struct.unpack("<I", raw[:4])[0]
    off = 24 + 4 * flag
    return raw[off:off + 2] == b"\xff\xd8"


class ImageRecordIter(DataIter):
    """MXNet's RecordIO image pipeline: reads a .rec (and its .idx),
    decodes, augments and assembles NCHW float batches on the host, through
    one of three tiers. Tier 1, the native pipeline (3 channels, JPEG
    payloads): decode, resize, crop, mirror and normalisation in C++
    threads. Tier 2, the native reader: C++ read-ahead, PIL decode in a
    thread pool (``preprocess_threads``). Tier 3 (``force_python``, or
    ``MXTPU_NO_NATIVE``, or no ``g++``): Python reads and PIL decodes. The
    native tiers wrap the last batch around with records from the start
    and report them as ``pad``. ``num_parts``/``part_index`` shard the
    file."""

    def __init__(self, path_imgrec=None, data_shape=(3, 224, 224), batch_size=1,
                 label_width=1, shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, rand_crop=False, rand_mirror=False,
                 num_parts=1, part_index=0, preprocess_threads=None, round_batch=True,
                 seed=0, path_imgidx=None, prefetch_buffer=2, resize=0,
                 force_python=False, dtype="float32", **kwargs):
        super().__init__(batch_size)
        import os
        from concurrent.futures import ThreadPoolExecutor
        from .. import recordio
        if preprocess_threads is None:
            from ..config import get_env
            preprocess_threads = get_env("MXTPU_CPU_WORKER_NTHREADS")
        from ..native import lib as native
        self._path = path_imgrec
        self._pipe_batch = 0
        self._native_pipe = self._native = None
        if not force_python and native.available():
            if data_shape[0] == 3 and _payload_is_jpeg(path_imgrec):
                self._native_pipe = native.NativeImagePipeline(
                    path_imgrec, batch_size, data_shape,
                    label_width=label_width, resize_short=resize,
                    rand_crop=rand_crop, rand_mirror=rand_mirror,
                    mean_rgb=(mean_r, mean_g, mean_b),
                    std_rgb=(std_r, std_g, std_b), shuffle=shuffle,
                    seed=seed, num_threads=preprocess_threads,
                    part_index=part_index, num_parts=num_parts)
            else:
                self._native = native.NativeBatchReader(
                    path_imgrec, batch_size, shuffle=shuffle, seed=seed,
                    num_threads=max(1, preprocess_threads // 2),
                    part_index=part_index, num_parts=num_parts)
        if path_imgidx is None and path_imgrec is not None:
            guess = path_imgrec[: path_imgrec.rfind(".")] + ".idx"
            path_imgidx = guess if os.path.exists(guess) else None
        if path_imgidx:
            self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            keys = self._rec.keys
        else:
            self._rec = recordio.MXRecordIO(path_imgrec, "r")
            keys = None
            # sequential scan to index record offsets
            offsets = []
            while True:
                pos = self._rec.tell()
                if self._rec.read() is None:
                    break
                offsets.append(pos)
            self._offsets = offsets
        self._keys = keys
        n = len(keys) if keys is not None else len(self._offsets)
        shard = n // num_parts
        self._lo = part_index * shard
        self._hi = n if part_index == num_parts - 1 else self._lo + shard
        self._order = onp.arange(self._lo, self._hi)
        self._shuffle = shuffle
        self._rng = onp.random.RandomState(seed)
        self._data_shape = tuple(data_shape)
        self._label_width = label_width
        self._mean = onp.array([mean_r, mean_g, mean_b], dtype="float32").reshape(3, 1, 1)
        self._std = onp.array([std_r, std_g, std_b], dtype="float32").reshape(3, 1, 1)
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        # dtype="uint8": raw 0..255 pixels (a quarter of the bytes to the
        # device; the model normalizes), so no mean/std here
        self._out_dtype = dtype
        if dtype == "uint8":
            assert not self._mean.any() and (self._std == 1).all(), \
                "dtype='uint8' ships raw pixels; fold mean/std into the model"
        self._pool = ThreadPoolExecutor(max_workers=preprocess_threads)
        self._rec_lock = threading.Lock()
        self._cursor = 0
        self._round = round_batch
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape)]

    @property
    def tier(self):
        """1 (native pipeline), 2 (native reader, PIL decode) or 3
        (Python)."""
        return 1 if self._native_pipe is not None else \
            2 if self._native is not None else 3

    def reset(self):
        self._pipe_batch = 0
        for native in (self._native_pipe, self._native):
            if native is not None:
                native.reset(reshuffle=self._shuffle)
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _read_record(self, i):
        from .. import recordio
        # seek+read must be atomic: decode workers share ONE file handle
        with self._rec_lock:
            if self._keys is not None:
                raw = self._rec.read_idx(self._keys[i])
            else:
                self._rec.record.seek(self._offsets[i])
                raw = self._rec.read()
        header, img = recordio.unpack_img(raw, iscolor=1)
        return header, img

    def _process(self, i):
        header, img = self._read_record(i)
        return self._augment(header, img)

    def _augment(self, header, img):
        c, h, w = self._data_shape
        ih, iw = img.shape[:2]
        if self._rand_crop and ih > h and iw > w:
            y0 = self._rng.randint(0, ih - h + 1)
            x0 = self._rng.randint(0, iw - w + 1)
            img = img[y0:y0 + h, x0:x0 + w]
        elif ih != h or iw != w:
            from PIL import Image
            img = onp.asarray(Image.fromarray(img).resize((w, h)))
        if img.ndim == 2:
            img = onp.stack([img] * 3, axis=-1)
        if self._rand_mirror and self._rng.rand() < 0.5:
            img = img[:, ::-1]
        chw = img.transpose(2, 0, 1).astype("float32")
        chw = (chw - self._mean) / self._std
        label = header.label if onp.ndim(header.label) else float(header.label)
        return chw, label

    def _decode_payload(self, raw):
        from .. import recordio
        return self._augment(*recordio.unpack_img(raw, iscolor=1))

    def _native_pad(self, native):
        """The wrapped records of the epoch's last batch (0 before it)."""
        if self._pipe_batch != native.num_batches:
            return 0
        return (self.batch_size - native.num_records % self.batch_size) \
            % self.batch_size

    def next(self):
        # a synchronous decode: all of next() is the consumer's wait
        # (PrefetchingIter overlaps it with the step), except on a
        # PrefetchingIter's producer thread
        if getattr(self, "_io_wait_suppressed_ident", None) \
                == threading.get_ident():
            return self._next_impl()
        t0 = _time.perf_counter()
        batch = self._next_impl()
        _IO_WAIT_SECONDS.inc(_time.perf_counter() - t0,
                             iter=type(self).__name__)
        _IO_BATCHES.inc(iter=type(self).__name__)
        return batch

    def _next_impl(self):
        if self._native_pipe is not None:
            got = self._native_pipe.next()
            if got is None:
                raise StopIteration
            data, labels, bad = got
            self._pipe_batch += 1       # the pipeline consumed the batch
            if bad:
                raise IOError(
                    "%d undecodable record(s) in %s (corrupt JPEG data); the "
                    "native pipeline fails as the Python path does"
                    % (bad, self._path))
            if self._label_width == 1:
                labels = labels[:, 0]
            # the pipeline reuses its buffers: nd.array copies
            return DataBatch([nd.array(self._cast_out(data), ctx=cpu())],
                             [nd.array(labels, ctx=cpu())],
                             pad=self._native_pad(self._native_pipe))
        if self._native is not None:
            payloads = self._native.next()
            if payloads is None:
                raise StopIteration
            self._pipe_batch += 1
            results = list(self._pool.map(self._decode_payload, payloads))
            data = onp.stack([r[0] for r in results])
            return DataBatch([nd.array(self._cast_out(data), ctx=cpu())],
                             [self._stack_labels(results)],
                             pad=self._native_pad(self._native))
        n = self._hi - self._lo
        if self._cursor >= n:
            raise StopIteration
        idxs = []
        for j in range(self.batch_size):
            k = self._cursor + j
            if k >= n:
                k = k % n if self._round else n - 1
            idxs.append(self._order[k % n])
        pad = max(0, self._cursor + self.batch_size - n)
        self._cursor += self.batch_size
        results = list(self._pool.map(self._process, idxs))
        data = onp.stack([r[0] for r in results])
        return DataBatch([nd.array(self._cast_out(data), ctx=cpu())],
                         [self._stack_labels(results)], pad=pad)

    def _cast_out(self, data):
        """dtype="uint8": raw pixels, a quarter of the bytes to copy."""
        if self._out_dtype == "uint8":
            return onp.clip(data, 0, 255).astype(onp.uint8)
        return data

    def _stack_labels(self, results):
        labels = onp.asarray([onp.ravel(r[1])[:self._label_width] if
                              onp.ndim(r[1]) else r[1] for r in results],
                             dtype="float32")
        return nd.array(labels, ctx=cpu())


class MNISTIter(NDArrayIter):
    """MNIST as (N, 1, 28, 28) in [0, 1] (or flat), over the port's MNIST
    (local files, else the JAX package's seeded stand-in, bit for bit)."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, **kwargs):
        from ..gluon.data.vision import MNIST
        ds = MNIST(train=True)
        imgs = ds._data.asnumpy().astype("float32") / 255.0
        labels = onp.asarray(ds._label, dtype="float32")
        imgs = imgs.reshape(len(labels), -1) if flat else \
            imgs.transpose(0, 3, 1, 2)
        super().__init__(imgs, labels, batch_size, shuffle)


class CSVIter(DataIter):
    """A CSV file as fixed-shape batches."""

    def __init__(self, data_csv=None, data_shape=None, label_csv=None,
                 label_shape=(1,), batch_size=1, **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype="float32", ndmin=2)
        self._data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            lbl = onp.loadtxt(label_csv, delimiter=",", dtype="float32", ndmin=2)
            self._label = lbl.reshape((-1,) + tuple(label_shape))
        else:
            self._label = onp.zeros((len(self._data), 1), "float32")
        self._inner = NDArrayIter(self._data, self._label, batch_size,
                                  last_batch_handle="discard")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label


class LibSVMIter(DataIter):
    """libsvm text ("label idx:val ...") as CSR batches (``CSRNDArray``
    data on the host). Feature indices are 0-based; ``indexing_mode=1`` reads
    1-based files."""

    def __init__(self, data_libsvm=None, data_shape=None, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 indexing_mode=0, **kwargs):
        super().__init__(batch_size)
        self._round = round_batch
        if tuple(label_shape) != (1,):
            raise NotImplementedError(
                "LibSVMIter supports scalar labels (label_shape=(1,))")
        from ..ndarray import sparse as _sp
        self._sp = _sp
        n_feat = data_shape[0] if isinstance(data_shape, (tuple, list)) \
            else int(data_shape)
        self._n_feat = n_feat
        labels, rows = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = []
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    col = int(k) - indexing_mode
                    if not 0 <= col < n_feat:
                        raise ValueError(
                            "libsvm feature index %s out of range [0, %d) — "
                            "1-based files need indexing_mode=1" % (k, n_feat))
                    row.append((col, float(v)))
                rows.append(row)
        if label_libsvm is not None:
            with open(label_libsvm) as lf:
                labels = [float(l.split()[0]) for l in lf if l.strip()]
            if len(labels) != len(rows):
                raise ValueError(
                    "label file has %d rows but data file has %d"
                    % (len(labels), len(rows)))
        self._rows = rows
        self._labels = onp.asarray(labels, "float32")
        self._cursor = 0
        self._n = len(rows)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._n_feat))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= self._n:
            raise StopIteration
        idxs = []
        for j in range(self.batch_size):
            k = self._cursor + j
            if k >= self._n:
                # round_batch wraps to the head; otherwise repeat the tail
                k = k % self._n if self._round else self._n - 1
            idxs.append(k)
        pad = max(0, self._cursor + self.batch_size - self._n)
        self._cursor += self.batch_size
        data, cols, indptr = [], [], [0]
        for i in idxs:
            for k, v in self._rows[i]:
                cols.append(k)
                data.append(v)
            indptr.append(len(cols))
        csr = self._sp.CSRNDArray(
            onp.asarray(data, "float32"), onp.asarray(cols, "int32"),
            onp.asarray(indptr, "int32"), (self.batch_size, self._n_feat),
            ctx=cpu())
        label = nd.array(self._labels[idxs], ctx=cpu())
        return DataBatch([csr], [label], pad=pad)


class ImageDetRecordIter(ImageRecordIter):
    """Detection records: the extra label section holds [header_width,
    obj_width, (id, xmin, ymin, xmax, ymax) * n_obj] normalized boxes;
    labels are padded to (batch, label_pad, obj_width) and the boxes flip
    with the image when rand_mirror fires."""

    def __init__(self, label_pad_width=16, object_width=5, **kwargs):
        self._label_pad = label_pad_width
        self._obj_width = object_width
        kwargs.setdefault("label_width", label_pad_width * object_width)
        kwargs["force_python"] = True
        super().__init__(**kwargs)

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size, self._label_pad,
                                   self._obj_width))]

    def _augment(self, header, img):
        ow = self._obj_width
        lab = onp.asarray(header.label, "float32").ravel()
        if lab.size >= 2 and lab.size > ow:
            hw, obj_w = int(lab[0]), int(lab[1])
            objs = lab[hw:]
            objs = objs[: (objs.size // obj_w) * obj_w].reshape(-1, obj_w)
            objs = objs.copy()  # header label views can be read-only
        else:
            objs = onp.zeros((0, ow), "float32")
        mirrored = self._rand_mirror and self._rng.rand() < 0.5
        c, h, w = self._data_shape
        ih, iw = img.shape[:2]
        if ih != h or iw != w:
            from PIL import Image
            img = onp.asarray(Image.fromarray(img).resize((w, h)))
        if img.ndim == 2:
            img = onp.stack([img] * 3, axis=-1)
        if mirrored:
            img = img[:, ::-1]
            if len(objs):
                x1 = objs[:, 1].copy()
                objs[:, 1] = 1.0 - objs[:, 3]
                objs[:, 3] = 1.0 - x1
        chw = img.transpose(2, 0, 1).astype("float32")
        chw = (chw - self._mean) / self._std
        padded = -onp.ones((self._label_pad, ow), "float32")
        n = min(len(objs), self._label_pad)
        if n:
            padded[:n, : objs.shape[1]] = objs[:n, :ow]
        return chw, padded

    def _stack_labels(self, results):
        return nd.array(onp.stack([r[1] for r in results]), ctx=cpu())


def _gather(t, sel):
    """Rows ``sel`` of ``t`` as a new NDArray; from a host tensor into
    pinned memory where CUDA is available (the executor's copy to the card
    then does not block)."""
    idx = torch.from_numpy(onp.asarray(sel, dtype=onp.int64))
    if t.device.type == "cpu" and torch.cuda.is_available():
        out = torch.empty((len(idx),) + tuple(t.shape[1:]), dtype=t.dtype,
                          pin_memory=True)
        return NDArray(torch.index_select(t, 0, idx, out=out))
    return NDArray(torch.index_select(t, 0, idx.to(t.device)))
