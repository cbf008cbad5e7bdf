"""Datasets (counterpart of ``incubator_mxnet_tpu/gluon/data/dataset.py``).

Samples stay on the host: ``ArrayDataset`` indexes the arrays it was
given (numpy arrays, or NDArrays on the CPU) and the ``DataLoader`` moves
each batch to the card once.
"""
from __future__ import annotations

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """An indexable sequence of samples."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn(sample)`` is true."""
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards, index):
        """Shard ``index`` of ``num_shards`` contiguous shards (the first
        ``len % num_shards`` one sample longer)."""
        if not 0 <= index < num_shards:
            raise ValueError("shard index %d out of range for %d shards"
                             % (index, num_shards))
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return SimpleDataset([self[i] for i in range(start, end)])

    def take(self, count):
        """The first ``count`` samples."""
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        """``fn`` applied to each sample (its fields as arguments), when it
        is read (``lazy``) or now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` applied to each sample's first field."""
        return self.transform(_First(fn), lazy)


class _First:
    """``fn`` of the first field, the other fields as they are (a class,
    not a closure, so a dataset pickles for process workers)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    """A dataset over a list (or any indexable)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Samples ``(a[i], b[i], ...)`` of arrays of one length (a single
    array gives its rows). A 1-D NDArray becomes numpy, as in the JAX
    package."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for data in args:
            if len(data) != self._length:
                raise ValueError("All arrays must have the same length; "
                                 "%d != %d" % (len(data), self._length))
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file (and its ``.idx``), as bytes."""

    def __init__(self, filename):
        from ... import recordio
        self._record = recordio.MXIndexedRecordIO(
            filename[: filename.rfind(".")] + ".idx", filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
