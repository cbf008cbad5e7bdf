"""The MXNet binary NDArray list format (counterpart of
``incubator_mxnet_tpu/ndarray/serialization.py``, byte for byte):

    uint64  list magic 0x112
    uint64  reserved (0)
    uint64  number of arrays
    per array (dense, V2):
        uint32  V2 magic 0xF993FAC9
        int32   storage type (0 = dense)
        int32   ndim; int64 x ndim
        int32   dev_type; int32 dev_id        (written as CPU 1, 0)
        int32   type flag                     (mshadow's: 0 float32 ...)
        raw little-endian data
    uint64  number of names
    per name: uint64 length; utf-8 bytes

so ``.params`` files written here load in the JAX package and in MXNet,
and theirs load here. V1 and the oldest (magic = ndim) records, V3
records, and row_sparse/CSR records (stored densely on load) are read too.
bfloat16 is type flag 12 and its raw 16-bit patterns are written and read
as they are, never through float32. A type without a flag is written as
float32 (flag 0), as the JAX package does.

``save_ndarray_list``/``load_ndarray_list`` are the JAX package's names and
signatures; they take NDArrays, tensors or numpy arrays and give NDArrays
on the CPU (the reference gives numpy arrays, which ``asnumpy()`` and
``numpy.asarray`` give here: numpy has no bfloat16 in this installation).
``save_tensor_list``/``load_tensor_list`` are the tensors' own path.
"""
from __future__ import annotations

import struct

import numpy as onp
import torch

__all__ = ["save_ndarray_list", "load_ndarray_list", "save_tensor_list",
           "load_tensor_list", "is_ndarray_list_file"]

kMXAPINDArrayListMagic = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA

_FLAG2DTYPE = {
    0: torch.float32, 1: torch.float64, 2: torch.float16, 3: torch.uint8,
    4: torch.int32, 5: torch.int8, 6: torch.int64, 7: torch.bool,
    12: torch.bfloat16,
}
_DTYPE2FLAG = {v: k for k, v in _FLAG2DTYPE.items()}

kDefaultStorage = 0
kRowSparseStorage = 1
kCSRStorage = 2


def _raw_bytes(t):
    """The little-endian bytes of a CPU tensor; bfloat16 as its 16-bit
    patterns."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _save_dense(out, t):
    """One dense array in V2 framing."""
    t = t.detach()
    if t.dtype not in _DTYPE2FLAG:
        t = t.float()
    t = t.cpu().contiguous()
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    out.append(struct.pack("<i", kDefaultStorage))
    out.append(struct.pack("<i", t.dim()))
    out.append(struct.pack("<%dq" % t.dim(), *t.shape))
    out.append(struct.pack("<ii", 1, 0))    # Context: CPU, device 0
    out.append(struct.pack("<i", _DTYPE2FLAG[t.dtype]))
    out.append(_raw_bytes(t))


def save_tensor_list(fname, tensors, names):
    """Write ``tensors`` and ``names`` (empty for a list) to ``fname``."""
    out = [struct.pack("<QQ", kMXAPINDArrayListMagic, 0),
           struct.pack("<Q", len(tensors))]
    for t in tensors:
        _save_dense(out, t)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    with open(fname, "wb") as f:
        f.write(b"".join(out))


def save_ndarray_list(fname, arrays, names):
    """Write ``arrays`` (NDArrays, tensors or numpy arrays) and ``names``
    (empty for a list) to ``fname``."""
    from .ndarray import NDArray
    save_tensor_list(fname, [
        a._data if isinstance(a, NDArray) else a
        if isinstance(a, torch.Tensor) else torch.from_numpy(
            onp.ascontiguousarray(a)) for a in arrays], names)


def load_ndarray_list(fname):
    """(NDArrays on the CPU, names) from a file in the list format."""
    from .ndarray import NDArray
    tensors, names = load_tensor_list(fname)
    return [NDArray(t) for t in tensors], names


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt):
        vals = self.read_tuple(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_tuple(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals

    def read_bytes(self, n):
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def read_shape_i64(self):
        ndim = self.read("i")
        return self.read_tuple("%dq" % ndim) if ndim else ()

    def read_shape_u32(self, ndim):
        return self.read_tuple("%dI" % ndim) if ndim else ()


def _read_data(r, flag, shape):
    dtype = _FLAG2DTYPE[flag]
    n = 1
    for s in shape:
        n *= s
    raw = bytearray(r.read_bytes(n * dtype.itemsize))
    if not raw:
        return torch.zeros(shape, dtype=dtype)
    as_dtype = torch.int16 if dtype == torch.bfloat16 else dtype
    return torch.frombuffer(raw, dtype=as_dtype).view(dtype).reshape(shape)


def _densify(stype, shape, data, aux):
    """A row_sparse or CSR record as a dense tensor."""
    out = torch.zeros(shape, dtype=data.dtype)
    if stype == kRowSparseStorage:
        if aux[0].numel():
            out[aux[0].long()] = data
    else:
        indptr, indices = aux[0].long(), aux[1].long()
        for i in range(shape[0]):
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            out[i, indices[lo:hi]] = data[lo:hi]
    return out


def _load_one(r):
    magic = r.read("I")
    if magic in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        stype = r.read("i")
        n_aux = {kDefaultStorage: 0, kRowSparseStorage: 1,
                 kCSRStorage: 2}[stype]
        storage_shape = r.read_shape_i64() if n_aux else None
        shape = r.read_shape_i64()
        if len(shape) == 0 and magic == NDARRAY_V2_MAGIC:
            return torch.zeros((), dtype=torch.float32)   # a "none" array
        r.read("ii")                                        # context
        flag = r.read("i")
        aux_meta = [(r.read("i"), r.read_shape_i64()) for _ in range(n_aux)]
        data = _read_data(r, flag, storage_shape if n_aux else shape)
        if not n_aux:
            return data
        aux = [_read_data(r, aflag, ashape) for aflag, ashape in aux_meta]
        return _densify(stype, shape, data, aux)
    if magic == NDARRAY_V1_MAGIC:
        shape = r.read_shape_i64()
    else:
        shape = r.read_shape_u32(magic)     # the oldest: magic is ndim
    if len(shape) == 0:
        return torch.zeros((), dtype=torch.float32)
    r.read("ii")
    return _read_data(r, r.read("i"), shape)


def load_tensor_list(fname):
    """(CPU tensors, names) from a file in the list format."""
    with open(fname, "rb") as f:
        return load_tensor_buffer(f.read(), fname)


def load_tensor_buffer(buf, what="the buffer"):
    """(CPU tensors, names) from the bytes of a file in the list format."""
    r = _Reader(buf)
    if len(buf) < 16 or r.read("Q") != kMXAPINDArrayListMagic:
        raise ValueError("%s is not a binary NDArray list file (magic "
                         "0x112)" % what)
    r.read("Q")
    tensors = [_load_one(r) for _ in range(r.read("Q"))]
    names = [r.read_bytes(r.read("Q")).decode("utf-8")
             for _ in range(r.read("Q"))]
    return tensors, names


def is_ndarray_list_file(fname):
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and \
            struct.unpack("<Q", head)[0] == kMXAPINDArrayListMagic
    except OSError:
        return False

