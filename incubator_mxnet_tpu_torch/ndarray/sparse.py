"""Sparse storage: ``row_sparse`` and ``csr`` (counterpart of
``incubator_mxnet_tpu/ndarray/sparse.py``; MXNet's ``ndarray/sparse.py``).

The reference's representation: a ``RowSparseNDArray`` holds ``(data,
indices)``, ``data[i]`` being row ``indices[i]`` of the dense array (the
indices unique and sorted), and a ``CSRNDArray`` holds ``(data, indices,
indptr)`` of a 2-D array; each part is a dense NDArray on the array's
device. Sparse storage is a contract of the API (``tostype``,
``cast_storage``, kvstore's ``row_sparse_pull``, the interchange of
LibSVM-style data), not of compute: training takes dense gradients, as in
the JAX package. Conversions run eagerly; the ones that find the nonzeros
read them on the host (their count decides the shapes). ``dot`` of a CSR
matrix and a dense one gathers the dense rows of the nonzeros and adds
them into the output with ``index_add_`` on the device, without making the
CSR matrix dense.
"""
from __future__ import annotations

import numpy as onp
import torch

from .ndarray import NDArray, _apply, array as _dense_array
from .ndarray import zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "array", "zeros", "dot",
           "retain", "embedding_backward", "add", "subtract", "multiply",
           "divide"]


def _part(x, ctx, dtype=None):
    if isinstance(x, NDArray):
        return x if ctx is None or x.context == ctx else x.as_in_context(ctx)
    return _dense_array(x, ctx=ctx, dtype=dtype)


class BaseSparseNDArray:
    stype = None

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    ctx = context

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def wait_to_read(self):
        self.data.wait_to_read()

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self._shape)), self.stype)


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` of a dense array, their values in ``data``."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        self.data = _part(data, ctx)
        self.indices = _part(indices, self.data.context, "int32")
        self._shape = tuple(shape)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            def fn(vals, idx):
                dense = vals.new_zeros(self._shape)
                dense[idx.long()] = vals
                return dense
            return _apply(fn, self.data, self.indices)
        raise ValueError("cannot convert row_sparse to %r" % stype)

    def retain(self, row_ids):
        """The rows whose ids are in ``row_ids``; the others drop."""
        ids = row_ids._data if isinstance(row_ids, NDArray) else \
            torch.as_tensor(onp.asarray(row_ids))
        idx = self.indices._data
        keep = torch.isin(idx, ids.to(idx.device, idx.dtype))
        return RowSparseNDArray(NDArray(self.data._data[keep]),
                                NDArray(idx[keep]), self._shape)

    def copy(self):
        return RowSparseNDArray(self.data.copy(), self.indices.copy(),
                                self._shape)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return RowSparseNDArray(self.data * other, self.indices,
                                    self._shape)
        return self.tostype("default") * other

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            # merge by row id without making either array dense
            idx = torch.cat([self.indices._data, other.indices._data])
            vals = torch.cat([self.data._data, other.data._data])
            uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
            merged = vals.new_zeros((uniq.shape[0],) + vals.shape[1:])
            merged.index_add_(0, inv, vals)
            return RowSparseNDArray(NDArray(merged),
                                    NDArray(uniq.to(torch.int32)),
                                    self._shape)
        return self.tostype("default") + other


class CSRNDArray(BaseSparseNDArray):
    """A 2-D array in compressed sparse rows."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        self.data = _part(data, ctx)
        self.indices = _part(indices, self.data.context, "int32")
        self.indptr = _part(indptr, self.data.context, "int32")
        self._shape = tuple(shape)

    def _rows(self):
        """The row of each stored value."""
        ptr = self.indptr._data
        k = torch.arange(self.data.shape[0], device=ptr.device,
                         dtype=ptr.dtype)
        return torch.searchsorted(ptr[1:].contiguous(), k, right=True)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            rows = self._rows()

            def fn(vals, cols):
                dense = vals.new_zeros(self._shape)
                dense[rows, cols.long()] = vals
                return dense
            return _apply(fn, self.data, self.indices)
        if stype == "row_sparse":
            return self.tostype("default").tostype("row_sparse")
        raise ValueError("cannot convert csr to %r" % stype)

    def __getitem__(self, i):
        """Row ``i`` as a dense array."""
        lo, hi = (int(v) for v in self.indptr._data[i:i + 2].tolist())
        row = self.data._data.new_zeros((self._shape[1],))
        row[self.indices._data[lo:hi].long()] = self.data._data[lo:hi]
        return NDArray(row)


def _dense_to_row_sparse(arr):
    a = arr._data
    nz = torch.nonzero(a.reshape(a.shape[0], -1).any(dim=1)).reshape(-1)
    return RowSparseNDArray(NDArray(a[nz].detach().clone()),
                            NDArray(nz.to(torch.int32)), a.shape)


def _dense_to_csr(arr):
    a = arr._data
    if a.dim() != 2:
        raise ValueError("csr is 2-D only")
    rows, cols = torch.nonzero(a, as_tuple=True)
    counts = torch.bincount(rows, minlength=a.shape[0])
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return CSRNDArray(NDArray(a[rows, cols].detach().clone()),
                      NDArray(cols.to(torch.int32)),
                      NDArray(indptr.to(torch.int32)), a.shape)


# ================================================================ creation

def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """From ``(data, indices)`` with ``shape``, or from a dense array."""
    if isinstance(arg, RowSparseNDArray):
        return arg
    if isinstance(arg, tuple) and len(arg) == 2:
        if shape is None:
            raise ValueError("shape required with (data, indices)")
        data, indices = arg
        return RowSparseNDArray(_part(data, ctx, dtype), indices, shape)
    return _dense_to_row_sparse(
        arg if isinstance(arg, NDArray)
        else _dense_array(arg, ctx=ctx, dtype=dtype))


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` with ``shape``, or from a dense
    array."""
    if isinstance(arg, CSRNDArray):
        return arg
    if isinstance(arg, tuple) and len(arg) == 3:
        if shape is None:
            raise ValueError("shape required with (data, indices, indptr)")
        data, indices, indptr = arg
        return CSRNDArray(_part(data, ctx, dtype), indices, indptr, shape)
    return _dense_to_csr(
        arg if isinstance(arg, NDArray)
        else _dense_array(arg, ctx=ctx, dtype=dtype))


def array(source_array, stype="default", **kwargs):
    if stype == "default":
        return _dense_array(source_array, **kwargs)
    if stype == "row_sparse":
        return row_sparse_array(source_array, **kwargs)
    if stype == "csr":
        return csr_matrix(source_array, **kwargs)
    raise ValueError("unknown stype %r" % stype)


def zeros(stype, shape, ctx=None, dtype=None):
    dtype = dtype or "float32"
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            _dense_zeros((0,) + tuple(shape[1:]), ctx=ctx, dtype=dtype),
            onp.zeros((0,), "int32"), shape)
    if stype == "csr":
        return CSRNDArray(_dense_zeros((0,), ctx=ctx, dtype=dtype),
                          onp.zeros((0,), "int32"),
                          onp.zeros((shape[0] + 1,), "int32"), shape)
    raise ValueError("unknown stype %r" % stype)


def retain(data, indices):
    return data.retain(indices)


def dot(lhs, rhs, transpose_a=False):
    """``csr @ dense`` (``csr.T @ dense`` with ``transpose_a``): each
    nonzero scales a row of ``rhs``, added into its output row."""
    if isinstance(lhs, CSRNDArray):
        rows = lhs._rows()

        def fn(vals, cols, r):
            cols = cols.long()
            src, dst, n = (rows, cols, lhs.shape[1]) if transpose_a \
                else (cols, rows, lhs.shape[0])
            contrib = vals.reshape((-1,) + (1,) * (r.dim() - 1)) * r[src]
            out = contrib.new_zeros((n,) + r.shape[1:])
            return out.index_add_(0, dst, contrib)
        return _apply(fn, lhs.data, lhs.indices,
                      rhs if isinstance(rhs, NDArray) else NDArray(
                          torch.as_tensor(rhs)))
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return _apply(torch.matmul, lhs, rhs)
    raise TypeError("sparse.dot supports (csr, dense)")


def embedding_backward(tokens, out_grad, vocab_size):
    """The embedding's gradient as row_sparse: rows the unique token ids,
    values the output gradients summed over each id's positions."""
    tok = tokens._data if isinstance(tokens, NDArray) else \
        torch.as_tensor(onp.asarray(tokens))
    og = out_grad._data if isinstance(out_grad, NDArray) else \
        torch.as_tensor(onp.asarray(out_grad))
    og = og.reshape(-1, og.shape[-1])
    uniq, inv = torch.unique(tok.reshape(-1).long(), sorted=True,
                             return_inverse=True)
    vals = og.new_zeros((uniq.shape[0], og.shape[-1])).index_add_(
        0, inv.to(og.device), og)
    return RowSparseNDArray(NDArray(vals), NDArray(uniq.to(torch.int32)),
                            (vocab_size, og.shape[-1]))


def _sparse_elemwise(fn_name):
    def op(lhs, rhs):
        """The dense operator on the operands made dense."""
        from . import ndarray as _nd
        a = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) \
            else lhs
        b = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) \
            else rhs
        return getattr(_nd, fn_name)(a, b)
    op.__name__ = fn_name
    return op


add = _sparse_elemwise("add")
subtract = _sparse_elemwise("subtract")
multiply = _sparse_elemwise("multiply")
divide = _sparse_elemwise("divide")
