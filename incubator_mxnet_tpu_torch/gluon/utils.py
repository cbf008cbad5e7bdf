"""Gluon utilities (counterpart of ``incubator_mxnet_tpu/gluon/utils.py``).

``clip_global_norm`` takes every array's norm with one
``torch._foreach_norm`` (in fp32 whatever the arrays' type), reads the
total on the host once, warns as the JAX package does when it is not
finite, and scales the arrays in place with one ``_foreach_mul_``, so
each array's object (a parameter's ``grad()``) keeps its identity.
``download`` raises: the port fetches nothing.
"""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last one
    takes the rest when the split is uneven)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d." % (str(data.shape), num_slice, batch_axis))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [nd.slice_axis(data, batch_axis, i * step,
                          (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``split_data`` with each slice on the next context of
    ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays or tensors) in place so their joint L2
    norm is at most ``max_norm``; returns the norm before (a host
    float)."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
        total = torch.stack(norms).double().square().sum().sqrt()
    total_norm = float(total)
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(tensors, scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for data in iter(lambda: f.read(1048576), b""):
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise RuntimeError("the port downloads nothing; place the file locally "
                       "instead (url=%s)" % url)
