"""Helper module of the embedded-interpreter imperative-invoke C API
(``native/src/c_predict_api.cc`` MXTPUImperativeInvoke and the MXTPUND*
calls; counterpart of ``incubator_mxnet_tpu/native/_invoke_embed.py``; ref
include/mxnet/c_api.h MXImperativeInvokeEx and MXNDArrayCreateEx).

The C side holds each array as an opaque PyObject (a port NDArray) and
calls the module-level functions below through the CPython C API: eager
operators by name through the port's ``nd`` and ``nd.contrib`` (every
registered operator is reachable from C), and the autograd calls that let
a C frontend train (attach a gradient, record, backward, read the
gradient, write the updated value back).

Arrays cross the ABI as raw C-contiguous bytes with (dtype, shape); the
dtype names are the JAX package's (``float32``, ``bfloat16``, ...). Op
attributes cross as a JSON object string, as the reference passes
stringified attributes. Every call runs under ``capi_context()``.
"""
from __future__ import annotations

import json

from . import dtype_name, in_capi_context, tensor_from_bytes

__all__ = ["nd_create", "nd_shape", "nd_dtype", "nd_bytes", "invoke",
           "attach_grad", "record_begin", "record_end", "backward",
           "grad_of", "set_data"]


def _nd_mod():
    from .. import ndarray as nd
    return nd


@in_capi_context
def nd_create(dtype, shape, view):
    """Host bytes -> NDArray on the call's context (MXNDArrayCreateEx +
    SyncCopyFromCPU)."""
    shape = tuple(int(d) for d in shape)
    return _nd_mod().array(tensor_from_bytes(view, dtype, shape))


def nd_shape(h):
    return tuple(int(d) for d in h.shape)


def nd_dtype(h):
    return dtype_name(h._data.dtype)


def nd_bytes(h):
    """The array's bytes, C-contiguous (MXNDArraySyncCopyToCPU)."""
    import torch
    t = h._data.detach().contiguous().reshape(-1)
    return t.view(torch.uint8).cpu().numpy().tobytes()


# -- autograd (MXAutogradSetIsRecording / MXAutogradBackwardEx /
# MXNDArrayGetGrad): with invoke() below, a C frontend trains
_RECORD_SCOPES = []


@in_capi_context
def attach_grad(h):
    h.attach_grad()
    return True


def record_begin():
    from .. import autograd
    scope = autograd.record()
    scope.__enter__()
    _RECORD_SCOPES.append(scope)
    return True


def record_end():
    if not _RECORD_SCOPES:
        raise RuntimeError("record_end without record_begin")
    _RECORD_SCOPES.pop().__exit__(None, None, None)
    return True


@in_capi_context
def backward(h):
    h.backward()
    return True


def grad_of(h):
    g = h.grad
    if g is None:
        raise ValueError("no gradient: attach_grad not called or backward "
                         "not run")
    return g


@in_capi_context
def set_data(h, view, dtype):
    """Overwrite h's values in place from host bytes (the write-back of a
    C-side optimizer update)."""
    import torch
    t = tensor_from_bytes(view, dtype, tuple(h.shape))
    with torch.no_grad():
        h._data.copy_(t)
    return True


@in_capi_context
def invoke(op_name, inputs, kwargs_json):
    """An eager operator by name (MXImperativeInvokeEx): ``op_name`` on
    ``nd``, else ``nd.contrib`` (dotted names such as "contrib.ROIAlign"
    or "linalg.gemm2" also resolve); returns a tuple of NDArrays."""
    nd = _nd_mod()
    target = nd
    name = op_name
    if "." in name:
        prefix, name = name.rsplit(".", 1)
        for part in prefix.split("."):
            target = getattr(target, part)
    fn = getattr(target, name, None)
    if fn is None and target is nd:
        fn = getattr(nd.contrib, name, None)
    if fn is None:
        raise ValueError("unknown operator %r" % op_name)
    kwargs = json.loads(kwargs_json) if kwargs_json else {}
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in kwargs.items()}
    out = fn(*inputs, **kwargs)
    if isinstance(out, (list, tuple)):
        return tuple(out)
    return (out,)
