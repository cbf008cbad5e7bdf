"""Native (C++) components of the port (counterpart of
``incubator_mxnet_tpu/native/``): the RecordIO reader and writer, the JPEG
decode-and-augment pipeline and the pooled host allocator (``src/*.cc``,
bound in ``lib.py``), the flat C ABI over them (``capi.py``), and the
embedded-interpreter C ABI (``src/c_predict_api.cc``) whose calls land in
the ``_*_embed`` modules.

An embedded call comes in on the C caller's thread, where no ``with ctx:``
scope is open, so each one runs under ``capi_context()``: the context
``MXTPU_CAPI_CONTEXT`` names (``gpu(0)`` by default). This takes the place
of the JAX package's ``JAX_PLATFORMS`` pin.
"""
from . import lib  # noqa: F401

__all__ = ["capi_context", "in_capi_context", "dtype_name",
           "tensor_from_bytes"]


def capi_context():
    """The Context of ``MXTPU_CAPI_CONTEXT``: ``cpu``, ``gpu`` or ``gpu(i)``
    (``cuda:i`` also)."""
    import re
    from ..config import get_env
    from ..context import cpu, gpu
    spec = get_env("MXTPU_CAPI_CONTEXT").strip().lower()
    m = re.fullmatch(r"(cpu|gpu|cuda)(?:[(:](\d+)\)?)?", spec)
    if m is None:
        raise ValueError("MXTPU_CAPI_CONTEXT=%r: want cpu, gpu or gpu(i)"
                         % spec)
    if m.group(1) == "cpu":
        return cpu()
    return gpu(int(m.group(2) or 0))


def in_capi_context(fn):
    """``fn`` run under ``capi_context()`` (an embedded call's entry)."""
    import functools

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with capi_context():
            return fn(*args, **kwargs)
    return call


def dtype_name(dtype):
    """A torch dtype by the JAX package's name (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def tensor_from_bytes(view, dtype, shape):
    """A CPU tensor of ``dtype`` (a torch dtype or its name) and ``shape``
    copied from a C caller's buffer (a memoryview over memory the caller
    frees after the call); raises unless the sizes agree. bfloat16 crosses
    as its raw 16-bit words."""
    import torch
    from ..ndarray.ndarray import torch_dtype
    dt = torch_dtype(dtype)
    want = dt.itemsize
    for d in shape:
        want *= d
    if view.nbytes != want:
        raise ValueError("got %d bytes, want %d (shape %s dtype %s)"
                         % (view.nbytes, want, tuple(shape), dtype_name(dt)))
    if not want:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(view), dtype=torch.uint8) \
        .view(dt).reshape(shape)
