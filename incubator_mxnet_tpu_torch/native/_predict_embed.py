"""Helper module of the embedded-interpreter C predict API
(``native/src/c_predict_api.cc``; counterpart of
``incubator_mxnet_tpu/native/_predict_embed.py``; ref
src/c_api/c_predict_api.cc).

The C side keeps each predictor as an opaque PyObject (a ``_PredState``)
and calls the module-level functions below through the CPython C API. All
array traffic crosses the ABI as raw bytes (C-contiguous, row-major), the
contract of the reference's MXPredSetInput/MXPredGetOutput float buffers
generalised to any dtype the artifact declares. Dtypes are named as the
JAX package names them (``float32``, ``int32``, ``bfloat16``); bfloat16
crosses as its raw 16-bit words.

A predictor is the port's ``contrib.serving.ServedModel``: a forward runs
the program through ``aot.CACHE`` on the device it was exported on (a CUDA
graph on the card, captured at the first forward). Forward keeps the
outputs on the device; ``output_into`` copies one into the caller's
buffer.
"""
from __future__ import annotations

from . import dtype_name, in_capi_context, tensor_from_bytes

__all__ = [
    "create", "num_inputs", "num_outputs", "input_shape", "input_dtype",
    "output_shape", "output_dtype", "set_input", "forward", "output_into",
]


class _PredState:
    __slots__ = ("model", "inputs", "outputs")

    def __init__(self, model):
        self.model = model
        self.inputs = [None] * len(model.input_shapes)
        self.outputs = None


@in_capi_context
def create(path):
    """Load a .mxtpu serving artifact as a predictor (MXPredCreate)."""
    from ..contrib import serving
    return _PredState(serving.load(path))


def num_inputs(st):
    return len(st.model.input_shapes)


def num_outputs(st):
    return len(st.model.output_shapes)


def input_shape(st, i):
    return tuple(int(d) for d in st.model.input_shapes[i])


def output_shape(st, i):
    return tuple(int(d) for d in st.model.output_shapes[i])


def input_dtype(st, i):
    return dtype_name(st.model._in[i].dtype)


def output_dtype(st, i):
    return dtype_name(st.model._out[i].dtype)


@in_capi_context
def set_input(st, i, view):
    """Stage input i from a C buffer (a memoryview): copied at once, to the
    program's device."""
    try:
        host = tensor_from_bytes(view, st.model._in[i].dtype,
                                 input_shape(st, i))
    except ValueError as e:
        raise ValueError("input %d: %s" % (i, e)) from None
    st.inputs[i] = host.to(st.model.device)


@in_capi_context
def forward(st):
    """Run the program on the staged inputs (MXPredForward); the outputs
    stay on the device."""
    missing = [i for i, x in enumerate(st.inputs) if x is None]
    if missing:
        raise ValueError("inputs %s not set before forward" % missing)
    st.outputs = st.model._run(*st.inputs)


@in_capi_context
def output_into(st, i, view):
    """Copy output i into the C caller's buffer (a writable memoryview of
    exactly its bytes), C-contiguous, straight from the device
    (MXPredGetOutput)."""
    if st.outputs is None:
        raise ValueError("forward has not been run")
    import torch
    out = st.outputs[i].detach().contiguous().reshape(-1).view(torch.uint8)
    if view.nbytes != out.numel():
        raise ValueError("output size mismatch: have %d bytes, caller gave "
                         "%d" % (out.numel(), view.nbytes))
    if out.numel():
        torch.frombuffer(view, dtype=torch.uint8).copy_(out)
