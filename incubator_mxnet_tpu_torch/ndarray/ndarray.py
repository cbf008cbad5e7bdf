"""MXNet-named operators as plain functions on ``torch.Tensor``
(counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``).

Only the operators the serving and training paths call are here. Each
mirrors the JAX package's arithmetic (same casts, same order) so the two
agree on the CPU in float32. The port keeps plain tensors: the ``NDArray``
wrapper is not ported yet, and gradients are torch's own (``autograd.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["FullyConnected", "Activation", "LeakyReLU", "LayerNorm",
           "Embedding", "softmax", "log_softmax", "pick", "batch_dot",
           "Dropout", "arange", "slice_axis", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "int8": torch.int8, "bool": torch.bool,
}


def torch_dtype(dtype):
    """``torch.dtype`` for an MXNet dtype name, a numpy dtype or a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **kw):
    """y = x Wᵀ + b, with W of shape (num_hidden, in_units)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    y = torch.matmul(x, weight.t())
    if no_bias or bias is None:
        return y
    return y + bias


def Activation(data, act_type="relu", **kw):
    """Only relu is ported so far."""
    if act_type != "relu":
        raise ValueError("unsupported act_type %r" % act_type)
    return torch.relu(data)


def LeakyReLU(data, act_type="leaky", **kw):
    """Only the exact (erf) GELU is ported so far."""
    if act_type != "gelu":
        raise ValueError("unsupported act_type %r" % act_type)
    return F.gelu(data, approximate="none")


def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, **kw):
    """Normalise over ``axis`` in float32 and cast back to the input type."""
    xf = data.float()
    m = xf.mean(dim=axis, keepdim=True)
    v = xf.var(dim=axis, keepdim=True, unbiased=False)
    shp = [1] * data.ndim
    shp[axis if axis >= 0 else data.ndim + axis] = data.shape[axis]
    out = (xf - m) * torch.rsqrt(v + eps) * gamma.reshape(shp) \
        + beta.reshape(shp)
    return out.to(data.dtype)


def Embedding(data, weight, input_dim=None, output_dim=None, **kw):
    """Gather rows of ``weight`` (input_dim, output_dim) by integer ids."""
    return F.embedding(data.long(), weight)


def softmax(data, axis=-1, temperature=None, **kw):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


def log_softmax(data, axis=-1, temperature=None, **kw):
    """log(softmax(x)) along ``axis``, in the input's type."""
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (indices clipped into range)."""
    if mode != "clip":
        raise ValueError("only mode='clip' is ported, got %r" % (mode,))
    axis = axis % data.ndim
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    picked = torch.gather(data, axis, idx)
    return picked if keepdims else picked.squeeze(axis)


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


def Dropout(data, p=0.5, axes=(), training=None, generator=None, **kw):
    """Inverted dropout; the identity outside training or for p <= 0.
    ``training=None`` reads ``autograd.is_training()``, as the JAX package
    does: dropout is active under ``autograd.record()``/``train_mode()``
    and in ``jit.TrainStep``, never in ``EvalStep`` or serving."""
    if training is None:
        from ..autograd import is_training
        training = is_training()
    if not training or p <= 0:
        return data
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return data * mask.to(data.dtype) / keep


def arange(start, stop=None, step=1, ctx=None, dtype="float32"):
    from ..context import as_device
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                        device=as_device(ctx))


def slice_axis(data, axis, begin, end):
    idx = [slice(None)] * data.ndim
    if end is None or end == 0 and begin < 0:
        end = None
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]
