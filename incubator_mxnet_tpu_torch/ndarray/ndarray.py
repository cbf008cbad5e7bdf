"""MXNet-named operators as plain functions on ``torch.Tensor``
(counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``).

Only the operators the serving and training paths call are here. Each
mirrors the JAX package's arithmetic (same casts, same order) so the two
agree on the CPU in float32. The port keeps plain tensors: the ``NDArray``
wrapper is not ported yet, and gradients are torch's own (``autograd.py``).
``Convolution`` and ``Pooling`` run PyTorch's convolution and pooling (cuDNN
on the card), as the JAX package leaves them to XLA; training-mode
``BatchNorm`` is a ``torch.autograd.Function`` so that autograd keeps only
the input in its own type and two fp32 vectors per channel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["FullyConnected", "Activation", "LeakyReLU", "LayerNorm",
           "Embedding", "softmax", "log_softmax", "pick", "batch_dot",
           "Dropout", "arange", "slice_axis", "torch_dtype", "Convolution",
           "Pooling", "BatchNorm", "Flatten", "flatten"]

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


_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid, "mish": F.mish,
}


def Activation(data, act_type="relu", **kw):
    """relu, sigmoid, tanh, softrelu (softplus), softsign, log_sigmoid and
    mish, as the JAX package's table."""
    if act_type not in _ACTIVATIONS:
        raise ValueError("unsupported act_type %r" % act_type)
    return _ACTIVATIONS[act_type](data)


def LeakyReLU(data, act_type="leaky", **kw):
    """Only the exact (erf) GELU is ported so far: any other act_type
    raises, so its keywords (``slope``, ``gamma``, the bounds) are never
    silently ignored; GELU takes none of them, in the JAX package too."""
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


def _take_fill(dtype):
    """``jnp.take``'s fill value for an id out of range: NaN for floats, the
    least value of a signed type, the largest of an unsigned one, True."""
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def Embedding(data, weight, input_dim=None, output_dim=None, **kw):
    """Gather rows of ``weight`` (input_dim, output_dim) by integer ids, as
    the JAX package's ``jnp.take`` (mode "fill"): an id in [-input_dim, 0)
    wraps, any other id outside [0, input_dim) gives a row of NaN (of the
    fill value, for an integer weight) and no gradient. The gather reads
    clamped ids, so no id indexes out of bounds: on the card an
    out-of-bounds gather trips a device-side assert, which leaves the
    process's CUDA context unusable."""
    n = weight.shape[0]
    ids = data.long()
    valid = (ids >= -n) & (ids < n)
    rows = F.embedding(torch.where(ids < 0, ids + n, ids).clamp(0, n - 1),
                       weight)
    return torch.where(valid.unsqueeze(-1), rows, _take_fill(weight.dtype))


def softmax(data, axis=-1, temperature=None, length=None, **kw):
    """softmax along ``axis``. With ``length`` (the data's shape without
    ``axis``), only the first ``length`` entries along ``axis`` take part:
    the others are -inf before the softmax and 0 after, as in the JAX
    package (whose mask is built along the last axis; here it is built
    along ``axis``, which is the same for the last axis)."""
    x = data / temperature if temperature else data
    if length is None:
        return torch.softmax(x, dim=axis)
    axis = axis % x.dim()
    pos = torch.arange(x.shape[axis], device=x.device).reshape(
        [-1 if i == axis else 1 for i in range(x.dim())])
    mask = pos < torch.as_tensor(length, device=x.device).long() \
        .unsqueeze(axis)
    out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=axis)
    return out.masked_fill(~mask, 0.0)


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


def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            training=None, generator=None, **kw):
    """Inverted dropout; the identity outside training or for p <= 0.
    ``training=None`` reads ``autograd.is_training()``, as the JAX package
    does: dropout is active under ``autograd.record()``/``train_mode()``
    and in ``jit.TrainStep``, never in ``EvalStep`` or serving. ``mode``
    and ``cudnn_off`` hold the JAX package's argument order and are
    ignored, as there."""
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


def _fit(v, n, fill):
    """``v`` (None, an int or a tuple) as an ``n``-tuple: cut to ``n``,
    padded with ``fill``, as the JAX package pads stride/dilate/pad."""
    if v is None or v == ():
        return (fill,) * n
    v = (v,) if isinstance(v, int) else tuple(v)[:n]
    return v + (fill,) * (n - len(v))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def Convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    """Channel-first convolution (NCW, NCHW or NCDHW by the kernel's rank)
    with OI… weights; the bias is added after the conv, as in the JAX
    package."""
    n = len(kernel) if kernel else weight.dim() - 2
    if n not in _CONV:
        raise ValueError("Convolution takes 1 to 3 spatial axes, got %d" % n)
    if layout is not None and not str(layout).startswith("NC"):
        raise ValueError("Convolution takes channel-first layouts, got %r"
                         % (layout,))
    y = _CONV[n](data, weight, None, _fit(stride, n, 1), _fit(pad, n, 0),
                 _fit(dilate, n, 1), num_group)
    if no_bias or bias is None:
        return y
    return y + bias.reshape((1, -1) + (1,) * n)


def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, **kw):
    """Max, avg or sum pooling over the two spatial axes of NCHW data, or
    over every spatial axis with ``global_pool`` (where avg and sum both
    take the mean, as the JAX package does).

    Padding is explicit, as the JAX package's ``reduce_window`` padding is:
    ``pad`` on both sides, and with ``pooling_convention="full"`` the extra
    high-side padding that makes the last partial window count (not
    PyTorch's ``ceil_mode`` rule, which drops a window that starts in the
    padding). Max pads with -inf; avg and sum with zeros, and avg divides
    by the kernel's size (``count_include_pad``) or by the count of real
    elements in the window."""
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if data.dim() != 4:
        raise ValueError("Pooling takes NCHW data (2 spatial axes), got "
                         "shape %s" % (tuple(data.shape),))
    if layout is not None and layout != "NCHW":
        raise ValueError("Pooling takes the NCHW layout, got %r" % (layout,))
    kernel = _fit(kernel, 2, 1)
    stride = _fit(stride, 2, 1)
    pad = _fit(pad, 2, 0)
    extra = [0, 0]
    if pooling_convention == "full":
        for i in range(2):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if rem else 0
    elif pooling_convention != "valid":
        raise ValueError("unknown pooling_convention %r" % pooling_convention)
    padding = (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(data, padding, value=-math.inf), kernel,
                            stride)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unsupported pool_type %r" % pool_type)
    s = F.avg_pool2d(F.pad(data, padding), kernel, stride, divisor_override=1)
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / math.prod(kernel)
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return s / F.avg_pool2d(F.pad(ones, padding), kernel, stride,
                            divisor_override=1)


def Flatten(data):
    """(N, ...) → (N, prod(...)), MXNet's Flatten."""
    return data.reshape(data.shape[0] if data.dim() else 1, -1)


flatten = Flatten


def _bshape(data, axis):
    return tuple(data.shape[i] if i == axis else 1 for i in range(data.dim()))


@torch.no_grad()
def _batch_stats(x, shift, axis):
    """(mean, var) of ``x`` over every axis but ``axis``, in fp32, by the
    JAX package's shifted one-pass form: ``var = E[(x-s)^2] - (E[x]-s)^2``
    with the running mean as the shift ``s``, clamped at 0."""
    red = tuple(i for i in range(x.dim()) if i != axis)
    xf = x.float()
    s = shift.float().reshape(_bshape(x, axis))
    m = xf.mean(dim=red)
    d2 = (xf - s).square().mean(dim=red)
    v = d2 - (m - s.reshape(m.shape)).square()
    return m, v.clamp_min(0.0)


class _BatchNormTrain(torch.autograd.Function):
    """``out = (x - mean) * rstd * gamma + beta`` in fp32, cast to x's type,
    with ``mean`` and ``var`` the batch's (computed by the caller, no
    gradient of their own): the backward is the whole batch-norm gradient,
    through the statistics. Saves x in its own type, gamma, and the fp32
    mean and rstd (C each), so a bf16 activation is not kept again in fp32.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, eps, axis, fix_gamma):
        bshape = _bshape(x, axis)
        rstd = torch.rsqrt(var + eps)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out = (x.float() - mean.reshape(bshape)) * rstd.reshape(bshape) \
            * g.float().reshape(bshape) + beta.float().reshape(bshape)
        ctx.save_for_backward(x, g, mean, rstd)
        ctx.axis, ctx.fix_gamma = axis, fix_gamma
        return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, g, mean, rstd = ctx.saved_tensors
        axis = ctx.axis
        bshape = _bshape(x, axis)
        red = tuple(i for i in range(x.dim()) if i != axis)
        count = x.numel() // x.shape[axis]
        xhat = (x.float() - mean.reshape(bshape)) * rstd.reshape(bshape)
        dyf = dy.float()
        dbeta = dyf.sum(dim=red)
        dgamma = (dyf * xhat).sum(dim=red)
        dx = (g.float() * rstd).reshape(bshape) * (
            dyf - (dbeta / count).reshape(bshape)
            - xhat * (dgamma / count).reshape(bshape))
        need = ctx.needs_input_grad
        return (dx.to(x.dtype) if need[0] else None,
                dgamma.to(g.dtype) if need[1] and not ctx.fix_gamma else None,
                dbeta.to(g.dtype) if need[2] else None,
                None, None, None, None, None)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, **kw):
    """Batch normalisation over ``axis``, in fp32, cast back to the input's
    type.

    In training mode (``autograd.is_training()`` and not
    ``use_global_stats``) it normalises with the batch's statistics
    (``_batch_stats``) and then updates the running statistics in place,
    ``new = momentum * old + (1 - momentum) * batch`` with the biased batch
    variance (MXNet's convention, not ``F.batch_norm``'s), as the JAX
    package writes its aux states. Otherwise it normalises with the running
    statistics. ``fix_gamma`` takes gamma as ones."""
    if output_mean_var:
        raise NotImplementedError("BatchNorm output_mean_var is not ported")
    from ..autograd import is_training
    axis = axis % data.dim()
    if is_training() and not use_global_stats:
        mean, var = _batch_stats(data, moving_mean, axis)
        out = _BatchNormTrain.apply(data, gamma, beta, mean, var, eps, axis,
                                    fix_gamma)
        with torch.no_grad():
            moving_mean.copy_(momentum * moving_mean + (1 - momentum) * mean)
            moving_var.copy_(momentum * moving_var + (1 - momentum) * var)
        return out
    bshape = _bshape(data, axis)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g.reshape(bshape) * torch.rsqrt(moving_var.reshape(bshape) + eps)
    out = (data - moving_mean.reshape(bshape)) * scale + beta.reshape(bshape)
    return out.to(data.dtype)
