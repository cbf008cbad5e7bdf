"""``npx.image`` (counterpart of
``incubator_mxnet_tpu/numpy_extension/image.py``; MXNet's
``_npx__image_*`` operators). HWC (or NHWC) ``mx.np`` arrays; ``resize``
is ``image.imresize``'s resampling (``jax.image.resize``'s), and the
``random_*`` variants draw from the port's seedable generator of the
image's device, so ``npx.random.seed`` repeats them."""
from __future__ import annotations

import math

import torch

from ..context import as_device
from ..image import _resize_nhwc
from ..ndarray import NDArray
from ..ndarray.random import _generator
from ..numpy import ndarray as np_ndarray

__all__ = ["to_tensor", "normalize", "resize", "crop", "flip_left_right",
           "flip_top_bottom", "random_flip_left_right",
           "random_flip_top_bottom", "random_brightness", "random_contrast",
           "random_saturation", "random_hue", "random_color_jitter",
           "random_lighting", "adjust_lighting"]

#: ITU-R BT.601 luma weights (the reference's saturation/gray path)
_LUMA = (0.299, 0.587, 0.114)


def _data(x):
    if isinstance(x, NDArray):
        return x._data
    return torch.as_tensor(x, device=as_device(None))


def _out(v):
    return np_ndarray(v)


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def to_tensor(data):
    """HWC uint8 [0,255] → CHW float32 [0,1] (MXNet's ToTensor); batched
    NHWC → NCHW."""
    x = _data(data).to(torch.float32) / 255.0
    perm = (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2)
    return _out(x.permute(*perm).contiguous())


def _channel(v, c, shp, like):
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.dim():
        return t.reshape(-1)[:c].reshape(shp)
    return t


def normalize(data, mean=0.0, std=1.0):
    """CHW (or NCHW) channel-wise (x - mean) / std (MXNet's Normalize)."""
    x = _data(data)
    c = x.shape[0] if x.dim() == 3 else x.shape[1]
    shp = (c, 1, 1) if x.dim() == 3 else (1, c, 1, 1)
    return _out((x - _channel(mean, c, shp, x)) / _channel(std, c, shp, x))


def resize(data, size, keep_ratio=False, interp=1):
    """HWC bilinear/nearest resize (MXNet's resize.cc); size int or
    (w, h). keep_ratio with an int size resizes the SHORTER edge to size
    and scales the other proportionally."""
    x = _data(data)
    if isinstance(size, int):
        if keep_ratio:
            h0, w0 = (x.shape[0], x.shape[1]) if x.dim() == 3 \
                else (x.shape[1], x.shape[2])
            if h0 <= w0:
                h, w = size, max(1, round(w0 * size / h0))
            else:
                w, h = size, max(1, round(h0 * size / w0))
        else:
            w = h = size
    else:
        w, h = size
    batch = x if x.dim() == 4 else x.unsqueeze(0)
    out = _resize_nhwc(batch, h, w, interp)
    out = out if x.dim() == 4 else out[0]
    return _out(out.to(x.dtype) if x.dtype != torch.float32 else out)


def crop(data, x, y, width, height):
    """HWC spatial crop at (x, y) (MXNet's crop.cc)."""
    a = _data(data)
    if a.dim() == 3:
        return _out(a[y:y + height, x:x + width, :].clone())
    return _out(a[:, y:y + height, x:x + width, :].clone())


def flip_left_right(data):
    return _out(torch.flip(_data(data), (-2,)))


def flip_top_bottom(data):
    return _out(torch.flip(_data(data), (-3,)))


def _u(a, lo=0.0, hi=1.0):
    """One uniform draw in [lo, hi) on ``a``'s device (a 0-dim tensor)."""
    g = _generator(a.device)
    return lo + (hi - lo) * torch.rand((), device=a.device, generator=g)


def random_flip_left_right(data):
    a = _data(data)
    return _out(torch.where(_u(a) < 0.5, torch.flip(a, (-2,)), a))


def random_flip_top_bottom(data):
    a = _data(data)
    return _out(torch.where(_u(a) < 0.5, torch.flip(a, (-3,)), a))


def random_brightness(data, min_factor, max_factor):
    a = _data(data).to(torch.float32)
    return _out(a * _u(a, min_factor, max_factor))


def random_contrast(data, min_factor, max_factor):
    a = _data(data).to(torch.float32)
    f = _u(a, min_factor, max_factor)
    gray = (a * _vec(_LUMA, a)).sum(-1, keepdim=True)
    return _out(a * f + gray.mean(dim=(-3, -2), keepdim=True) * (1 - f))


def random_saturation(data, min_factor, max_factor):
    a = _data(data).to(torch.float32)
    f = _u(a, min_factor, max_factor)
    gray = (a * _vec(_LUMA, a)).sum(-1, keepdim=True)
    return _out(a * f + gray * (1 - f))


def random_hue(data, min_factor, max_factor):
    """YIQ-rotation hue jitter (MXNet's RandomHue)."""
    a = _data(data).to(torch.float32)
    alpha = _u(a, min_factor, max_factor)
    u, w = torch.cos(alpha * math.pi), torch.sin(alpha * math.pi)
    t_yiq = _vec([[0.299, 0.587, 0.114],
                  [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]], a)
    t_rgb = _vec([[1.0, 0.956, 0.621],
                  [1.0, -0.272, -0.647],
                  [1.0, -1.107, 1.705]], a)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -w]),
                       torch.stack([zero, w, u])])
    m = t_rgb @ rot @ t_yiq
    return _out(a @ m.T)


def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    out = data
    if brightness:
        out = random_brightness(out, 1 - brightness, 1 + brightness)
    if contrast:
        out = random_contrast(out, 1 - contrast, 1 + contrast)
    if saturation:
        out = random_saturation(out, 1 - saturation, 1 + saturation)
    if hue:
        out = random_hue(out, -hue, hue)
    return out


def adjust_lighting(data, alpha):
    """AlexNet-style PCA lighting with a fixed eigen basis (MXNet's
    AdjustLighting)."""
    a = _data(data).to(torch.float32)
    eigval = _vec([55.46, 4.794, 1.148], a)
    eigvec = _vec([[-0.5675, 0.7192, 0.4009],
                   [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]], a)
    al = alpha._data if isinstance(alpha, NDArray) else torch.as_tensor(
        alpha, dtype=torch.float32)
    delta = eigvec @ (al.to(a.device, torch.float32) * eigval)
    return _out(a + delta)


def random_lighting(data, alpha_std=0.05):
    a = _data(data)
    alpha = alpha_std * torch.randn(3, device=a.device,
                                    generator=_generator(a.device))
    return adjust_lighting(data, alpha)
