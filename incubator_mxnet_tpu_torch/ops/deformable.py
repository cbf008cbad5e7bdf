"""Deformable convolution v1 and v2 (counterpart of
``incubator_mxnet_tpu/ops/deformable.py``; MXNet's
``deformable_convolution.cc`` and ``modulated_deformable_convolution.cc``,
Dai et al. 2017, Zhu et al. 2018).

The kernel's taps are sampled with ``ops.detection``'s bilinear gather, one
gather per tap and deformable group, at the regular grid moved by the
learned offsets (and scaled by the DCNv2 ``mask``); one ``einsum`` over
(in-channel, tap) then does the convolution. Autograd gives the gradients
of the input, the offsets, the mask and the weight, as in the JAX package.
"""
from __future__ import annotations

import torch

from .detection import _bilinear_gather

__all__ = ["deformable_conv2d"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def deformable_conv2d(x, offset, weight, bias=None, kernel=(3, 3),
                      stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                      num_deformable_group=1, mask=None):
    """x (N, C, H, W); offset (N, ndg·2·KH·KW, Ho, Wo), a (y, x) pair per
    tap; weight (Co, C, KH, KW); the optional DCNv2 ``mask`` (N,
    ndg·KH·KW, Ho, Wo), already through its sigmoid. Returns (N, Co, Ho,
    Wo). Tensors in, tensors out."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(pad)
    dh, dw = _pair(dilate)
    n, c, h, w = x.shape
    co = weight.shape[0]
    k = kh * kw
    ndg = num_deformable_group
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if offset.shape[1] != ndg * 2 * k:
        raise ValueError("offset has %d channels, want %d"
                         % (offset.shape[1], ndg * 2 * k))
    if c % ndg:
        raise ValueError("channels not divisible by num_deformable_group")
    kwt = dict(dtype=x.dtype, device=x.device)
    oy = torch.arange(ho, **kwt) * sh - ph
    ox = torch.arange(wo, **kwt) * sw - pw
    off = offset.reshape(n, ndg, k, 2, ho, wo)
    msk = None if mask is None else mask.reshape(n, ndg, k, ho, wo)
    cg = c // ndg
    taps = []
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            groups = []
            for g in range(ndg):
                ys = oy[None, :, None] + i * dh + off[:, g, t, 0]
                xs = ox[None, None, :] + j * dw + off[:, g, t, 1]
                s = _bilinear_gather(x[:, g * cg:(g + 1) * cg], ys, xs)
                if msk is not None:
                    s = s * msk[:, g, t][:, None]
                groups.append(s)
            taps.append(groups[0] if ndg == 1 else torch.cat(groups, 1))
    stacked = torch.stack(taps, dim=2)                   # (N, C, K, Ho, Wo)
    out = torch.einsum("nckhw,ock->nohw", stacked, weight.reshape(co, c, k))
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out
