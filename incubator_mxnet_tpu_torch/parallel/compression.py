"""Gradient compression (counterpart of
``incubator_mxnet_tpu/parallel/compression.py``; MXNet's
``src/kvstore/gradient_compression.h``).

2-bit stochastic-threshold quantization with error feedback: each value
pushed is added to the residual its key left last time, sent as +t, -t or
0 by the threshold t, and what was not sent stays as the key's residual.
The JAX package computes it with plain array ops outside any kernel, so
here it is plain torch, with the same arithmetic in the value's dtype.
"""
from __future__ import annotations

import torch

from ..ndarray import NDArray

__all__ = ["GradientCompression"]


class GradientCompression:
    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise ValueError("only 2bit compression is supported")
        self.threshold = float(threshold)
        self._residuals = {}

    @torch.no_grad()
    def compress_decompress(self, grad, key):
        """``grad`` quantized to {-t, 0, +t} after adding ``key``'s residual;
        the rest becomes the residual. ``key`` is the stable key of the
        value (the kvstore key, with the device's position for a list), never
        an object's identity, which Python may reuse."""
        data = grad._data if isinstance(grad, NDArray) else grad
        res = self._residuals.get(key)
        acc = data + res if res is not None else data.clone()
        t = self.threshold
        q = torch.where(acc >= t, torch.full_like(acc, t),
                        torch.where(acc <= -t, torch.full_like(acc, -t),
                                    torch.zeros_like(acc))).to(data.dtype)
        self._residuals[key] = acc - q
        return NDArray(q) if isinstance(grad, NDArray) else q
