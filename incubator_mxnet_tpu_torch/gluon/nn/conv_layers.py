"""Convolution and pooling layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``).

2-D layers in the NCHW layout, over ``nd.Convolution`` and ``nd.Pooling``
(PyTorch's convolution and pooling, cuDNN on the card); another layout
raises. The 1-D, 3-D and transposed convolutions and pools are not ported
yet.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _check_layout(layout):
    if layout != "NCHW":
        raise ValueError("only the NCHW layout is ported, got %r" % (layout,))


class _Conv(HybridBlock):
    """Convolution with an (channels, in_channels / groups, *kernel) weight;
    ``in_channels`` 0 defers it to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._groups = groups
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
        self.act_type = activation
        wshape = (channels, in_channels // groups if in_channels else 0) \
            + tuple(kernel_size)
        self.weight = Parameter("weight", shape=wshape,
                                init=weight_initializer,
                                allow_deferred_init=True)
        if use_bias:
            self.bias = Parameter("bias", shape=(channels,),
                                  init=bias_initializer,
                                  allow_deferred_init=True)
        else:
            self.bias = None

    def forward(self, x):
        if self.weight._data is None:
            ws = list(self.weight.shape)
            ws[1] = x.shape[1] // self._groups
            self.weight.shape = tuple(ws)
            self.weight._finish_deferred_init()
            if self.bias is not None:
                self.bias._finish_deferred_init()
        out = nd.Convolution(x, self.weight._tensor(),
                             self.bias._tensor() if self.bias is not None
                             else None, no_bias=self.bias is None,
                             **self._kwargs)
        if self.act_type:
            out = nd.Activation(out, act_type=self.act_type)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kw):
        _check_layout(layout)
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kw)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return nd.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kw):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, "max", layout,
                         **kw)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kw):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides else None,
                         _pair(padding, 2), ceil_mode, False, "avg", layout,
                         count_include_pad, **kw)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, (0, 0), True, True, "max", layout,
                         **kw)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kw):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kw)
