"""Convolution and pooling layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``).

1-D, 2-D and 3-D convolutions, transposed convolutions and pools in the
channel-first layouts (NCW, NCHW, NCDHW), over ``nd.Convolution``,
``nd.Deconvolution`` and ``nd.Pooling`` (PyTorch's convolution and
pooling, cuDNN on the card); another layout raises. A transposed
convolution's weight is MXNet's (in_channels, channels / groups,
*kernel), and ``output_padding`` is its ``adj``.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _pair(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _check_layout(layout, n):
    if layout != _LAYOUTS[n]:
        raise ValueError("only the %s layout is ported for %d-D layers, got "
                         "%r" % (_LAYOUTS[n], n, layout))


class _Conv(HybridBlock):
    """Convolution with an (channels, in_channels / groups, *kernel) weight,
    or with ``op_name="Deconvolution"`` a transposed one with an
    (in_channels, channels / groups, *kernel) weight; ``in_channels`` 0
    defers it to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        _check_layout(layout, len(kernel_size))
        self._channels = channels
        self._groups = groups
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self.act_type = activation
        if op_name == "Convolution":
            wshape = (channels, in_channels // groups if in_channels else 0)
        else:
            wshape = (in_channels, channels // groups)
        self.weight = Parameter("weight", shape=wshape + tuple(kernel_size),
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
            if self._op_name == "Convolution":
                ws[1] = x.shape[1] // self._groups
            else:
                ws[0] = x.shape[1]
            self.weight.shape = tuple(ws)
            self.weight._finish_deferred_init()
            if self.bias is not None:
                self.bias._finish_deferred_init()
        op = getattr(nd, self._op_name)
        out = op(x, self.weight._tensor(),
                 self.bias._tensor() if self.bias is not None else None,
                 no_bias=self.bias is None, **self._kwargs)
        if self.act_type:
            out = nd.Activation(out, act_type=self.act_type)
        return out


def _conv_class(n, transpose):
    """The ``n``-D convolution layer class (transposed or not), with
    MXNet's signature."""
    layout = _LAYOUTS[n]
    one = (1,) * n if n > 1 else 1
    zero = (0,) * n if n > 1 else 0

    if transpose:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     output_padding=zero, dilation=one, groups=1,
                     layout=layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kw):
            _Conv.__init__(self, channels, _pair(kernel_size, n),
                           _pair(strides, n), _pair(padding, n),
                           _pair(dilation, n), groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, op_name="Deconvolution",
                           adj=_pair(output_padding, n), **kw)
        name = "Conv%dDTranspose" % n
    else:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     dilation=one, groups=1, layout=layout, activation=None,
                     use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kw):
            _Conv.__init__(self, channels, _pair(kernel_size, n),
                           _pair(strides, n), _pair(padding, n),
                           _pair(dilation, n), groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, **kw)
        name = "Conv%dD" % n
    return type(name, (_Conv,), {"__init__": __init__, "__module__": __name__,
                                 "__doc__": "%d-D %sconvolution, %s." % (
                                     n, "transposed " if transpose else "",
                                     layout)})


Conv1D, Conv2D, Conv3D = (_conv_class(n, False) for n in (1, 2, 3))
Conv1DTranspose, Conv2DTranspose, Conv3DTranspose = (
    _conv_class(n, True) for n in (1, 2, 3))


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout, len(pool_size))
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


def _pool_class(n, pool_type):
    """The ``n``-D max or avg pooling layer class, MXNet's signature."""
    layout = _LAYOUTS[n]
    size = (2,) * n if n > 1 else 2

    def __init__(self, pool_size=size, strides=None, padding=0,
                 layout=layout, ceil_mode=False, count_include_pad=True,
                 **kw):
        _Pooling.__init__(self, _pair(pool_size, n),
                          _pair(strides, n) if strides else None,
                          _pair(padding, n), ceil_mode, False, pool_type,
                          layout, count_include_pad if pool_type == "avg"
                          else None, **kw)
    name = "%sPool%dD" % (pool_type.capitalize(), n)
    return type(name, (_Pooling,), {"__init__": __init__,
                                    "__module__": __name__,
                                    "__doc__": "%d-D %s pooling, %s."
                                    % (n, pool_type, layout)})


def _global_pool_class(n, pool_type):
    """The ``n``-D global max or avg pooling layer class."""
    def __init__(self, layout=_LAYOUTS[n], **kw):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, True, True,
                          pool_type, layout, **kw)
    name = "Global%sPool%dD" % (pool_type.capitalize(), n)
    return type(name, (_Pooling,), {"__init__": __init__,
                                    "__module__": __name__,
                                    "__doc__": "%d-D global %s pooling."
                                    % (n, pool_type)})


MaxPool1D, MaxPool2D, MaxPool3D = (_pool_class(n, "max") for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool_class(n, "avg") for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(n, "max") for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(n, "avg") for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the two spatial axes of NCHW data:
    ``padding`` on every side, or MXNet's flat pad_width of 8."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def forward(self, x):
        return nd.pad(x, mode="reflect", pad_width=self._padding)
