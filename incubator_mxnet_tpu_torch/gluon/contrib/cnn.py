"""gluon.contrib.cnn (counterpart of
``incubator_mxnet_tpu/gluon/contrib/cnn.py``; MXNet's
``gluon/contrib/cnn/conv_layers.py``): ``DeformableConvolution`` (v1) and
``ModulatedDeformableConvolution`` (DCNv2).

The offsets (and DCNv2's mask) come from an ordinary convolution, the
child ``_offset``, initialized to zeros as MXNet's, so training starts as a
plain convolution; the deformable sampling is the port's
``ops.deformable.deformable_conv2d``.
"""
from __future__ import annotations

from ... import ndarray as nd
from ...ndarray.ndarray import _apply
from ...ops.deformable import deformable_conv2d
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["DeformableConvolution", "ModulatedDeformableConvolution"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1: ``offset = _offset(x)``, then the
    convolution of ``x`` sampled at the offset taps."""

    _use_mask = False

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros", offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", num_deformable_group=1,
                 **kwargs):
        super().__init__(**kwargs)
        from ..nn import Conv2D
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._strides = _pair(strides)
        self._padding = _pair(padding)
        self._dilation = _pair(dilation)
        self._ndg = num_deformable_group
        self._activation = activation
        taps = self._kernel[0] * self._kernel[1]
        off_ch = self._ndg * (3 if self._use_mask else 2) * taps
        self._offset = Conv2D(off_ch, self._kernel, self._strides,
                              self._padding, self._dilation,
                              in_channels=in_channels,
                              weight_initializer=offset_weight_initializer,
                              bias_initializer=offset_bias_initializer,
                              prefix="offset_")
        self.weight = Parameter("weight",
                                shape=(channels, in_channels) + self._kernel,
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,),
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None

    def forward(self, x):
        if self.weight._data is None:
            self.weight.shape = (self._channels, x.shape[1]) + self._kernel
            self.weight._finish_deferred_init()
            if self.bias is not None:
                self.bias._finish_deferred_init()
        taps = self._kernel[0] * self._kernel[1]
        raw = self._offset(x)
        use_mask, use_bias = self._use_mask, self.bias is not None
        if use_mask:
            off = nd.slice_axis(raw, axis=1, begin=0,
                                end=self._ndg * 2 * taps)
            mask = nd.sigmoid(nd.slice_axis(raw, axis=1,
                                            begin=self._ndg * 2 * taps,
                                            end=None))
            args = [x, off, mask, self.weight._tensor()]
        else:
            args = [x, raw, self.weight._tensor()]
        if use_bias:
            args.append(self.bias._tensor())

        def fn(*ts):
            i = 2 + use_mask
            return deformable_conv2d(
                ts[0], ts[1], ts[i], bias=ts[i + 1] if use_bias else None,
                kernel=self._kernel, stride=self._strides, pad=self._padding,
                dilate=self._dilation, num_deformable_group=self._ndg,
                mask=ts[2] if use_mask else None)

        out = _apply(fn, *args)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class ModulatedDeformableConvolution(DeformableConvolution):
    """DCNv2: a sigmoid modulation mask per sampling tap besides the
    offsets."""

    _use_mask = True
