"""Basic neural-net layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``)."""
from __future__ import annotations

import math

from ... import ndarray as nd
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding", "LayerNorm"]


class HybridSequential(HybridBlock):
    """Children named "0", "1", … run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return list(self._modules.values())[key]


class Dense(HybridBlock):
    """Fully-connected layer; weight (units, in_units), deferred when
    in_units is 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self.act_type = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                init=weight_initializer, dtype=dtype,
                                allow_deferred_init=True)
        if use_bias:
            self.bias = Parameter("bias", shape=(units,),
                                  init=bias_initializer, dtype=dtype,
                                  allow_deferred_init=True)
        else:
            self.bias = None

    def forward(self, x):
        if self.weight._data is None:
            in_units = math.prod(x.shape[1:]) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)
            self.weight._finish_deferred_init()
            if self.bias is not None:
                self.bias._finish_deferred_init()
        out = nd.FullyConnected(x, self.weight.data(),
                                self.bias.data() if self.bias is not None
                                else None,
                                num_hidden=self._units, flatten=self._flatten,
                                no_bias=self.bias is None)
        if self.act_type:
            out = nd.Activation(out, act_type=self.act_type)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return nd.Dropout(x, p=self._rate, axes=self._axes)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return nd.Embedding(x, self.weight.data(), input_dim=self._input_dim,
                            output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", grad_req="write" if scale else "null",
                               shape=(in_channels,), init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", grad_req="write" if center else "null",
                              shape=(in_channels,), init=beta_initializer,
                              allow_deferred_init=True)

    def forward(self, x):
        if self.gamma._data is None:
            c = x.shape[self._axis]
            for p in (self.gamma, self.beta):
                p.shape = (c,)
                p._finish_deferred_init()
        return nd.LayerNorm(x, self.gamma.data(), self.beta.data(),
                            axis=self._axis, eps=self._epsilon)
