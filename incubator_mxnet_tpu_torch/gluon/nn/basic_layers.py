"""Basic neural-net layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``)."""
from __future__ import annotations

import math

import torch

from ... import initializer
from ... import ndarray as nd
from ...ndarray import NDArray
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "SyncBatchNorm", "InstanceNorm", "LayerNorm",
           "GroupNorm", "Flatten", "Lambda", "HybridLambda", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU", "Identity"]


class _Stack:
    """Children named "0", "1", … run in order; indexing by a slice gives a
    new stack of those children."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


class Sequential(_Stack, Block):
    """Blocks run in order; ``hybridize`` hybridizes each child."""

    def hybridize(self, active=True, **kwargs):
        for child in self._modules.values():
            if isinstance(child, Block) and hasattr(child, "hybridize"):
                child.hybridize(active, **kwargs)


class HybridSequential(_Stack, HybridBlock):
    """Blocks run in order, captured as one when hybridized."""


class Dense(HybridBlock):
    """Fully-connected layer; weight (units, in_units), deferred when
    in_units is 0."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
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
        if self.weight.sharding is not None:
            out = self._tensor_parallel(x)
            if out is not None:
                return out
        out = nd.FullyConnected(x, self.weight._tensor(),
                                self.bias._tensor() if self.bias is not None
                                else None,
                                num_hidden=self._units, flatten=self._flatten,
                                no_bias=self.bias is None)
        if self.act_type:
            out = nd.Activation(out, act_type=self.act_type)
        return out

    def _tensor_parallel(self, x):
        """The forward computed per shard over the current mesh when the
        weight's ``sharding`` splits over one of its axes
        (``parallel.tensor_parallel``); None otherwise."""
        from ...parallel.tensor_parallel import dense_forward
        out = dense_forward(self, x._data if isinstance(x, NDArray) else x)
        if out is None:
            return None
        if isinstance(x, NDArray):
            out = NDArray(out)
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
    """Rows of ``weight`` (input_dim, output_dim) at the ids. MXNet's
    ``sparse_grad`` (a row_sparse gradient) is accepted; the gradient
    stays dense, as in the JAX package."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return nd.Embedding(x, self.weight._tensor(),
                            input_dim=self._input_dim,
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
        return nd.LayerNorm(x, self.gamma._tensor(), self.beta._tensor(),
                            axis=self._axis, eps=self._epsilon)


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (``nd.BatchNorm``): gamma, beta and
    the running statistics, which are parameters with ``grad_req="null"``
    updated in place by each training-mode forward. ``in_channels`` 0 defers
    the four shapes to the first forward. ``cast`` to bf16/fp16 keeps all
    four fp32, as the JAX package's does."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter("gamma", grad_req="write" if scale else "null",
                               shape=(in_channels,), init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", grad_req="write" if center else "null",
                              shape=(in_channels,), init=beta_initializer,
                              allow_deferred_init=True)
        self.running_mean = Parameter("running_mean", grad_req="null",
                                      shape=(in_channels,),
                                      init=running_mean_initializer,
                                      allow_deferred_init=True)
        self.running_var = Parameter("running_var", grad_req="null",
                                     shape=(in_channels,),
                                     init=running_variance_initializer,
                                     allow_deferred_init=True)

    def forward(self, x):
        if self.gamma._data is None:
            c = x.shape[self._axis]
            for p in (self.gamma, self.beta, self.running_mean,
                      self.running_var):
                p.shape = (c,)
                p._finish_deferred_init()
        return nd.BatchNorm(x, self.gamma._tensor(), self.beta._tensor(),
                            self.running_mean._tensor(),
                            self.running_var._tensor(),
                            eps=self._epsilon, momentum=self._momentum,
                            fix_gamma=not self._scale,
                            use_global_stats=self._use_global_stats,
                            axis=self._axis)

    def cast(self, dtype):
        if nd.torch_dtype(dtype) in (torch.float16, torch.bfloat16):
            dtype = "float32"     # the statistics stay fp32 (AMP semantics)
        return super().cast(dtype)


class SyncBatchNorm(BatchNorm):
    """Batch normalisation whose statistics MXNet synchronises across
    devices. It is ``BatchNorm``, as in the JAX package: on one device the
    batch's statistics, and inside a data-parallel step over a mesh
    (``TrainStep(mesh=)``) those of the global batch, whatever
    ``num_devices`` says."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class _ChannelNorm(HybridBlock):
    """gamma and beta, one per channel of axis 1, deferred when
    ``in_channels`` is 0."""

    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        self.gamma = Parameter("gamma", grad_req="write" if scale else "null",
                               shape=(in_channels,), init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", grad_req="write" if center else "null",
                              shape=(in_channels,), init=beta_initializer,
                              allow_deferred_init=True)

    def _affine(self, x):
        if self.gamma._data is None:
            for p in (self.gamma, self.beta):
                p.shape = (x.shape[1],)
                p._finish_deferred_init()
        return self.gamma._tensor(), self.beta._tensor()


class InstanceNorm(_ChannelNorm):
    """Normalise each sample's channel over its spatial axes
    (``nd.InstanceNorm``); gamma is fixed at ones unless ``scale``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._axis = axis
        self._epsilon = epsilon

    def forward(self, x):
        gamma, beta = self._affine(x)
        return nd.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(_ChannelNorm):
    """Normalise each sample over ``num_groups`` channel groups
    (``nd.GroupNorm``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon

    def forward(self, x):
        gamma, beta = self._affine(x)
        return nd.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                            eps=self._epsilon)


class Flatten(HybridBlock):
    """(N, ...) → (N, prod(...))."""

    def forward(self, x):
        return nd.Flatten(x)


class Activation(HybridBlock):
    """``nd.Activation`` of ``activation`` ("relu", "sigmoid", ...)."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def forward(self, x):
        return nd.Activation(x, act_type=self._act_type)


class Identity(HybridBlock):
    """Its input, unchanged."""

    def forward(self, x):
        return x


class Lambda(Block):
    """A block over ``function``: a callable, or the name of an ``nd``
    operator."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = getattr(nd, function) \
            if isinstance(function, str) else function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """``Lambda``, hybridizable."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = getattr(nd, function) \
            if isinstance(function, str) else function

    def forward(self, *args):
        return self._func_impl(*args)


class LeakyReLU(HybridBlock):
    """x, or ``alpha`` x below 0."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """x, or alpha x below 0 with a learned ``alpha`` per channel
    (``in_channels`` of them; 0.25 at first)."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer
                               or initializer.Constant(0.25))

    def forward(self, x):
        return nd.LeakyReLU(x, self.alpha._tensor(), act_type="prelu")


class ELU(HybridBlock):
    """x, or ``alpha`` (eˣ - 1) below 0."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (Klambauer et al., 2017)."""

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """x Φ(x), exact (erf)."""

    def forward(self, x):
        return nd.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """x σ(``beta`` x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)
