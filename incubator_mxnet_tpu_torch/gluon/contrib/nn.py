"""gluon.contrib.nn (counterpart of
``incubator_mxnet_tpu/gluon/contrib/nn.py``; MXNet's
``gluon/contrib/nn/basic_layers.py``).

``HybridConcurrent`` (alias ``Concurrent``) runs its children on one input
and concatenates their outputs; ``Identity`` passes its input on;
``SparseEmbedding`` is an ``Embedding`` with ``sparse_grad`` (its gradient
is kept dense, as in the JAX package); ``PixelShuffle1D/2D/3D`` move
channels into the spatial axes (Shi et al. 2016) by a reshape and a
transpose. ``SyncBatchNorm`` is ``gluon.nn``'s, re-exported.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..nn import SyncBatchNorm, HybridSequential  # noqa: F401

__all__ = ["SyncBatchNorm", "Concurrent", "HybridConcurrent", "Identity",
           "SparseEmbedding", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class HybridConcurrent(HybridSequential):
    """Every child on the same input, outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        return nd.concat(*[child(x) for child in self._modules.values()],
                         dim=self.axis)


Concurrent = HybridConcurrent


class Identity(HybridSequential):
    """The input, unchanged."""

    def forward(self, x):
        return x


class SparseEmbedding(HybridSequential):
    """An ``Embedding`` whose gradient MXNet keeps row-sparse: here the
    child ``nn.Embedding(sparse_grad=True)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ..nn import Embedding
        self.add(Embedding(input_dim, output_dim, dtype=dtype,
                           weight_initializer=weight_initializer,
                           sparse_grad=True))


class _PixelShuffle(HybridSequential):
    """(N, C·f1·…·fd, s1, …, sd) → (N, C, s1·f1, …, sd·fd): each factor
    taken from the channels and interleaved after its spatial axis."""

    def __init__(self, factor, dims, **kwargs):
        super().__init__(**kwargs)
        self._dims = dims
        f = factor if isinstance(factor, (tuple, list)) else (factor,) * dims
        self._factor = tuple(int(v) for v in f)

    def forward(self, x):
        fs, d = self._factor, self._dims
        n, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        prod = 1
        for v in fs:
            prod *= v
        x = nd.reshape(x, shape=(n, c // prod) + fs + spatial)
        perm = [0, 1]
        for i in range(d):
            perm += [2 + d + i, 2 + i]
        x = nd.transpose(x, axes=tuple(perm))
        return nd.reshape(x, shape=(n, c // prod) + tuple(
            s * f for s, f in zip(spatial, fs)))


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor, **kw):
        super().__init__(factor, 1, **kw)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor, **kw):
        super().__init__(factor, 2, **kw)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor, **kw):
        super().__init__(factor, 3, **kw)
