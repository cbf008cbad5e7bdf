"""``mx.npx`` (counterpart of ``incubator_mxnet_tpu/numpy_extension/``;
MXNet's ``python/mxnet/numpy_extension``): the neural-network operators
on ``mx.np`` arrays, the NumPy-mode switches and the ``image`` and
``random`` namespaces. Each operator is the port's ``nd`` operator, its
outputs re-classed in place as ``mx.np.ndarray`` so autograd keeps the
objects it recorded."""
from __future__ import annotations

from .. import ndarray as _nd
from ..numpy import ndarray as np_ndarray, _apply_np
from ..util import set_np, reset_np, is_np_array, is_np_shape, use_np
from ..context import cpu, gpu, tpu, num_gpus, num_tpus, current_context

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
           "cpu", "gpu", "tpu",
           "num_gpus", "num_tpus", "current_context", "relu", "sigmoid",
           "softmax", "log_softmax", "activation", "batch_norm", "layer_norm",
           "fully_connected", "convolution", "pooling", "dropout", "one_hot",
           "pick", "topk", "embedding", "gamma", "reshape_like", "waitall",
           "seed",
           "arange_like", "batch_dot", "batch_flatten", "cast",
           "deconvolution", "erf", "erfinv", "gammaln", "gather_nd",
           "leaky_relu", "multibox_detection", "multibox_prior",
           "multibox_target", "rnn", "roi_pooling", "sequence_mask",
           "shape_array", "slice", "smooth_l1", "save", "load",
           "image", "random"]


def _wrap(nd_fn):
    def op(*args, **kwargs):
        out = nd_fn(*args, **kwargs)

        # re-class IN PLACE (a new object would not be the one autograd
        # recorded); an operator that hands back one of its inputs
        # (eval-mode Dropout) goes through a recorded identity first, so
        # the caller's array keeps its class
        def reclass(o):
            if any(o is a for a in args):
                o = _apply_np(lambda x: x, o)
            o.__class__ = np_ndarray
            return o

        if isinstance(out, (list, tuple)):
            return type(out)(reclass(o) for o in out)
        return reclass(out)
    op.__name__ = getattr(nd_fn, "__name__", "op")
    return op


relu = _wrap(_nd.relu)
sigmoid = _wrap(_nd.sigmoid)
softmax = _wrap(_nd.softmax)
log_softmax = _wrap(_nd.log_softmax)
activation = _wrap(_nd.Activation)
batch_norm = _wrap(_nd.BatchNorm)
layer_norm = _wrap(_nd.LayerNorm)
fully_connected = _wrap(_nd.FullyConnected)
convolution = _wrap(_nd.Convolution)
pooling = _wrap(_nd.Pooling)
dropout = _wrap(_nd.Dropout)
one_hot = _wrap(_nd.one_hot)
pick = _wrap(_nd.pick)
topk = _wrap(_nd.topk)
embedding = _wrap(_nd.Embedding)
gamma = _wrap(_nd.gamma)
reshape_like = _wrap(_nd.reshape_like)
waitall = _nd.waitall

arange_like = _wrap(_nd.arange_like)
batch_dot = _wrap(_nd.batch_dot)
# MXNet's _npx_batch_flatten: (N, prod(rest)), not np_ndarray's ravel
batch_flatten = _wrap(lambda x: _nd.reshape(x, (x.shape[0], -1)))
cast = _wrap(_nd.cast)
deconvolution = _wrap(_nd.Deconvolution)
erf = _wrap(_nd.erf)
erfinv = _wrap(_nd.erfinv)
gammaln = _wrap(_nd.gammaln)
gather_nd = _wrap(_nd.gather_nd)
leaky_relu = _wrap(_nd.LeakyReLU)
rnn = _wrap(_nd.RNN)
roi_pooling = _wrap(_nd.ROIPooling)
sequence_mask = _wrap(_nd.sequence_mask)
shape_array = _wrap(_nd.shape_array)
slice = _wrap(_nd.slice)   # noqa: A001  (MXNet's _npx_slice)
smooth_l1 = _wrap(_nd.smooth_l1)


def _contrib_wrap(name):
    from ..ndarray import contrib as _c
    return _wrap(getattr(_c, name))


multibox_prior = _contrib_wrap("MultiBoxPrior")
multibox_target = _contrib_wrap("MultiBoxTarget")
multibox_detection = _contrib_wrap("MultiBoxDetection")


def save(file, arr):
    """MXNet's numpy_extension/utils.py save: arrays into a ``.params``-
    format file."""
    arrs = arr if isinstance(arr, (list, tuple, dict)) else [arr]
    _nd.save(file, arrs)


def load(file):
    """MXNet's numpy_extension/utils.py load: ``mx.np`` arrays."""
    out = _nd.load(file)

    def reclass(o):
        o.__class__ = np_ndarray
        return o
    if isinstance(out, dict):
        return {k: reclass(v) for k, v in out.items()}
    return [reclass(v) for v in out]


def seed(s):
    from ..ndarray import random as _r
    _r.seed(s)


from . import image  # noqa: E402  (npx.image.* op namespace)
from . import random  # noqa: E402  (npx.random: bernoulli/normal_n/uniform_n)
