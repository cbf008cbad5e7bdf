"""NDArray and the ``nd`` operators over ``torch.Tensor`` (counterpart of
``incubator_mxnet_tpu/ndarray/ndarray.py``).

``NDArray`` wraps one ``torch.Tensor`` in ``_data`` (composition, not a
tensor subclass: MXNet's ``size``, ``reshape``, ``sum(axis=)``, ``T``,
``grad`` and ``astype`` mean other things than torch's). Every public
operator goes through ``_apply``, the one choke point: it unwraps NDArray
arguments, runs the tensor function, and wraps the result in an NDArray
when any argument was one. Tensor arguments pass straight through and give
tensors back, so the layers' hot path (BERT, GPT, ResNet inside their
Blocks, which unwrap their arguments once) carries no wrappers.

An NDArray operation records for ``autograd.backward`` only inside
``autograd.record()``, as MXNet's tape does; gradients are torch's
(``autograd.py``). No two NDArrays share memory, as no two JAX arrays do:
an operator's output that shares storage with an input (``x[k]``,
``reshape``, ``astype`` to the same type, ...) is copied. Writes into an
NDArray (``x[k] = v``, ``x += y``) are in place where torch allows it and
rebind ``_data`` to a new tensor where it does not (a view, or a tensor
that autograd records); a write into a variable is in place, unrecorded.

Each operator mirrors the JAX package's arithmetic, casts and type
promotion (JAX runs without x64: Python lists and float64 become float32,
int64 becomes int32 when no dtype is given; comparisons return the
promoted input type, not bool). Operators that index (``take``, ``pick``,
``one_hot``, ``gather_nd``, ``scatter_nd``, ``batch_take``, ``Embedding``)
never read out of bounds: ids out of range are clipped, wrapped, dropped
or filled as the reference's ``jnp`` call does, through clamped gathers,
so no device-side assert can leave the CUDA context unusable.

``Convolution`` and ``Pooling`` run PyTorch's convolution and pooling
(cuDNN on the card), as the JAX package leaves them to XLA; training-mode
``BatchNorm`` is a ``torch.autograd.Function`` so that autograd keeps only
the input in its own type and two fp32 vectors per channel.
"""
from __future__ import annotations

import builtins
import functools
import math
import operator
import sys

import numpy as onp
import torch
import torch.nn.functional as F

from .. import autograd
from .. import profiler as _profiler
from ..context import Context, as_device, context_of

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "zeros_like", "ones_like", "waitall",
           "torch_dtype",
           # shape
           "reshape", "reshape_like", "flatten", "Flatten", "transpose",
           "swapaxes", "SwapAxis", "expand_dims", "squeeze", "broadcast_to",
           "broadcast_like", "broadcast_axis", "tile", "repeat", "pad",
           "flip", "reverse", "concat", "Concat", "concatenate", "stack",
           "split", "SliceChannel", "split_v2", "slice_op", "slice_axis",
           "slice_like", "moveaxis", "depth_to_space", "space_to_depth",
           "diag",
           # reductions
           "sum", "mean", "max", "min", "prod", "norm", "argmax", "argmin",
           "moments",
           # indexing
           "take", "pick", "one_hot", "gather_nd", "scatter_nd",
           "batch_take", "where", "topk", "sort", "argsort", "shape_array",
           "size_array", "arange_like",
           # casts, products, the rest
           "cast", "Cast", "amp_cast", "amp_multicast", "dot", "batch_dot",
           "khatri_rao", "trace", "clip", "maximum_scalar", "identity",
           "BlockGrad", "stop_gradient", "make_loss", "add_n", "smooth_l1",
           "hard_sigmoid", "digamma", "IdentityAttachKLSparseReg",
           # nn-style
           "FullyConnected", "Activation", "LeakyReLU", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Embedding", "softmax",
           "log_softmax", "Dropout", "Convolution", "Deconvolution",
           "Pooling", "BatchNorm",
           # sequences
           "sequence_mask", "SequenceMask", "SequenceLast",
           "SequenceReverse",
           # files
           "save", "load"]

# ===================================================================== dtypes

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "int8": torch.int8, "int16": torch.int16, "bool": torch.bool,
}


class _BFloat16:
    """``NDArray.dtype`` of a bfloat16 array: numpy has no such type here
    (the card's machine has no ``ml_dtypes``). It compares equal to
    "bfloat16", ``torch.bfloat16`` and any dtype named bfloat16."""

    name = "bfloat16"
    itemsize = 2

    def __eq__(self, other):
        return other is self or other is torch.bfloat16 or "bfloat16" in (
            str(other), getattr(other, "name", None),
            getattr(other, "__name__", None))

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "bfloat16"


BFLOAT16 = _BFloat16()


def torch_dtype(dtype):
    """``torch.dtype`` for an MXNet dtype name, a numpy dtype or type, the
    bfloat16 marker, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None)
    if not isinstance(name, str):
        try:
            name = onp.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name not in _DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def _mx_dtype(tdtype):
    """The dtype an NDArray reports: numpy's, or BFLOAT16."""
    if tdtype == torch.bfloat16:
        return BFLOAT16
    return onp.dtype(str(tdtype).split(".")[-1])


# ===================================================================== NDArray

def _writable_in_place(t, value=None):
    """Whether ``t`` may be written in place: not a view (a broadcast view
    has overlapping elements; ``NDArray(view)`` shares another tensor's
    storage), and not a tensor autograd records. A variable (a marked leaf,
    such as a parameter) is always written in place, inside ``record()``
    too: MXNet records no write into a variable."""
    if t._is_view():
        return False
    if hasattr(t, "_mx_req"):
        return True
    recording = autograd.is_recording()
    if recording and isinstance(value, torch.Tensor) and value.requires_grad:
        return False
    if t.requires_grad:
        return t.is_leaf and not recording
    return True


class NDArray:
    """An array on a device context: one ``torch.Tensor`` in ``_data``."""

    __slots__ = ("_data", "__weakref__")
    __array_priority__ = 100.0
    __array_ufunc__ = None    # numpy defers a mixed operator to NDArray's

    def __init__(self, data, ctx=None):
        """Wraps a tensor as it is (no copy); any other array (numpy, a
        list, a number) is converted by ``nd.array``'s rules onto ``ctx``
        (default: the current context). A tensor on another device than a
        given ``ctx`` is moved there."""
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _host_tensor(data, None).to(as_device(ctx))
        elif ctx is not None and data.device != as_device(ctx):
            data = data.to(as_device(ctx))
        self._data = data

    # ---------------------------------------------------------------- basics
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _mx_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return context_of(self._data)

    ctx = context

    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype``: itself for "default", else a
        ``sparse.RowSparseNDArray`` or ``sparse.CSRNDArray``."""
        if stype == "default":
            return self
        from . import sparse
        if stype == "row_sparse":
            return sparse.row_sparse_array(self)
        if stype == "csr":
            return sparse.csr_matrix(self)
        raise ValueError("unknown stype %r" % stype)

    def as_nd_ndarray(self):
        return self

    def __getstate__(self):
        # pickled as host numpy (bfloat16 widened, its name kept), so it
        # crosses process boundaries without device buffers; it unpickles
        # on the CPU
        return {"data": self.asnumpy(), "dtype": self.dtype.name}

    def __setstate__(self, state):
        self._data = torch.from_numpy(state["data"]).to(
            torch_dtype(state["dtype"]))

    def asnumpy(self):
        """A numpy copy; bfloat16 comes back as float32 (exact), as the
        served outputs do (``serving/registry.py``)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type != "cpu":
            return t.cpu().numpy()
        return t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().item()

    def item(self):
        return self.asnumpy().item()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        return bool(self.asscalar())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def wait_to_read(self):
        """Block until the array's pending work is done."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # -------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable of ``autograd.backward`` with a zero
        gradient buffer; ``grad_req`` is "write", "add" or "null". The
        gradient is dense whatever ``stype`` asks, as in the JAX package."""
        if stype not in (None, "default", "row_sparse", "csr"):
            raise ValueError("unknown stype %r" % stype)
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data.detach()))],
            grad_req)

    @property
    def grad(self):
        """The gradient buffer of a variable (``attach_grad``), else None."""
        return autograd._grad_array(self._data)

    def detach(self):
        return _apply(torch.Tensor.detach, self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # -------------------------------------------------------------- movement
    def copy(self):
        """A copy; gradients flow through it (MXNet's ``_copy``)."""
        return _apply(torch.clone, self)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, in place) or onto a Context."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            other[:] = self
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(
                as_device(other), copy=True))
        raise TypeError("copyto expects NDArray or Context")

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return _apply(lambda x: x.to(as_device(ctx)), self)

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return _apply(lambda x: x.to(dt, copy=True), self)

    # -------------------------------------------------------------- indexing
    def __getitem__(self, key):
        return _apply(operator.getitem, self, _index_key(key))

    def __setitem__(self, key, value):
        key = _index_key(key)
        t = self._data
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(device=t.device, dtype=t.dtype)
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(onp.asarray(value), device=t.device) \
                .to(t.dtype)
        if _writable_in_place(t, value):
            with torch.no_grad():
                t[key] = value
            return
        with torch.set_grad_enabled(autograd.is_recording()):
            new = t.clone()
            new[key] = value
        self._data = new

    def take(self, indices, axis=0, mode="clip"):
        return take(self, indices, axis=axis, mode=mode)

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, fn, reverse=False):
        if reverse:
            return _apply(lambda a, b: fn(b, a), self, _operand(other))
        return _apply(fn, self, _operand(other))

    def __add__(self, o): return self._binop(o, _tadd)
    def __radd__(self, o): return self._binop(o, _tadd, True)
    def __sub__(self, o): return self._binop(o, _tsub)
    def __rsub__(self, o): return self._binop(o, _tsub, True)
    def __mul__(self, o): return self._binop(o, _tmul)
    def __rmul__(self, o): return self._binop(o, _tmul, True)
    def __truediv__(self, o): return self._binop(o, _tdiv)
    def __rtruediv__(self, o): return self._binop(o, _tdiv, True)
    __div__ = __truediv__
    def __mod__(self, o): return self._binop(o, _tmod)
    def __rmod__(self, o): return self._binop(o, _tmod, True)
    def __pow__(self, o): return self._binop(o, _tpow)
    def __rpow__(self, o): return self._binop(o, _tpow, True)
    def __floordiv__(self, o): return self._binop(o, _tfloordiv)
    def __matmul__(self, o): return self._binop(o, torch.matmul)

    def _inplace(self, other, fn):
        other = _operand(other)
        t = self._data
        o = other._data if isinstance(other, NDArray) else other
        out_dtype = torch.result_type(t, o)
        if out_dtype == t.dtype and _writable_in_place(t, o) and (
                not isinstance(o, torch.Tensor)
                or torch.broadcast_shapes(t.shape, o.shape) == t.shape):
            with torch.no_grad():
                t.copy_(fn(t, o))
        else:
            self._data = _apply(fn, self, other)._data
        return self

    def __iadd__(self, o): return self._inplace(o, _tadd)
    def __isub__(self, o): return self._inplace(o, _tsub)
    def __imul__(self, o): return self._inplace(o, _tmul)
    def __itruediv__(self, o): return self._inplace(o, _tdiv)

    def __neg__(self): return _apply(torch.neg, self)
    def __abs__(self): return _apply(torch.abs, self)

    # comparisons return self's type, as the JAX package's operators do
    def _cmp(self, o, fn):
        return self._binop(o, lambda a, b: fn(a, b).to(a.dtype))

    def __eq__(self, o): return self._cmp(o, torch.eq)
    def __ne__(self, o): return self._cmp(o, torch.ne)
    def __lt__(self, o): return self._cmp(o, torch.lt)
    def __le__(self, o): return self._cmp(o, torch.le)
    def __gt__(self, o): return self._cmp(o, torch.gt)
    def __ge__(self, o): return self._cmp(o, torch.ge)

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- shape ops
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if "shape" in kwargs:
            shape = kwargs.pop("shape")
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if kwargs:
            raise TypeError("reshape got unexpected arguments %s"
                            % sorted(kwargs))
        return reshape(self, shape)

    def reshape_like(self, other):
        return reshape_like(self, other)

    def flatten(self):
        return flatten(self)

    @property
    def T(self):
        return transpose(self)

    def transpose(self, axes=None):
        return transpose(self, axes)

    def swapaxes(self, dim1, dim2):
        return swapaxes(self, dim1, dim2)

    def expand_dims(self, axis):
        return expand_dims(self, axis)

    def squeeze(self, axis=None):
        return squeeze(self, axis)

    def broadcast_to(self, shape):
        return broadcast_to(self, shape)

    def broadcast_like(self, other):
        return broadcast_like(self, other)

    def tile(self, reps):
        return tile(self, reps)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return split(self, num_outputs, axis, squeeze_axis)

    def slice(self, begin, end, step=None):
        return slice_op(self, begin, end, step)

    def slice_axis(self, axis, begin, end):
        return slice_axis(self, axis, begin, end)

    def pick(self, index, axis=-1, keepdims=False):
        return pick(self, index, axis, keepdims)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return one_hot(self, depth, on_value, off_value, dtype)

    # ------------------------------------------------------------ reductions
    def sum(self, axis=None, keepdims=False, exclude=False):
        return sum(self, axis, keepdims, exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return mean(self, axis, keepdims, exclude)

    def max(self, axis=None, keepdims=False, exclude=False):
        return max(self, axis, keepdims, exclude)

    def min(self, axis=None, keepdims=False, exclude=False):
        return min(self, axis, keepdims, exclude)

    def prod(self, axis=None, keepdims=False, exclude=False):
        return prod(self, axis, keepdims, exclude)

    def argmax(self, axis=None, keepdims=False):
        return argmax(self, axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return argmin(self, axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return norm(self, ord, axis, keepdims)

    def clip(self, a_min=None, a_max=None):
        return clip(self, a_min, a_max)

    # ------------------------------------------------------------- unary math
    def abs(self): return abs(self)
    def exp(self): return exp(self)
    def log(self): return log(self)
    def sqrt(self): return sqrt(self)
    def square(self): return square(self)
    def sign(self): return sign(self)
    def round(self): return round(self)
    def floor(self): return floor(self)
    def ceil(self): return ceil(self)
    def sigmoid(self): return sigmoid(self)
    def tanh(self): return tanh(self)
    def relu(self): return relu(self)
    def softmax(self, axis=-1): return softmax(self, axis=axis)
    def log_softmax(self, axis=-1): return log_softmax(self, axis=axis)

    def dot(self, other):
        return dot(self, other)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return topk(self, axis, k, ret_typ, is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return sort(self, axis, is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return argsort(self, axis, is_ascend)


# =============================================================== choke point

def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data, True
    if isinstance(x, (list, tuple)) and any(isinstance(e, NDArray)
                                            for e in x):
        return type(x)(e._data if isinstance(e, NDArray) else e
                       for e in x), True
    return x, False


def _wrap(out, inputs=()):
    """``out``'s tensors as NDArrays. One that is one of the tensors
    ``inputs`` or shares its storage (a view, ``x.to(x.dtype)``, ``detach``)
    comes back as a copy: no two NDArrays share memory, as no two JAX
    arrays do, so a write into one never shows in another."""
    if isinstance(out, torch.Tensor):
        if any(_shares_storage(out, x) for x in inputs):
            out = out.clone()
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o, inputs) for o in out)
    return out


def _as_ndarrays(tree):
    """``tree`` (tuples and lists, nested) with every tensor an NDArray
    over it (no copy; NDArrays stay as they are): what a block's hooks
    see."""
    if isinstance(tree, torch.Tensor):
        return NDArray(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_ndarrays(t) for t in tree)
    return tree


def _shares_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _apply(fn, *inputs, **kwargs):
    """Run the tensor function ``fn`` on ``inputs``: the one choke point of
    every ``nd`` operator (MXNet's ``Imperative::Invoke``) and of a block's
    call.

    NDArray arguments (and NDArrays inside a list or tuple argument) are
    unwrapped; when any was one, ``fn`` runs with torch's grad mode set to
    ``autograd.is_recording()`` and its tensors come back as NDArrays of
    their own (``_wrap``). Otherwise ``fn`` runs as called and its tensors
    come back as they are.

    While the profiler runs with ``profile_imperative``, each call on
    NDArrays is timed (``profiler.record_op``, synchronised) under the name
    of the public operator it belongs to (``_profiled_name``), as the JAX
    package's ``_apply`` times each of its calls.
    """
    wrapped = False
    args = []
    for x in inputs:
        x, w = _unwrap(x)
        wrapped |= w
        args.append(x)
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            kwargs[k] = v._data
            wrapped = True
    if not wrapped:
        return fn(*args, **kwargs)
    tensors = [t for x in (*args, *kwargs.values())
               for t in (x if isinstance(x, (list, tuple)) else (x,))
               if isinstance(t, torch.Tensor)]
    profiling = _profiler.imperative_active()
    if profiling:
        t0 = _profiler.now_us()
    with torch.set_grad_enabled(autograd.is_recording()):
        out = _wrap(fn(*args, **kwargs), tensors)
    if profiling:
        _profiler.record_op(_profiled_name(fn), t0,
                            out if isinstance(out, (list, tuple)) else [out])
    return out


def _profiled_name(fn):
    """The public operator a profiled ``_apply`` call belongs to: the
    innermost caller in the port that is a public function or method
    (``FullyConnected``, ``dot``, ``reshape``, ``__mul__``), or a wrapper
    that makes one (``_op``, ``_make_unary``, ``_make_binary``: the
    operator's own name); a block's call is named by the block's class.
    The JAX package names its events by its inner functions' qualified
    names (``FullyConnected.<locals>.fn_b``), which are its internals."""
    frame = sys._getframe(2)
    for _ in range(_NAME_DEPTH):
        if frame is None or not frame.f_globals.get(
                "__name__", "").startswith(_PACKAGE):
            break
        code = frame.f_code
        named = _WRAPPER_NAMES.get(code)
        if named is not None:
            return named(frame.f_locals)
        qual = code.co_qualname
        if "<" not in qual:
            last = qual.rsplit(".", 1)[-1]
            if last == "__call__" and "self" in frame.f_locals:
                return type(frame.f_locals["self"]).__name__
            if not last.startswith("_") or (last.startswith("__")
                                            and last.endswith("__")):
                return last
        frame = frame.f_back
    name = getattr(fn, "__name__", "")
    return name if name.isidentifier() and not name.startswith("_") else "op"


_PACKAGE = __name__.split(".")[0]
_NAME_DEPTH = 4


def _op(fn):
    """A public operator from its tensor function, through ``_apply``."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return _apply(fn, *args, **kwargs)
    op.__wrapped_tensor_fn__ = fn
    return op


def _operand(x):
    """A binary operator's other operand: NDArrays and tensors as they are,
    Python numbers as they are (weakly typed, as in JAX), numpy arrays as
    tensors (float64 narrowed to float32, JAX without x64)."""
    if isinstance(x, (NDArray, torch.Tensor, int, float, bool)):
        return x
    a = onp.asarray(x)
    if a.ndim == 0:
        return a.item()
    return torch.from_numpy(_narrow(a).copy())


def _as_tensor(x, like):
    """``x`` as a tensor on ``like``'s device: a Python number becomes a
    0-dim tensor, which loses type promotion to ``like`` within its kind
    (JAX's weak types)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == like.device or x.dim() == 0 \
            else x.to(like.device)
    return torch.full((), x, device=like.device)   # no copy: capture-safe


def _binary(fn):
    """A binary tensor function that also takes a Python number on either
    side."""
    def op(a, b):
        if not isinstance(a, torch.Tensor):
            a = _as_tensor(a, b)
        elif not isinstance(b, torch.Tensor):
            b = _as_tensor(b, a)
        return fn(a, b)
    return op


_tadd = _binary(torch.add)
_tsub = _binary(torch.sub)
_tmul = _binary(torch.mul)
_tdiv = _binary(torch.true_divide)
_tmod = _binary(torch.remainder)
_tpow = _binary(torch.pow)
_tfloordiv = _binary(torch.floor_divide)


def _index_key(key):
    def fix(k):
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, torch.Tensor) and k.is_floating_point():
            k = k.long()
        return k
    if isinstance(key, tuple):
        return tuple(fix(k) for k in key)
    return fix(key)


def _narrow(a):
    """JAX without x64: float64 → float32, int64 → int32."""
    if a.dtype == onp.float64:
        return a.astype(onp.float32)
    if a.dtype == onp.int64:
        return a.astype(onp.int32)
    return a


# ================================================================== creation

def _host_tensor(source, dtype):
    """A CPU tensor copy of numpy data or a Python list/number, by the JAX
    package's dtype rules when ``dtype`` is None."""
    if isinstance(source, (list, tuple, int, float)) and dtype is None:
        return torch.tensor(source, dtype=torch.float32)
    a = onp.asarray(source)
    if a.dtype.name == "bfloat16":          # ml_dtypes: keep the raw bits
        return torch.from_numpy(a.view(onp.uint16).copy()) \
            .view(torch.bfloat16)
    if dtype is None:
        a = _narrow(a)
    return torch.from_numpy(onp.array(a, copy=True))


def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default: the current context) from an NDArray,
    a tensor, a numpy array or a Python list/number. Without ``dtype``,
    Python lists and float64 become float32 and int64 becomes int32 (the
    JAX package's rules); a copy is always made."""
    device = as_device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach().to(device, copy=True)
    else:
        t = _host_tensor(source_array, dtype).to(device)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    if getattr(ctx, "device_type", None) == "cpu_pinned" \
            and torch.cuda.is_available():
        t = t.pin_memory()
    return NDArray(t)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=as_device(ctx)))


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=as_device(ctx)))


def full(shape, val, ctx=None, dtype="float32", **kwargs):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=as_device(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    """Zeros, as in the JAX package (which has no uninitialised memory)."""
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """[start, stop) by ``step``, each value ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=as_device(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray(out)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    """An N x M (M=0: N x N) matrix with ones on diagonal ``k``."""
    device = as_device(ctx)
    M = M or N
    rows = torch.arange(N, device=device).unsqueeze(1)
    cols = torch.arange(M, device=device).unsqueeze(0)
    return NDArray((cols - rows == k).to(torch_dtype(dtype)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    num = int(num)
    device = as_device(ctx)
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64,
                             device=device)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                             device=device)[:num]
    return NDArray(out.to(torch_dtype(dtype)))


@_op
def zeros_like(a):
    return torch.zeros_like(a)


@_op
def ones_like(a):
    return torch.ones_like(a)


def waitall():
    """Block until all launched work on every card is done."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ================================================================== op tables

def _cbrt(x):
    x = x if x.is_floating_point() else x.float()
    return x.sign() * x.abs().pow(1.0 / 3.0)


def _float(fn):
    """``fn`` on floats: an integer input is computed in float32, as jnp
    promotes it."""
    def op(x):
        return fn(x if x.is_floating_point() else x.float())
    return op


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "round": torch.round,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc, "square": torch.square,
    "sqrt": _float(torch.sqrt), "rsqrt": _float(torch.rsqrt), "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": _float(torch.exp), "log": _float(torch.log),
    "log10": _float(torch.log10), "log2": _float(torch.log2),
    "log1p": _float(torch.log1p), "expm1": _float(torch.expm1),
    "sin": _float(torch.sin), "cos": _float(torch.cos),
    "tan": _float(torch.tan), "arcsin": _float(torch.asin),
    "arccos": _float(torch.acos), "arctan": _float(torch.atan),
    "sinh": _float(torch.sinh), "cosh": _float(torch.cosh),
    "tanh": _float(torch.tanh), "arcsinh": _float(torch.asinh),
    "arccosh": _float(torch.acosh), "arctanh": _float(torch.atanh),
    "degrees": _float(torch.rad2deg), "radians": _float(torch.deg2rad),
    "reciprocal": _float(torch.reciprocal), "negative": torch.neg,
    "erf": _float(torch.erf), "erfinv": _float(torch.erfinv),
    "gamma": _float(lambda x: torch.exp(torch.lgamma(x))),
    "gammaln": _float(torch.lgamma),
    "sigmoid": _float(torch.sigmoid), "relu": torch.relu,
    "softsign": _float(F.softsign),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}


def _promoted(fn):
    """A predicate cast to the promoted type of its operands."""
    def op(a, b):
        return fn(a, b).to(torch.result_type(a, b))
    return op


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "modulo": torch.remainder,
    "power": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": lambda a, b: torch.hypot(*_floats(a, b)),
    "arctan2": lambda a, b: torch.atan2(*_floats(a, b)),
    "equal": _promoted(torch.eq), "not_equal": _promoted(torch.ne),
    "greater": _promoted(torch.gt), "greater_equal": _promoted(torch.ge),
    "lesser": _promoted(torch.lt), "lesser_equal": _promoted(torch.le),
    "logical_and": _promoted(lambda a, b: (a != 0) & (b != 0)),
    "logical_or": _promoted(lambda a, b: (a != 0) | (b != 0)),
    "logical_xor": _promoted(lambda a, b: (a != 0) ^ (b != 0)),
}


def _floats(a, b):
    dt = torch.result_type(a, b)
    if not dt.is_floating_point:
        dt = torch.float32
    return a.to(dt), b.to(dt)


def _make_unary(fn, name):
    def op(data, **kwargs):
        if kwargs:
            raise TypeError("%s got unexpected arguments %s"
                            % (name, sorted(kwargs)))
        return _apply(fn, data)
    op.__name__ = op.__qualname__ = name
    return op


def _make_binary(fn, name):
    fn = _binary(fn)

    def op(lhs, rhs, **kwargs):
        if kwargs:
            raise TypeError("%s got unexpected arguments %s"
                            % (name, sorted(kwargs)))
        return _apply(fn, _operand(lhs), _operand(rhs))
    op.__name__ = op.__qualname__ = name
    return op


# the wrappers that make public operators, and how each names its own
_WRAPPER_NAMES = {
    _op(len).__code__: lambda local: local["fn"].__name__,
    _make_unary(len, "").__code__: lambda local: local["name"],
    _make_binary(len, "").__code__: lambda local: local["name"],
}

_g = globals()
for _name, _fn in _UNARY.items():
    _g[_name] = _make_unary(_fn, _name)
    __all__.append(_name)
for _name, _fn in _BINARY.items():
    _g[_name] = _make_binary(_fn, _name)
    _g["broadcast_" + _name] = _g[_name]
    __all__ += [_name, "broadcast_" + _name]
del _g, _name, _fn

broadcast_sub = broadcast_minus = broadcast_subtract  # noqa: F821
broadcast_mul = broadcast_multiply  # noqa: F821
broadcast_div = broadcast_divide  # noqa: F821
broadcast_mod = broadcast_modulo  # noqa: F821
broadcast_plus = broadcast_add  # noqa: F821
elemwise_add = add  # noqa: F821
elemwise_sub = subtract  # noqa: F821
elemwise_mul = multiply  # noqa: F821
elemwise_div = divide  # noqa: F821
true_divide = divide  # noqa: F821
mod = modulo  # noqa: F821
__all__ += ["broadcast_sub", "broadcast_minus", "broadcast_mul",
            "broadcast_div", "broadcast_mod", "broadcast_plus",
            "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
            "true_divide", "mod"]


# ================================================================= shape ops

def _mx_reshape(old, new):
    """MXNet reshape codes: 0 copies a dim, -1 infers one, -2 copies the
    rest, -3 merges two dims, -4 splits one into the next two entries."""
    if -2 not in new and -3 not in new and -4 not in new:
        return tuple(old[i] if d == 0 else d for i, d in enumerate(new))
    out, i, j = [], 0, 0
    while j < len(new):
        d = new[j]
        if d == 0:
            out.append(old[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(old[i:])
            i = len(old)
        elif d == -3:
            out.append(old[i] * old[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = new[j + 1], new[j + 2]
            if d1 == -1:
                d1 = old[i] // d2
            if d2 == -1:
                d2 = old[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    return tuple(out)


@_op
def reshape(data, shape):
    """Reshape with MXNet's codes (0, -1, -2, -3, -4)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return data.reshape(_mx_reshape(tuple(data.shape), shape))


@_op
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@_op
def Flatten(data):
    """(N, ...) → (N, prod(...)), MXNet's Flatten."""
    return data.reshape(data.shape[0] if data.dim() else 1, -1)


flatten = Flatten


@_op
def transpose(data, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@_op
def swapaxes(data, dim1=0, dim2=1):
    return data.transpose(dim1, dim2)


SwapAxis = swapaxes


@_op
def expand_dims(data, axis):
    return data.unsqueeze(axis)


@_op
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis if isinstance(axis, int) else tuple(axis))


@_op
def broadcast_to(data, shape):
    return data.expand(tuple(shape))


@_op
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@_op
def broadcast_axis(data, axis=None, size=None):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return data.expand(shape)


@_op
def tile(data, reps):
    return torch.tile(data, (reps,) if isinstance(reps, int) else tuple(reps))


@_op
def repeat(data, repeats, axis=None):
    """``jnp.repeat``: each element ``repeats`` times along ``axis`` (the
    flattened array when None)."""
    return torch.repeat_interleave(data, repeats, dim=axis)


def _pad_index(n, before, after, mode, device):
    """Indices into an axis of size ``n`` that pad it by ``before`` and
    ``after`` as numpy's "edge" or "reflect" mode (the edge not repeated,
    reflecting again past the far end), made on ``device``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


@_op
def pad(data, mode="constant", pad_width=None, constant_value=0):
    """``pad_width`` in MXNet's flat (before, after) order, one pair per
    axis; any axis may be padded in each mode ("constant", "edge",
    "reflect"), as ``jnp.pad`` pads in the JAX package."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [p for pair in reversed(pw) for p in pair]
        return F.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unsupported pad mode %r" % (mode,))
    out = data
    for axis, (before, after) in enumerate(pw):
        if before or after:
            out = out.index_select(axis, _pad_index(
                data.shape[axis], before, after, mode, data.device))
    return out


@_op
def flip(data, axis):
    return torch.flip(data, (axis,) if isinstance(axis, int) else tuple(axis))


reverse = flip


@_op
def concat(*data, dim=1, axis=None, num_args=None):
    """Join along ``dim`` (or ``axis``); takes the arrays as arguments or
    as one list."""
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.cat(data, dim=dim if axis is None else axis)


Concat = concat


def concatenate(arrays, axis=0):
    return concat(*arrays, dim=axis)


@_op
def stack(*data, axis=0, num_args=None):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return torch.stack(data, dim=axis)


def _split_parts(x, sections, axis, squeeze_axis):
    if isinstance(sections, int):
        n = x.shape[axis]
        if n % sections:
            raise ValueError("array split does not result in an equal "
                             "division: %d into %d" % (n, sections))
        parts = torch.split(x, n // sections, dim=axis)
    else:
        parts = torch.tensor_split(x, list(sections), dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return list(parts)


@_op
def _split(data, num_outputs, axis=1, squeeze_axis=False):
    return _split_parts(data, num_outputs, axis, squeeze_axis)


def split(data, num_outputs, axis=1, squeeze_axis=False):
    """MXNet's SliceChannel: ``num_outputs`` equal parts along ``axis`` (a
    list; the part itself when ``num_outputs`` is 1)."""
    out = _split(data, num_outputs, axis, squeeze_axis)
    return out if num_outputs > 1 else out[0]


SliceChannel = split


@_op
def split_v2(ary, indices_or_sections=1, axis=0, squeeze_axis=False):
    """numpy-style split: equal sections or index points; always a list."""
    sections = tuple(indices_or_sections) \
        if isinstance(indices_or_sections, (list, tuple)) \
        else indices_or_sections
    return _split_parts(ary, sections, axis, squeeze_axis)


def _slice_axes(x, idx):
    """``x[idx]`` for a tuple of slices, a negative step included (torch
    slicing takes only positive steps)."""
    plain, flips = [], []
    for a, s in enumerate(idx):
        if s.step is not None and s.step < 0:
            plain.append(builtins.slice(None))
            flips.append((a, s))
        else:
            plain.append(s)
    out = x[tuple(plain)]
    for a, s in flips:
        ids = torch.arange(*s.indices(x.shape[a]), device=x.device)
        out = out.index_select(a, ids)
    return out


@_op
def slice_op(data, begin, end, step=None):
    """MXNet's ``slice``: ``begin``/``end``/``step`` per leading axis (None
    entries take the whole axis)."""
    n = data.dim()
    begin = list(begin) + [None] * (n - len(begin))
    end = list(end) + [None] * (n - len(end))
    step = list(step) + [None] * (n - len(step)) if step else [None] * n
    return _slice_axes(data, tuple(builtins.slice(b, e, s)
                                   for b, e, s in zip(begin, end, step)))


@_op
def slice_axis(data, axis, begin, end):
    idx = [builtins.slice(None)] * data.dim()
    if end is None or end == 0 and begin < 0:
        end = None
    idx[axis] = builtins.slice(begin, end)
    return data[tuple(idx)]


@_op
def slice_like(data, shape_like, axes=None):
    idx = [builtins.slice(None)] * data.dim()
    for a in (axes if axes is not None else range(data.dim())):
        idx[a] = builtins.slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@_op
def moveaxis(data, source, destination):
    return torch.movedim(data, source, destination)


@_op
def depth_to_space(data, block_size):
    """(N, C·b², H, W) → (N, C, H·b, W·b), DCR order."""
    b = block_size
    N, C, H, W = data.shape
    c = C // (b * b)
    y = data.reshape(N, b, b, c, H, W).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(N, c, H * b, W * b)


@_op
def space_to_depth(data, block_size):
    """(N, C, H·b, W·b) → (N, C·b², H, W), depth_to_space's inverse."""
    b = block_size
    N, C, Hb, Wb = data.shape
    H, W = Hb // b, Wb // b
    y = data.reshape(N, C, H, b, W, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(N, C * b * b, H, W)


@_op
def diag(data, k=0):
    """``jnp.diag`` for 1-D/2-D data, ``jnp.diagonal`` above."""
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, k)


# ================================================================ reductions

def _axes(axis, ndim, exclude=False):
    """A reduction's axes as a tuple (every axis for None)."""
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % ndim for a in axes) if ndim else ()
    if exclude:
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


def _int_result(x):
    """jnp's accumulation type for an integer or bool reduction: int32,
    int64 kept (the port holds int64, JAX without x64 does not)."""
    return x.dtype if x.dtype == torch.int64 else torch.int32


def _make_reduce(name, reduce_fn):
    def fn(data, axis=None, keepdims=False, exclude=False):
        return reduce_fn(data, _axes(axis, data.dim(), exclude), keepdims)
    fn.__name__ = fn.__qualname__ = name
    return _op(fn)


def _sum(x, axes, keepdims):
    if not x.is_floating_point():
        return torch.sum(x, dim=axes, keepdim=keepdims, dtype=_int_result(x))
    return torch.sum(x, dim=axes, keepdim=keepdims)


def _mean(x, axes, keepdims):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _amax(x, axes, keepdims):
    return torch.amax(x, dim=axes, keepdim=keepdims) if axes else x


def _amin(x, axes, keepdims):
    return torch.amin(x, dim=axes, keepdim=keepdims) if axes else x


def _prod(x, axes, keepdims):
    dtype = None if x.is_floating_point() else _int_result(x)
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims, dtype=dtype)
    return x


sum = _make_reduce("sum", _sum)
mean = _make_reduce("mean", _mean)
max = _make_reduce("max", _amax)
min = _make_reduce("min", _amin)
prod = _make_reduce("prod", _prod)


@_op
def norm(data, ord=2, axis=None, keepdims=False):
    """L1 (``ord=1``) or L2 norm over ``axis`` (every axis for None)."""
    axes = _axes(axis, data.dim())
    if ord == 1:
        return data.abs().sum(dim=axes, keepdim=keepdims)
    if ord != 2:
        raise ValueError("norm takes ord 1 or 2, got %r" % (ord,))
    return torch.sqrt(data.square().sum(dim=axes, keepdim=keepdims))


def _argreduce(fn, x, axis, keepdims):
    """MXNet's float indices: float32, float64 past 2^24 elements (where
    float32 can no longer hold every index exactly)."""
    extent = x.numel() if axis is None else x.shape[axis]
    dtype = torch.float64 if extent > (1 << 24) else torch.float32
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * x.dim())
        return out.to(dtype)
    return fn(x, dim=axis, keepdim=keepdims).to(dtype)


@_op
def argmax(data, axis=None, keepdims=False):
    return _argreduce(torch.argmax, data, axis, keepdims)


@_op
def argmin(data, axis=None, keepdims=False):
    return _argreduce(torch.argmin, data, axis, keepdims)


@_op
def moments(data, axes=None, keepdims=False):
    """(mean, biased variance) over ``axes``."""
    x = data if data.is_floating_point() else data.float()
    ax = _axes(axes, x.dim())
    m = x.mean(dim=ax, keepdim=True)
    v = (x - m).square().mean(dim=ax, keepdim=keepdims)
    return m if keepdims else m.squeeze(ax), v


# ================================================================== indexing

def _take_fill(dtype):
    """``jnp.take``'s fill value for an id out of range: NaN for floats, the
    least value of a signed type, the largest of an unsigned one, True."""
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _fill_ids(ids, n):
    """(clamped ids, valid mask) for ``jnp.take``'s "fill" mode: ids in
    [-n, 0) wrap, any other id outside [0, n) is invalid."""
    ids = ids.long()
    valid = (ids >= -n) & (ids < n)
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1), valid


@_op
def take(a, indices, axis=0, mode="clip"):
    """Gather along ``axis``: "clip" clamps ids into range, "wrap" takes
    them modulo the axis, any other mode fills ids out of range as
    ``jnp.take`` does (NaN rows for floats)."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.long() if isinstance(indices, torch.Tensor) \
        else torch.as_tensor(indices, device=a.device).long()
    valid = None
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx, valid = _fill_ids(idx, n)
    out = a.index_select(axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if valid is None:
        return out
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (a.dim() - axis - 1))
    return torch.where(mask, out, _take_fill(a.dtype))


@_op
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis`` (indices clipped into range)."""
    if mode != "clip":
        raise ValueError("only mode='clip' is ported, got %r" % (mode,))
    axis = axis % data.dim()
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    picked = torch.gather(data, axis, idx)
    return picked if keepdims else picked.squeeze(axis)


@_op
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """Rows of ``depth``; an id outside [0, depth) gives a row of
    ``off_value``, as ``jax.nn.one_hot``."""
    dt = torch_dtype(dtype)
    oh = (indices.long().unsqueeze(-1)
          == torch.arange(depth, device=indices.device)).to(dt)
    return oh * (on_value - off_value) + off_value


def _nd_index(idx, shape):
    """The rows of an (M, ...) index array as M index tensors: negative ids
    wrap, then every id is clamped into its axis, as ``x[...]`` gathers in
    JAX."""
    idx = idx.long()
    out = []
    for i in range(idx.shape[0]):
        n = shape[i]
        r = idx[i]
        out.append(torch.where(r < 0, r + n, r).clamp(0, n - 1))
    return tuple(out)


@_op
def gather_nd(data, indices):
    return data[_nd_index(indices, data.shape)]


@_op
def scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` set at ``indices`` ((M, ...) ids of
    the first M axes). Negative ids wrap; any other id out of range is
    dropped, as JAX's ``.at[].set``, through a spare row that is cut off."""
    shape = tuple(shape)
    idx = indices.long()
    m = idx.shape[0]
    lead, rest = shape[:m], shape[m:]
    flat = torch.zeros(idx.shape[1:], dtype=torch.long, device=idx.device)
    valid = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    for i, n in enumerate(lead):
        r = idx[i]
        r = torch.where(r < 0, r + n, r)
        valid &= (r >= 0) & (r < n)
        flat = flat * n + r.clamp(0, n - 1)
    rows = math.prod(lead)
    flat = torch.where(valid, flat, rows).reshape(-1)
    out = torch.zeros((rows + 1,) + rest, dtype=data.dtype,
                      device=data.device)
    out = out.index_put((flat,), data.reshape((-1,) + rest))
    return out[:rows].reshape(shape)


@_op
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``; ids out of range fill as
    ``jnp.take_along_axis`` does (NaN for floats)."""
    idx, valid = _fill_ids(indices.reshape(-1), a.shape[1])
    out = torch.gather(a, 1, idx.unsqueeze(1))[:, 0]
    return torch.where(valid, out, _take_fill(a.dtype))


@_op
def where(condition, x, y):
    return torch.where(condition != 0, x, y)


@_op
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``:
    "value", "indices" (as ``dtype``) or "both"."""
    if ret_typ not in ("value", "indices", "both"):
        raise ValueError("unsupported ret_typ %r" % (ret_typ,))
    vals, idxs = torch.topk(data, k, dim=axis, largest=not is_ascend)
    idxs = idxs.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    return idxs


@_op
def sort(data, axis=-1, is_ascend=True):
    s = torch.sort(data, dim=axis, stable=True).values
    return s if is_ascend else torch.flip(s, (axis,))


@_op
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """Stable ascending order, flipped for ``is_ascend=False`` (so ties come
    last-first, as the JAX package's)."""
    s = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        s = torch.flip(s, (axis,))
    return s.to(torch_dtype(dtype))


@_op
def shape_array(data):
    """The shape as an int64 array."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@_op
def size_array(data):
    """The element count as a (1,) int64 array."""
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@_op
def arange_like(data, start=0.0, step=1.0, axis=None):
    """``start + step * arange`` shaped like ``data`` (or the length of its
    ``axis``)."""
    if axis is None:
        n = data.numel()
        return (start + step * torch.arange(n, device=data.device)) \
            .reshape(data.shape).to(torch.float32)
    return (start + step * torch.arange(data.shape[axis],
                                        device=data.device)) \
        .to(torch.float32)


# ===================================================== casts, products, rest

@_op
def cast(data, dtype):
    return data.to(torch_dtype(dtype))


Cast = amp_cast = cast


@_op
def amp_multicast(*data, num_outputs=None):
    """Every input cast to the widest of their types."""
    widest = data[0].dtype
    for d in data[1:]:
        widest = torch.promote_types(widest, d.dtype)
    return [d.to(widest) for d in data]


@_op
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` against the first of ``rhs``
    (each fully transposed first when asked)."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


@_op
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@_op
def khatri_rao(*args):
    """Column-wise Kronecker product of (R_i, C) matrices."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@_op
def trace(data, offset=0, axis1=0, axis2=1):
    return torch.diagonal(data, offset, axis1, axis2).sum(-1)


@_op
def clip(data, a_min, a_max):
    return torch.clamp(data, a_min, a_max)


@_op
def maximum_scalar(data, scalar):
    return torch.maximum(data, _as_tensor(scalar, data))


@_op
def identity(data):
    return data.clone()


@_op
def BlockGrad(data):
    """The identity with no gradient."""
    return data.detach()


stop_gradient = BlockGrad


def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """``data * grad_scale``, and ``data`` itself for a scale of 1, as in
    the JAX package (whose ``make_loss`` ignores ``valid_thresh`` and
    ``normalization``, so the port does)."""
    if grad_scale == 1.0:
        return data
    return _apply(lambda d: d * grad_scale, data)


@_op
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@_op
def smooth_l1(data, scalar=1.0):
    """Huber with sigma ``scalar``."""
    s2 = float(scalar) ** 2
    ax = data.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data * data, ax - 0.5 / s2)


@_op
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@_op
def digamma(data):
    return torch.digamma(data if data.is_floating_point() else data.float())


@_op
def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    """The identity; the KL sparseness penalty of the backward is not
    replicated, as in the JAX package."""
    return data.clone()


# =================================================================== nn-style

@_op
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **kw):
    """y = x Wᵀ + b, with W of shape (num_hidden, in_units)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    y = torch.matmul(x, weight.t())
    if no_bias or bias is None:
        return y
    return y + bias


_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign,
    "log_sigmoid": F.logsigmoid, "mish": F.mish,
}


@_op
def Activation(data, act_type="relu", **kw):
    """relu, sigmoid, tanh, softrelu (softplus), softsign, log_sigmoid and
    mish, as the JAX package's table."""
    if act_type not in _ACTIVATIONS:
        raise ValueError("unsupported act_type %r" % act_type)
    return _ACTIVATIONS[act_type](data)


@_op
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334, **kw):
    """MXNet's LeakyReLU family: "leaky" (``slope`` x below 0), "prelu"
    (the learned ``gamma``, one per channel of axis 1, or broadcast as
    given), "elu" (``slope`` (eˣ - 1) below 0), "selu", "gelu" (exact, erf)
    and "rrelu" with the mean of its slope bounds, as the JAX package
    computes it (MXNet's inference-mode rrelu)."""
    x = data
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return torch.selu(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "prelu":
        if x.dim() > 1 and gamma.dim() == 1:
            gamma = gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, gamma * x)
    if act_type == "rrelu":
        return torch.where(x >= 0, x, (lower_bound + upper_bound) / 2.0 * x)
    raise ValueError("unsupported act_type %r" % act_type)


@_op
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, **kw):
    """Normalise over ``axis`` in float32 and cast back to the input type."""
    xf = data.float()
    m = xf.mean(dim=axis, keepdim=True)
    v = xf.var(dim=axis, keepdim=True, unbiased=False)
    shp = [1] * data.ndim
    shp[axis if axis >= 0 else data.ndim + axis] = data.shape[axis]
    out = (xf - m) * torch.rsqrt(v + eps) * gamma.reshape(shp) \
        + beta.reshape(shp)
    return out.to(data.dtype)


@_op
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5, **kw):
    """Normalise (N, C, ...) data over each of ``num_groups`` channel
    groups and its spatial axes, in float32, then scale and shift per
    channel; cast back to the input type."""
    n, c = data.shape[:2]
    xf = data.float().reshape((n, num_groups, c // num_groups)
                              + tuple(data.shape[2:]))
    axes = tuple(range(2, xf.dim()))
    m = xf.mean(dim=axes, keepdim=True)
    v = xf.var(dim=axes, keepdim=True, unbiased=False)
    xn = ((xf - m) * torch.rsqrt(v + eps)).reshape(data.shape)
    shp = (1, c) + (1,) * (data.dim() - 2)
    return (xn * gamma.reshape(shp) + beta.reshape(shp)).to(data.dtype)


@_op
def InstanceNorm(data, gamma, beta, eps=1e-3, **kw):
    """Normalise (N, C, ...) data over its spatial axes per sample and
    channel, then scale and shift per channel, in the input's type (as the
    JAX package computes it)."""
    axes = tuple(range(2, data.dim()))
    m = data.mean(dim=axes, keepdim=True)
    v = data.var(dim=axes, keepdim=True, unbiased=False)
    shp = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    out = (data - m) * torch.rsqrt(v + eps) * gamma.reshape(shp) \
        + beta.reshape(shp)
    return out.to(data.dtype)


@_op
def Embedding(data, weight, input_dim=None, output_dim=None, **kw):
    """Gather rows of ``weight`` (input_dim, output_dim) by integer ids, as
    the JAX package's ``jnp.take`` (mode "fill"): an id in [-input_dim, 0)
    wraps, any other id outside [0, input_dim) gives a row of NaN (of the
    fill value, for an integer weight) and no gradient. The gather reads
    clamped ids, so no id indexes out of bounds: on the card an
    out-of-bounds gather trips a device-side assert, which leaves the
    process's CUDA context unusable."""
    ids, valid = _fill_ids(data, weight.shape[0])
    rows = F.embedding(ids, weight)
    return torch.where(valid.unsqueeze(-1), rows, _take_fill(weight.dtype))


@_op
def softmax(data, axis=-1, temperature=None, length=None, **kw):
    """softmax along ``axis``. With ``length`` (the data's shape without
    ``axis``), only the first ``length`` entries along ``axis`` take part:
    the others are -inf before the softmax and 0 after, as in the JAX
    package (whose mask is built along the last axis; here it is built
    along ``axis``, which is the same for the last axis)."""
    x = data / temperature if temperature else data
    if length is None:
        return torch.softmax(x, dim=axis)
    axis = axis % x.dim()
    pos = torch.arange(x.shape[axis], device=x.device).reshape(
        [-1 if i == axis else 1 for i in range(x.dim())])
    mask = pos < torch.as_tensor(length, device=x.device).long() \
        .unsqueeze(axis)
    out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=axis)
    return out.masked_fill(~mask, 0.0)


@_op
def log_softmax(data, axis=-1, temperature=None, **kw):
    """log(softmax(x)) along ``axis``, in the input's type."""
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@_op
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            training=None, generator=None, **kw):
    """Inverted dropout; the identity outside training or for p <= 0.
    ``training=None`` reads ``autograd.is_training()``, as the JAX package
    does: dropout is active under ``autograd.record()``/``train_mode()``
    and in ``jit.TrainStep``, never in ``EvalStep`` or serving. ``mode``
    and ``cudnn_off`` hold the JAX package's argument order and are
    ignored, as there."""
    if training is None:
        training = autograd.is_training()
    if not training or p <= 0:
        return data
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = autograd._remat_keep(lambda: torch.rand(
        shape, generator=generator, device=data.device) < keep)
    return data * mask.to(data.dtype) / keep


def _fit(v, n, fill):
    """``v`` (None, an int or a tuple) as an ``n``-tuple: cut to ``n``,
    padded with ``fill``, as the JAX package pads stride/dilate/pad."""
    if v is None or v == ():
        return (fill,) * n
    v = (v,) if isinstance(v, int) else tuple(v)[:n]
    return v + (fill,) * (n - len(v))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@_op
def Convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    """Channel-first convolution (NCW, NCHW or NCDHW by the kernel's rank)
    with OI… weights; the bias is added after the conv, as in the JAX
    package."""
    n = len(kernel) if kernel else weight.dim() - 2
    if n not in _CONV:
        raise ValueError("Convolution takes 1 to 3 spatial axes, got %d" % n)
    if layout is not None and not str(layout).startswith("NC"):
        raise ValueError("Convolution takes channel-first layouts, got %r"
                         % (layout,))
    y = _CONV[n](data, weight, None, _fit(stride, n, 1), _fit(pad, n, 0),
                 _fit(dilate, n, 1), num_group)
    if no_bias or bias is None:
        return y
    return y + bias.reshape((1, -1) + (1,) * n)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@_op
def Deconvolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                  dilate=(1, 1), pad=(0, 0), adj=(0, 0), num_filter=None,
                  num_group=1, no_bias=False, target_shape=None, layout=None,
                  **kw):
    """Transposed convolution, channel first, with MXNet's (in, out /
    num_group, *kernel) weight: output size s·(i - 1) + d·(k - 1) + 1 -
    2·pad + adj along each spatial axis. A ``target_shape`` with any
    nonzero entry sets pad and adj from the output size it asks for, as
    MXNet's ``InferPad`` does: total = s·(i - 1) + d·(k - 1) + 1 - target,
    adj = total mod 2, pad = ⌈total / 2⌉."""
    n = len(kernel) if kernel else weight.dim() - 2
    if n not in _CONV_T:
        raise ValueError("Deconvolution takes 1 to 3 spatial axes, got %d"
                         % n)
    if layout is not None and not str(layout).startswith("NC"):
        raise ValueError("Deconvolution takes channel-first layouts, got %r"
                         % (layout,))
    stride, dilate = _fit(stride, n, 1), _fit(dilate, n, 1)
    pad, adj = _fit(pad, n, 0), _fit(adj, n, 0)
    if target_shape is not None and any(target_shape):
        k = weight.shape[2:]
        total = [s * (i - 1) + d * (kk - 1) + 1 - t for s, i, d, kk, t in
                 zip(stride, data.shape[2:], dilate, k, _fit(target_shape,
                                                             n, 0))]
        if any(t < 0 for t in total):
            raise ValueError("Deconvolution: target_shape %s is too big"
                             % (tuple(target_shape),))
        adj = tuple(t % 2 for t in total)
        pad = tuple((t + 1) // 2 for t in total)
    if data.dtype in (torch.float16, torch.bfloat16):
        # accumulate in float32 and round once, as XLA does for the JAX
        # package: cuDNN's fp16 transposed convolution rounds partial sums
        # (5 % off a small output of the op sweep on the H100)
        y = _CONV_T[n](data.float(), weight.float(), None, stride, pad, adj,
                       num_group, dilate).to(data.dtype)
    else:
        y = _CONV_T[n](data, weight, None, stride, pad, adj, num_group,
                       dilate)
    if no_bias or bias is None:
        return y
    return y + bias.reshape((1, -1) + (1,) * n)


@_op
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, **kw):
    """Max, avg, sum or lp pooling over the 1 to 3 spatial axes of
    channel-first data (NCW, NCHW, NCDHW), or over every spatial axis with
    ``global_pool`` (where every type but max takes the mean, as the JAX
    package does).

    Padding is explicit, as the JAX package's ``reduce_window`` padding is:
    ``pad`` on both sides, and with ``pooling_convention="full"`` the extra
    high-side padding that makes the last partial window count (not
    PyTorch's ``ceil_mode`` rule, which drops a window that starts in the
    padding). Max pads with -inf; avg, sum and lp with zeros. Avg divides
    by the kernel's size (``count_include_pad``) or by the count of real
    elements in the window; lp is (Σ|x|ᵖ)^(1/p) with ``p_value`` (2)."""
    if global_pool:
        axes = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    n = data.dim() - 2
    if n not in (1, 2, 3):
        raise ValueError("Pooling takes channel-first data with 1 to 3 "
                         "spatial axes, got shape %s" % (tuple(data.shape),))
    if layout is not None and layout != ("NCW", "NCHW", "NCDHW")[n - 1]:
        raise ValueError("Pooling takes channel-first layouts, got %r"
                         % (layout,))
    kernel = _fit(kernel, n, 1)
    stride = _fit(stride, n, 1)
    pad = _fit(pad, n, 0)
    extra = [0] * n
    if pooling_convention == "full":
        for i in range(n):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if rem else 0
    elif pooling_convention != "valid":
        raise ValueError("unknown pooling_convention %r" % pooling_convention)
    padding = [p for i in reversed(range(n))
               for p in (pad[i], pad[i] + extra[i])]
    if n == 1:        # as 2-D pooling over (1, W)
        kernel, stride = (1,) + kernel, (1,) + stride
    max_pool = F.max_pool3d if n == 3 else F.max_pool2d
    sum_pool = functools.partial(F.avg_pool3d if n == 3 else F.avg_pool2d,
                                 kernel_size=kernel, stride=stride,
                                 divisor_override=1)

    def spatial(x):
        return x.unsqueeze(2) if n == 1 else x

    def out(y):
        return y.squeeze(2) if n == 1 else y

    if pool_type == "max":
        return out(max_pool(spatial(F.pad(data, padding, value=-math.inf)),
                            kernel, stride))
    if pool_type == "lp":
        p = kw.get("p_value", 2) or 2
        return out(sum_pool(spatial(F.pad(data.abs() ** p, padding)))) \
            ** (1.0 / p)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unsupported pool_type %r" % pool_type)
    s = out(sum_pool(spatial(F.pad(data, padding))))
    if pool_type == "sum":
        return s
    if count_include_pad:
        return s / math.prod(kernel)
    ones_ = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                       device=data.device)
    return s / out(sum_pool(spatial(F.pad(ones_, padding))))


def _bshape(data, axis):
    return tuple(data.shape[i] if i == axis else 1 for i in range(data.dim()))


@torch.no_grad()
def _batch_stats(x, shift, axis):
    """(mean, var) of ``x`` over every axis but ``axis``, in fp32, by the
    JAX package's shifted one-pass form: ``var = E[(x-s)^2] - (E[x]-s)^2``
    with the running mean as the shift ``s``, clamped at 0."""
    red = tuple(i for i in range(x.dim()) if i != axis)
    xf = x.float()
    s = shift.float().reshape(_bshape(x, axis))
    m = xf.mean(dim=red)
    d2 = (xf - s).square().mean(dim=red)
    v = d2 - (m - s.reshape(m.shape)).square()
    return m, v.clamp_min(0.0)


class _BatchNormTrain(torch.autograd.Function):
    """``out = (x - mean) * rstd * gamma + beta`` in fp32, cast to x's type,
    with ``mean`` and ``var`` the batch's (computed by the caller, no
    gradient of their own): the backward is the whole batch-norm gradient,
    through the statistics. Saves x in its own type, gamma, and the fp32
    mean and rstd (C each), so a bf16 activation is not kept again in fp32.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, mean, var, eps, axis, fix_gamma):
        bshape = _bshape(x, axis)
        rstd = torch.rsqrt(var + eps)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out = (x.float() - mean.reshape(bshape)) * rstd.reshape(bshape) \
            * g.float().reshape(bshape) + beta.float().reshape(bshape)
        ctx.save_for_backward(x, g, mean, rstd)
        ctx.axis, ctx.fix_gamma = axis, fix_gamma
        return out.to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, g, mean, rstd = ctx.saved_tensors
        axis = ctx.axis
        bshape = _bshape(x, axis)
        red = tuple(i for i in range(x.dim()) if i != axis)
        count = x.numel() // x.shape[axis]
        xhat = (x.float() - mean.reshape(bshape)) * rstd.reshape(bshape)
        dyf = dy.float()
        dbeta = dyf.sum(dim=red)
        dgamma = (dyf * xhat).sum(dim=red)
        dx = (g.float() * rstd).reshape(bshape) * (
            dyf - (dbeta / count).reshape(bshape)
            - xhat * (dgamma / count).reshape(bshape))
        need = ctx.needs_input_grad
        return (dx.to(x.dtype) if need[0] else None,
                dgamma.to(g.dtype) if need[1] and not ctx.fix_gamma else None,
                dbeta.to(g.dtype) if need[2] else None,
                None, None, None, None, None)


@_op
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, **kw):
    """Batch normalisation over ``axis``, in fp32, cast back to the input's
    type.

    In training mode (``autograd.is_training()`` and not
    ``use_global_stats``) it normalises with the batch's statistics
    (``_batch_stats``) and then updates the running statistics in place,
    ``new = momentum * old + (1 - momentum) * batch`` with the biased batch
    variance (MXNet's convention, not ``F.batch_norm``'s), as the JAX
    package writes its aux states. Otherwise it normalises with the running
    statistics. ``fix_gamma`` takes gamma as ones."""
    if output_mean_var:
        raise NotImplementedError("BatchNorm output_mean_var is not ported")
    axis = axis % data.dim()
    if autograd.is_training() and not use_global_stats:
        from ..parallel import compat as _spmd
        batch_axes = _spmd.batch_axes()
        if batch_axes:
            return _batch_norm_global(data, gamma, beta, moving_mean,
                                      moving_var, eps, momentum, fix_gamma,
                                      axis, batch_axes)
        shift = moving_mean
        if autograd._in_remat():     # the recomputation shifts as the forward
            shift = autograd._remat_keep(lambda: moving_mean.detach().clone())
        mean_, var = _batch_stats(data, shift, axis)
        out = _BatchNormTrain.apply(data, gamma, beta, mean_, var, eps, axis,
                                    fix_gamma)
        if not autograd._recomputing():     # a remat replay updates once
            with torch.no_grad():
                moving_mean.copy_(momentum * moving_mean
                                  + (1 - momentum) * mean_)
                moving_var.copy_(momentum * moving_var + (1 - momentum) * var)
        return out
    bshape = _bshape(data, axis)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g.reshape(bshape) * torch.rsqrt(moving_var.reshape(bshape) + eps)
    out = (data - moving_mean.reshape(bshape)) * scale + beta.reshape(bshape)
    return out.to(data.dtype)


def _batch_norm_global(x, gamma, beta, moving_mean, moving_var, eps,
                       momentum, fix_gamma, axis, batch_axes):
    """Training-mode batch norm of one position of a data-parallel
    ``shard_map`` with the statistics of the global batch: the shifted
    sums and sums of squares are all-reduced over ``batch_axes`` (as the
    JAX package's mean over a dp-split axis lowers to an all-reduce), and
    the normalisation is composed of differentiable ops, so the one
    backward carries the statistics' gradient across the positions. The
    position at index 0 of the batch axes updates the running statistics
    (every position holds the same values)."""
    from ..parallel import compat as _spmd
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = _bshape(x, axis)
    count = (x.numel() // x.shape[axis]) * _spmd.axis_size(batch_axes)
    xf = x.float()
    # a copy: the position at index 0 updates the running mean in place
    # while its peers may still read the shift
    s = moving_mean.detach().float().clone()
    mean_ = _spmd.psum(xf.sum(dim=red), batch_axes) / count
    d2 = _spmd.psum((xf - s.reshape(bshape)).square().sum(dim=red),
                    batch_axes) / count
    var = (d2 - (mean_ - s).square()).clamp_min(0.0)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    out = (xf - mean_.reshape(bshape)) * torch.rsqrt(var + eps).reshape(
        bshape) * g.float().reshape(bshape) + beta.float().reshape(bshape)
    if _spmd.axis_index(batch_axes) == 0 and not autograd._recomputing():
        with torch.no_grad():
            moving_mean.copy_(momentum * moving_mean
                              + (1 - momentum) * mean_)
            moving_var.copy_(momentum * moving_var + (1 - momentum) * var)
    return out.to(x.dtype)


# ================================================================ sequences

def _batch_axis(axis):
    return 1 - axis if axis in (0, 1) else 0


@_op
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at the steps of ``axis`` (time) at or past each sequence's
    length (``sequence_length``, one per sample of the other of axes 0 and
    1); the data as it is without ``use_sequence_length``."""
    if not use_sequence_length or sequence_length is None:
        return data
    shp = [1] * data.dim()
    shp[axis] = data.shape[axis]
    pos = torch.arange(data.shape[axis], device=data.device).reshape(shp)
    lshp = [1] * data.dim()
    lshp[_batch_axis(axis)] = data.shape[_batch_axis(axis)]
    keep = pos < sequence_length.to(torch.int32).reshape(lshp)
    return data.masked_fill(~keep, value)


SequenceMask = sequence_mask


@_op
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each sequence's last valid step along ``axis`` (its length less
    one; the last step without ``use_sequence_length``)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    xm = torch.movedim(data, axis, 0)
    t = xm.shape[0]
    idx = sequence_length.to(torch.int64) - 1
    idx = torch.where(idx < 0, idx + t, idx).clamp(0, t - 1)
    return xm[idx, torch.arange(xm.shape[1], device=data.device)]


@_op
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """Each sequence's first ``sequence_length`` steps reversed along axis
    0 (time, the only axis MXNet takes with lengths), the steps past it
    left in place; the whole of ``axis`` flipped without
    ``use_sequence_length``."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    t, n = data.shape[:2]
    pos = torch.arange(t, device=data.device).reshape(t, 1)
    ln = sequence_length.to(torch.int64).reshape(1, n)
    idx = torch.where(pos < ln, ln - 1 - pos, pos)
    idx = idx.reshape((t, n) + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


# ===================================================================== files

def save(fname, data):
    """Save an NDArray, a list of them or a dict of name → NDArray in the
    MXNet binary list format (``serialization.py``): files load in the JAX
    package and in MXNet, and theirs load here."""
    from . import serialization
    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        names = list(data.keys())
        arrays = [data[k] for k in names]
    serialization.save_tensor_list(
        fname, [a._data if isinstance(a, NDArray) else a for a in arrays],
        names)


def load(fname):
    """Load a file in the MXNet binary list format: a dict of name →
    NDArray when it holds names, else a list. Arrays land on the CPU, the
    context the format records."""
    from . import serialization
    tensors, names = serialization.load_tensor_list(fname)
    if names:
        return {k: NDArray(t) for k, t in zip(names, tensors)}
    return [NDArray(t) for t in tensors]


# ================================================================ loss layers

def _label_hot(label, n_class, axis, like):
    """One-hot rows of ``label`` along ``axis`` by comparison (no gather, so
    an id outside [0, n_class) gives a row of zeros, as ``jax.nn.one_hot``,
    and never a device-side assert)."""
    classes = torch.arange(n_class, device=like.device).reshape(
        [-1 if i == axis else 1 for i in range(like.dim())])
    return (label.long().unsqueeze(axis) == classes).to(like.dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """softmax forward; MXNet's loss-layer backward (``softmax_output.cc``):
    ``(p - y) * grad_scale / valid_count``, independent of the head
    gradient unless ``out_grad``."""

    @staticmethod
    def forward(ctx, x, label, cfg):
        probs = torch.softmax(x, dim=cfg["axis"])
        ctx.save_for_backward(probs, label)
        ctx.cfg = cfg
        return probs

    @staticmethod
    def backward(ctx, g):
        probs, label = ctx.saved_tensors
        cfg = ctx.cfg
        axis = cfg["axis"]
        n_class = probs.shape[axis]
        hot = _label_hot(label, n_class, axis, probs)
        alpha = cfg["smooth_alpha"]
        if alpha:
            hot = hot * (1 - alpha) + (1 - hot) * (alpha / (n_class - 1))
        grad = probs - hot
        keep = label != cfg["ignore_label"]
        if cfg["use_ignore"]:
            grad = grad * keep.unsqueeze(axis).to(grad.dtype)
        scale = cfg["grad_scale"]
        if cfg["normalization"] == "batch":
            grad = grad * (scale / label.shape[0])
        elif cfg["normalization"] == "valid":
            count = keep.sum().clamp_min(1).to(grad.dtype)
            grad = grad * scale / count
        else:
            grad = grad * scale
        if cfg["out_grad"]:
            grad = grad * g
        return grad, None, None


def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, multi_output=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """softmax with MXNet's loss-layer backward. The softmax runs over axis
    1 with ``multi_output`` (label (N, d1, ...)), over the last axis with
    ``preserve_shape``, else over all axes but the first (label (N,)); for
    2-D data the three agree. The JAX package always takes the last axis
    and ignores ``multi_output``, ``preserve_shape``, ``smooth_alpha`` and
    ``out_grad``, and its "valid" normalisation needs ``use_ignore``: the
    port takes MXNet's meaning of each."""
    if normalization not in ("null", "batch", "valid"):
        raise ValueError("unknown normalization %r" % normalization)
    cfg = dict(grad_scale=float(grad_scale), ignore_label=ignore_label,
               use_ignore=bool(use_ignore), normalization=normalization,
               out_grad=bool(out_grad), smooth_alpha=float(smooth_alpha))

    def fn(x, lbl):
        if multi_output:
            return _SoftmaxOutputFn.apply(x, lbl, dict(cfg, axis=1))
        if preserve_shape or x.dim() <= 2:
            return _SoftmaxOutputFn.apply(x, lbl, dict(cfg, axis=x.dim() - 1))
        flat = _SoftmaxOutputFn.apply(x.reshape(x.shape[0], -1),
                                      lbl.reshape(-1), dict(cfg, axis=1))
        return flat.reshape(x.shape)
    return _apply(fn, data, label)


class _RegressionOutputFn(torch.autograd.Function):
    """MXNet's regression loss layers (``regression_output.cc``): forward
    the identity or the sigmoid; backward ``grad_scale / num_output *
    (out - label)`` (its sign for "mae"), ``num_output`` the label's size
    per sample."""

    @staticmethod
    def forward(ctx, x, label, kind, grad_scale):
        out = torch.sigmoid(x) if kind == "logistic" else x.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape).to(out.dtype)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        num_output = label.numel() // label.shape[0] if label.dim() else 1
        return diff * (ctx.grad_scale / num_output), None, None, None


def _regression(kind):
    def op(data, label, grad_scale=1.0):
        return _apply(lambda x, lbl: _RegressionOutputFn.apply(
            x, lbl, kind, float(grad_scale)), data, label)
    return op


LinearRegressionOutput = _regression("linear")
LogisticRegressionOutput = _regression("logistic")
MAERegressionOutput = _regression("mae")
for _f, _n in ((LinearRegressionOutput, "LinearRegressionOutput"),
               (LogisticRegressionOutput, "LogisticRegressionOutput"),
               (MAERegressionOutput, "MAERegressionOutput")):
    _f.__name__ = _n
    _f.__doc__ = ("%s: MXNet's regression loss layer (the JAX package's "
                  "backward omits the 1 / num_output)." % _n)
del _f, _n


@_op
def softmax_cross_entropy(data, label):
    """The cross entropy of softmax(data) against integer labels, summed
    over the batch (a scalar)."""
    logp = torch.log_softmax(data, dim=-1)
    ids = label.long().clamp(0, data.shape[-1] - 1)
    return -logp.gather(-1, ids[:, None]).sum()


@_op
def softmin(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(-x, dim=axis)


def SoftmaxActivation(data, mode="instance"):
    """softmax over the last axis ("instance") or axis 1 ("channel")."""
    return softmax(data, axis=-1 if mode == "instance" else 1)


# ================================================================= nn-style

@_op
def L2Normalization(data, eps=1e-10, mode="instance"):
    """``x / sqrt(sum(x²) + eps)`` over all axes but the first
    ("instance"), axis 1 ("channel") or the spatial axes ("spatial")."""
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError("unknown mode %r" % mode)
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True) + eps)


@_op
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across channels:
    ``x / (knorm + alpha / nsize * sum of x² over nsize channels)^beta``."""
    half = nsize // 2
    sq = F.pad(data.square(), (0, 0) * (data.dim() - 2) + (half, half))
    acc = functools.reduce(operator.add, (sq.narrow(1, i, data.shape[1])
                                          for i in range(nsize)))
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


def UpSampling(*data, scale=2, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each input repeated to ``scale`` times the first input's
    size, joined along the channels ("concat") or summed ("sum").
    Bilinear: ``data = (x, weight)``, a transposed convolution per channel
    with MXNet's kernel ``2 scale - scale % 2``, stride ``scale`` and pad
    ``ceil((scale - 1) / 2)``. (The JAX package repeats the first input
    only and ignores ``sample_type``.)"""
    if sample_type == "bilinear":
        k = 2 * scale - scale % 2
        p = -(-(scale - 1) // 2)

        def bil(x, w):
            y = F.conv_transpose2d(x, w, stride=scale, padding=p,
                                   groups=x.shape[1])
            return y[..., :x.shape[2] * scale, :x.shape[3] * scale]
        if data[1].shape[-1] != k:
            raise ValueError("bilinear UpSampling wants a %d x %d kernel"
                             % (k, k))
        return _apply(bil, data[0], data[1])
    if sample_type != "nearest":
        raise ValueError("unknown sample_type %r" % sample_type)

    def near(*xs):
        h = xs[0].shape[2] * scale
        outs = [x.repeat_interleave(h // x.shape[2], 2)
                 .repeat_interleave(h // x.shape[2], 3) for x in xs]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            return functools.reduce(operator.add, outs)
        return torch.cat(outs, 1)
    return _apply(near, *data)


@_op
def BilinearResize2D(data, height=None, width=None, scale_height=None,
                     scale_width=None):
    """Linear resize to (height, width), or by the scales, on half-pixel
    centres (``jax.image.resize``'s "linear"); a downscale filters with the
    stretched triangle kernel, as JAX's antialiased resize does."""
    h = height or int(data.shape[2] * scale_height)
    w = width or int(data.shape[3] * scale_width)
    down = h < data.shape[2] or w < data.shape[3]
    return F.interpolate(data, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=down)


@_op
def Correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's cost volume (``correlation.cc``): (N, D², top_h, top_w),
    D = 2 (max_displacement // stride2) + 1; channel ``dy * D + dx`` holds
    the sum over the kernel window and the channels of ``x1 · x2`` moved by
    the displacement (``|x1 - x2|`` without ``is_multiply``), over
    ``kernel_size² C``."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    gr = max_displacement // stride2
    border = max_displacement + (kernel_size - 1) // 2
    md, p = max_displacement, pad_size
    n, c, h, w = data1.shape
    top_h = -((2 * border - (h + 2 * p)) // stride1)
    top_w = -((2 * border - (w + 2 * p)) // stride1)
    if top_h < 1 or top_w < 1:
        raise ValueError("Correlation: input too small for "
                         "max_displacement/kernel_size")
    x1p = F.pad(data1, (p, p, p, p))
    x2p = F.pad(data2, (p, p, p, p))

    def tap(src, y0, x0):
        return src[:, :, y0:y0 + (top_h - 1) * stride1 + 1:stride1,
                   x0:x0 + (top_w - 1) * stride1 + 1:stride1]

    outs = []
    for dy in range(-gr, gr + 1):
        for dx in range(-gr, gr + 1):
            acc = None
            for i in range(kernel_size):
                for j in range(kernel_size):
                    a = tap(x1p, md + i, md + j)
                    b = tap(x2p, md + dy * stride2 + i, md + dx * stride2 + j)
                    t = (a * b if is_multiply else (a - b).abs()).sum(1)
                    acc = t if acc is None else acc + t
            outs.append(acc / (kernel_size * kernel_size * c))
    return torch.stack(outs, 1)


def Crop(*data, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=None):
    """Crop ``data[0]`` to ``h_w``, or to ``data[1]``'s spatial size, at
    ``offset`` or centred."""
    x = data[0]
    th, tw = (data[1].shape[2], data[1].shape[3]) if len(data) == 2 else h_w
    if center_crop:
        oy, ox = (x.shape[2] - th) // 2, (x.shape[3] - tw) // 2
    else:
        oy, ox = offset
    return _apply(lambda a: a[:, :, oy:oy + th, ox:ox + tw], x)


def _patch_geometry(x_shape, kernel, stride, dilate, pad):
    d = len(kernel)
    stride = tuple(stride) if stride else (1,) * d
    dilate = tuple(dilate) if dilate else (1,) * d
    pad = tuple(pad) if pad else (0,) * d
    out = tuple((x_shape[2 + i] + 2 * pad[i] - dilate[i] * (kernel[i] - 1)
                 - 1) // stride[i] + 1 for i in range(d))
    return stride, dilate, pad, out


def _tap_slices(k_idx, stride, dilate, out):
    return tuple(builtins.slice(k * dl, k * dl + (o - 1) * s + 1, s)
                 for k, s, dl, o in zip(k_idx, stride, dilate, out))


@_op
def im2col(data, kernel, stride=None, dilate=None, pad=None):
    """Sliding patches: (N, C, *spatial) → (N, C·∏kernel, L), channel-major
    then the kernel taps in row-major order (``lax``'s patch order)."""
    kernel = tuple(kernel)
    stride, dilate, pad, out = _patch_geometry(data.shape, kernel, stride,
                                               dilate, pad)
    xp = F.pad(data, tuple(q for p in reversed(pad) for q in (p, p)))
    taps = [xp[(Ellipsis,) + _tap_slices(k, stride, dilate, out)]
            for k in onp.ndindex(*kernel)]
    cols = torch.stack(taps, 2)                       # (N, C, K, *out)
    return cols.reshape(data.shape[0], -1, math.prod(out))


@_op
def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None):
    """The transpose of ``im2col``: each patch added back into its place of
    an (N, C, *output_size) image."""
    kernel = tuple(kernel)
    output_size = tuple(output_size)
    k_prod = math.prod(kernel)
    n, c = data.shape[0], data.shape[1] // k_prod
    stride, dilate, pad, out = _patch_geometry(
        (n, c) + output_size, kernel, stride, dilate, pad)
    cols = data.reshape((n, c, k_prod) + out)
    img = data.new_zeros((n, c) + tuple(s + 2 * p for s, p in
                                        zip(output_size, pad)))
    for i, k in enumerate(onp.ndindex(*kernel)):
        idx = (Ellipsis,) + _tap_slices(k, stride, dilate, out)
        img[idx] = img[idx] + cols[:, :, i]
    crop = tuple(builtins.slice(p, p + s) for p, s in zip(pad, output_size))
    return img[(Ellipsis,) + crop]


# ========================================================== index and shape

@_op
def argmax_channel(data):
    """argmax over axis 1, in the input's type."""
    return torch.argmax(data, dim=1).to(data.dtype)


def meshgrid(*arrays, indexing="xy"):
    return list(_apply(lambda *xs: torch.meshgrid(*xs, indexing=indexing),
                       *arrays))


def histogram(a, bins=10, range=None):
    """(counts, bin edges): ``bins`` equal bins over ``range`` (default the
    data's min and max), the last bin closed; or the given edges."""
    x = a._data
    if isinstance(bins, NDArray):
        edges = bins._data.to(x.dtype)
    else:
        if range is None:
            lo = float(x.min())
            range = (lo, builtins.max(float(x.max()), lo + 1e-6))
        edges = torch.linspace(range[0], range[1], bins + 1,
                               dtype=torch.float32, device=x.device) \
            .to(x.dtype)
    nb = edges.shape[0] - 1
    idx = torch.bucketize(x.reshape(-1), edges, right=True) - 1
    flat = x.reshape(-1)
    idx = torch.where(flat == edges[-1], torch.full_like(idx, nb - 1), idx)
    inside = (flat >= edges[0]) & (flat <= edges[-1])
    counts = torch.zeros(nb, dtype=torch.int32, device=x.device)
    counts.index_add_(0, idx.clamp(0, nb - 1),
                      inside.to(torch.int32))
    return NDArray(counts), NDArray(edges.clone())


@_op
def unravel_index(data, shape=None):
    """Flat ids → (ndim, N) coordinates in ``shape``."""
    x = data.long()
    coords = []
    for dim in reversed(shape):
        coords.append(torch.remainder(x, dim))
        x = torch.div(x, dim, rounding_mode="floor")
    return torch.stack(coords[::-1], 0).to(torch.int32)


@_op
def ravel_multi_index(data, shape=None):
    """(ndim, N) coordinates, each clipped into its axis, → flat ids."""
    flat = torch.zeros(data.shape[1:], dtype=torch.int32, device=data.device)
    for i, dim in enumerate(shape):
        flat = flat * dim + data[i].to(torch.int32).clamp(0, dim - 1)
    return flat


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out`` (in place)."""
    hot = _label_hot(indices._data, out.shape[1], 1, out._data)
    with torch.no_grad():
        out._data.copy_(hot)
    return out


def shuffle(data):
    """The rows of ``data`` in a random order (``nd.random.shuffle``)."""
    from . import random as _random
    return _random.shuffle(data)


def multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Samples of the categorical distributions in the rows of ``data``
    (probabilities over the last axis): ``data.shape[:-1] + shape``
    (an int ``shape`` n gives n samples a row); with ``get_prob`` also the
    log-probability of each sample."""
    from . import random as _random
    return _random._categorical(data, (shape,) if isinstance(shape, int)
                                else tuple(shape), get_prob, dtype, False)


# ================================================================ interop

def cast_storage(data, stype):
    """``data`` in storage ``stype`` ("default", "row_sparse", "csr")."""
    return data.tostype(stype)


def from_numpy(ndarray_np, zero_copy=True):
    """An NDArray on the CPU over a numpy array (sharing its memory when
    ``zero_copy`` and its type is kept; float64 and int64 become float32
    and int32, the JAX package's rules)."""
    a = _narrow(onp.asarray(ndarray_np))
    if not zero_copy or not a.flags.writeable:
        a = a.copy()
    return NDArray(torch.from_numpy(onp.ascontiguousarray(a)))


def to_dlpack_for_read(data):
    """A DLPack capsule over the array (``torch.utils.dlpack``)."""
    data.wait_to_read()
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def to_dlpack_for_write(data):
    """A DLPack capsule over the array, which the consumer may write."""
    data.wait_to_write()
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def from_dlpack(dlpack):
    """An NDArray over a DLPack capsule or an object with ``__dlpack__``
    (sharing its memory)."""
    return NDArray(torch.utils.dlpack.from_dlpack(dlpack))


def load_frombuffer(buf):
    """``load`` from the bytes of a file in the MXNet binary list format."""
    from . import serialization
    tensors, names = serialization.load_tensor_buffer(bytes(buf))
    if names:
        return {k: NDArray(t) for k, t in zip(names, tensors)}
    return [NDArray(t) for t in tensors]


# ====================================================================== CTC

def CTCLoss(data, label, data_lengths=None, label_lengths=None,
            use_data_lengths=False, use_label_lengths=False,
            blank_label="first"):
    """The CTC negative log-likelihood of each sample (``ops.ctc``): data
    (T, N, C) activations, label (N, L)."""
    from ..ops.ctc import ctc_loss as _ctc
    dl = data_lengths if use_data_lengths else None
    ll = label_lengths if use_label_lengths else None

    def fn(x, lbl, d, l_):
        return _ctc(x, lbl, d, l_, blank_label)
    return _apply(fn, data, label, dl, ll)


ctc_loss = CTCLoss


__all__ += ["SoftmaxOutput", "LinearRegressionOutput",
            "LogisticRegressionOutput", "MAERegressionOutput",
            "softmax_cross_entropy", "softmin", "SoftmaxActivation",
            "L2Normalization", "LRN", "UpSampling", "BilinearResize2D",
            "Correlation", "Crop", "im2col", "col2im", "argmax_channel",
            "meshgrid", "histogram", "unravel_index", "ravel_multi_index",
            "onehot_encode", "shuffle", "multinomial", "cast_storage",
            "from_numpy", "to_dlpack_for_read", "to_dlpack_for_write",
            "from_dlpack", "load_frombuffer", "CTCLoss", "ctc_loss"]
