"""Executor: a bound symbolic graph (counterpart of
``incubator_mxnet_tpu/executor.py``).

Bind allocates every array on the bound context: the arguments and
auxiliary states given are used as they are (moved there if they lie
elsewhere), and the parameter variables of layer ops are made as zeros of
the shapes inferred from the data (``symbol._infer``, on meta tensors).
An inference bind that leaves out a label gives it zeros of (batch,).

``forward`` copies each fed array into its bound buffer (``copy_``, without
blocking from pinned host memory) and runs the DAG on the port's ``nd``
operators, under ``autograd.record()`` when training; while the fed shapes
are the bound ones the buffers never change identity, so arrays taken from
``arg_dict`` keep following the executor, and an array that was fed stays
the caller's. A data or label array fed at another shape (a batch of
another size, as ``Module.predict`` meets at a last batch or
``FeedForward.load(...).predict`` at its first) rebinds the executor at
that shape, as MXNet's ``Module.forward`` reshapes its executors and the
JAX package's ``forward`` takes the fed array: those inputs, the labels
not fed (batch rows) and their gradient buffers get buffers of the new
shape, the parameters and auxiliary states stay shared. The buffers of
each shape are kept, so a shape fed again copies into its buffers as
before (``_reshape``). ``backward`` runs
the port's autograd with MXNet's gradient requests: "write" replaces a
gradient, "add" adds into it, "null" keeps none. ``copy_params_from``
copies values in; it never shares the caller's arrays.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from . import autograd
from .context import Context, as_device, context_of, current_context
from .ndarray import NDArray

__all__ = ["Executor"]


def _tensor_of(value):
    if isinstance(value, NDArray):
        return value._data
    if isinstance(value, torch.Tensor):
        return value
    a = onp.asarray(value)
    if a.dtype == onp.float64:
        a = a.astype(onp.float32)
    return torch.from_numpy(onp.ascontiguousarray(a))


@torch.no_grad()
def _copy_into(dst, value):
    """Copy ``value`` (an NDArray, tensor or numpy array) into the tensor of
    ``dst`` in place, converting its dtype and device; from pinned host
    memory the copy does not block."""
    src = _tensor_of(value)
    t = dst._data
    if tuple(src.shape) != tuple(t.shape):
        if src.numel() != t.numel():
            raise ValueError("cannot feed an array of shape %s into one of "
                             "shape %s" % (tuple(src.shape), tuple(t.shape)))
        src = src.reshape(t.shape)
    pinned = src.device.type == "cpu" and t.device.type == "cuda" and \
        src.is_pinned()
    t.copy_(src, non_blocking=pinned)


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, inputs_need_grad=True, shared_arrays=None,
                 shared_grads=None):
        self._symbol = symbol
        self._shaped = {}       # (input, shape) -> (array, gradient)
        self._ctx = ctx if ctx is not None else current_context()
        if not isinstance(self._ctx, Context):
            self._ctx = context_of(torch.empty(0, device=self._ctx))
        self._device = as_device(self._ctx)
        self.grad_req = grad_req
        self.outputs = []
        given = dict(args or {})
        given.update(aux_states or {})
        self._materialize(given, shared_arrays or {})
        reqs = self._reqs(grad_req)
        shared_grads = shared_grads or {}
        if args_grad is None and grad_req != "null":
            # gradient buffers for every argument, the data inputs too
            # unless inputs_need_grad is False (the Module's default); label
            # variables never get one (loss layers give them no gradient)
            labels = {v.name for v in self._walk_vars() if _is_label(v)}
            skip = labels if inputs_need_grad else \
                labels | self._data_names()
            args_grad = {}
            for k, v in self.arg_dict.items():
                if k in skip or reqs[k] == "null":
                    continue
                g = shared_grads.get(k)
                args_grad[k] = g if g is not None else \
                    NDArray(torch.zeros_like(v._data.detach()))
        self.grad_dict = {}
        for k, g in (args_grad or {}).items():
            if k not in self.arg_dict:
                raise ValueError("gradient for unknown argument %r" % k)
            if not isinstance(g, NDArray):
                g = NDArray(_tensor_of(g).to(self._device))
            arr = self.arg_dict[k]
            if k in shared_grads and getattr(arr._data, "_mx_grad",
                                             None) is g:
                self.grad_dict[k] = g       # already marked by its owner
                continue
            autograd.mark_variables([arr], [g], reqs[k])
            self.grad_dict[k] = g

    # -----------------------------------------------------------------
    def _reqs(self, grad_req):
        """{argument: request} from one request, a list in
        ``list_arguments`` order or a dict."""
        names = list(self.arg_dict)
        if isinstance(grad_req, str):
            return {n: grad_req for n in names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(self._symbol.list_arguments(), grad_req))
        return {n: grad_req.get(n, "null") for n in names}

    def _walk_vars(self):
        return [s for s in self._symbol._walk() if s.is_var]

    def _data_names(self):
        return {v.name for v in self._walk_vars()
                if not getattr(v, "_is_param", False)}

    def _materialize(self, given, shared):
        """Put every argument and auxiliary state on the bound device: the
        arrays given, the arrays shared with another executor, and zeros of
        the inferred shapes for the rest."""
        from .symbol.symbol import _infer
        device = self._device
        shapes, dtypes = {}, {}
        for k, v in list(given.items()) + list(shared.items()):
            t = _tensor_of(v)
            shapes[k], dtypes[k] = tuple(t.shape), t.dtype
        got = _infer(self._symbol, shapes, dtypes, label_default=True)
        if got is None:
            missing = [n for n in self._symbol.list_inputs()
                       if n not in shapes]
            raise ValueError("unbound variable %r" % (missing[:1] or ["?"])[0])
        shapes, outs = got
        arrays = {}
        for name in self._symbol.list_inputs():
            if name in given:
                v = given[name]
                if isinstance(v, NDArray) and v._data.device == device:
                    arrays[name] = v
                else:
                    arrays[name] = NDArray(_tensor_of(v).detach().to(
                        device, copy=True))
            elif name in shared:
                arrays[name] = shared[name]
            else:
                arrays[name] = NDArray(torch.zeros(
                    shapes[name], dtype=dtypes.get(name, torch.float32),
                    device=device))
        self._aux_names = self._symbol.list_auxiliary_states()
        self.arg_dict = {n: arrays[n] for n in self._symbol.list_arguments()}
        self.aux_dict = {n: arrays[n] for n in self._aux_names}
        # outputs are live right after bind (zeros), as MXNet's are
        self.outputs = [NDArray(torch.zeros(tuple(o.shape), dtype=o._data.dtype,
                                            device=device)) for o in outs]

    # -----------------------------------------------------------------
    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_dict]

    @property
    def aux_arrays(self):
        return list(self.aux_dict.values())

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def _feed(self, **kwargs):
        """Copy each fed array into its buffer (an unknown name gets a
        buffer of its own), rebinding the inputs at the fed shapes first
        where they differ from the bound ones."""
        data = self._data_names()
        fed = {}
        for k, v in kwargs.items():
            dst = self.arg_dict.get(k)
            shape = tuple(onp.shape(v))
            if k in data and dst is not None and shape != dst.shape and \
                    math.prod(shape) != dst.size:
                fed[k] = shape
        if fed:
            self._reshape(fed)
        for k, v in kwargs.items():
            dst = self.arg_dict.get(k, self.aux_dict.get(k))
            if dst is None:
                self.arg_dict[k] = NDArray(_tensor_of(v).detach().to(
                    self._device, copy=True))
            else:
                _copy_into(dst, v)

    def _reshape(self, fed):
        """Bind the data inputs at the ``fed`` shapes ({name: shape}), the
        labels not fed at the fed batch (their first axis), each with a
        gradient buffer where it had one; buffers are kept by name and
        shape, the bound ones too."""
        batch = next(iter(fed.values()))[:1]
        shapes = dict(fed)
        for v in self._walk_vars():
            if _is_label(v) and v.name not in fed and v.name in self.arg_dict:
                shapes[v.name] = batch + self.arg_dict[v.name].shape[1:]
        reqs = None
        for k, shape in shapes.items():
            old = self.arg_dict[k]
            self._shaped.setdefault((k, old.shape),
                                    (old, self.grad_dict.get(k)))
            if (k, shape) not in self._shaped:
                arr = NDArray(torch.zeros(shape, dtype=old._data.dtype,
                                          device=self._device))
                grad = None
                if k in self.grad_dict:
                    grad = NDArray(torch.zeros_like(arr._data))
                    reqs = reqs or self._reqs(self.grad_req)
                    autograd.mark_variables([arr], [grad], reqs[k])
                self._shaped[(k, shape)] = (arr, grad)
            arr, grad = self._shaped[(k, shape)]
            self.arg_dict[k] = arr
            if grad is not None:
                self.grad_dict[k] = grad

    def forward(self, is_train=False, **kwargs):
        """Copy the fed arrays into their buffers and run the graph,
        recording it when ``is_train``; returns the outputs."""
        self._feed(**kwargs)
        scope = autograd.record(train_mode=True) if is_train else \
            autograd.pause(train_mode=False)
        with scope, self._ctx:       # creation ops make their arrays here
            out = self._symbol.eval_imperative({**self.arg_dict,
                                                **self.aux_dict})
        self.outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """The gradients of the outputs (seeded with ``out_grads``, ones by
        default; loss layers ignore theirs) into ``grad_dict``."""
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        autograd.backward(self.outputs, out_grads, train_mode=is_train)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound arrays."""
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                _copy_into(self.arg_dict[k], v)
            elif not allow_extra_params:
                raise ValueError("unknown arg %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _copy_into(self.aux_dict[k], v)
            elif not allow_extra_params:
                raise ValueError("unknown aux %r" % k)


def _is_label(v):
    return bool(getattr(v, "_is_label", False)) or v.name.endswith("_label")
