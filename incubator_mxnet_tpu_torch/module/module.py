"""Module: the symbolic trainer (counterpart of
``incubator_mxnet_tpu/module/module.py``).

``bind`` makes one ``Executor`` on the module's context (default: the
current context, ``gpu(0)``); ``init_params`` fills the parameters (drawn
on the host from ``nd.random``'s CPU generator, so one ``mx.random.seed``
gives the same weights on every device) or copies given ones in;
``init_optimizer`` makes the optimizer, with ``rescale_grad`` 1/batch when
it builds it from a name, and the "local" kvstore; ``update`` runs the
optimizer's ``update_all`` over every parameter at once (the arithmetic of
its per-index ``update``; one state per index, written to and read from the
JAX package's states file format). Parameters and optimizer states are
written in place and never shared with arrays the caller gave.

Several contexts (``context=[gpu(0), gpu(1)]``, or one device named
more than once) make one executor on the first, whose forward runs the
batch split over a "dp" mesh of the contexts through ``parallel.shard_map``
(the JAX package shards one program's batch over a dp mesh of them): each
position evaluates the graph on its slice of the fed arrays and of the
label variables, with the parameters (on another
device, a differentiable copy), batch norm and SoftmaxOutput's "batch" /
"valid" normalisation take the global batch's statistics and counts, and
the outputs are joined along axis 0 (each output must carry the batch
there; the batch must divide over the contexts). One backward sums every
position's gradient into the parameters' gradients, so the update is the
one of a single context over the whole batch, up to the order of the
sums.

With a "dist*" kvstore the update runs in the store (``update_on_kvstore``,
as MXNet's ``model._update_params_on_kvstore``): ``init_optimizer`` sets
the optimizer on it and ``init``s every trained parameter (rank 0's values
reach every process); ``update`` pushes every gradient in one multi-key
push (``priority=-i``) and pulls every parameter back. The store sums over
the processes; the optimizer built from a name rescales by 1/the local
batch, as the JAX package's and MXNet's do.
"""
from __future__ import annotations

import logging
import pickle

import torch

from .. import initializer as init_mod
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from ..context import as_device, current_context
from ..executor import _copy_into
from ..model import load_params as _load_params, save_checkpoint
from ..ndarray import NDArray
from ..ndarray import random as _random
from ..optimizer.optimizer import _state_from_np, _state_to_np
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._contexts = self._mesh = None
        if isinstance(context, (list, tuple)):
            if len(context) > 1:
                kinds = {as_device(c).type for c in context}
                if len(kinds) > 1:
                    raise ValueError("the contexts of a Module are of one "
                                     "device type; got %s" % (list(context),))
                self._contexts = list(context)
            context = context[0]
        self._context = context if context is not None else current_context()
        self._fixed_param_names = set(fixed_param_names or [])
        self._exec = None
        self._optimizer = None
        self._kvstore = None
        self._updater_states = {}
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._param_names = [n for n in self._arg_names
                             if n not in self._data_names
                             and n not in self._label_names]

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over the checkpoint ``prefix``/``epoch``; its parameters
        are set at ``bind`` (and its optimizer states at
        ``init_optimizer``, with ``load_optimizer_states``)."""
        from ..symbol import load as sym_load
        sym = sym_load("%s-symbol.json" % prefix)
        mod = Module(sym, **kwargs)
        arg_params, aux_params = _load_params(prefix, epoch)
        mod._preloaded_params = (arg_params, aux_params)
        if load_optimizer_states:
            mod._preloaded_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    # -----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Make the executor for these data and label shapes. With
        ``shared_module`` the parameters, their gradients and the optimizer
        are that module's own objects (a ``BucketingModule``'s buckets)."""
        if self.binded and not force_rebind:
            return
        from ..executor import Executor

        shapes = {}
        for desc in data_shapes:
            shapes[desc[0]] = tuple(desc[1])
        if label_shapes:
            for desc in label_shapes:
                shapes[desc[0]] = tuple(desc[1])
        device = as_device(self._context)
        args = {k: NDArray(torch.zeros(v, device=device))
                for k, v in shapes.items()}
        shared_arrays = shared_grads = None
        if shared_module is not None:
            ex = shared_module._exec
            shared_arrays = {n: a for n, a in
                             list(ex.arg_dict.items()) + list(ex.aux_dict.items())
                             if n in shared_module.param_names
                             or n in ex.aux_dict}
            shared_grads = dict(ex.grad_dict)
        self._exec = Executor(self.symbol, self._context, args,
                              grad_req=grad_req if for_training else "null",
                              inputs_need_grad=inputs_need_grad,
                              shared_arrays=shared_arrays,
                              shared_grads=shared_grads)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.binded = True
        self.for_training = for_training
        if shared_module is not None and shared_module.params_initialized:
            self.params_initialized = True
            if shared_module.optimizer_initialized:
                self._optimizer = shared_module._optimizer
                self._kvstore = shared_module._kvstore
                self._updater_states = shared_module._updater_states
                self._update_on_kvstore = False
                self.optimizer_initialized = True
        if hasattr(self, "_preloaded_params"):
            arg_params, aux_params = self._preloaded_params
            self.init_params(arg_params=arg_params, aux_params=aux_params)

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def label_names(self):
        return list(self._label_names)

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def output_shapes(self):
        """(name, shape) of each output, live from bind on."""
        outs = getattr(self._exec, "outputs", None) if self._exec else None
        if not outs:
            return None
        return list(zip(self.symbol.list_outputs(),
                        [tuple(o.shape) for o in outs]))

    @property
    def param_names(self):
        return [n for n in self._exec.arg_dict
                if n not in self._data_names and n not in self._label_names
                and not n.endswith("_label")] if self._exec else \
            self._param_names

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Copy in the given parameters; draw the others with
        ``initializer`` (default ``Uniform(0.01)``) on the host, from
        ``nd.random``'s CPU generator (``moving_mean`` zeros,
        ``moving_var`` ones)."""
        assert self.binded
        if self.params_initialized and not force_init:
            return
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        initializer = init_mod.create(initializer)
        generator = _random._generator(torch.device("cpu"))
        groups = ((self.param_names, self._exec.arg_dict, arg_params),
                  (self._exec._aux_names, self._exec.aux_dict, aux_params))
        for names, arrays, given in groups:
            for name in names:
                arr = arrays[name]
                if given and name in given:
                    _copy_into(arr, given[name])
                    continue
                buf = torch.empty(arr.shape, dtype=torch.float32)
                initializer(name, buf, generator)
                _copy_into(arr, buf)
        self.params_initialized = True

    def get_params(self):
        """(arg_params, aux_params): copies of the parameters."""
        assert self.binded and self.params_initialized
        arg = {n: self._exec.arg_dict[n].copy() for n in self.param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._exec._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(None, arg_params, aux_params, allow_missing, force_init,
                         allow_extra)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """Make the optimizer (``rescale_grad`` 1/batch when it is built
        from a name here: a loss layer's gradient is a sum over the batch)
        and the kvstore."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {"learning_rate": 0.01})
        if isinstance(optimizer, str):
            if "rescale_grad" not in optimizer_params and \
                    getattr(self, "_data_shapes", None):
                batch = self._data_shapes[0][1][0]
                optimizer_params["rescale_grad"] = 1.0 / batch
            idx2name = {i: n for i, n in enumerate(self.param_names)}
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **optimizer_params)
        self._optimizer = optimizer
        self._update_on_kvstore = False
        if kvstore:
            kv = kvs_mod.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            self._kvstore = kv
            self._update_on_kvstore = kv.type.startswith("dist")
            if self._update_on_kvstore:
                kv.set_optimizer(optimizer)
                for i, name in self._trained():
                    kv.init(i, self._exec.arg_dict[name])
        self._updater_states = {}
        self.optimizer_initialized = True
        states = getattr(self, "_preloaded_states", None)
        if states is not None:
            self.load_optimizer_states(states)

    # -----------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Feed a batch (copied into the bound buffers) and run forward."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feed[name] = arr
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                feed[name] = arr
        if self._contexts is None:
            self._exec.forward(is_train=is_train, **feed)
        else:
            self._forward_dp(feed, is_train)

    def _forward_dp(self, feed, is_train):
        """The forward over several contexts: the fed batch split over a
        "dp" mesh of them (module docstring)."""
        from .. import autograd
        from ..parallel.compat import shard_map
        from ..parallel.mesh import Mesh, P
        import numpy as onp
        ex = self._exec
        ex._feed(**feed)
        n = len(self._contexts)
        # the fed arrays and every label variable (one row a sample, fed
        # or left at the zeros of the bind) split over the contexts
        names = list(feed) + [k for k in ex.arg_dict
                              if k.endswith("_label") and k not in feed]
        for name in names:
            if ex.arg_dict[name].shape[0] % n:
                raise ValueError("a batch of %d does not divide over %d "
                                 "contexts" % (ex.arg_dict[name].shape[0], n))
        if self._mesh is None:
            self._mesh = Mesh(onp.asarray([as_device(c) for c in
                                           self._contexts], dtype=object),
                              axis_names=("dp",))
        rest = {k: v for k, v in list(ex.arg_dict.items()) +
                list(ex.aux_dict.items()) if k not in names}
        master = ex._device

        def run(*shards):
            device = shards[0].device
            bindings = {k: a if device == master else NDArray(
                a._data.to(device)) for k, a in rest.items()}
            bindings.update((k, NDArray(t)) for k, t in zip(names, shards))
            out = self.symbol.eval_imperative(bindings)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return tuple(o._data for o in outs)
        scope = autograd.record(train_mode=True) if is_train else \
            autograd.pause(train_mode=False)
        with scope, ex._ctx:
            outs = shard_map(run, self._mesh, in_specs=P("dp"),
                             out_specs=P("dp"), batch_axes=("dp",))(
                *[ex.arg_dict[k]._data for k in names])
        ex.outputs = [NDArray(o) for o in outs]

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def _trained(self):
        """(index, name) of every parameter the update touches."""
        return [(i, n) for i, n in enumerate(self.param_names)
                if self._exec.grad_dict.get(n) is not None
                and n not in self._fixed_param_names]

    def update(self):
        """One optimizer step of every parameter from its gradient:
        ``update_all`` over the lot, with each index's learning rate, weight
        decay and update count, in place; with a dist kvstore, one push of
        every gradient and one pull of every parameter."""
        assert self.optimizer_initialized
        trained = self._trained()
        if self._update_on_kvstore and self._kvstore is not None:
            if trained:
                keys = [i for i, _ in trained]
                ex = self._exec
                self._kvstore.push(keys, [ex.grad_dict[n] for _, n in trained],
                                   priority=[-i for i in keys])
                self._kvstore.pull(keys, out=[ex.arg_dict[n]
                                              for _, n in trained])
            return
        opt = self._optimizer
        idx, weights, grads, states = [], [], [], []
        for i, name in trained:
            g = self._exec.grad_dict[name]
            w = self._exec.arg_dict[name]._data
            if i not in self._updater_states:
                self._updater_states[i] = \
                    opt.create_state_multi_precision(i, w)
            idx.append(i)
            weights.append(w)
            grads.append(g._data)
            states.append(self._updater_states[i])
        if not idx:
            return
        scalars = opt.step_scalars(idx).to(weights[0].device,
                                           non_blocking=True)
        opt.update_all(weights, grads, states, *opt.split_scalars(scalars))

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self._exec.outputs)

    def install_monitor(self, monitor):
        monitor.install_exec(self._exec)

    # -----------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        """``<prefix>-symbol.json``, ``<prefix>-%04d.params`` and, with
        ``save_optimizer_states``, ``<prefix>-%04d.states``."""
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_optimizer_states(self, fname):
        """A pickle of {index: state as numpy}, the JAX package's file."""
        with open(fname, "wb") as f:
            pickle.dump({k: _state_to_np(v)
                         for k, v in self._updater_states.items()}, f)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            st = pickle.load(f)
        device = self._exec._device if self._exec is not None else None
        self._updater_states = {k: _state_from_np(v, device)
                                for k, v in st.items()}
