"""SequentialModule: a chain of Modules (counterpart of
``incubator_mxnet_tpu/module/sequential_module.py``): module i's outputs
feed module i+1's data; backward runs the chain in reverse, passing each
module's input gradients to the one before."""
from __future__ import annotations

import logging

from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules = []
        self._metas = []
        self._label_modules = []

    def add(self, module, **kwargs):
        """Append ``module`` (``take_labels``: it gets the labels)."""
        self._modules.append(module)
        self._metas.append(kwargs)
        if kwargs.get(self.META_TAKE_LABELS):
            self._label_modules.append(module)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert self._modules, "add modules first"

        self._label_shapes = label_shapes
        cur_shapes = data_shapes
        for i, mod in enumerate(self._modules):
            take_labels = self._metas[i].get(self.META_TAKE_LABELS)
            mod.bind(cur_shapes,
                     label_shapes if take_labels else None,
                     for_training=for_training,
                     # intermediate modules must propagate input grads
                     inputs_need_grad=inputs_need_grad or i > 0,
                     force_rebind=force_rebind, grad_req=grad_req)
            # the outputs are live from bind on: their shapes feed the next
            cur_shapes = [("data", tuple(o.shape)) for o in mod._exec.outputs]
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        assert self.binded
        for mod in self._modules:
            mod.init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params, allow_missing=True,
                            force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        from ..io import DataBatch
        batch = data_batch
        for i, mod in enumerate(self._modules):
            mod.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            outs = mod.get_outputs()
            label = data_batch.label if \
                self._metas[i + 1].get(self.META_TAKE_LABELS) else None
            batch = DataBatch(outs, label)

    def backward(self, out_grads=None):
        grads = out_grads
        for i, mod in reversed(list(enumerate(self._modules))):
            mod.backward(grads)
            if i > 0:
                grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def install_monitor(self, monitor):
        for mod in self._modules:
            mod.install_monitor(monitor)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for i, mod in enumerate(self._modules):
            if self._metas[i].get(self.META_TAKE_LABELS) or \
                    i + 1 == len(self._modules):
                mod.update_metric(eval_metric, labels)
                return
