"""Block / HybridBlock as ``torch.nn.Module`` subclasses (counterpart of
``incubator_mxnet_tpu/gluon/block.py``).

A child block assigned as an attribute, or given to ``register_child``, is
an ``nn.Module`` child under that name; a ``gluon.Parameter`` assigned as an
attribute is registered as an ``nn.Parameter`` under that name. So
``state_dict()`` keys are the JAX package's structural parameter names
(``Block._collect_params_with_prefix``), for example
``encoder.layer0.attention_cell.query.weight``. ``collect_params()`` is
keyed by the same names.

Train/predict behaviour (dropout) follows ``autograd``'s thread-local
training flag, as in the JAX package, not ``nn.Module.training``. PyTorch
runs eagerly, so ``hybridize()`` has nothing to compile and is accepted as
a no-op.
"""
from __future__ import annotations

import torch

from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class Block(torch.nn.Module):
    """Base building block."""

    def __init__(self):
        super().__init__()
        self._reg_params = {}
        self.training = False

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__["_reg_params"][name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def collect_params(self):
        """Every parameter of this block and its children, keyed by
        structural name."""
        ret = ParameterDict()
        ret.update(self._collect_params_with_prefix())
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Allocate every parameter on ``ctx`` (default: the current
        context), drawing from ``generator``."""
        self.collect_params().initialize(init, ctx, force_reinit=force_reinit,
                                         generator=generator)

    def cast(self, dtype):
        self.collect_params().cast(dtype)
        return self


class HybridBlock(Block):
    """Block whose forward the JAX package can compile as one program."""

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; PyTorch runs the forward eagerly."""
