"""Inference step (counterpart of ``incubator_mxnet_tpu/jit.py``
``EvalStep``). PyTorch runs eagerly, so there is no program to compile or
cache: the step moves its inputs to the net's device and runs the forward
under ``torch.inference_mode()``. ``TrainStep`` comes with the training
slice."""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["EvalStep"]


def net_device(net):
    """The device of the net's (first) parameter."""
    for p in net.parameters():
        return p.device
    raise RuntimeError("%s has no initialized parameters; call "
                       ".initialize() first" % type(net).__name__)


class EvalStep:
    """``step(*inputs)`` = ``net(*inputs)`` in inference mode on the net's
    device. Inputs may be tensors or numpy arrays."""

    def __init__(self, net):
        self.net = net

    def __call__(self, *inputs):
        device = net_device(self.net)
        with torch.inference_mode():
            args = [torch.as_tensor(onp.asarray(x)).to(device)
                    if not isinstance(x, torch.Tensor) else x.to(device)
                    for x in inputs]
            return self.net(*args)
