"""AMP, automatic mixed precision (counterpart of
``incubator_mxnet_tpu/contrib/amp.py``; MXNet's ``contrib/amp/amp.py``).

The target type is bf16 by default, as in the JAX package: the H100's
tensor cores run it at the fp16 rate without fp16's narrow range.
``convert_model`` / ``convert_hybrid_block`` cast the parameters (a
BatchNorm keeps fp32 statistics, by its own ``cast``); ``init_trainer``
turns on fp32 master weights. ``LossScaler`` is the dynamic loss scaler of
fp16-style flows: its overflow check is one reduction over the whole
gradient list on the device and one scalar transfer to the host.
"""
from __future__ import annotations

import torch

from ..ndarray import NDArray

__all__ = ["init", "init_trainer", "convert_model", "convert_hybrid_block",
           "scale_loss", "unscale", "LossScaler",
           "FP16_FP32_FUNCS", "FP16_FUNCS", "FP32_FUNCS"]

# the JAX package's cast lists (indicative subsets of MXNet's)
FP16_FUNCS = ["FullyConnected", "Convolution", "Deconvolution", "batch_dot",
              "dot"]
FP32_FUNCS = ["softmax", "log_softmax", "norm", "mean", "sum", "BatchNorm",
              "LayerNorm", "SoftmaxOutput", "exp", "log"]
FP16_FP32_FUNCS = ["relu", "sigmoid", "tanh", "add", "subtract", "multiply"]

_INITIALIZED = {"flag": False, "dtype": "bfloat16"}


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Record the policy: bf16 for a 16-bit target (as the JAX package),
    else ``target_dtype``."""
    _INITIALIZED["flag"] = True
    _INITIALIZED["dtype"] = "bfloat16" if target_dtype in (
        "float16", "bfloat16") else target_dtype


def init_trainer(trainer):
    """Turn on fp32 master weights for the trainer's optimizer."""
    trainer._optimizer.multi_precision = True


def _tensor(g):
    return g._data if isinstance(g, NDArray) else g


class LossScaler:
    """Dynamic loss scaling: the scale grows by ``scale_factor`` after
    ``scale_window`` finite checks in a row and shrinks by it (to no less
    than 1) at an overflow, which also skips the step."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def scale(self, loss):
        return loss * self.loss_scale

    def unscale(self, grads):
        """Divide each gradient (NDArray or tensor) by the scale, in
        place."""
        inv = 1.0 / self.loss_scale
        for g in grads:
            _tensor(g).mul_(inv)

    @staticmethod
    def _all_finite(grads):
        """One reduction over the list on the device (a zero times each
        gradient is zero where it is finite and NaN elsewhere; their L1
        norms, one per gradient, cannot overflow) and one transfer."""
        tensors = [_tensor(g) for g in grads]
        if not tensors:
            return True
        zeros = torch._foreach_mul(tensors, 0.0)
        norms = torch.stack(torch._foreach_norm(zeros, 1))
        return bool(torch.isfinite(norms).all().item())

    def check_and_update(self, grads):
        """True if every gradient is finite (the step should apply); moves
        the scale."""
        finite = self._all_finite(grads)
        if finite:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
        else:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        return finite


def scale_loss(loss, trainer):
    """``loss`` times the trainer's loss scale (a ``LossScaler`` made at
    first use)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        scaler = LossScaler()
        trainer._amp_loss_scaler = scaler
    return scaler.scale(loss)


def unscale(trainer):
    """Divide the trainer's live gradients by its loss scale, in place."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is not None:
        scaler.unscale([p.grad() for p in trainer._params
                        if p.grad_req != "null"])


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  **kwargs):
    """Symbolic conversion: the argument parameters cast to
    ``target_dtype``, the auxiliary states (batch norm's statistics) kept
    as they are; ``sym`` is returned unchanged."""
    new_args = {k: v.astype(target_dtype) for k, v in arg_params.items()}
    return sym, new_args, dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None,
                         **kwargs):
    """The block with its parameters cast to ``target_dtype`` (batch norm
    keeps fp32 statistics)."""
    block.cast(target_dtype)
    return block
