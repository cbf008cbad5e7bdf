"""Learning-rate schedulers (counterpart of
``incubator_mxnet_tpu/lr_scheduler.py``).

Plain Python on the host, with the JAX package's float arithmetic: a
scheduler maps the optimizer's ``num_update`` to a learning rate, which
``Optimizer.step_scalars`` puts into the step's device vector, so a
captured ``jit.TrainStep`` replays each step with that step's rate.

Warm-up: ``warmup_mode="linear"`` rises from ``warmup_begin_lr`` to the
base rate over ``warmup_steps`` updates, as in the JAX package;
``"constant"`` holds ``warmup_begin_lr`` until then, as MXNet does (the
JAX package squares a ramp there instead).
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler: ``__call__(num_update)`` is the learning rate."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant', "
                             "got %r" % (warmup_mode,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr * factor^k`` after every ``step`` updates, never below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor,
                               self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """``base_lr * factor`` past each update count in ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay from ``base_lr`` to ``final_lr`` at
    ``max_update`` (power ``pwr``) after the warm-up."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            return self.final_lr + (self.base_lr_orig - self.final_lr) * pow(
                1 - (num_update - self.warmup_steps) / self.max_steps,
                self.power)
        return self.final_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` at ``max_update``
    after the warm-up."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            return self.final_lr + (self.base_lr_orig - self.final_lr) * (
                1 + math.cos(math.pi * (num_update - self.warmup_steps)
                             / self.max_steps)) / 2
        return self.final_lr
