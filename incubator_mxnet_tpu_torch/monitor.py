"""Monitor: statistics of intermediate outputs during training
(counterpart of ``incubator_mxnet_tpu/monitor.py``).

``install`` hooks a Gluon block tree, ``install_exec`` an Executor (the
Module's ``install_monitor``). Every value queued is a copy taken when it
is queued: a torch tensor is written in place, so an output read later at
``toc`` could otherwise show the next step's values.
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return nd.norm(x) / (x.size ** 0.5)
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_pattern = re.compile(pattern)
        self.sort = sort

    def install(self, block):
        """Hook a Gluon block tree."""
        def hook(blk, inputs, output):
            if self.activated and self.re_pattern.match(blk.name):
                outs = output if isinstance(output, (list, tuple)) else [output]
                for i, o in enumerate(outs):
                    if isinstance(o, NDArray):
                        # a copy now: stats at toc() must read this step
                        self.queue.append((self.step,
                                           "%s_output%d" % (blk.name, i),
                                           o.copy()))
        def walk(b):
            b.register_forward_hook(hook)
            for c in b.children():
                walk(c)
        walk(block)

    def install_exec(self, executor):
        self.exes.append(executor)

    def tic(self):
        """Begin collecting for this batch (every ``interval`` batches)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Collect the stats: a list of (step, name, stat)."""
        if not self.activated:
            return []
        for exe in self.exes:
            for i, o in enumerate(getattr(exe, "outputs", [])):
                self.queue.append((self.step, "output%d" % i, o.copy()))
        self.activated = False
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v_arr in queue:
            assert isinstance(v_arr, NDArray)
            v = self.stat_func(v_arr)
            res.append((n, k, v))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k,
                         str(v.asnumpy() if isinstance(v, NDArray) else v))
