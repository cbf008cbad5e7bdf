"""Gluon pipeline parallelism: embed → pipelined trunk → head (counterpart
of ``incubator_mxnet_tpu/parallel/gluon_pipeline.py``).

``PipelineStack`` runs N structurally identical stage blocks (transformer
layers) on the GPipe ring over the ``pp`` mesh axis
(``pipeline.pipeline_spmd``); the embedding and head around it run outside
the ring. Each stage keeps its own Parameters (``collect_params`` and the
Trainer see them all); at call time the stages' tensors are stacked on a
leading stage dim (the stack's gradient is the per-stage unstack), and on
position s the first stage's block runs with slice s of the stack standing
in for its parameters (``Parameter._tensor``'s thread-local override).
The ring is differentiable, so one backward (``TrainStep``) trains embed,
trunk and head together::

    trunk = PipelineStack([make_layer() for _ in range(4)], mesh,
                          n_microbatches=8)
    net = nn.HybridSequential()
    net.add(embed, trunk, head)
    step = TrainStep(net, loss_fn, trainer)

Stages with running statistics (batch norm) are refused, as in the JAX
package: their in-place updates cannot cross the ring. Use LayerNorm.
"""
from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..gluon import parameter as _param
from .compat import in_shard_map
from .mesh import current_mesh
from .pipeline import pipeline_spmd

__all__ = ["PipelineStack"]


class PipelineStack(HybridBlock):
    """Pipeline N structurally identical blocks over the ``pp`` mesh
    axis; stages map (batch, ...) -> (batch, ...) with identical shapes."""

    def __init__(self, stages, mesh, axis="pp", n_microbatches=None,
                 data_axis=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.n_stages = len(stages)
        self.n_microbatches = n_microbatches or self.n_stages
        self.stages = list(stages)
        for s in self.stages:
            self.register_child(s)
        self._per_stage = None

    def _build(self):
        from ..gluon.nn.basic_layers import BatchNorm
        per_stage = [list(s.collect_params().items()) for s in self.stages]

        def sig(items):
            return [(name, tuple(p.shape)) for name, p in items]
        first = sig(per_stage[0])
        for items in per_stage[1:]:
            if sig(items) != first:
                raise ValueError("pipeline stages must be structurally "
                                 "identical (same parameter structure)")
        if any(isinstance(m, BatchNorm) for m in self.stages[0].modules()):
            raise ValueError(
                "PipelineStack stages cannot carry aux-state updates "
                "(BatchNorm running stats); use LayerNorm in ring stages")
        self._per_stage = [[p for _, p in items] for items in per_stage]

    def forward(self, x):
        from ..ndarray import NDArray
        if self._per_stage is None:
            self._build()
        wrap = isinstance(x, NDArray)
        xd = x._data if wrap else x
        nper = len(self._per_stage[0])
        stacked = [torch.stack([ps[j]._tensor() for ps in self._per_stage])
                   for j in range(nper)]
        block, own = self.stages[0], self._per_stage[0]

        def stage_fn(stage_params, h):
            mapping = {id(p): t for p, t in zip(own, stage_params)}
            outer = getattr(_param._OVERRIDE, "fn", None)

            def override(p):
                t = mapping.get(id(p))
                if t is None and outer is not None:
                    t = outer(p)
                return t
            _param._OVERRIDE.fn = override
            try:
                return block(h)
            finally:
                _param._OVERRIDE.fn = outer

        mesh, data_axis = self.mesh, self.data_axis
        inner = current_mesh()
        if in_shard_map() and inner is not None and self.axis in inner.shape:
            # inside a data-parallel step's position: the batch is already
            # this position's slice, and the ring runs over what is left
            mesh = inner
            if data_axis not in inner.shape:
                data_axis = None
        out = pipeline_spmd(stage_fn, stacked, xd, mesh,
                            self.n_microbatches, axis=self.axis,
                            data_axis=data_axis)
        out = out.to(xd.device)
        return NDArray(out) if wrap else out
