"""Data parallelism and ZeRO-1 over a mesh (counterpart of
``incubator_mxnet_tpu/parallel/data_parallel.py`` and of the mesh path of
the JAX package's ``TrainStep``).

``TrainStep(net, loss_fn, trainer, mesh=, data_axis=)`` splits the batch
over ``data_axis`` with ``shard_map``: each position runs the forward and
the loss on its slice with its replica of the parameters (on the master's
device the parameters themselves, elsewhere a differentiable copy), the
per-sample losses are joined, and one backward sums every position's
gradient into the master copy: the all-reduce. Batch norm takes its
statistics over the global batch there (``ndarray._batch_norm_global``).
Parameters with a ``sharding`` spec over another mesh axis run tensor
parallel inside each position (a 2-D ``dp × tp`` mesh). The mesh step runs
eagerly: it is not captured into a CUDA graph.

``zero=True`` (ZeRO-1) holds each optimizer state of a parameter whose
dimension 0 divides over ``data_axis`` (and that no tensor-parallel spec
already splits) as n ``ShardedState`` slices of its rows, slice i on
position i's device, fp32 masters included (the JAX package's per-leaf
rule). Each position updates its 1/n of the flattened parameter with its
slices (``zero_apply``) and writes the result into the parameter (the
gather). The update is elementwise per slice, so optimizers that take a
norm over a whole weight (LAMB, LARS) are refused under ``zero``.
"""
from __future__ import annotations

import torch

from ..jit import TrainStep
from .mesh import current_mesh

__all__ = ["DataParallelTrainStep", "ShardedState"]

#: optimizers whose update reads a whole weight (a norm): not sliceable
_WHOLE_WEIGHT = ("LAMB", "LARS")


class DataParallelTrainStep(TrainStep):
    """TrainStep with the batch split over a mesh axis. Parameters follow
    their per-parameter ``sharding`` (tensor and expert parallel compose
    with dp on a 2-D mesh); unannotated parameters replicate."""

    def __init__(self, net, loss_fn, trainer, mesh=None, data_axis="dp",
                 **kw):
        mesh = mesh or current_mesh()
        if mesh is None:
            raise ValueError("DataParallelTrainStep needs a mesh "
                             "(parallel.make_mesh({'dp': N}))")
        super().__init__(net, loss_fn, trainer, mesh=mesh,
                         data_axis=data_axis, **kw)


class ShardedState:
    """One optimizer-state tensor held as ``len(devices)`` slices of its
    rows (dimension 0), flattened, slice i on ``devices[i]``."""

    def __init__(self, full, devices):
        n = len(devices)
        rows = full.shape[0] // n
        self.shape = tuple(full.shape)
        self.dtype = full.dtype
        self.device = full.device
        self.slices = [full[i * rows:(i + 1) * rows].reshape(-1)
                       .to(devices[i]).clone() for i in range(n)]

    def gather(self):
        """The whole tensor on the device it came from."""
        return torch.cat([s.to(self.device) for s in self.slices]) \
            .reshape(self.shape)

    def __repr__(self):
        return "ShardedState(%s, %s, %d slices)" % (
            self.shape, self.dtype, len(self.slices))


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [] if state is None else [state]


def _map(fn, state):
    if isinstance(state, (tuple, list)):
        return type(state)(_map(fn, s) for s in state)
    return None if state is None else fn(state)


def is_sharded(state):
    return any(isinstance(t, ShardedState) for t in _leaves(state))


def gathered(state):
    """``state`` with every ``ShardedState`` leaf gathered into a tensor."""
    return _map(lambda t: t.gather() if isinstance(t, ShardedState) else t,
                state)


def shard_states(trainer, mesh, data_axis):
    """Split the trainer's optimizer states over ``data_axis`` (ZeRO-1), in
    place: each state of a parameter whose dimension 0 divides over the
    axis (and whose ``sharding`` is None) becomes ``ShardedState``s; the
    others stay whole."""
    name = type(trainer._optimizer).__name__
    if name in _WHOLE_WEIGHT:
        raise NotImplementedError(
            "zero=True shards the update elementwise; %s reads whole weights"
            % name)
    n = mesh.shape[data_axis]
    index = [0] * len(mesh.axis_names)
    devices = []
    for i in range(n):
        index[mesh.axis_names.index(data_axis)] = i
        devices.append(mesh.devices[tuple(index)])
    for i, (p, state) in enumerate(zip(trainer._params, trainer._states)):
        if state is None or is_sharded(state) or \
                getattr(p, "sharding", None) is not None:
            continue
        shape = tuple(p.shape)
        leaves = _leaves(state)
        if not shape or shape[0] % n or \
                any(tuple(t.shape) != shape for t in leaves):
            continue
        trainer._states[i] = _map(lambda t: ShardedState(t, devices), state)
        trainer._zero = True


def zero_apply(optimizer, weights, grads, states, lrs, wds, t, rescale):
    """``Optimizer.update_all`` with ZeRO-1 states: weights whose states
    are whole are updated as usual; for each sharded weight, position i
    updates rows slice i of the flattened weight (a view of the parameter,
    or a copy on another device, written back) with gradient slice i and
    its state slices."""
    whole = [j for j, s in enumerate(states) if not is_sharded(s)]
    split = [j for j, s in enumerate(states) if is_sharded(s)]
    per_weight = isinstance(t, torch.Tensor) and t.dim() == 1

    def pick(idx):
        sel = torch.tensor(idx, device=lrs.device)
        return (lrs.index_select(0, sel), wds.index_select(0, sel),
                t.index_select(0, sel) if per_weight else t)
    if whole:
        optimizer.update_all([weights[j] for j in whole],
                             [grads[j] for j in whole],
                             [states[j] for j in whole], *pick(whole),
                             rescale)
    if not split:
        return
    n = len(_leaves(states[split[0]])[0].slices)
    lr_s, wd_s, t_s = pick(split)
    use_master = [optimizer._uses_master(weights[j]) for j in split]
    for i in range(n):
        ws, gs, ss, back = [], [], [], []
        for j in split:
            w, g = weights[j], grads[j]
            leaf = _leaves(states[j])[0]
            rows = leaf.slices[i].numel()
            dev = leaf.slices[i].device
            view = w.view(-1)[i * rows:(i + 1) * rows]
            local = view if view.device == dev else view.to(dev)
            if local is not view:
                back.append((view, local))
            ws.append(local)
            gs.append(None if g is None else
                      g.reshape(-1)[i * rows:(i + 1) * rows].to(dev))
            ss.append(_map(lambda s: s.slices[i], states[j]))
        dev = ws[0].device
        optimizer.update_all(ws, gs, ss, lr_s.to(dev), wd_s.to(dev),
                             t_s.to(dev) if isinstance(t_s, torch.Tensor)
                             else t_s, rescale.to(dev),
                             use_master=use_master)
        with torch.no_grad():
            for view, local in back:
                view.copy_(local)
