"""Mesh-split servables: tensor-parallel predict behind the batcher
(counterpart of ``incubator_mxnet_tpu/serving/sharded.py``).

- Tensor parallelism: parameters annotated by ``parallel.tensor_parallel``
  (``ColParallelDense``, ``RowParallelDense``, ``shard_params``, the
  models' ``tp_axis``) carry a spec over the ``tp`` mesh axis; a forward
  under the group's mesh computes those layers per shard
  (``shard_map``) and gathers at their boundaries. Unannotated
  parameters replicate.
- Data-parallel replica groups: ``replicas=N`` carves the device list into
  N disjoint tp-sized groups, one mesh each, and ``predict_batch(...,
  replica=r)`` runs on group r, so the batcher's per-replica workers each
  drive their own group. Each group holds its own copy of the weights (on
  its first device), which its forwards read through
  ``Parameter._tensor``'s thread-local override.

Programs go through the process-wide ``aot.CACHE`` keyed with the mesh
signature and the group, so the registry's prewarm covers every (bucket x
replica) pair and counts one build each. A mesh program is the eager
forward run as it is (``jit._Direct``): it is neither captured into a CUDA
graph (its positions launch from threads of their own) nor exported
through the artifact layer (``torch.export`` does not trace threads), so
with ``MXTPU_AOT_CACHE_DIR`` set mesh entries stay in memory only.
Outputs come back as host numpy arrays, bfloat16 widened to float32, as
``BlockServable``'s do.
"""
from __future__ import annotations

import threading
import time as _time

import torch

from .. import aot
from .. import config
from .. import jit as _jit
from ..gluon import parameter as _param
from ..parallel.mesh import Mesh, _visible_devices
from ..telemetry import devstats, spans
from .registry import _to_host

__all__ = ["MeshServable", "serving_mesh"]


def serving_mesh(tp=None, devices=None, tp_axis="tp"):
    """A 1-axis tp mesh over the first ``tp`` devices (``MeshServable``'s
    default when no mesh is passed; tp default ``MXTPU_SERVE_TP``;
    devices default every visible CUDA device, and none raises)."""
    if tp is None:
        tp = int(config.get_env("MXTPU_SERVE_TP"))
    if devices is None:
        devices = _visible_devices()
    devices = [torch.device(d) for d in devices]
    if tp < 1 or tp > len(devices):
        raise ValueError("tp=%d needs 1..%d devices" % (tp, len(devices)))
    return Mesh(devices[:tp], axis_names=(tp_axis,))


class MeshServable:
    """Serve a live, initialized Gluon block tensor-parallel over a mesh,
    optionally in data-parallel replica groups. ``predict_batch(*stacked[,
    replica=r])`` is the batcher's entry point. ``devices`` (the port's
    own keyword) is the list groups are carved from: default every
    visible CUDA device."""

    def __init__(self, net, mesh=None, tp=None, tp_axis="tp", replicas=1,
                 model_id=None, devices=None):
        self.tp_axis = tp_axis
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError("replicas must be >= 1 (got %d)" % replicas)
        if mesh is not None:
            meshes = [mesh]
            if replicas > 1:
                raise ValueError(
                    "pass either an explicit mesh (one group) or "
                    "replicas=N (N auto-carved tp groups), not both")
        else:
            if tp is None:
                tp = int(config.get_env("MXTPU_SERVE_TP"))
            if devices is None:
                devices = _visible_devices()
            devices = [torch.device(d) for d in devices]
            if replicas * tp > len(devices):
                raise ValueError(
                    "replicas=%d x tp=%d needs %d devices, have %d"
                    % (replicas, tp, replicas * tp, len(devices)))
            meshes = [serving_mesh(tp, devices[g * tp:(g + 1) * tp],
                                   tp_axis) for g in range(replicas)]
        self.meshes = meshes
        self.mesh = meshes[0]
        self._net = net
        self._params = list(net.collect_params().values())
        with torch.no_grad():
            self._group_params = [
                {id(p): p._tensor().detach().to(m.devices.flat[0],
                                                copy=True)
                 for p in self._params} for m in meshes]
        if model_id is None:
            model_id = aot.model_id_for(net, extra=("mesh-serve",))
        self._model_id = model_id
        self._owner = object()
        self._keys = set()
        self._keys_lock = threading.Lock()

    @property
    def replicas(self):
        return len(self.meshes)

    def _forward(self, group, inputs):
        """The net's forward on group ``group``: its mesh current, its
        copy of the weights standing in for the parameters."""
        from ..gluon._functional import plain
        copies = self._group_params[group]
        saved = getattr(_param._OVERRIDE, "fn", None)
        _param._OVERRIDE.fn = lambda p: copies.get(id(p))
        try:
            with self.meshes[group], torch.inference_mode(), plain():
                return self._net(*inputs)
        finally:
            _param._OVERRIDE.fn = saved

    def _compiled(self, datas, group, first):
        """This signature's program on group ``group`` through the shared
        cache (the mesh signature and the group in the key); the build's
        eager answer goes to ``first``."""
        from ..gluon._functional import _flat
        mesh = self.meshes[group]
        key = aot.cache_key(self._model_id, aot.input_signature(datas),
                            kind="serve", mesh=mesh, extra=("rep", group))
        with self._keys_lock:
            self._keys.add(key)

        def build():
            t0 = _time.perf_counter()
            spec = []

            def body(*xs):
                outs, structure = _flat(self._forward(group, xs),
                                        "MeshServable's net")
                spec[:] = [structure]
                return outs
            with spans.span("eval:build", model_id=self._model_id,
                            mesh=str(aot.mesh_sig(mesh)), replica=group):
                program = _jit._Direct(body)
                out, program.stats = devstats.measure(lambda: body(*datas))
            dur = _time.perf_counter() - t0
            _jit._COMPILES.inc(kind="serve")
            _jit._COMPILE_SECONDS.inc(dur, kind="serve")
            first.append(out)
            return program, spec[0], None
        return aot.compile_cached(key, build, owner=self._owner)

    def predict_batch(self, *stacked_inputs, replica=0):
        """Run one stacked batch tensor-parallel on replica group ``replica
        % self.replicas``; host numpy outputs."""
        from ..gluon._functional import _unflatten
        group = int(replica) % len(self.meshes)
        device = self.meshes[group].devices.flat[0]
        datas = _jit._to_device(stacked_inputs, device)
        first = []
        entry = self._compiled(datas, group, first)
        if first:
            out = first[0]
        else:
            with entry.fn.lock:
                out = _jit.run_program(entry.fn, datas, entry.stats,
                                       "serve", self._model_id)
        outs = _unflatten(entry.extras, iter(out))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        return tuple(_to_host(o) for o in outs)

    def release(self):
        """Drop this servable's programs from the ``aot`` cache."""
        with self._keys_lock:
            keys, self._keys = self._keys, set()
        for key in keys:
            aot.CACHE.release(key, self._owner)
