"""Device meshes and partition specs (counterpart of
``incubator_mxnet_tpu/parallel/mesh.py``).

A ``Mesh`` is a numpy array of ``torch.device``s with one name per axis, as
``jax.sharding.Mesh`` is of ``jax.Device``s. ``make_mesh(axes)`` takes
every visible CUDA device unless ``devices=`` is given; with no CUDA device
and no ``devices=`` it raises, and never falls back to the CPU by itself. A
mesh may name one device more than once (``[torch.device("cuda", 0)] * 4``
on a one-card machine, ``[torch.device("cpu")] * 8`` in the tests): each
position is still a position of its own, run in a thread of its own by
``shard_map``; positions on one device share its memory and its stream.

``P`` is the ``PartitionSpec`` counterpart: a tuple with one entry per
dimension, an axis name, a tuple of axis names or None (replicated).
``NamedSharding(mesh, spec)`` pairs them, as the JAX package's helpers
return. ``with mesh:`` makes a mesh current on this thread for the block.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as onp
import torch

__all__ = ["make_mesh", "current_mesh", "set_current_mesh", "replicated",
           "shard_spec", "P", "NamedSharding", "Mesh"]

_CURRENT = [None]
_LOCAL = threading.local()     # .stack: meshes entered with ``with``


class P(tuple):
    """A partition spec: ``P("tp", None)`` splits dimension 0 over the
    ``tp`` axis and replicates dimension 1; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


class NamedSharding:
    """A spec laid over a mesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class Mesh:
    """``devices`` (an array of ``torch.device``s of the axes' shape) with
    ``axis_names``; ``shape`` is an ordered {name: size}."""

    def __init__(self, devices, axis_names):
        arr = onp.asarray(devices, dtype=object)
        arr = onp.vectorize(torch.device, otypes=[object])(arr)
        if arr.ndim != len(axis_names):
            raise ValueError("devices of shape %s for axes %s"
                             % (arr.shape, tuple(axis_names)))
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))

    def device_at(self, coords):
        """The device at ``coords`` ({axis: index}, axes left out at 0)."""
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def rest(self, coords):
        """The mesh of the axes ``coords`` leaves out, at ``coords`` (None
        when it binds every axis)."""
        keep = [a for a in self.axis_names if a not in coords]
        if not keep:
            return None
        index = tuple(slice(None) if a in keep else coords[a]
                      for a in self.axis_names)
        return Mesh(self.devices[index], keep)

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _LOCAL.stack.pop()
        return False

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape),
                                 sorted({str(d) for d in self.devices.flat}))


def _visible_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass devices= (for "
            "example [torch.device('cpu')] * 8) to build a mesh elsewhere")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes=None, devices=None):
    """A ``Mesh`` from {'axis': size} (sizes must multiply to the number of
    devices; one size may be -1 to take the rest), made current. Devices
    default to every visible CUDA device."""
    if devices is None:
        devices = _visible_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError("mesh axes %s do not cover %d devices"
                         % (dict(zip(names, sizes)), n))
    mesh = Mesh(onp.asarray(devices, dtype=object).reshape(sizes),
                axis_names=tuple(names))
    set_current_mesh(mesh)
    return mesh


def set_current_mesh(mesh):
    _CURRENT[0] = mesh


def current_mesh():
    """The mesh code on this thread runs over: inside a ``shard_map``
    position, the mesh of the axes it left unbound (None if it bound them
    all); else the innermost ``with mesh:``; else the last one made or
    set."""
    from .compat import _ENV
    frame = getattr(_ENV, "frame", None)
    if frame is not None:
        return frame.rest
    stack = getattr(_LOCAL, "stack", None)
    if stack:
        return stack[-1]
    return _CURRENT[0]


def replicated(mesh):
    return NamedSharding(mesh, P())


def shard_spec(mesh, *axes):
    """NamedSharding partitioning consecutive dims over the given axis
    names (None entries mean 'replicated on that dim')."""
    return NamedSharding(mesh, P(*axes))
